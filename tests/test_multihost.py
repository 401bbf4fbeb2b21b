"""Multi-host (jax.distributed, 2 CPU processes × 4 virtual devices)
tests — SURVEY.md §4's "multi-host tests the reference never needed" and
the 2-D Mesh(("host","chip")) step must produce the
same tracking result whether the host axis lives in one process or spans
a process boundary (cross-host fake)."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8-device virtual mesh")

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nproc=2, timeout=420):
    """Launch the workers; return {scene: mean_state (13,)}."""
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # worker sets its own device count
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(_WORKER))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(nproc), coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
    means = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MEAN "):
                rec = json.loads(line[5:])
                means[rec["scene"]] = np.array(rec["state"], np.float32)
    return means


def _reference_means(nproc=2):
    """The same problem on the single-process 8-device mesh (identical
    global mesh shape → identical collective structure)."""
    import jax.numpy as jnp

    from dbot_ros_tpu.filters import rbcpf
    from dbot_ros_tpu.models import beam, occlusion, transition
    from dbot_ros_tpu.models.sensor import make_rb_sensor
    from dbot_ros_tpu.ops.raycast import raycast_depth
    from dbot_ros_tpu.parallel import dist_filter
    from dbot_ros_tpu.utils import se3
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh

    K = np.array([[28.0, 0, 10], [0, 28.0, 10], [0, 0, 1.0]])
    cam = make_camera(K, 20, 20)
    mesh = box_mesh(0.08, 0.06, 0.05)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    tp = transition.make_transition_params(0.4, 1.5, damping=8.0)
    sensor = make_rb_sensor(mesh, cam, bp, op, tri_chunk=128)

    S, n_part = nproc, 32
    mesh2d = dist_filter.make_scene_mesh(nproc, 4)
    true_poses = jnp.stack([
        jnp.concatenate([jnp.array([0.02 * s - 0.01, 0.0, 0.55 + 0.03 * s]),
                         se3.quat_identity()]) for s in range(S)])
    obs = jnp.stack([
        jnp.where(jnp.isfinite(z), z, jnp.nan)
        for z in [raycast_depth(mesh, true_poses[s], cam.rays, 128)
                  for s in range(S)]])

    belief_local = jax.vmap(
        lambda k, p: rbcpf.init_belief(k, p, n_part, cam.num_pixels))(
        jax.random.split(jax.random.PRNGKey(7), S), true_poses[:, None, :])
    from jax.sharding import NamedSharding, PartitionSpec as P
    sp = NamedSharding(mesh2d, P("host", "chip"))
    ss = NamedSharding(mesh2d, P("host"))
    belief = rbcpf.ParticleBelief(
        states=jax.device_put(belief_local.states, sp),
        log_weights=jax.device_put(belief_local.log_weights, sp),
        occlusion=jax.device_put(belief_local.occlusion, sp),
        key=jax.device_put(belief_local.key, ss),
    )
    obs = jax.device_put(obs, ss)
    step = dist_filter.make_multi_scene_step(
        mesh2d, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.8)
    for t in range(5):
        belief, mean_states, ess = step(belief, obs)
    return np.asarray(mean_states), np.asarray(true_poses)


def test_multihost_matches_single_process():
    """2 processes × 4 devices vs 1 process × 8 devices, identical global
    mesh: the multi-scene step must agree to float tolerance (same data,
    same PRNG, same collective structure) and track every scene."""
    ref, true_poses = _reference_means()
    means = _run_workers()
    assert sorted(means) == [0, 1], sorted(means)
    for s in range(2):
        got = means[s].reshape(ref.shape[1:])
        np.testing.assert_allclose(got, ref[s], atol=1e-5,
                                   err_msg=f"scene {s}")
        err = np.linalg.norm(got[0, :3] - true_poses[s, :3])
        assert err < 0.012, (s, err)

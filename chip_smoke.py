"""Smoke run of the tracking system on one NVIDIA GPU (or four).

Runs the production path compiled for the card, at the production
operating point (examples/particle_tracker.json: 10,000 particles, 80×60
depth frames, the fused GPU kernel), in one process:

  1. device      — require a GPU; print platform, kind, count, the
                   card's name and power limit, the JAX version and
                   XLA_FLAGS;
  2. parity      — the compiled fused likelihood kernel vs its plain
                   ``jnp`` formulation at 10k particles × 4800 px (full
                   and compacted level, fresh and lazily aged occlusion),
                   then the whole FusedSensor vs the exact renderer +
                   image_loglik;
  3. particle    — ``python -m dbot_ros_tpu simulate`` (called in
                   process) on the particle tracker's JSON config;
  4. gaussian    — the same for the Gaussian tracker;
  5. distributed — the shard_map filter step on a one-card mesh.

``--four`` instead runs only the sharded path on four cards and what it
is compared with (the same particles on one card).

Any failure exits non-zero. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage::

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards of one host
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

P = 10_000
DOWNSAMPLING = 8            # 640×480 / 8 → 80×60 = 4800 px
FRAMES = 30
# Position-RMSE bound for the end-to-end runs: 1 cm, under one pixel's
# footprint at the 0.8 m start distance (0.8 m / fx 65.6 px ≈ 12 mm).
MAX_RMSE = 0.01
# Tolerances of the parity checks. tests/test_pallas.py compares a
# 1024-pixel sum at rtol 2e-4 / atol 0.05; a 4800-pixel sum can carry
# 4800/1024 ≈ 4.7× the absolute rounding error in the worst case →
# atol 0.25. The relative bound also covers the kernel's erf-free beam
# normalizer (< 1e-6 per pixel away from the range limits).
LL_RTOL = 2e-4
LL_ATOL = 0.25
# bf16 occlusion storage: one ulp of a [0, 1] probability is ≤ 2⁻⁸.
OCC_ATOL = 4e-3


def log(msg):
    print(msg, flush=True)


def device_info(min_count: int):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX backend is "
                         f"{backend!r}")
    devs = jax.devices()
    if len(devs) < min_count:
        raise SystemExit(f"need {min_count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    for line in smi.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def _scene(num_particles=P, downsampling=DOWNSAMPLING, subdivisions=3,
           spread=(0.005, 0.02), seed=0):
    """Camera, icosphere, model params, jittered particle states and an
    observed frame of the object 3 mm off the particles' center."""
    import jax
    import jax.numpy as jnp

    from dbot_ros_tpu.models import beam, occlusion
    from dbot_ros_tpu.ops.raycast import raycast_depth
    from dbot_ros_tpu.utils import se3
    from dbot_ros_tpu.utils.camera import default_kinect_camera
    from dbot_ros_tpu.utils.mesh import icosphere_mesh

    cam = default_kinect_camera(downsampling)
    mesh = icosphere_mesh(radius=0.06, subdivisions=subdivisions)
    bp = beam.make_beam_params()
    op = occlusion.make_occlusion_params()
    ref = jnp.concatenate([jnp.array([0.0, 0.0, 0.8]), se3.quat_identity()])
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    dpos = spread[0] * jax.random.normal(k1, (num_particles, 3))
    drot = spread[1] * jax.random.normal(k2, (num_particles, 3))
    quats = jax.vmap(se3.quat_boxplus, in_axes=(None, 0))(ref[3:7], drot)
    states = jnp.zeros((num_particles, 1, 13), jnp.float32)
    states = states.at[:, 0, :3].set(ref[:3] + dpos)
    states = states.at[:, 0, 3:7].set(quats)
    truth = ref.at[0].add(0.003)
    z = raycast_depth(mesh, truth, cam.rays)
    z_obs = jnp.where(jnp.isfinite(z), z, 1.5).at[::97].set(jnp.nan)
    return cam, mesh, bp, op, ref, states, z_obs


def _close(name, got, want, rtol, atol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - want)
    log(f"  {name}: max |diff| {err.max():.3g} (bound {atol} + "
        f"{rtol}·|ref|, |ref| ≤ {np.abs(want).max():.4g})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


def tight_level(sensor, states, cand):
    """The sensor's tight compaction level, built on the host: packed
    slabs of the selected triangles only, the selected pixels (active
    ones first, padded to the level's cap), their candidate ids
    renumbered into the slabs, and the number of active pixels."""
    import jax.numpy as jnp

    from dbot_ros_tpu.ops import raycast_pallas as rp

    n = cand.shape[0]
    deg = sensor.union_triangles - 1
    cand_np = np.asarray(cand)
    active = np.nonzero((cand_np != deg).any(axis=1))[0]
    pcap = sensor._active_cap(n, sensor.levels[0][0])
    tcap = sensor._tri_cap(sensor.levels[0][1])
    inactive = np.setdiff1d(np.arange(n), active)
    sel = np.concatenate([active, inactive])[:pcap].astype(np.int32)
    uniq = np.unique(cand_np[sel])
    if len(active) > pcap or len(uniq) >= tcap:
        raise AssertionError(f"scene does not fit the tight level: "
                             f"{len(active)} px, {len(uniq)} triangles")
    uniq = np.concatenate([uniq, np.full(tcap - len(uniq), deg)])
    cand_c = np.searchsorted(uniq, cand_np[sel]).astype(np.int32)
    p_pad, _ = rp._particle_pads(states.shape[0])
    gt = sensor._pack_selected(states, p_pad, jnp.asarray(uniq))
    return gt, jnp.asarray(sel), jnp.asarray(cand_c), len(active)


def phase_kernel_parity(num_particles=P, downsampling=DOWNSAMPLING,
                        subdivisions=3, interpret=None):
    """Compiled kernel vs plain formulation, then sensor vs exact model."""
    import jax
    import jax.numpy as jnp

    from dbot_ros_tpu.models.image_loglik import image_loglik
    from dbot_ros_tpu.ops import raycast_pallas as rp
    from dbot_ros_tpu.ops.raycast import raycast_depth

    cam, mesh, bp, op, ref, states, z_obs = _scene(
        num_particles, downsampling, subdivisions)
    sensor = rp.make_fused_sensor(mesh, cam, bp, op, bary_slack=0.0,
                                  interpret=interpret)
    n, nb = cam.num_pixels, sensor.nb
    p_pad, pr = rp._particle_pads(num_particles)
    n_pad = rp._round_up(n, nb)
    cand = sensor.candidates(states)
    key = jax.random.PRNGKey(1)
    occ = (0.6 * jax.random.uniform(key, (n_pad * pr, 128))).astype(
        jnp.bfloat16)
    ages = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0,
                              6).astype(jnp.float32)
    pv = rp.make_params_vec(bp, op, jnp.float32(1.0), 0.0)

    gt_c, sel, cand_c, n_active = tight_level(sensor, states, cand)
    log(f"  scene: {num_particles} particles, {n} px, {n_active} "
        f"active px (level cap {len(sel)}), {mesh.num_triangles} "
        f"triangles")

    levels = {
        "full": (sensor._pack_full(states, p_pad), occ, z_obs, cand,
                 cam.rays, ages, nb),
        "compact": (gt_c, rp.gather_pixel_rows(occ, sel, pr), z_obs[sel],
                    cand_c, cam.rays[sel], ages[sel], nb),
    }
    for lvl, (gt, q, z, c, rays, age, nbl) in levels.items():
        for aged in (False, True):
            kw = dict(num_particles=num_particles, nb=nbl,
                      ages=age if aged else None)
            t0 = time.perf_counter()
            got = jax.jit(functools.partial(
                rp.fused_loglik_packed, interpret=interpret, **kw))(
                gt, q, z, c, rays, pv)
            jax.block_until_ready(got)
            t1 = time.perf_counter()
            want = jax.jit(functools.partial(
                rp.fused_loglik_reference, **kw))(gt, q, z, c, rays, pv)
            log(f"  kernel vs plain, {lvl} level, "
                f"{'aged' if aged else 'fresh'} occlusion "
                f"(kernel compile+run {t1 - t0:.2f} s):")
            _close("loglik", got[0], want[0], LL_RTOL, LL_ATOL)
            _close("occ_post", got[1], want[1], 0.0, OCC_ATOL)

    # Whole sensor (candidate pass, pack, ladder, kernel, row merge) vs
    # the exact renderer + image_loglik at HIGHEST precision. Particles
    # share the candidate pass's reference pose, so every pixel's hit
    # triangle is a candidate; they differ through per-particle
    # occlusion priors and per-pixel lazy ages.
    same = jnp.broadcast_to(states[:1].at[0, 0, :7].set(ref),
                            states.shape)
    occ_pn = (0.6 * jax.random.uniform(jax.random.fold_in(key, 2),
                                       (num_particles, n)))
    q_leaf = rp.occ_to_kernel(occ_pn.astype(jnp.bfloat16), nb)
    age_leaf = jnp.pad(ages, (0, n_pad - n))
    leaf = (q_leaf, age_leaf)
    dt = 1.0 / 30.0
    occ_now = sensor.occlusion_as_pn(leaf, num_particles)
    ll, post = jax.jit(lambda s, o, z: sensor(s, o, z, dt))(
        same, leaf, z_obs)
    depth = raycast_depth(mesh, ref, cam.rays)
    ll_ref, occ_ref = image_loglik(
        jnp.broadcast_to(depth, (num_particles, n)), z_obs, occ_now, bp,
        op, dt_frames=dt * sensor.frame_rate)
    # the sensor's sum also counts the kernel grid's padding pixels (no
    # observation: log p_invalid_background each, the same for every
    # particle; none at 80×60 = 75·64 px)
    ll_ref = ll_ref + (n_pad - n) * jnp.log(bp.p_invalid_background)
    log("  FusedSensor vs raycast_depth + image_loglik:")
    _close("loglik", ll, ll_ref, LL_RTOL, LL_ATOL)
    _close("occ_post", sensor.occlusion_as_pn(post, num_particles),
           occ_ref, 0.0, OCC_ATOL)


def _example_config(root, name, mesh_path):
    with open(os.path.join(root, "examples", f"{name}.json")) as fh:
        conf = json.load(fh)
    conf["object"]["meshes"] = [mesh_path]
    conf["object"].pop("directory", None)
    return conf


def phase_trackers(work_dir, which=("particle_tracker", "gaussian_tracker"),
                   subdivisions=3, frames=FRAMES, max_rmse=MAX_RMSE):
    """``dbot_ros_tpu simulate`` on the example configs (in process: a
    second JAX process could not open the card)."""
    from dbot_ros_tpu.runtime import cli
    from dbot_ros_tpu.utils.mesh import icosphere_mesh

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(work_dir, exist_ok=True)
    mesh = icosphere_mesh(radius=0.06, subdivisions=subdivisions)
    v = np.asarray(mesh.vertices)[:mesh.num_vertices]
    f = np.asarray(mesh.faces)[:mesh.num_triangles] + 1
    mesh_path = os.path.join(work_dir, "icosphere.obj")
    with open(mesh_path, "w") as fh:
        fh.writelines(f"v {a:.9g} {b:.9g} {c:.9g}\n" for a, b, c in v)
        fh.writelines(f"f {a} {b} {c}\n" for a, b, c in f)
    for name in which:
        conf = _example_config(root, name, mesh_path)
        path = os.path.join(work_dir, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(conf, fh)
        argv = ["simulate", "--config", path, "--frames", str(frames),
                "--max-rmse", str(max_rmse)]
        log(f"  dbot_ros_tpu {' '.join(argv)}")
        rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"simulate {name} exited {rc}")


def phase_distributed(num_particles=P, downsampling=DOWNSAMPLING,
                      subdivisions=3, interpret=None, steps=5):
    """The shard_map filter step (counts exchange) on a one-card mesh."""
    import jax

    from dbot_ros_tpu.models import transition
    from dbot_ros_tpu.models.sensor import make_rb_sensor
    from dbot_ros_tpu.parallel import dist_filter

    cam, mesh, bp, op, ref, _, z_obs = _scene(num_particles, downsampling,
                                              subdivisions)
    sensor = make_rb_sensor(mesh, cam, bp, op, backend="pallas",
                            interpret=interpret)
    tp = transition.make_transition_params(0.1, 0.5, damping=4.0)
    mesh1 = dist_filter.make_particle_mesh(1)
    belief = dist_filter.init_distributed_belief(
        jax.random.PRNGKey(0), ref, num_particles, mesh1, cam.num_pixels,
        sensor=sensor)
    step = dist_filter.make_distributed_step(mesh1, sensor, tp, 1.0 / 30.0,
                                             max_kl_divergence=1.0)
    for _ in range(steps):
        belief, mean_state, ess = step(belief, z_obs)
    mean_state = np.asarray(mean_state)
    if mean_state.shape != (1, 13) or not np.isfinite(mean_state).all():
        raise AssertionError(f"distributed step: bad mean {mean_state}")
    err = float(np.linalg.norm(mean_state[0, :3] - np.asarray(ref[:3])))
    log(f"  {steps} steps; mean position {err * 1e3:.2f} mm from the "
        f"start pose, ESS {float(ess):.0f}")
    if err > 0.01:
        raise AssertionError(f"distributed step drifted {err:.4f} m")


def phase_four(n_devices=4, num_particles=P, downsampling=DOWNSAMPLING,
               subdivisions=3, interpret=None):
    """Particles sharded over ``n_devices`` cards vs the same particles
    on one card: per-particle logliks, then the counts-exchange step
    with a forced resample."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as Pspec

    from dbot_ros_tpu.models import transition
    from dbot_ros_tpu.models.sensor import make_rb_sensor
    from dbot_ros_tpu.parallel import dist_filter

    cam, mesh, bp, op, ref, states, z_obs = _scene(
        num_particles // n_devices, downsampling, subdivisions)
    sensor = make_rb_sensor(mesh, cam, bp, op, backend="pallas",
                            interpret=interpret)
    dt = 1.0 / 30.0
    # Every shard holds the same particle block, so each shard's
    # candidate pass (at its local mean pose) sees the global mean.
    states = jnp.concatenate([states] * n_devices)
    meshn = dist_filter.make_particle_mesh(n_devices)
    local = num_particles // n_devices
    occ1 = sensor.init_occlusion(num_particles, 0.1)
    occn = jax.tree_util.tree_map(
        lambda x: jnp.concatenate([x] * n_devices),
        sensor.init_occlusion(local, 0.1))
    ll1, _ = jax.jit(lambda s, o, z: sensor(s, o, z, dt))(states, occ1,
                                                          z_obs)
    sharded = jax.jit(shard_map(
        lambda s, o, z: sensor(s, o, z, dt), mesh=meshn,
        in_specs=(Pspec("p"), Pspec("p"), Pspec()),
        out_specs=(Pspec("p"), Pspec("p")), check_vma=False))
    lln, _ = sharded(states, occn, z_obs)
    log(f"  per-particle loglik, {n_devices} cards vs one card:")
    _close("loglik", lln, ll1, LL_RTOL, LL_ATOL)
    if len(lln.sharding.device_set) != n_devices:
        raise AssertionError("loglik not sharded over the mesh")

    tp = transition.make_transition_params(0.1, 0.5, damping=4.0)
    for n in (n_devices, 1):
        meshk = dist_filter.make_particle_mesh(n)
        belief = dist_filter.init_distributed_belief(
            jax.random.PRNGKey(0), ref, num_particles, meshk,
            cam.num_pixels, sensor=sensor)
        step = dist_filter.make_distributed_step(
            meshk, sensor, tp, dt, max_kl_divergence=-1.0,
            exchange="counts")
        belief, mean_state, _ = step(belief, z_obs)
        jax.block_until_ready(belief)
        mean_state = np.asarray(mean_state)
        err = float(np.linalg.norm(mean_state[0, :3] - np.asarray(ref[:3])))
        lw = np.asarray(belief.log_weights)
        log(f"  counts-exchange step on {n} card(s): forced resample "
            f"{'fired' if not lw.any() else 'DID NOT FIRE'}; states on "
            f"{len(belief.states.sharding.device_set)} device(s); mean "
            f"{err * 1e3:.2f} mm from the start pose")
        if (lw.any() or not np.isfinite(mean_state).all() or err > 0.01
                or len(belief.states.sharding.device_set) != n):
            raise AssertionError(f"counts-exchange step on {n} card(s)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded path")
    args = parser.parse_args(argv)

    from dbot_ros_tpu.utils.compile_cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    devs = device_info(4 if args.four else 1)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".smoke")
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [
            ("parity", phase_kernel_parity),
            ("particle", functools.partial(
                phase_trackers, work, ("particle_tracker",))),
            ("gaussian", functools.partial(
                phase_trackers, work, ("gaussian_tracker",))),
            ("distributed", phase_distributed),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        fn()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()

"""Multi-chip (virtual 8-device CPU mesh) particle filter tests.

The distributed coverage the reference never had (SURVEY.md §4): the
shard_map step must track like the single-device filter and resample
globally across shards.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dbot_ros_tpu.filters import rbcpf
from dbot_ros_tpu.models import beam, occlusion, transition
from dbot_ros_tpu.models.sensor import make_rb_sensor
from dbot_ros_tpu.ops.raycast import raycast_depth
from dbot_ros_tpu.parallel import dist_filter
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import make_camera
from dbot_ros_tpu.utils.mesh import box_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device mesh")


def setup(n_particles=64):
    K = np.array([[28.0, 0, 10], [0, 28.0, 10], [0, 0, 1.0]])
    cam = make_camera(K, 20, 20)
    mesh = box_mesh(0.08, 0.06, 0.05)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    tp = transition.make_transition_params(0.4, 1.5, damping=8.0)
    sensor = make_rb_sensor(mesh, cam, bp, op, tri_chunk=128)
    return cam, mesh, tp, sensor


def test_distributed_step_runs_and_tracks():
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    b = rbcpf.init_belief(jax.random.PRNGKey(0), pose0, 64, cam.num_pixels)
    b = dist_filter.shard_belief(b, mesh_dev)
    step = dist_filter.make_distributed_step(
        mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.8)

    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    for t in range(6):
        b, mean_state, ess = step(b, z)
    assert b.states.shape == (64, 1, 13)
    err = float(jnp.linalg.norm(mean_state[0, :3] - pose0[:3]))
    assert err < 0.01, err
    assert float(ess) > 1.0
    # sharding preserved on outputs
    assert len(b.states.sharding.device_set) == 8


def test_distributed_resampling_global():
    """Degenerate weights concentrated on one shard must repopulate ALL
    shards with that particle after resampling."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    b = rbcpf.init_belief(jax.random.PRNGKey(1), pose0, 64, cam.num_pixels)
    # mark particle 5's position so we can see its offspring
    states = b.states.at[:, 0, 1].set(jnp.arange(64, dtype=jnp.float32)
                                      * 1e-4)
    b = rbcpf.ParticleBelief(
        states=states,
        log_weights=jnp.full((64,), -500.0).at[5].set(0.0),
        occlusion=b.occlusion, key=b.key)
    b = dist_filter.shard_belief(b, mesh_dev)
    # max_kl tiny → always resample; transition noise ~0 keeps marker
    tp0 = transition.make_transition_params(1e-6, 1e-6, damping=0.0)
    step = dist_filter.make_distributed_step(
        mesh_dev, sensor, tp0, 1.0 / 30.0, max_kl_divergence=0.1)
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    b2, mean_state, ess = step(b, z)
    # All offspring carry particle 5's marker (weights were degenerate).
    np.testing.assert_allclose(np.asarray(b2.states[:, 0, 1]),
                               np.full(64, 5e-4), atol=1e-5)
    np.testing.assert_allclose(np.asarray(b2.log_weights),
                               np.zeros(64), atol=1e-5)


def test_distributed_matches_single_device_statistics():
    """Same scene: distributed posterior mean ≈ single-device posterior
    mean (different RNG streams → statistical, not bitwise, agreement)."""
    cam, mesh, tp, sensor = setup()
    pose0 = jnp.concatenate([jnp.array([0.0, 0.01, 0.55]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    # single device
    b1 = rbcpf.init_belief(jax.random.PRNGKey(2), pose0, 128,
                           cam.num_pixels)
    step1 = jax.jit(lambda bel, obs: rbcpf.rbcpf_step(
        bel, obs, sensor, tp, 1.0 / 30.0, 0.8))
    for t in range(5):
        b1, info1 = step1(b1, z)

    # distributed
    mesh_dev = dist_filter.make_particle_mesh(8)
    b2 = rbcpf.init_belief(jax.random.PRNGKey(3), pose0, 128,
                           cam.num_pixels)
    b2 = dist_filter.shard_belief(b2, mesh_dev)
    step2 = dist_filter.make_distributed_step(mesh_dev, sensor, tp,
                                              1.0 / 30.0, 0.8)
    for t in range(5):
        b2, mean_state, ess = step2(b2, z)

    e1 = np.asarray(info1.mean_state[0, :3]) - np.asarray(pose0[:3])
    e2 = np.asarray(mean_state[0, :3]) - np.asarray(pose0[:3])
    assert np.linalg.norm(e1) < 0.008
    assert np.linalg.norm(e2) < 0.008


def test_ring_exchange_matches_all_gather():
    """The memory-bounded ring-ppermute parent fetch must produce exactly
    the all_gather resampler's output (same belief → same RNG → same
    parents)."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    def make_belief():
        b = rbcpf.init_belief(jax.random.PRNGKey(9), pose0, 64,
                              cam.num_pixels)
        # uneven weights + distinct occlusion rows so a wrong parent fetch
        # is visible in the occlusion leaf
        occ = jnp.linspace(0.05, 0.9, 64)[:, None] * jnp.ones(
            (64, cam.num_pixels))
        lw = jnp.sin(jnp.arange(64.0)) * 3.0
        b = rbcpf.ParticleBelief(states=b.states, log_weights=lw,
                                 occlusion=occ, key=b.key)
        return dist_filter.shard_belief(b, mesh_dev)

    outs = {}
    for mode in ("ring", "all_gather", "neighbor", "counts"):
        step = dist_filter.make_distributed_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.01,
            exchange=mode)
        b2, mean_state, ess = step(make_belief(), z)
        outs[mode] = (b2, mean_state)
    for mode in ("ring", "neighbor", "counts"):
        np.testing.assert_allclose(
            np.asarray(outs[mode][0].occlusion),
            np.asarray(outs["all_gather"][0].occlusion), atol=1e-6,
            err_msg=mode)
        np.testing.assert_allclose(
            np.asarray(outs[mode][0].states),
            np.asarray(outs["all_gather"][0].states), atol=1e-6,
            err_msg=mode)
        np.testing.assert_allclose(np.asarray(outs[mode][1]),
                                   np.asarray(outs["all_gather"][1]),
                                   atol=1e-6, err_msg=mode)


@pytest.mark.parametrize("mode", ["neighbor", "counts"])
@pytest.mark.parametrize("skew", ["mild", "degenerate"])
def test_bounded_exchange_matches_all_gather(mode, skew):
    """Bounded-hop exchange: mild weight skew stays on the 2H+1-ppermute
    fast path (parents within ±1 shard); degenerate weights exceed
    max_hops and must fall back to the exact full ring. Both must equal
    the all_gather resampler bit-for-bit (same key → same parents)."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    if skew == "mild":
        lw = 0.4 * jnp.sin(jnp.arange(64.0))   # resamples, span <= 1 shard
    else:
        lw = jnp.full((64,), -500.0).at[40].set(0.0)  # span = 5 shards

    def make_belief():
        b = rbcpf.init_belief(jax.random.PRNGKey(11), pose0, 64,
                              cam.num_pixels)
        occ = jnp.linspace(0.05, 0.9, 64)[:, None] * jnp.ones(
            (64, cam.num_pixels))
        b = rbcpf.ParticleBelief(states=b.states, log_weights=lw,
                                 occlusion=occ, key=b.key)
        return dist_filter.shard_belief(b, mesh_dev)

    outs = {}
    for m in (mode, "all_gather"):
        step = dist_filter.make_distributed_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.01,
            exchange=m, max_hops=1)
        b2, mean_state, ess = step(make_belief(), z)
        outs[m] = b2
    assert bool(outs["all_gather"].log_weights.sum() == 0.0), \
        "test must actually resample"
    np.testing.assert_allclose(np.asarray(outs[mode].occlusion),
                               np.asarray(outs["all_gather"].occlusion),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(outs[mode].states),
                               np.asarray(outs["all_gather"].states),
                               atol=1e-6)


def test_counts_exchange_capacity_overflow_falls_back():
    """Counts mode with a tiny capacity vs many distinct parents: the
    m_max > C overflow predicate must route to the exact full ring."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    def make_belief(p):
        b = rbcpf.init_belief(jax.random.PRNGKey(13), pose0, p,
                              cam.num_pixels)
        occ = jnp.linspace(0.05, 0.9, p)[:, None] * jnp.ones(
            (p, cam.num_pixels))
        # near-uniform weights → every parent distinct → m ≈ L > C
        lw = 0.01 * jnp.sin(jnp.arange(float(p)))
        b = rbcpf.ParticleBelief(states=b.states, log_weights=lw,
                                 occlusion=occ, key=b.key)
        return dist_filter.shard_belief(b, mesh_dev)

    # L = 256 local particles, capacity 128 < L: near-uniform weights
    # give ~L distinct parents per shard → overflow → ring fallback.
    p = 2048
    outs = {}
    for m in ("counts", "all_gather"):
        step = dist_filter.make_distributed_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.0001,
            exchange=m, capacity=128)
        b2, mean_state, ess = step(make_belief(p), z)
        outs[m] = b2
    assert bool(outs["all_gather"].log_weights.sum() == 0.0)
    np.testing.assert_allclose(np.asarray(outs["counts"].occlusion),
                               np.asarray(outs["all_gather"].occlusion),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(outs["counts"].states),
                               np.asarray(outs["all_gather"].states),
                               atol=1e-6)


def test_multi_object_distributed_step():
    """K=2 objects across the 8-device mesh: per-object coordinate
    blocks with global per-block resampling (the
    states[:, 0] hardcode is gone). Both objects must track."""
    K = np.array([[28.0, 0, 10], [0, 28.0, 10], [0, 0, 1.0]])
    cam = make_camera(K, 20, 20)
    m1 = box_mesh(0.08, 0.06, 0.05)
    m2 = box_mesh(0.05, 0.05, 0.05)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    tp = transition.make_transition_params(0.4, 1.5, damping=8.0)
    sensor = make_rb_sensor([m1, m2], cam, bp, op, tri_chunk=128)
    mesh_dev = dist_filter.make_particle_mesh(8)
    poses0 = jnp.stack([
        jnp.concatenate([jnp.array([-0.06, 0.0, 0.6]),
                         se3.quat_identity()]),
        jnp.concatenate([jnp.array([0.07, 0.0, 0.62]),
                         se3.quat_identity()])])
    from dbot_ros_tpu.models.sensor import render_scene
    z_true = render_scene([m1, m2], poses0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    b = rbcpf.init_belief(jax.random.PRNGKey(21), poses0, 128,
                          cam.num_pixels)
    b = dist_filter.shard_belief(b, mesh_dev)
    step = dist_filter.make_distributed_step(
        mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.5)
    for t in range(8):
        b, mean_state, ess = step(b, z)
    assert mean_state.shape == (2, 13)
    for k in range(2):
        err = float(jnp.linalg.norm(mean_state[k, :3] - poses0[k, :3]))
        assert err < 0.012, (k, err)
    assert float(ess) > 1.0


def test_multi_scene_2d_mesh_step():
    """The 2-D Mesh(("host","chip")) step: scenes data-parallel on the
    host axis, particles + collectives on the chip axis (SURVEY §7
    layer 8). Every scene must track its own pose."""
    cam, mesh, tp, sensor = setup()
    mesh2d = dist_filter.make_scene_mesh(2, 4)
    S, n_part = 2, 32
    true_poses = jnp.stack([
        jnp.concatenate([jnp.array([0.02 * s - 0.01, 0.0, 0.55 + 0.03 * s]),
                         se3.quat_identity()]) for s in range(S)])
    obs = jnp.stack([
        jnp.where(jnp.isfinite(z), z, jnp.nan)
        for z in [raycast_depth(mesh, true_poses[s], cam.rays, 128)
                  for s in range(S)]])
    belief = dist_filter.init_multi_scene_belief(
        jax.random.PRNGKey(7), true_poses[:, None, :], S, n_part, mesh2d,
        num_pixels=cam.num_pixels)
    step = dist_filter.make_multi_scene_step(
        mesh2d, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.8)
    for t in range(6):
        belief, mean_states, ess = step(belief, obs)
    assert mean_states.shape == (S, 1, 13)
    for s in range(S):
        err = float(jnp.linalg.norm(
            mean_states[s, 0, :3] - true_poses[s, :3]))
        assert err < 0.012, (s, err)
    assert belief.states.shape == (S, n_part, 1, 13)
    assert len(belief.states.sharding.device_set) == 8


def _fused_setup(n_particles=64):
    from dbot_ros_tpu.utils.mesh import l_shape_mesh

    K = np.array([[28.0, 0, 10], [0, 28.0, 10], [0, 0, 1.0]])
    cam = make_camera(K, 20, 20)
    mesh = l_shape_mesh()
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    tp = transition.make_transition_params(0.4, 1.5, damping=8.0)
    sensor = make_rb_sensor(mesh, cam, bp, op, backend="pallas",
                            interpret=True, nb=32)
    return cam, mesh, tp, sensor


@pytest.mark.parametrize("make_step", ["counts", "ring", "island"])
def test_distributed_fused_pallas_sensor(make_step):
    """The fused Pallas sensor (kernel-layout occlusion leaf) inside
    shard_map: the exact counts/ring-exchange steps (exercising the
    generalized gather/concat hooks on the opaque layout) and the island
    step must track on the virtual 8-device mesh."""
    cam, mesh, tp, sensor = _fused_setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    b = dist_filter.init_distributed_belief(
        jax.random.PRNGKey(4), pose0, 64, mesh_dev,
        num_pixels=cam.num_pixels, sensor=sensor)
    occ_q = jax.tree_util.tree_leaves(b.occlusion)[0]
    assert occ_q.shape[0] % 8 == 0
    if make_step == "island":
        step = dist_filter.make_island_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.5,
            island_max_kl=0.3)
    else:
        step = dist_filter.make_distributed_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.5,
            exchange=make_step)
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    for t in range(10):
        b, mean_state, ess = step(b, z)
    err = float(jnp.linalg.norm(mean_state[0, :3] - pose0[:3]))
    # 8 particles/island is deliberately tiny; the island variant carries
    # extra Monte-Carlo error vs the globally-resampling steps
    assert err < (0.02 if make_step == "island" else 0.015), err
    assert float(ess) > 1.0
    assert len(b.states.sharding.device_set) == 8
    # occlusion stayed in the kernel layout (opaque leaf, right shape)
    assert jax.tree_util.tree_leaves(b.occlusion)[0].shape[1] == 128


def test_scaling_harness_mechanics():
    """Weak-scaling sweep runs and reports sane efficiency numbers on the
    virtual CPU mesh (absolute values meaningless off-hardware)."""
    from dbot_ros_tpu.parallel.scaling import run_scaling

    cam, mesh, tp, sensor = setup()
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    res = run_scaling(sensor, tp, cam, pose0, particles_per_device=16,
                      device_counts=[1, 2], frames=3, z_obs=z)
    assert res.device_counts == [1, 2]
    assert res.particles == [16, 32]
    assert len(res.steps_per_s) == 2
    assert res.efficiency[0] == 1.0
    assert all(s > 0 for s in res.steps_per_s)


def test_island_step_tracks():
    """Island-model distributed PF: zero-collective common path must track
    like the plain distributed step."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.01, 0.58]),
                             se3.quat_identity()])
    b = rbcpf.init_belief(jax.random.PRNGKey(5), pose0, 128,
                          cam.num_pixels)
    b = dist_filter.shard_belief(b, mesh_dev)
    step = dist_filter.make_island_step(mesh_dev, sensor, tp, 1.0 / 30.0,
                                        max_kl_divergence=0.8,
                                        island_max_kl=0.3)
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    for t in range(12):
        b, mean_state, ess = step(b, z)
    err = float(jnp.linalg.norm(mean_state[0, :3] - pose0[:3]))
    # 16 particles/island: slightly looser than the global-resampling step
    assert err < 0.015, err
    assert float(ess) > 1.0
    assert bool(jnp.all(jnp.isfinite(b.log_weights)))
    assert len(b.states.sharding.device_set) == 8


def test_island_resampling_exchanges_blocks():
    """One island holds all the posterior mass: island-level resampling
    must replicate its block to the starved islands."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    b = rbcpf.init_belief(jax.random.PRNGKey(6), pose0, 64, cam.num_pixels)
    # Mark each particle with its shard id via y; give shard 3 all weight.
    states = b.states.at[:, 0, 1].set(
        (jnp.arange(64, dtype=jnp.float32) // 8) * 1e-4)
    log_w = jnp.full((64,), -400.0).at[24:32].set(0.0)  # shard 3's block
    b = rbcpf.ParticleBelief(states=states, log_weights=log_w,
                             occlusion=b.occlusion, key=b.key)
    b = dist_filter.shard_belief(b, mesh_dev)
    tp0 = transition.make_transition_params(1e-6, 1e-6, damping=0.0)
    step = dist_filter.make_island_step(mesh_dev, sensor, tp0, 1.0 / 30.0,
                                        max_kl_divergence=1e9,
                                        island_max_kl=0.1)
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)
    b2, mean_state, ess = step(b, z)
    # Every particle now descends from shard 3 (marker y = 3e-4).
    np.testing.assert_allclose(np.asarray(b2.states[:, 0, 1]),
                               np.full(64, 3e-4), atol=1e-5)
    # Weights are globally normalized-ish and equal across islands.
    w = np.exp(np.asarray(b2.log_weights))
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(w, w[0], rtol=1e-4)


def test_multi_scene_vmap_sharded():
    """P7: independent scenes batch on a leading axis (vmap) and shard
    across the mesh as pure data parallelism — the multi-host scaling
    axis for batched serving (SURVEY.md §2.5)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cam, mesh, tp, sensor = setup()
    S, n_part = 8, 32
    mesh_dev = dist_filter.make_particle_mesh(8, axis="b")
    true_poses = jnp.stack([
        jnp.concatenate([jnp.array([0.01 * s - 0.03, 0.0, 0.55 + 0.02 * s]),
                         se3.quat_identity()]) for s in range(S)])
    obs = jnp.stack([
        jnp.where(jnp.isfinite(z), z, jnp.nan)
        for z in [raycast_depth(mesh, true_poses[s], cam.rays, 128)
                  for s in range(S)]])

    beliefs = jax.vmap(
        lambda k, p: rbcpf.init_belief(k, p, n_part, cam.num_pixels))(
        jax.random.split(jax.random.PRNGKey(0), S), true_poses)
    shard = NamedSharding(mesh_dev, P("b"))
    beliefs = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, shard), beliefs)
    obs = jax.device_put(obs, shard)

    step = jax.jit(jax.vmap(functools.partial(
        rbcpf.rbcpf_step, loglik_fn=sensor, trans_params=tp,
        dt=1.0 / 30.0, max_kl_divergence=0.8)))
    for t in range(5):
        beliefs, infos = step(beliefs, obs)
    err = np.linalg.norm(
        np.asarray(infos.mean_state[:, 0, :3] - true_poses[:, :3]),
        axis=-1)
    assert (err < 0.01).all(), err
    assert len(beliefs.states.sharding.device_set) == 8


def test_two_shard_counts_matches_all_gather():
    """S=2 mesh: hops ±1 reach the SAME neighbor — the deduped counts
    exchange must still equal the all_gather resampler bit-for-bit
    (regression for the duplicate-buffer bug, code review r4)."""
    cam, mesh, tp, sensor = setup()
    mesh2 = dist_filter.make_particle_mesh(2)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    def make_belief():
        b = rbcpf.init_belief(jax.random.PRNGKey(9), pose0, 64,
                              cam.num_pixels)
        occ = jnp.linspace(0.05, 0.9, 64)[:, None] * jnp.ones(
            (64, cam.num_pixels))
        b = rbcpf.ParticleBelief(states=b.states,
                                 log_weights=jnp.sin(jnp.arange(64.0)) * 3,
                                 occlusion=occ, key=b.key)
        return dist_filter.shard_belief(b, mesh2)

    outs = {}
    for mode in ("counts", "all_gather"):
        step = dist_filter.make_distributed_step(
            mesh2, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.01,
            exchange=mode)
        b2, ms, ess = step(make_belief(), z)
        outs[mode] = b2
    np.testing.assert_allclose(np.asarray(outs["counts"].occlusion),
                               np.asarray(outs["all_gather"].occlusion),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(outs["counts"].states),
                               np.asarray(outs["all_gather"].states),
                               atol=1e-6)


def test_mixed_trigger_sequence_counts_matches_all_gather():
    """Six frames at a REAL KL threshold (some frames resample, some
    don't): the cond-free counts path must stay bit-identical to
    all_gather through the mixture — including the no-resample frames'
    identity gathers leaving the occlusion leaf exactly unchanged."""
    cam, mesh, tp, sensor = setup()
    mesh_dev = dist_filter.make_particle_mesh(8)
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    z_true = raycast_depth(mesh, pose0, cam.rays, 128)
    z = jnp.where(jnp.isfinite(z_true), z_true, jnp.nan)

    def run(mode):
        b = rbcpf.init_belief(jax.random.PRNGKey(31), pose0, 64,
                              cam.num_pixels)
        b = dist_filter.shard_belief(b, mesh_dev)
        step = dist_filter.make_distributed_step(
            mesh_dev, sensor, tp, 1.0 / 30.0, max_kl_divergence=0.8,
            exchange=mode)
        resampled = []
        for _ in range(6):
            lw_before = np.asarray(b.log_weights).copy()
            b, ms, ess = step(b, z)
            resampled.append(bool(np.asarray(b.log_weights).sum() == 0.0
                                  and lw_before.sum() != 0.0))
        return b, resampled

    b_c, rs_c = run("counts")
    b_g, rs_g = run("all_gather")
    assert rs_c == rs_g
    assert any(rs_c) and not all(rs_c), rs_c   # genuinely mixed triggers
    np.testing.assert_allclose(np.asarray(b_c.occlusion),
                               np.asarray(b_g.occlusion), atol=1e-6)
    np.testing.assert_allclose(np.asarray(b_c.states),
                               np.asarray(b_g.states), atol=1e-6)
    np.testing.assert_allclose(np.asarray(b_c.log_weights),
                               np.asarray(b_g.log_weights), atol=1e-6)

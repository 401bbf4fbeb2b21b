"""Fused kernel vs the XLA reference path (Pallas interpreter on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dbot_ros_tpu.models import beam, occlusion
from dbot_ros_tpu.models.image_loglik import image_loglik
from dbot_ros_tpu.models.sensor import make_rb_sensor
from dbot_ros_tpu.ops import deferred, raycast
from dbot_ros_tpu.ops.raycast_pallas import (fused_loglik, make_fused_sensor,
                                             make_params_vec, occ_from_kernel,
                                             occ_to_kernel)
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import make_camera
from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh


def setup(P=96):
    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    mesh = l_shape_mesh()
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    ref = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]), se3.quat_identity()])
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    dpos = 0.005 * jax.random.normal(k1, (P, 3))
    drot = 0.03 * jax.random.normal(k2, (P, 3))
    poses = jnp.concatenate(
        [ref[None, :3] + dpos,
         jax.vmap(se3.quat_boxplus, in_axes=(None, 0))(ref[3:7], drot)], -1)
    z_true = raycast.raycast_depth(mesh, ref, cam.rays, 128)
    z_obs = jnp.where(jnp.isfinite(z_true), z_true, 2.0)
    # a few invalid pixels
    z_obs = z_obs.at[::37].set(jnp.nan)
    occ0 = jax.random.uniform(jax.random.PRNGKey(5),
                              (P, cam.num_pixels)) * 0.4
    return cam, mesh, bp, op, ref, poses, z_obs, occ0


def test_fused_matches_xla_on_same_depths():
    """Feed the kernel the same candidates the deferred XLA path uses and
    compare loglik + occlusion posterior against image_loglik on the
    deferred depths (identical geometry → only density-math differences:
    the erf truncation normalizer, ≈1 away from range limits)."""
    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup()
    h, w = cam.height, cam.width
    _, ids = deferred.raycast_ids(mesh, ref, cam.rays, 128)
    cand = deferred.candidate_ids(ids, h, w, 2, 2)
    sel = deferred.one_hot_selectors(cand, mesh.padded_triangles)
    depth = deferred.deferred_depth(mesh, poses, cam.rays, sel)
    dtf = 1.0
    ll_ref, occ_ref_post = image_loglik(depth, z_obs, occ0, bp, op, dtf)

    cand_k = jnp.where(cand >= 0, cand,
                       mesh.padded_triangles - 1).astype(jnp.int32)
    pv = make_params_vec(bp, op, jnp.float32(dtf))
    P = poses.shape[0]
    occ_k = occ_to_kernel(occ0, nb=32)
    # layout roundtrip sanity
    np.testing.assert_allclose(
        np.asarray(occ_from_kernel(occ_k, cam.num_pixels, P, nb=32)),
        np.asarray(occ0))
    ll, occ_post_k = fused_loglik(mesh, poses, occ_k, z_obs, cand_k,
                                  cam.rays, pv, nb=32, interpret=True)
    occ_post = occ_from_kernel(occ_post_k, cam.num_pixels, P, nb=32)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=2e-4, atol=0.05)
    np.testing.assert_allclose(np.asarray(occ_post),
                               np.asarray(occ_ref_post), atol=2e-4)


def test_fused_sensor_contract():
    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True, nb=32)
    states = jnp.zeros((64, 1, 13)).at[:, 0, :7].set(poses[:64])
    occ_k = sensor.init_occlusion(64, 0.1)
    ll, occ_post = sensor(states, occ_k, z_obs, 1.0 / 30.0)
    assert ll.shape == (64,)
    # opaque leaf: same pytree structure/shapes in and out
    assert (jax.tree_util.tree_structure(occ_post)
            == jax.tree_util.tree_structure(occ_k))
    for a, b in zip(jax.tree_util.tree_leaves(occ_post),
                    jax.tree_util.tree_leaves(occ_k)):
        assert a.shape == b.shape
    assert bool(jnp.all(jnp.isfinite(ll)))
    q_leaf = jax.tree_util.tree_leaves(occ_post)[0]
    assert bool(jnp.all((q_leaf >= 0) & (q_leaf <= 1)))
    # lineage gather hook: all-parent-5 must replicate particle 5's map
    occ_pn = sensor.occlusion_as_pn(occ_post, 64)
    idx = jnp.full((64,), 5, jnp.int32)
    gathered = sensor.gather_occlusion(occ_post, idx)
    gathered_pn = sensor.occlusion_as_pn(gathered, 64)
    np.testing.assert_allclose(np.asarray(gathered_pn),
                               np.tile(np.asarray(occ_pn[5])[None], (64, 1)))

    # ranking sanity vs exact renderer
    exact = raycast.raycast_depth(mesh, poses[:64], cam.rays, 128)
    ll_e, _ = image_loglik(exact, z_obs, occ0[:64], bp, op, 1.0)
    best_a = int(jnp.argmax(ll))
    exact_rank = int(jnp.sum(ll_e > ll_e[best_a]))
    assert exact_rank < 8, exact_rank


def _perturb_poses(key, ref, P, dpos=0.004, drot=0.02):
    k1, k2 = jax.random.split(key)
    return jnp.concatenate(
        [ref[None, :3] + dpos * jax.random.normal(k1, (P, 3)),
         jax.vmap(se3.quat_boxplus, in_axes=(None, 0))(
             ref[3:7], drot * jax.random.normal(k2, (P, 3)))], -1)


def test_fused_multi_object_matches_candidate_oracle():
    """Two objects (partially mutually occluding) through the fused kernel
    vs an exact jnp intersection of the SAME union candidate sets — the
    only differences left are density-math (erf normalizer ≈ 1)."""
    K_cam = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = make_camera(K_cam, 32, 32)
    meshes = [l_shape_mesh(), box_mesh(0.05, 0.08, 0.04)]
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    P = 64
    refs = [
        jnp.concatenate([jnp.array([-0.02, 0.0, 0.62]),
                         se3.quat_identity()]),
        # box slightly in front and overlapping the L in the image
        jnp.concatenate([jnp.array([0.03, 0.01, 0.55]),
                         se3.quat_identity()]),
    ]
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    poses = jnp.stack(
        [_perturb_poses(keys[k], refs[k], P) for k in range(2)],
        axis=1)                                           # (P, 2, 7)
    states = jnp.zeros((P, 2, 13)).at[..., :7].set(poses)

    from dbot_ros_tpu.models.sensor import render_scene
    z_true = render_scene(meshes, jnp.stack(refs), cam.rays)
    z_obs = jnp.where(jnp.isfinite(z_true), z_true, 2.0)
    z_obs = z_obs.at[::29].set(jnp.nan)

    # bary_slack=0: this is a parity test against the exact intersection
    # of the same candidate sets (slack intentionally deviates from it)
    sensor = make_fused_sensor(meshes, cam, bp, op, interpret=True, nb=32,
                               bary_slack=0.0)
    occ0_prob = 0.15
    occ_k = sensor.init_occlusion(P, occ0_prob)
    dt = 1.0 / 30.0
    ll, occ_post_k = sensor(states, occ_k, z_obs, dt)

    # --- oracle: exact intersection of the same union candidates
    cand = sensor.candidates(states)                      # (N, K)
    Gs, tns = zip(*[raycast.pose_tri_constants(m, poses[:, k])
                    for k, m in enumerate(meshes)])
    Gu = jnp.concatenate(Gs, axis=1)                      # (P, Tu, 3, 3)
    tnu = jnp.concatenate(tns, axis=1)                    # (P, Tu)
    Gc = jnp.take(Gu, cand, axis=1)                       # (P, N, K, 3, 3)
    tc = jnp.take(tnu, cand, axis=1)                      # (P, N, K)
    nums = jnp.einsum("nd,pnkid->pnki", cam.rays, Gc,
                      precision=jax.lax.Precision.HIGHEST)
    t = raycast._intersect_from_numerators(
        nums[..., 0], nums[..., 1], nums[..., 2], tc)
    depth = jnp.min(t, axis=-1)                           # (P, N)

    occ0 = jnp.full((P, cam.num_pixels), occ0_prob)
    ll_ref, occ_ref = image_loglik(depth, z_obs, occ0, bp, op,
                                   dt_frames=1.0)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=2e-4, atol=0.05)
    occ_post = sensor.occlusion_as_pn(occ_post_k, P)
    # atol spans the sensor's bf16 occlusion storage (~0.4 % relative
    # quantization of a [0, 1] probability; FusedSensor.occ_dtype)
    np.testing.assert_allclose(np.asarray(occ_post), np.asarray(occ_ref),
                               atol=4e-3)
    # mutual occlusion is active in this scene: some pixel of the L's
    # silhouette must be shadowed by the box (depth from the box, i.e. the
    # oracle depth at those pixels < the L-only depth)
    d_l_only = raycast.raycast_depth(meshes[0], poses[:, 0], cam.rays, 128)
    assert bool(jnp.any(depth < d_l_only - 1e-4))


def test_fused_backend_tracking_two_objects():
    """Closed-loop 2-object PF with backend='pallas' (interpret mode)."""
    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node, sources
    from dbot_ros_tpu.trackers.particle import ParticleTracker

    K_cam = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = make_camera(K_cam, 32, 32)
    meshes = [l_shape_mesh(), box_mesh(0.05, 0.08, 0.04)]
    config = cfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8, backend="pallas",
        backend_options=dict(interpret=True),
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 2.0, damping=4.0), seed=3)
    tracker = ParticleTracker(config, meshes=meshes, camera=cam)
    starts = np.array([[-0.04, 0, 0.62, 1, 0, 0, 0],
                       [0.05, 0.01, 0.55, 1, 0, 0, 0]], np.float32)

    def traj(t):
        p = starts.copy()
        p[0, 0] += 0.05 * t / 30.0
        p[1, 1] -= 0.04 * t / 30.0
        return p

    src = sources.SyntheticSource(meshes, cam, traj, num_frames=8,
                                  noise_sigma=0.003, seed=5)
    result = node.run(tracker, src)
    assert result.position_rmse() < 0.025, result.position_rmse()


def test_active_pixel_compaction_exact():
    """Compaction must be bit-compatible with the full kernel: same loglik
    (background constants restored) and same occlusion posterior, in both
    the compact branch and the over-cap fallback branch."""
    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    states = jnp.zeros((64, 1, 13)).at[:, 0, :7].set(poses[:64])
    dt = 1.0 / 30.0

    def run(frac, tri_frac=1.0):
        sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True,
                                   nb=32, active_cap_frac=frac,
                                   tri_cap_frac=tri_frac)
        occ_k = occ_to_kernel(occ0[:64], nb=32)
        ll, occ_post = sensor(states, occ_k, z_obs, dt)
        return ll, sensor.occlusion_as_pn(occ_post, 64)

    ll_full, occ_full = run(1.0)       # compaction off
    ll_half, occ_half = run(0.5)       # compact branch (silhouette small)
    ll_tiny, occ_tiny = run(0.04)      # cap=64 px < active → full fallback
    # loglik equality up to f32 accumulation order (|ll| ~ 1.7e3 over
    # 1024 adds); the spread of the difference across particles (what the
    # filter weights actually see) must be far tighter.
    d = np.asarray(ll_half) - np.asarray(ll_full)
    np.testing.assert_allclose(d, d.mean(), atol=5e-3)
    np.testing.assert_allclose(np.asarray(ll_half), np.asarray(ll_full),
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(occ_half), np.asarray(occ_full),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ll_tiny), np.asarray(ll_full),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(occ_tiny), np.asarray(occ_full),
                               atol=1e-6)
    # triangle compaction: compact-tri branch and over-cap fallback
    ll_tri, occ_tri = run(0.5, tri_frac=0.6)   # uniq fits → compact pack
    d2 = np.asarray(ll_tri) - np.asarray(ll_full)
    np.testing.assert_allclose(d2, d2.mean(), atol=5e-3)
    np.testing.assert_allclose(np.asarray(ll_tri), np.asarray(ll_full),
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(occ_tri), np.asarray(occ_full),
                               atol=1e-5)
    ll_tf, occ_tf = run(1.0, tri_frac=0.02)    # tcap < uniq → full fallback
    np.testing.assert_allclose(np.asarray(ll_tf), np.asarray(ll_full),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(occ_tf), np.asarray(occ_full),
                               atol=1e-6)
    # default two-level ladder (tight level + mid level + full fallback)
    sensor_l = make_fused_sensor(mesh, cam, bp, op, interpret=True, nb=32)
    assert len(sensor_l.levels) == 2
    occ_k = occ_to_kernel(occ0[:64], nb=32)
    ll_lad, occ_lad = sensor_l(states, occ_k, z_obs, dt)
    d3 = np.asarray(ll_lad) - np.asarray(ll_full)
    np.testing.assert_allclose(d3, d3.mean(), atol=5e-3)
    np.testing.assert_allclose(np.asarray(ll_lad), np.asarray(ll_full),
                               atol=0.05)
    np.testing.assert_allclose(
        np.asarray(sensor_l.occlusion_as_pn(occ_lad, 64)),
        np.asarray(occ_full), atol=1e-5)
    # sanity: the scene really has active pixels between 64 and cap(0.5)
    sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True, nb=32,
                               active_cap_frac=0.5)
    cand = sensor.candidates(states)
    n_act = int(jnp.sum(jnp.any(cand != sensor.union_triangles - 1,
                                axis=1)))
    assert 64 < n_act <= sensor._active_cap(cam.num_pixels, 0.5), n_act


def test_lazy_occlusion_matches_eager():
    """The lazy (q, age) occlusion leaf must reproduce the eager raw-array
    semantics exactly over several frames, including pixels that enter
    and leave the compacted active set (silhouette moves)."""
    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True, nb=32)
    assert sensor._lazy
    dt = 1.0 / 30.0
    occ_lazy = sensor.init_occlusion(64, 0.1)
    occ_raw = occ_lazy[0]  # same initial q, eager semantics
    for t in range(4):
        # drift the particles so the silhouette (and active set) moves
        states = jnp.zeros((64, 1, 13)).at[:, 0, :7].set(poses[:64])
        states = states.at[:, 0, 0].add(0.01 * t)
        ll_l, occ_lazy = sensor(states, occ_lazy, z_obs, dt)
        ll_r, occ_raw = sensor(states, occ_raw, z_obs, dt)
        np.testing.assert_allclose(np.asarray(ll_l), np.asarray(ll_r),
                                   rtol=1e-6, atol=1e-4)
        # lazy and eager quantize to the bf16 store at different points
        # of the propagation recursion — equal to quantization noise only
        np.testing.assert_allclose(
            np.asarray(sensor.occlusion_as_pn(occ_lazy, 64)),
            np.asarray(sensor.occlusion_as_pn(occ_raw, 64)), atol=4e-3)
    assert bool(jnp.any(occ_lazy[1] > 0)), \
        "some pixels should have aged (test must exercise laziness)"


def test_lazy_occlusion_checkpoint_roundtrip(tmp_path):
    from dbot_ros_tpu.filters import rbcpf
    from dbot_ros_tpu.runtime.checkpoint import load_belief, save_belief

    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True, nb=32)
    belief = rbcpf.init_belief(jax.random.PRNGKey(0), ref, 64,
                               cam.num_pixels, sensor=sensor)
    assert isinstance(belief.occlusion, tuple)
    path = str(tmp_path / "belief.npz")
    save_belief(path, belief)
    restored = load_belief(path)
    assert isinstance(restored.occlusion, tuple)
    for a, b in zip(jax.tree_util.tree_leaves(belief.occlusion),
                    jax.tree_util.tree_leaves(restored.occlusion)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bary_slack_fixes_displaced_pose_scoring():
    """Regression: with faces finer than the pixel grid, the reference-pose
    id image covers only a small fraction of the triangles a displaced
    particle actually hits (8-25 % measured), so with an exact inside-test
    the TRUE pose scores ~10 nats/px below a stale one and the filter
    locks onto the stale pose. The default bary_slack must make the true
    pose win; slack=0 must reproduce the failure (documenting why the
    default is nonzero)."""
    from dbot_ros_tpu.utils.camera import default_kinect_camera
    from dbot_ros_tpu.utils.mesh import icosphere_mesh

    cam = default_kinect_camera(16)
    mesh = icosphere_mesh(radius=0.06, subdivisions=2)  # face ≪ pixel
    bp = beam.make_beam_params(model_sigma=0.005)
    op = occlusion.make_occlusion_params()
    pose0 = jnp.concatenate([jnp.array([0.0, 0.0, 0.8]),
                             se3.quat_identity()])
    gt = pose0.at[0].set(0.006).at[1].set(0.003)
    z = raycast.raycast_depth(mesh, gt, cam.rays)
    z_obs = jnp.where(jnp.isfinite(z), z, jnp.nan)
    P = 64
    dpos = 0.01 * jax.random.normal(jax.random.PRNGKey(0), (P, 3))
    states = jnp.zeros((P, 1, 13), jnp.float32)
    states = states.at[:, 0, :3].set(pose0[:3] + dpos)
    states = states.at[:, 0, 3:7].set(pose0[3:7])
    states = states.at[0, 0, :7].set(gt)     # particle 0 = truth
    states = states.at[1, 0, :7].set(pose0)  # particle 1 = stale

    def loglik(slack):
        # radius/num_candidates pinned (advisor r2): the slack=0 failure
        # reproduction below documents THIS geometry — improving the
        # candidate defaults must not fail the regression guard
        sensor = make_fused_sensor(mesh, cam, bp, op, interpret=True,
                                   bary_slack=slack, num_candidates=2,
                                   radius=2)
        occ = sensor.init_occlusion(P, 0.1)
        ll, _ = sensor(states, occ, z_obs, 1.0 / 30.0)
        return np.asarray(ll)

    ll_fixed = loglik(0.5)
    assert ll_fixed[0] > ll_fixed[1], (ll_fixed[0], ll_fixed[1])
    assert int(ll_fixed.argmax()) == 0
    ll_broken = loglik(0.0)
    assert ll_broken[0] < ll_broken[1], "coverage bug gone? revisit slack"


def test_fused_backend_tracking():
    """Closed-loop PF with backend='pallas' (interpret mode)."""
    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node, sources
    from dbot_ros_tpu.trackers.particle import ParticleTracker

    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup()
    config = cfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8, backend="pallas",
        backend_options=dict(interpret=True),
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 2.0, damping=4.0), seed=3)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    start = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)

    def traj(t):
        p = start.copy()
        p[0] += 0.05 * t / 30.0
        return p[None]

    src = sources.SyntheticSource(mesh, cam, traj, num_frames=8,
                                  noise_sigma=0.003, seed=5)
    result = node.run(tracker, src)
    assert result.position_rmse() < 0.02, result.position_rmse()


@pytest.mark.parametrize("pr", [1, 2, 3])
def test_scatter_pixel_rows_kernel(pr):
    """The XLA row merge: selected pixels' rows replaced, everything
    else untouched, in place under donation."""
    from dbot_ros_tpu.ops.raycast_pallas import scatter_pixel_rows

    n_pix = 10
    q = jnp.arange(n_pix * pr * 128, dtype=jnp.float32).reshape(
        n_pix * pr, 128)
    vals = -(1.0 + jnp.arange(4 * pr * 128,
                              dtype=jnp.float32)).reshape(4 * pr, 128)
    sel = jnp.array([7, 0, 3, 9], dtype=jnp.int32)
    exp = np.asarray(q).copy()
    for j, s in enumerate([7, 0, 3, 9]):
        exp[s * pr:(s + 1) * pr] = np.asarray(vals)[j * pr:(j + 1) * pr]
    out = np.asarray(jax.jit(
        lambda q, v, s: scatter_pixel_rows(q, v, s, pr),
        donate_argnums=(0,))(q, vals, sel))
    np.testing.assert_array_equal(out, exp)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_pixel_rows(dtype):
    """The XLA row gather: out row j = q row sel[j], duplicates allowed."""
    from dbot_ros_tpu.ops.raycast_pallas import gather_pixel_rows

    pr, n_pix = 2, 9
    q = jnp.arange(n_pix * pr * 128).reshape(n_pix * pr, 128).astype(dtype)
    sel = jnp.array([8, 2, 2, 0, 5], dtype=jnp.int32)
    out = np.asarray(jax.jit(lambda q, s: gather_pixel_rows(q, s, pr))(
        q, sel).astype(jnp.float32))
    qn = np.asarray(q.astype(jnp.float32))
    exp = np.concatenate([qn[s * pr:(s + 1) * pr] for s in [8, 2, 2, 0, 5]])
    np.testing.assert_array_equal(out, exp)


def test_merge_modes_equivalent():
    """merge="scatter" (in-place DMA) and merge="select" (full-map
    take+where) are alternative implementations of the same compacted
    merge — identical loglik and occlusion state."""
    from dbot_ros_tpu.ops.raycast_pallas import make_fused_sensor

    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    states = jnp.zeros((64, 1, 13), jnp.float32).at[:, 0, :7].set(poses)
    outs = {}
    for merge in ("scatter", "select"):
        sensor = make_fused_sensor(mesh, cam, bp, op, nb=32,
                                   interpret=True, merge=merge)
        occ = sensor.init_occlusion(64, 0.15)
        ll, occ1 = sensor(states, occ, z_obs, 1.0 / 30.0)
        ll2, occ2 = sensor(states, occ1, z_obs, 1.0 / 30.0)
        outs[merge] = (ll, ll2, occ2)
    np.testing.assert_allclose(np.asarray(outs["scatter"][0]),
                               np.asarray(outs["select"][0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(outs["scatter"][1]),
                               np.asarray(outs["select"][1]), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(outs["scatter"][2]),
                    jax.tree_util.tree_leaves(outs["select"][2])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-7)


@pytest.mark.parametrize("pattern", ["identity", "systematic", "degenerate",
                                     "scattered"])
def test_grouped_lane_gather_matches_take(pattern):
    """The grouped (row-gather + one-hot matmul) lineage gather must equal
    the plain lane take for every parent pattern — including the
    span-overflow fallback ('scattered')."""
    from dbot_ros_tpu.ops.raycast_pallas import (grouped_lane_gather,
                                                 _particle_pads)

    P, n_pad = 300, 6
    p_pad, pr = _particle_pads(P)
    key = jax.random.PRNGKey(3)
    q = jax.random.uniform(key, (n_pad * pr, 128))
    if pattern == "identity":
        idx = jnp.arange(p_pad, dtype=jnp.int32)
    elif pattern == "systematic":
        lw = 0.3 * jnp.sin(jnp.arange(float(P)))
        from dbot_ros_tpu.ops import resample as rs
        idx = rs.systematic_indices(jax.random.PRNGKey(1), lw, p_pad)
    elif pattern == "degenerate":
        idx = jnp.full((p_pad,), 137, jnp.int32)
    else:  # scattered: parents jump across groups within one block
        idx = (jnp.arange(p_pad, dtype=jnp.int32) * 113) % P
    out = jax.jit(lambda q: grouped_lane_gather(q, idx, n_pad, pr))(q)
    ref = jnp.take(q.reshape(n_pad, p_pad), idx, axis=1,
                   mode="clip").reshape(n_pad * pr, 128)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=0)


def test_gather_occlusion_grouped_matches_take_sensor():
    """FusedSensor lineage gather: grouped vs take on the lazy (q, age)
    leaf — bit-equal for systematic parents."""
    from dbot_ros_tpu.ops.raycast_pallas import make_fused_sensor

    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=96)
    outs = {}
    for lg in ("grouped", "take"):
        sensor = make_fused_sensor(mesh, cam, bp, op, nb=32,
                                   interpret=True, lineage_gather=lg)
        occ = sensor.init_occlusion(96, 0.2)
        states = jnp.zeros((96, 1, 13), jnp.float32).at[:, 0, :7].set(poses)
        _, occ1 = sensor(states, occ, z_obs, 1.0 / 30.0)
        lw = jnp.cos(jnp.arange(96.0)) * 2.0
        from dbot_ros_tpu.ops import resample as rs
        par = rs.systematic_indices(jax.random.PRNGKey(7), lw, 96)
        outs[lg] = sensor.gather_occlusion(occ1, par)
    for a, b in zip(jax.tree_util.tree_leaves(outs["grouped"]),
                    jax.tree_util.tree_leaves(outs["take"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)


def test_bf16_occlusion_storage_parity():
    """bf16 occlusion storage (the default; halves every occ-touching HBM
    pass) must match an f32-storage sensor to quantization noise: loglik
    within a small fraction of a nat, occlusion within one bf16 ulp of
    [0, 1], over a multi-frame chained run (quantization must not
    accumulate — the chain contracts toward the stationary point)."""
    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=64)
    kw = dict(interpret=True)
    s16 = make_fused_sensor(mesh, cam, bp, op, **kw)
    s32 = make_fused_sensor(mesh, cam, bp, op, occ_dtype=jnp.float32, **kw)
    assert s16.init_occlusion(64, 0.1)[0].dtype == jnp.bfloat16

    states = jnp.zeros((64, 1, 13)).at[:, 0, :7].set(poses[:64])
    o16 = s16.init_occlusion(64, 0.1)
    o32 = s32.init_occlusion(64, 0.1)
    for t in range(4):
        st = states.at[:, 0, 0].add(0.004 * t)
        ll16, o16 = s16(st, o16, z_obs, 1.0 / 30.0)
        ll32, o32 = s32(st, o32, z_obs, 1.0 / 30.0)
        np.testing.assert_allclose(np.asarray(ll16), np.asarray(ll32),
                                   rtol=0, atol=0.05)
        np.testing.assert_allclose(
            np.asarray(s16.occlusion_as_pn(o16, 64)),
            np.asarray(s32.occlusion_as_pn(o32, 64)), atol=5e-3)

    # lineage gather + checkpoint roundtrip preserve the bf16 dtype
    par = jnp.arange(64, dtype=jnp.int32)[::-1]
    g = s16.gather_occlusion(o16, par)
    assert s16._unpack_occ(g)[0].dtype == jnp.bfloat16


def test_multi_reference_candidates_match_on_unimodal_cloud():
    """reference_poses=4 must reproduce the single-reference sensor's
    likelihoods when the cloud is unimodal (all strided references land
    on the same pose ⇒ identical candidate sets)."""
    import jax

    from dbot_ros_tpu.models import beam, occlusion
    from dbot_ros_tpu.ops.raycast_pallas import make_fused_sensor
    from dbot_ros_tpu.utils import se3
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh
    from dbot_ros_tpu.ops.raycast import raycast_depth

    K = np.array([[24.0, 0, 8], [0, 24.0, 8], [0, 0, 1.0]])
    cam = make_camera(K, 16, 16)
    mesh = box_mesh(0.08, 0.06, 0.05)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                            se3.quat_identity()])
    d = raycast_depth(mesh, pose, cam.rays, 128)
    z = jnp.where(jnp.isfinite(d), d, jnp.nan)
    P = 32
    states = jnp.zeros((P, 1, 13), jnp.float32).at[:, 0, :7].set(pose)

    outs = []
    for R in (1, 4):
        s = make_fused_sensor(mesh, cam, bp, op, nb=16, interpret=True,
                              reference_poses=R)
        occ = s.init_occlusion(P, 0.1)
        ll, _ = s(states, occ, z, 1.0 / 30.0)
        outs.append(np.asarray(ll))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)


def test_island_trial_resolves_twin_pallas():
    """Flip-aware PF recovery (session-33 fix): with a ≥2-hypothesis
    init the tracker races separate ISLAND beliefs and commits once on
    the accumulated observation marginal — the round-4 score-weighted
    mixture lost the race structurally (the first KL resample
    annihilates a block whose beam arrived a few nats under-refined,
    and the fused sensor's mean-referenced candidate pass is a ghost
    pose for a bimodal cloud). The true basin must win even when the
    wrong twin is slot 0."""
    import jax

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node, sources
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils import se3
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import l_shape_mesh

    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    mesh = l_shape_mesh()
    true_pose = np.concatenate([[0.0, 0.0, 0.6], [1.0, 0, 0, 0]])
    flip = np.asarray(se3.quat_multiply(
        se3.so3_exp_quat(jnp.array([0.0, np.pi, 0.0])),
        jnp.asarray(true_pose[3:7], jnp.float32)))
    twin = np.concatenate([true_pose[:3] + [0.01, 0, 0.005], flip])

    conf = cfg.ParticleTrackerConfig(
        evaluation_count=256, max_kl_divergence=0.5,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(linear_acceleration_sigma=0.3,
                                        angular_acceleration_sigma=1.5,
                                        damping=4.0),
        backend="pallas", seed=7,
        backend_options=dict(nb=16, interpret=True,
                             num_candidates=4, radius=3))
    tracker = ParticleTracker(conf, meshes=[mesh], camera=cam)
    tracker.initialize(true_pose,
                       hypotheses=np.stack([twin, true_pose]),
                       hypothesis_logits=np.zeros(2, np.float32))
    assert tracker.trial_active == 2        # island race engaged

    src = sources.SyntheticSource(
        mesh, cam, lambda t: jnp.asarray(true_pose, jnp.float32)[None],
        num_frames=10, noise_sigma=0.002, seed=1)
    run = node.run(tracker, src)
    assert tracker.trial_active is None     # trial committed
    err = run.rotation_errors()[-1, 0]
    assert err < 0.5, f"twin not resolved: final rot err {err}"


# ---------------------------------------------------------------------------
# The Triton kernel (interpret mode) vs its plain formulation and the
# exact XLA path, and the wrapper around it
# ---------------------------------------------------------------------------

KERNEL_CASES = {
    # id: (K candidates, objects, lazy ages, storage, P, level)
    "k2-full-bf16": (2, 1, False, jnp.bfloat16, 96, "full"),
    "k1-full-f32": (1, 1, False, jnp.float32, 96, "full"),
    "k2-aged-bf16": (2, 1, True, jnp.bfloat16, 96, "full"),
    "k2-aged-f32-p300": (2, 1, True, jnp.float32, 300, "full"),
    "k2-two-objects-f32": (2, 2, False, jnp.float32, 64, "full"),
    "k2-compact-aged-bf16": (2, 1, True, jnp.bfloat16, 96, "compact"),
    "k3-compact-two-objects-f32": (3, 2, True, jnp.float32, 200, "compact"),
}


def _kernel_case(K, objects, aged, dtype, P, level, nb=16):
    """Inputs of one kernel call plus its exact-XLA-path expectation."""
    from dbot_ros_tpu.models.sensor import render_scene
    from dbot_ros_tpu.ops import raycast_pallas as rp

    cam = make_camera(np.array([[24.0, 0, 8], [0, 24.0, 8], [0, 0, 1.0]]),
                      16, 16)
    meshes = [l_shape_mesh(), box_mesh(0.05, 0.08, 0.04)][:objects]
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = occlusion.make_occlusion_params()
    refs = [jnp.array([-0.02, 0.0, 0.62, 1, 0, 0, 0], jnp.float32),
            jnp.array([0.03, 0.01, 0.55, 1, 0, 0, 0], jnp.float32)]
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    poses = jnp.stack([_perturb_poses(keys[k], refs[k], P)
                       for k in range(objects)], axis=1)   # (P, O, 7)
    states = jnp.zeros((P, objects, 13)).at[..., :7].set(poses)
    z = render_scene(meshes, jnp.stack(refs[:objects]), cam.rays)
    z_obs = jnp.where(jnp.isfinite(z), z, 2.0).at[::23].set(jnp.nan)
    sensor = make_fused_sensor(meshes, cam, bp, op, interpret=True, nb=nb,
                               num_candidates=K, bary_slack=0.0)
    cand = sensor.candidates(states)                       # (N, K)
    N = cam.num_pixels
    p_pad, pr = rp._particle_pads(P)
    gt = jnp.concatenate([rp.pack_constants(m, poses[:, k], p_pad)
                          for k, m in enumerate(meshes)])
    occ_pn = (0.6 * jax.random.uniform(keys[2], (P, N))).astype(dtype)
    q = rp.occ_to_kernel(occ_pn, nb=nb)
    ages = (jax.random.randint(keys[3], (N,), 0, 5).astype(jnp.float32)
            if aged else jnp.zeros((N,), jnp.float32))
    sel = np.arange(N)
    if level == "compact":
        deg = sensor.union_triangles - 1
        act = np.nonzero((np.asarray(cand) != deg).any(axis=1))[0]
        rest = np.setdiff1d(sel, act)
        sel = np.concatenate([act, rest])[:rp._round_up(len(act) + 5, nb)]
        uniq = np.unique(np.asarray(cand)[sel])
        uniq = np.concatenate([uniq, [deg] * 3])           # degenerate pad
        gt = jnp.take(gt, jnp.asarray(uniq), axis=0)
        cand_in = jnp.asarray(np.searchsorted(uniq, np.asarray(cand)[sel]),
                              jnp.int32)
        q = rp.gather_pixel_rows(q, jnp.asarray(sel, jnp.int32), pr)
    else:
        cand_in = cand
    args = (gt, q, z_obs[sel], cand_in, cam.rays[sel],
            rp.make_params_vec(bp, op, jnp.float32(1.0), 0.0))
    kw = dict(num_particles=P, nb=nb, ages=ages[sel] if aged else None)

    # exact XLA path: HIGHEST-precision intersection of the same
    # candidates, the lazily aged prior, then image_loglik
    Gs, tns = zip(*[raycast.pose_tri_constants(m, poses[:, k])
                    for k, m in enumerate(meshes)])
    Gc = jnp.take(jnp.concatenate(Gs, axis=1), cand[sel], axis=1)
    tc = jnp.take(jnp.concatenate(tns, axis=1), cand[sel], axis=1)
    nums = jnp.einsum("nd,pnkid->pnki", cam.rays[sel], Gc,
                      precision=jax.lax.Precision.HIGHEST)
    depth = jnp.min(raycast._intersect_from_numerators(
        nums[..., 0], nums[..., 1], nums[..., 2], tc), axis=-1)
    g = op.p_occluded_occluded - op.p_occluded_visible
    pi = op.p_occluded_visible / (1.0 - g)
    occ_f = occ_pn.astype(jnp.float32)[:, sel]
    occ_now = pi + jnp.power(g, ages[sel])[None] * (occ_f - pi)
    exact = image_loglik(depth, z_obs[sel], occ_now, bp, op, dt_frames=1.0)
    return args, kw, exact, len(sel)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_triton_kernel_matches_plain_and_exact(case):
    from dbot_ros_tpu.ops import raycast_pallas as rp

    K, objects, aged, dtype, P, level = KERNEL_CASES[case]
    args, kw, (ll_x, occ_x), n_in = _kernel_case(K, objects, aged, dtype, P,
                                                 level)
    ll, occ_k = rp.fused_loglik_packed(*args, interpret=True, **kw)
    ll_p, occ_p = rp.fused_loglik_reference(*args, **kw)
    assert ll.shape == (P,) and occ_k.shape == args[1].shape
    assert occ_k.dtype == dtype
    # same f32 math, another summation order
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_p),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(occ_k, np.float32),
                               np.asarray(occ_p, np.float32),
                               atol=4e-3 if dtype == jnp.bfloat16 else 1e-6)
    # exact path: erf normalizer ≈ 1, aged prior in one closed-form step
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_x),
                               rtol=2e-4, atol=0.05)
    occ_pn = rp.occ_from_kernel(occ_k.astype(jnp.float32), n_in, P, nb=16)
    np.testing.assert_allclose(
        np.asarray(occ_pn), np.asarray(occ_x),
        atol=4e-3 if dtype == jnp.bfloat16 else 2e-4)


def test_kernel_wrapper_partials_and_padding(monkeypatch):
    """Per-chunk partial sums reduce to the loglik; the pixel grid's
    padding rows (z = NaN, degenerate candidate) each add log
    p_invalid_background and keep their propagated prior."""
    from dbot_ros_tpu.ops import raycast_pallas as rp

    args, kw, _, n_in = _kernel_case(2, 1, True, jnp.float32, 96, "full")
    gt, q, z, cand, rays, pv = args
    N = z.shape[0] - 7                        # drop 7 px → 7 padding rows
    P, nb = kw["num_particles"], kw["nb"]
    p_pad, pr = rp._particle_pads(P)
    q = q[:rp._round_up(N, nb) * pr]
    sub = (gt, q, z[:N], cand[:N], rays[:N], pv)
    ages = kw["ages"][:N]
    ll, occ = rp.fused_loglik_packed(*sub, P, nb=nb, interpret=True,
                                     ages=ages)
    ll_p, occ_p = rp.fused_loglik_reference(*sub, P, nb=nb, ages=ages)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_p), rtol=1e-5)
    # padding rows: age 0, so the prior propagates by one frame
    op = occlusion.make_occlusion_params()
    g = op.p_occluded_occluded - op.p_occluded_visible
    pi = op.p_occluded_visible / (1.0 - g)
    tail = np.asarray(q).reshape(-1, p_pad)[N:]
    np.testing.assert_allclose(np.asarray(occ).reshape(-1, p_pad)[N:],
                               pi + g * (tail - pi), atol=1e-6)
    # the padding pixels' share: 7 · log p_invalid_background (nb=1
    # lays out the same N pixels with no padding row)
    ll_nopad, _ = rp.fused_loglik_reference(
        gt, q[:N * pr], z[:N], cand[:N], rays[:N], pv, P, nb=1, ages=ages)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    np.testing.assert_allclose(
        np.asarray(ll) - np.asarray(ll_nopad),
        7 * np.log(float(bp.p_invalid_background)), rtol=1e-4)
    # partial-sum rows: one per pixel chunk, summed by the wrapper
    monkeypatch.setattr(rp, "_PIX_BLOCK", 8)
    calls = []
    real = rp.pl.pallas_call

    def spy(kernel, **kwargs):
        calls.append(kwargs)
        return real(kernel, **kwargs)

    monkeypatch.setattr(rp.pl, "pallas_call", spy)
    ll8, _ = rp.fused_loglik_packed(*sub, P, nb=nb, interpret=True,
                                    ages=ages)
    n_pad = rp._round_up(N, nb)
    assert calls[0]["grid"] == (p_pad // rp._LANE_BLOCK, n_pad // 8)
    assert calls[0]["out_shape"][1].shape == (n_pad // 8, p_pad)
    assert calls[0]["backend"] == "triton"
    np.testing.assert_allclose(np.asarray(ll8), np.asarray(ll), rtol=1e-5)


def test_kernel_needs_gpu_or_explicit_interpret():
    """interpret=None never means 'interpret because there is no GPU'."""
    from dbot_ros_tpu.ops import raycast_pallas as rp

    cam, mesh, bp, op, ref, poses, z_obs, occ0 = setup(P=8)
    with pytest.raises(ValueError, match="interpret=True"):
        make_fused_sensor(mesh, cam, bp, op)
    with pytest.raises(ValueError, match="interpret=True"):
        rp.resolve_interpret(False)
    assert rp.resolve_interpret(True) is True
    args, kw, _, _ = _kernel_case(1, 1, False, jnp.float32, 8, "full")
    with pytest.raises(ValueError, match="compiles only for the GPU"):
        rp.fused_loglik_packed(*args, **kw)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain(gpu):
    """On the card: the compiled kernel vs its plain formulation."""
    from dbot_ros_tpu.ops import raycast_pallas as rp

    for case in ("k2-aged-bf16", "k3-compact-two-objects-f32"):
        K, objects, aged, dtype, P, level = KERNEL_CASES[case]
        args, kw, _, _ = _kernel_case(K, objects, aged, dtype, P, level)
        ll, occ = jax.jit(functools.partial(rp.fused_loglik_packed,
                                            **kw))(*args)
        ll_p, occ_p = rp.fused_loglik_reference(*args, **kw)
        np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_p),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(np.asarray(occ, np.float32),
                                   np.asarray(occ_p, np.float32),
                                   atol=4e-3)

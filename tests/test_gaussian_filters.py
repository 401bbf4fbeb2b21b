"""Gaussian filter stack tests (ref: fl/test gaussian_filter suites).

Includes the fl-style cross-filter consistency checks: sigma-point moment
recovery, UKF-vs-KF agreement on linear dynamics, robustness to outliers,
and the RGF closed-loop tracking test on synthetic depth.
"""

import jax
import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu.filters import kf, pf, rgf
from dbot_ros_tpu.models import beam, transition
from dbot_ros_tpu.ops import sigma_points as sp
from dbot_ros_tpu.ops.raycast import raycast_depth
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import make_camera
from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh


# ------------------------------------------------------------- sigma points

def test_sigma_points_recover_moments():
    key = jax.random.PRNGKey(0)
    mean = se3.state_identity().at[:3].set(jnp.array([0.1, -0.2, 0.5]))
    A = jax.random.normal(key, (12, 12)) * 0.05
    cov = A @ A.T + 0.01 * jnp.eye(12)
    states, deltas, wm, wc = sp.sigma_points(mean, cov)
    assert states.shape == (25, 13)
    m2, c2, _ = sp.reconstruct_moments(states, mean, wm, wc)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(mean), atol=1e-4)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(cov), atol=1e-3)


def test_sigma_point_weights_sum_to_one():
    wm, wc, _ = sp.unscented_weights(12, 1.0, 2.0, 1.0)
    np.testing.assert_allclose(float(jnp.sum(wm)), 1.0, atol=1e-6)


# ----------------------------------------------------------------- linear KF

def _lin_system():
    dt = 0.1
    A = jnp.array([[1.0, dt], [0.0, 1.0]])
    Q = 0.01 * jnp.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    H = jnp.array([[1.0, 0.0]])
    R = jnp.array([[0.04]])
    return A, Q, H, R


def test_kf_converges_on_constant_state():
    A, Q, H, R = _lin_system()
    A = jnp.eye(2)
    Q = 1e-6 * jnp.eye(2)
    b = kf.LinearBelief(mean=jnp.zeros(2), cov=jnp.eye(2))
    for i in range(50):
        b = kf.step(b, jnp.array([1.0]), A, Q, H, R)
    np.testing.assert_allclose(float(b.mean[0]), 1.0, atol=0.05)
    assert float(b.cov[0, 0]) < 0.01


def test_kf_tracks_ramp():
    A, Q, H, R = _lin_system()
    b = kf.LinearBelief(mean=jnp.zeros(2), cov=jnp.eye(2))
    key = jax.random.PRNGKey(0)
    for t in range(80):
        key, k = jax.random.split(key)
        y = jnp.array([0.1 * t * 0.1]) + 0.2 * jax.random.normal(k, (1,))
        b = kf.step(b, y, A, Q, H, R)
    np.testing.assert_allclose(float(b.mean[1]), 0.1, atol=0.05)


# ----------------------------------------------------------------- vanilla PF

def test_sir_pf_estimates_static_mean():
    key = jax.random.PRNGKey(3)
    particles = jax.random.normal(key, (512, 1)) * 2.0
    b = pf.init(jax.random.PRNGKey(4), particles)

    def propagate(k, x):
        return x + 0.02 * jax.random.normal(k, x.shape)

    def loglik(x, y):
        return -0.5 * ((x[:, 0] - y) / 0.3) ** 2

    for t in range(30):
        b = pf.step(b, jnp.float32(1.5), propagate, loglik)
    np.testing.assert_allclose(float(pf.mean(b)[0]), 1.5, atol=0.1)


# ------------------------------------------------------------------- RGF

def rgf_setup(hw=32):
    K = np.array([[48.0, 0, hw // 2], [0, 48.0, hw // 2], [0, 0, 1.0]])
    cam = make_camera(K, hw, hw)
    mesh = box_mesh(0.12, 0.10, 0.06)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0,
                               tail_weight=0.05)
    tp = transition.make_transition_params(0.3, 2.0, damping=4.0)

    def render_fn(poses):
        return raycast_depth(mesh, poses, cam.rays, tri_chunk=128)

    return cam, mesh, bp, tp, render_fn


def synth(mesh, cam, pose, key=None, sigma=0.003, background=2.0):
    """Synthetic frame with a background plane (real scenes have one; an
    all-NaN background would make lateral translation unobservable to any
    depth-only Gaussian filter, reference included)."""
    d = raycast_depth(mesh, pose, cam.rays, 128)
    z = jnp.where(jnp.isfinite(d), d, background)
    if key is not None:
        z = z + sigma * jax.random.normal(key, z.shape)
    return z


def test_rgf_predict_grows_uncertainty():
    cam, mesh, bp, tp, render_fn = rgf_setup()
    pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]), se3.quat_identity()])
    b = rgf.init_belief(jax.random.PRNGKey(0), pose,
                        num_pixels=cam.num_pixels)
    b2 = rgf.predict(b, 1.0 / 30.0, tp)
    assert float(jnp.trace(b2.cov)) > float(jnp.trace(b.cov)) * 0.99
    assert bool(jnp.all(jnp.isfinite(b2.mean)))


def test_rgf_update_recovers_depth_error():
    """3 cm depth error: interior pixels observe it directly; the iterated
    update must recover z within ~1 mm in two calls."""
    cam, mesh, bp, tp, render_fn = rgf_setup()
    true_pose = jnp.concatenate([jnp.array([0.01, -0.005, 0.6]),
                                 se3.quat_identity()])
    start = true_pose.at[0].add(0.02).at[2].add(-0.03)
    z = synth(mesh, cam, true_pose)
    b = rgf.init_belief(jax.random.PRNGKey(0), start, first_frame=z,
                        pos_sigma=0.02)
    err0 = float(jnp.linalg.norm(b.mean[:3] - true_pose[:3]))
    for i in range(2):
        b, info = rgf.update(b, z, render_fn, bp)
    assert abs(float(b.mean[2]) - 0.6) < 2e-3
    err1 = float(jnp.linalg.norm(b.mean[:3] - true_pose[:3]))
    assert err1 < err0, (err0, err1)


def test_rgf_closed_loop_static():
    """L-shaped object (fully observable) at a rotated pose: the filter
    must converge from a 2.5 cm init error. A symmetric box would slide
    along its y-translation↔pitch ambiguity here — depth-only Gaussian
    filters need identifiable geometry (same in the reference)."""
    cam, _, bp, tp, _ = rgf_setup()
    mesh = l_shape_mesh()

    def render_fn(poses):
        return raycast_depth(mesh, poses, cam.rays, tri_chunk=128)

    true_pose = jnp.concatenate([jnp.array([0.0, 0.01, 0.6]),
                                 se3.so3_exp_quat(jnp.array([0.0, 0.2, 0.1]))])
    b = rgf.init_belief(jax.random.PRNGKey(0),
                        true_pose.at[0].add(0.015).at[2].add(-0.02),
                        first_frame=synth(mesh, cam, true_pose),
                        pos_sigma=0.02)
    step = jax.jit(lambda bel, z: rgf.rgf_step(bel, z, render_fn, tp,
                                               1.0 / 30.0, bp))
    key = jax.random.PRNGKey(9)
    errs, rots = [], []
    for t in range(12):
        key, kz = jax.random.split(key)
        b, info = step(b, synth(mesh, cam, true_pose, kz))
        errs.append(float(jnp.linalg.norm(b.mean[:3] - true_pose[:3])))
        rots.append(float(jnp.linalg.norm(
            se3.quat_boxminus(b.mean[3:7], true_pose[3:7]))))
    assert np.mean(errs[-4:]) < 0.015, errs
    assert np.mean(rots[-4:]) < 0.1, rots


def test_rgf_closed_loop_moving():
    cam, mesh, bp, tp, render_fn = rgf_setup()
    start_pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                                  se3.quat_identity()])
    vel = jnp.array([0.05, 0.0, 0.02])
    b = rgf.init_belief(jax.random.PRNGKey(0), start_pose,
                        first_frame=synth(mesh, cam, start_pose),
                        pos_sigma=0.01)
    step = jax.jit(lambda bel, z: rgf.rgf_step(bel, z, render_fn, tp,
                                               1.0 / 30.0, bp))
    key = jax.random.PRNGKey(11)
    dt = 1.0 / 30.0
    errs = []
    for t in range(12):
        pose_t = start_pose.at[:3].add(vel * t * dt)
        key, kz = jax.random.split(key)
        b, info = step(b, synth(mesh, cam, pose_t, kz))
        errs.append(float(jnp.linalg.norm(b.mean[:3] - pose_t[:3])))
    assert np.mean(errs[6:]) < 0.015, errs


def test_rgf_robust_to_transient_occlusion():
    """Closed loop with an occluder at 0.45 m covering the top half of the
    image for 5 frames: the estimate must not be dragged more than ~2 cm
    during occlusion and must recover afterwards (the ICRA-2016 scenario)."""
    cam, mesh, bp, tp, render_fn = rgf_setup()
    true_pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                                 se3.quat_identity()])
    z0 = synth(mesh, cam, true_pose)
    b = rgf.init_belief(jax.random.PRNGKey(0), true_pose, first_frame=z0,
                        pos_sigma=0.01)
    step = jax.jit(lambda bel, z: rgf.rgf_step(bel, z, render_fn, tp,
                                               1.0 / 30.0, bp))
    key = jax.random.PRNGKey(21)
    n = cam.num_pixels
    errs, betas = [], []
    for t in range(15):
        key, kz = jax.random.split(key)
        z = synth(mesh, cam, true_pose, kz)
        if 4 <= t < 9:
            z = z.at[: n // 2].set(0.45)
        b, info = step(b, z)
        errs.append(float(jnp.linalg.norm(b.mean[:3] - true_pose[:3])))
        betas.append(float(info.mean_beta))
    assert max(errs[4:9]) < 0.025, errs       # bounded drag under occlusion
    assert np.mean(errs[-3:]) < 0.008, errs   # recovery
    assert min(betas[4:9]) < betas[0]         # outliers were detected


def test_rgf_all_invalid_frame_is_noop_ish():
    cam, mesh, bp, tp, render_fn = rgf_setup()
    pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]), se3.quat_identity()])
    b = rgf.init_belief(jax.random.PRNGKey(0), pose,
                        num_pixels=cam.num_pixels)
    z = jnp.full((cam.num_pixels,), jnp.nan)
    b2, info = rgf.update(b, z, render_fn, bp)
    np.testing.assert_allclose(np.asarray(b2.mean), np.asarray(b.mean),
                               atol=1e-5)
    # Invalid-return semantics (beam invalid masses): on a blackout frame
    # the object-predicted pixels are partly explained by
    # P(invalid | visible), so the inlier diagnostic stays above the
    # watchdog's beta floor (0.05) — a sensor failure must coast, not
    # trip a re-initialization.
    assert float(info.mean_beta) > 0.1


# -------------------------------------------------------- multi-object RGF

def test_rgf_scene_two_objects_closed_loop():
    """Joint 24-dim-tangent RGF over two objects: both poses must converge
    from centimeter init errors; the scene render min-combines objects."""
    cam, _, bp, tp, _ = rgf_setup()
    meshes = [l_shape_mesh(), box_mesh(0.06, 0.10, 0.05)]

    def render_fn(poses):  # (S, 2, 7) → (S, N)
        d = None
        for k, m in enumerate(meshes):
            dk = raycast_depth(m, poses[..., k, :], cam.rays, 128)
            d = dk if d is None else jnp.minimum(d, dk)
        return d

    true_poses = jnp.stack([
        jnp.concatenate([jnp.array([-0.06, 0.01, 0.6]),
                         se3.so3_exp_quat(jnp.array([0.0, 0.2, 0.1]))]),
        jnp.concatenate([jnp.array([0.07, -0.01, 0.68]),
                         se3.quat_identity()])])

    def synth2(key=None):
        d = None
        for k, m in enumerate(meshes):
            dk = raycast_depth(m, true_poses[k], cam.rays, 128)
            d = dk if d is None else jnp.minimum(d, dk)
        z = jnp.where(jnp.isfinite(d), d, 2.0)
        if key is not None:
            z = z + 0.003 * jax.random.normal(key, z.shape)
        return z

    start = true_poses.at[0, 0].add(0.015).at[1, 2].add(-0.02)
    b = rgf.init_belief(jax.random.PRNGKey(0), start,
                        first_frame=synth2(), pos_sigma=0.02)
    assert b.mean.shape == (2, 13)
    assert b.cov.shape == (24, 24)
    step = jax.jit(lambda bel, z: rgf.rgf_step(bel, z, render_fn, tp,
                                               1.0 / 30.0, bp))
    key = jax.random.PRNGKey(3)
    errs = []
    for t in range(12):
        key, kz = jax.random.split(key)
        b, info = step(b, synth2(kz))
        errs.append(np.linalg.norm(
            np.asarray(b.mean[:, :3] - true_poses[:, :3]), axis=-1))
    final = np.mean(np.stack(errs[-4:]), axis=0)
    assert final[0] < 0.015, (final, errs)
    assert final[1] < 0.015, (final, errs)
    assert info.mean_state.shape == (2, 13)


def test_rgf_occlusion_memory_tracks_occluder_pixels():
    """The D10-chain clutter prior (round 4): pixels showing a surface
    in FRONT of the object accumulate occlusion probability across
    frames; visible-surface pixels stay near the baseline; with
    occ_prior=None behavior is the memoryless filter."""
    import jax
    import jax.numpy as jnp

    from dbot_ros_tpu.filters import rgf
    from dbot_ros_tpu.models import beam as bm
    from dbot_ros_tpu.models import occlusion as om
    from dbot_ros_tpu.ops.raycast import raycast_depth
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh
    from dbot_ros_tpu.utils import se3

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    mesh = box_mesh(0.10, 0.08, 0.05)
    pose = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                            se3.quat_identity()])
    bp = bm.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    op = om.make_occlusion_params()

    def render_fn(poses):
        return raycast_depth(mesh, poses, cam.rays)

    d = raycast_depth(mesh, pose, cam.rays, 128)
    on_obj = np.isfinite(np.asarray(d))
    z = jnp.where(jnp.isfinite(d), d, 2.0)
    # an "occluder" covers the left half of the object's pixels at 0.45 m
    cols = np.arange(cam.num_pixels) % cam.width
    occluded_px = on_obj & (cols < 16)
    z_occ = jnp.where(jnp.asarray(occluded_px), 0.45, z)

    b = rgf.init_belief(jax.random.PRNGKey(0), pose,
                        num_pixels=cam.num_pixels, first_frame=z,
                        initial_occlusion_prob=0.1)
    assert b.occ_prior is not None
    for _ in range(4):
        b, info = rgf.update(b, z_occ, render_fn, bp, occ_params=op,
                             iterations=2)
    occ = np.asarray(b.occ_prior)
    assert occ[occluded_px].mean() > 0.8, occ[occluded_px].mean()
    visible_px = on_obj & (cols >= 18)
    assert occ[visible_px].mean() < 0.3, occ[visible_px].mean()

    # memoryless path: occ_prior stays None and the update runs
    b0 = rgf.init_belief(jax.random.PRNGKey(0), pose,
                         num_pixels=cam.num_pixels, first_frame=z)
    assert b0.occ_prior is None
    b0, _ = rgf.update(b0, z_occ, render_fn, bp, occ_params=op,
                       iterations=2)
    assert b0.occ_prior is None


# ------------------------------------------- deferred sigma-render backend

def test_sigma_renderer_matches_exact():
    """make_sigma_renderer (candidate matmul pass, the GF hot-path backend)
    must agree with the exact scan on a sigma-like pose batch: hits where
    both hit carry identical depths (slack=0 ⇒ candidate hits are a
    subset of exact hits), and candidate-coverage misses are rare at the
    production dilation."""
    from dbot_ros_tpu.ops.deferred import make_sigma_renderer

    cam, mesh, bp, tp, _ = rgf_setup()
    mean_pose = jnp.concatenate([jnp.array([0.0, 0.01, 0.6]),
                                 se3.so3_exp_quat(
                                     jnp.array([0.1, 0.2, 0.05]))])
    # sigma-like spread: mean first (the reference slot), then ±deltas
    key = jax.random.PRNGKey(3)
    dpos = 0.008 * jax.random.normal(key, (24, 3))
    drot = 0.04 * jax.random.normal(jax.random.fold_in(key, 1), (24, 3))
    poses = jnp.concatenate([
        mean_pose[None],
        jnp.concatenate([mean_pose[None, :3] + dpos,
                         se3.quat_boxplus(
                             jnp.broadcast_to(mean_pose[None, 3:7],
                                              (24, 4)), drot)], -1)])
    render = make_sigma_renderer([mesh], cam.rays, cam.height, cam.width,
                                 bary_slack=0.0)
    d_def = np.asarray(render(poses))
    d_ex = np.asarray(raycast_depth(mesh, poses, cam.rays, 128))
    both = np.isfinite(d_def) & np.isfinite(d_ex)
    # where both hit, depths agree except the rare pixel whose nearest
    # triangle fell outside the candidate set (deferred min is then over
    # a subset → depth can only be FARTHER, never nearer)
    diff = d_def[both] - d_ex[both]
    assert (np.abs(diff) > 1e-4).sum() <= 0.01 * both.sum()
    assert diff.min() > -1e-4
    # deferred never invents hits the exact path lacks (slack=0)
    assert not np.any(np.isfinite(d_def) & ~np.isfinite(d_ex))
    # coverage: candidate misses are silhouette-fringe only (edge-on
    # faces that cover no reference pixel center — the documented
    # slack=0 limitation; auto slack halves them)
    miss = np.isfinite(d_ex) & ~np.isfinite(d_def)
    assert miss.sum() < 0.10 * np.isfinite(d_ex).sum(), miss.sum()
    # the reference row (the mean pose itself) is covered exactly
    assert not np.any(np.isfinite(d_ex[0]) & ~np.isfinite(d_def[0]))


def test_sigma_renderer_scene_and_subset():
    """Scene form (S, K, 7) with a pixel subset: min-depth composition
    over objects and subset gathers must match the exact path."""
    from dbot_ros_tpu.ops.deferred import make_sigma_renderer

    cam, _, bp, tp, _ = rgf_setup()
    meshes = [l_shape_mesh(), box_mesh(0.06, 0.05, 0.04)]
    p0 = jnp.concatenate([jnp.array([-0.04, 0.0, 0.6]),
                          se3.quat_identity()])
    p1 = jnp.concatenate([jnp.array([0.05, 0.0, 0.65]),
                          se3.quat_identity()])
    key = jax.random.PRNGKey(7)
    d = 0.006 * jax.random.normal(key, (9, 2, 3))
    poses = jnp.stack([
        jnp.concatenate([jnp.stack([p0[:3], p1[:3]]) + d[s],
                         jnp.stack([p0[3:], p1[3:]])], -1)
        for s in range(9)])
    poses = poses.at[0, :, :3].set(jnp.stack([p0[:3], p1[:3]]))
    idx = jnp.arange(0, cam.num_pixels, 3)
    render = make_sigma_renderer(meshes, cam.rays, cam.height, cam.width,
                                 pixel_idx=idx, bary_slack=0.0)
    d_def = np.asarray(render(poses))
    assert d_def.shape == (9, idx.shape[0])
    d_ex = jnp.minimum(
        raycast_depth(meshes[0], poses[:, 0], cam.rays, 128),
        raycast_depth(meshes[1], poses[:, 1], cam.rays, 128))
    d_ex = np.asarray(d_ex[:, idx])
    both = np.isfinite(d_def) & np.isfinite(d_ex)
    diff = d_def[both] - d_ex[both]
    assert (np.abs(diff) > 1e-4).sum() <= 0.01 * both.sum()
    assert diff.min() > -1e-4
    miss = np.isfinite(d_ex) & ~np.isfinite(d_def)
    assert miss.sum() < 0.10 * np.isfinite(d_ex).sum()


# ------------------------------------------------- multi-scene batching

def test_rgf_batched_step_matches_individual():
    """make_batched_step (P7 for the GF): a vmapped 2-scene step must
    reproduce the per-scene steps (same math, scene axis is pure data
    parallelism)."""
    cam, mesh, bp, tp, render_fn = rgf_setup()
    p0 = jnp.concatenate([jnp.array([0.0, 0.01, 0.6]),
                          se3.quat_identity()])
    p1 = jnp.concatenate([jnp.array([0.02, -0.01, 0.65]),
                          se3.so3_exp_quat(jnp.array([0.1, 0.0, 0.0]))])
    key = jax.random.PRNGKey(5)
    z0 = synth(mesh, cam, p0, key)
    z1 = synth(mesh, cam, p1, jax.random.fold_in(key, 1))
    b0 = rgf.init_belief(jax.random.PRNGKey(0), p0, first_frame=z0)
    b1 = rgf.init_belief(jax.random.PRNGKey(1), p1, first_frame=z1)

    step1 = jax.jit(lambda b, z: rgf.rgf_step(b, z, render_fn, tp,
                                              1.0 / 30.0, bp))
    stepS = jax.jit(rgf.make_batched_step(render_fn, tp, 1.0 / 30.0, bp))

    bb = rgf.stack_beliefs([b0, b1])
    zz = jnp.stack([z0, z1])
    for _ in range(2):
        b0, i0 = step1(b0, z0)
        b1, i1 = step1(b1, z1)
        bb, ii = stepS(bb, zz)
    np.testing.assert_allclose(np.asarray(bb.mean[0]),
                               np.asarray(b0.mean), atol=1e-4)
    np.testing.assert_allclose(np.asarray(bb.mean[1]),
                               np.asarray(b1.mean), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ii.mean_state[0]),
                               np.asarray(i0.mean_state), atol=1e-4)
    assert bb.background.shape == (2, cam.num_pixels)

"""Automatic pose initialization (replaces R9 interactive markers)."""

import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu.runtime.initializer import (find_initial_pose,
                                              initialize_tracker,
                                              orientation_candidates,
                                              segment_centroid)
from dbot_ros_tpu.ops.raycast import raycast_depth
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import make_camera
from dbot_ros_tpu.utils.mesh import l_shape_mesh


def cam32():
    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    return make_camera(K, 32, 32)


def test_orientation_candidates_are_unit_quats():
    q = orientation_candidates(12, 4)
    assert q.shape == (48, 4)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(q), axis=1), 1.0,
                               atol=1e-5)


def test_segment_centroid():
    cam = cam32()
    mesh = l_shape_mesh()
    pose = jnp.concatenate([jnp.array([0.02, -0.01, 0.6]),
                            se3.quat_identity()])
    d = raycast_depth(mesh, pose, cam.rays, 128)
    z = jnp.where(jnp.isfinite(d), d, jnp.nan)
    c, n = segment_centroid(z, cam, 0.3, 1.5)
    assert int(n) > 20
    # centroid near the front surface of the object
    np.testing.assert_allclose(np.asarray(c[:2]), [0.02, -0.01], atol=0.02)
    assert 0.5 < float(c[2]) < 0.65


def test_find_initial_pose_recovers_translation_and_coarse_rotation():
    cam = cam32()
    mesh = l_shape_mesh()
    true_pose = jnp.concatenate([
        jnp.array([0.03, -0.02, 0.62]),
        se3.so3_exp_quat(jnp.array([0.0, 0.0, 0.4]))])
    d = raycast_depth(mesh, true_pose, cam.rays, 128)
    z = jnp.where(jnp.isfinite(d), d, jnp.nan)
    # lean refine budget (suite-time trim):
    # measured 14 s vs 40 s at perr 4 mm and a 35-nat score gap —
    # inside this test's 60-nat criterion with margin
    pose, score, n_fg = find_initial_pose(z, mesh, cam, n_axes=12,
                                          n_spins=8,
                                          refine_particles=128,
                                          refine_steps=3,
                                          polish_rounds=1)
    assert n_fg > 20
    perr = float(jnp.linalg.norm(pose[:3] - true_pose[:3]))
    assert perr < 0.05, perr
    # Global-search criterion: the found pose must explain the image at
    # least as well as the ground-truth pose (up to noise) — if a
    # different orientation scores equally, that is a genuine scene
    # ambiguity, not an optimizer failure. The e2e test below asserts the
    # converged tracking result.
    from dbot_ros_tpu.models import beam as bm
    from dbot_ros_tpu.models import occlusion as om
    from dbot_ros_tpu.models.image_loglik import image_loglik
    bp, op = bm.make_beam_params(), om.make_occlusion_params()
    dp = raycast_depth(mesh, true_pose[None], cam.rays)
    ll_true, _ = image_loglik(dp, z, jnp.full((1, cam.num_pixels), 0.1),
                              bp, op, 1.0)
    # Budget-limited single-frame global search: must land within ~6% of
    # the ground-truth pose's score (guards gross failures; the e2e test
    # asserts the tracking outcome).
    assert float(score) > float(ll_true[0]) - 60.0, (float(score),
                                                     float(ll_true[0]))


def test_initialize_tracker_then_track():
    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.trackers.particle import ParticleTracker

    cam = cam32()
    mesh = l_shape_mesh()
    config = cfg.ParticleTrackerConfig(
        evaluation_count=192, max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 3.0, damping=4.0), seed=1)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    true_pose = jnp.concatenate([jnp.array([0.01, 0.02, 0.58]),
                                 se3.so3_exp_quat(jnp.array([0.0, 0.0,
                                                             0.3]))])
    d = raycast_depth(mesh, true_pose, cam.rays, 128)
    z = np.asarray(jnp.where(jnp.isfinite(d), d, jnp.nan))

    pose0, score = initialize_tracker(tracker, z, n_axes=12, n_spins=8,
                                      refine_particles=128,
                                      refine_steps=3, polish_rounds=1)
    for _ in range(8):
        poses, info = tracker.track(z)

    # Auto-init may legitimately land on a near-symmetric twin of the L at
    # this coarse resolution (the flip scores within a few % of truth), so
    # the criterion is *render quality*: the converged pose must explain
    # the frame almost as well as the ground-truth pose does.
    from dbot_ros_tpu.models.image_loglik import image_loglik
    from dbot_ros_tpu.trackers import base

    zj = jnp.asarray(z).reshape(-1)
    occ1 = jnp.full((1, cam.num_pixels),
                    float(tracker.occ_params.initial_occlusion_prob))

    def pose_ll_center(pose_center):
        dp = raycast_depth(mesh, jnp.asarray(pose_center).reshape(1, 7),
                           cam.rays)
        ll, _ = image_loglik(dp, zj, occ1, tracker.beam_params,
                             tracker.occ_params, 1.0)
        return float(ll[0])

    est_center = base.to_center_frame(
        jnp.asarray(np.asarray(poses)[0]), mesh.center)
    ll_est = pose_ll_center(est_center)
    ll_true = pose_ll_center(true_pose)  # the frame was rendered from this
    assert ll_est > ll_true - 60.0, (ll_est, ll_true)


def test_multi_hypothesis_init_resolves_twin():
    """Seed the PF with the true pose AND a 180-degree twin at equal
    score (the initializer's near-symmetry failure mode); a few frames
    of tracking must collapse the mixture onto the true orientation."""
    import jax

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node, sources
    from dbot_ros_tpu.trackers.particle import ParticleTracker

    cam = cam32()
    mesh = l_shape_mesh()
    true_pose = np.concatenate([[0.0, 0.0, 0.6], [1.0, 0, 0, 0]])
    flip = np.asarray(se3.quat_multiply(
        se3.so3_exp_quat(jnp.array([0.0, np.pi, 0.0])),
        jnp.asarray(true_pose[3:7], jnp.float32)))
    twin = np.concatenate([true_pose[:3], flip])

    conf = cfg.ParticleTrackerConfig(
        evaluation_count=256, max_kl_divergence=0.5,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(linear_acceleration_sigma=0.3,
                                        angular_acceleration_sigma=1.5,
                                        damping=4.0),
        seed=7)
    tracker = ParticleTracker(conf, meshes=[mesh], camera=cam)
    # the WRONG twin first (slot 0 = the published prior choice): the
    # island race must still commit to the true basin on accumulated
    # marginal (round 5: islands replaced the score-weighted mixture,
    # whose first KL resample annihilated under-refined blocks)
    tracker.initialize(true_pose,
                       hypotheses=np.stack([twin, true_pose]),
                       hypothesis_logits=np.zeros(2, np.float32))
    assert tracker.trial_active == 2

    src = sources.SyntheticSource(
        mesh, cam, lambda t: jnp.asarray(true_pose, jnp.float32)[None],
        num_frames=10, noise_sigma=0.002, seed=1)
    run = node.run(tracker, src)
    err = run.rotation_errors()[-1, 0]
    assert err < 0.5, f"twin not resolved: final rot err {err}"


def test_hypothesis_allocation_tempering():
    """A runner-up hypothesis 12 nats behind must still receive particles
    after the margin/ln(P) tempering initialize_tracker applies (raw
    image-loglik nats would collapse the softmax: e^-12 of 512 = 0)."""
    import jax

    from dbot_ros_tpu.filters import rbcpf

    P, margin = 512, 30.0
    beam_ll = np.array([0.0, -12.0], np.float32)
    temp = margin / np.log(P)
    logits = (beam_ll - beam_ll.max()) / temp
    poses = np.stack([
        np.concatenate([[0.0, 0, 0.6], [1, 0, 0, 0]]),
        np.concatenate([[0.1, 0, 0.6], [1, 0, 0, 0]])]).astype(np.float32)
    b = rbcpf.init_belief(jax.random.PRNGKey(0), poses, P, 16,
                          hypothesis_logits=logits)
    n_runner = int(np.sum(np.asarray(b.states[:, 0, 0]) > 0.05))
    assert 10 < n_runner < P // 2, n_runner
    # untempered raw nats: the runner-up would get nothing
    b2 = rbcpf.init_belief(jax.random.PRNGKey(0), poses, P, 16,
                           hypothesis_logits=beam_ll)
    assert int(np.sum(np.asarray(b2.states[:, 0, 0]) > 0.05)) == 0


def test_find_initial_poses_two_objects():
    """K=2 joint auto-init (R9/R11 multi-object): greedy (mesh, cluster)
    assignment with explaining-away must place BOTH objects, matched to
    the right mesh."""
    from dbot_ros_tpu.runtime.initializer import find_initial_poses
    from dbot_ros_tpu.utils.mesh import box_mesh

    cam = cam32()
    m_l = l_shape_mesh()
    m_box = box_mesh(0.05, 0.07, 0.03)
    pose_l = jnp.concatenate([jnp.array([-0.07, 0.0, 0.62]),
                              se3.quat_identity()])
    pose_box = jnp.concatenate([jnp.array([0.08, 0.02, 0.55]),
                                se3.quat_identity()])
    d = jnp.minimum(raycast_depth(m_l, pose_l, cam.rays, 128),
                    raycast_depth(m_box, pose_box, cam.rays, 128))
    z = jnp.where(jnp.isfinite(d), d, jnp.nan)

    # lean budget: measured 2.3× faster at equal accuracy (5 mm both
    # objects) — the suite-time trim
    poses, scores = find_initial_poses(
        z, [m_l, m_box], cam, n_axes=6, n_spins=4,
        refine_particles=96, refine_steps=2, polish_rounds=0)
    assert poses.shape == (2, 7)
    err_l = float(jnp.linalg.norm(poses[0, :3] - pose_l[:3]))
    err_box = float(jnp.linalg.norm(poses[1, :3] - pose_box[:3]))
    assert err_l < 0.05, (err_l, np.asarray(poses))
    assert err_box < 0.05, (err_box, np.asarray(poses))


def test_cluster_masks_partition_three_objects():
    """K=3 foreground clustering: pure per-object pixel partitions."""
    from dbot_ros_tpu.runtime.initializer import _cluster_masks
    from dbot_ros_tpu.utils.mesh import box_mesh

    cam = cam32()
    ms = [box_mesh(0.05, 0.05, 0.04)] * 3
    xs = (-0.12, 0.0, 0.12)
    d = None
    per = []
    for m, x in zip(ms, xs):
        pose = jnp.concatenate([jnp.array([x, 0.0, 0.6]),
                                se3.quat_identity()])
        di = raycast_depth(m, pose, cam.rays, 128)
        per.append(np.isfinite(np.asarray(di)))
        d = di if d is None else jnp.minimum(d, di)
    z = jnp.where(jnp.isfinite(d), d, jnp.nan)
    masks = _cluster_masks(z, cam, 3, 0.3, 1.5)
    # every cluster is dominated by exactly one object
    owners = set()
    for m in masks:
        m = np.asarray(m)
        overlaps = [np.logical_and(m, p).sum() for p in per]
        k = int(np.argmax(overlaps))
        assert overlaps[k] > 0.9 * m.sum(), overlaps
        owners.add(k)
    assert owners == {0, 1, 2}


def test_scale_camera_roundtrip():
    from dbot_ros_tpu.runtime.sources import scale_camera
    from dbot_ros_tpu.utils.camera import make_camera

    K = np.array([[44.0, 0, 14], [0, 44.0, 12], [0, 0, 1.0]])
    cam = make_camera(K, 24, 28)
    cam4 = scale_camera(cam, 4)
    assert (cam4.height, cam4.width) == (96, 112)
    # strided picking of the native rays lands back on the coarse grid:
    # ray (0,0) is identical; focal scales with resolution
    np.testing.assert_allclose(np.asarray(cam4.camera_matrix)[:2, :2],
                               4 * np.asarray(cam.camera_matrix)[:2, :2],
                               rtol=1e-6)
    r4 = np.asarray(cam4.rays).reshape(96, 112, 3)
    r1 = np.asarray(cam.rays).reshape(24, 28, 3)
    np.testing.assert_allclose(r4[::4, ::4], r1, atol=1e-5)

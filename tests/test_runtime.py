"""Tracker facades + runtime streaming loop (ref R1-R7, D18-D21).

The closed-loop synthetic runs here are the framework's replacement for the
reference's *_tracker_simulation_node manual validation (SURVEY.md §3.3/§4)
— but with hard RMSE assertions instead of RViz eyeballing.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dbot_ros_tpu import config as cfg
from dbot_ros_tpu.runtime import checkpoint, node, publisher, sources
from dbot_ros_tpu.trackers import base
from dbot_ros_tpu.trackers.gaussian import GaussianTracker
from dbot_ros_tpu.trackers.particle import ParticleTracker
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import make_camera
from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh


def small_camera(hw=32, f=48.0):
    K = np.array([[f, 0, hw // 2], [0, f, hw // 2], [0, 0, 1.0]])
    return make_camera(K, hw, hw)


def small_particle_config(n=200):
    return cfg.ParticleTrackerConfig(
        evaluation_count=n,
        max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(linear_acceleration_sigma=0.4,
                                        angular_acceleration_sigma=2.0,
                                        damping=4.0),
        seed=3)


def linear_trajectory(start_pose, vel, dt=1.0 / 30.0):
    start_pose = np.asarray(start_pose, np.float32)
    vel = np.asarray(vel, np.float32)

    def fn(t):
        p = start_pose.copy()
        p[:3] = p[:3] + vel * (t * dt)
        return p[None]

    return fn


# ----------------------------------------------------------- frame algebra

def test_center_model_frame_roundtrip():
    center = jnp.array([0.01, -0.02, 0.03])
    pose = jnp.concatenate([jnp.array([0.1, 0.2, 0.7]),
                            se3.so3_exp_quat(jnp.array([0.2, -0.1, 0.3]))])
    pc = base.to_center_frame(pose, center)
    pm = base.to_model_frame(pc, center)
    np.testing.assert_allclose(np.asarray(pm), np.asarray(pose), atol=1e-6)
    # Both frames map their respective mesh points identically:
    x_model = jnp.array([0.05, 0.0, 0.01])
    np.testing.assert_allclose(
        np.asarray(se3.pose_apply(pose, x_model)),
        np.asarray(se3.pose_apply(pc, x_model - center)), atol=1e-6)


def test_moving_average_pose():
    p1 = jnp.concatenate([jnp.zeros(3), se3.quat_identity()])
    p2 = jnp.concatenate([jnp.array([1.0, 0.0, 0.0]), se3.quat_identity()])
    half = base.moving_average_pose(p1, p2, 0.5)
    np.testing.assert_allclose(half[0], 0.5, atol=1e-6)
    full = base.moving_average_pose(p1, p2, 1.0)
    np.testing.assert_allclose(np.asarray(full), np.asarray(p2), atol=1e-6)


# ----------------------------------------------------------------- config

def test_config_from_dict_and_unknown_key():
    c = cfg.particle_config_from_dict({
        "evaluation_count": 500,
        "observation": {"tail_weight": 0.05},
        "transition": {"damping": 2.0},
    })
    assert c.evaluation_count == 500
    assert c.observation.tail_weight == 0.05
    assert c.transition.damping == 2.0
    assert c.observation.model_sigma == 0.003  # default preserved
    with pytest.raises(ValueError):
        cfg.particle_config_from_dict({"not_a_param": 1})


def test_config_json_load(tmp_path):
    p = tmp_path / "tracker.json"
    p.write_text('{"tracker": "particle", "evaluation_count": 64}')
    c = cfg.load_config(str(p))
    assert isinstance(c, cfg.ParticleTrackerConfig)
    assert c.evaluation_count == 64


# ------------------------------------------------- particle tracker e2e

def test_particle_tracker_closed_loop():
    cam = small_camera()
    mesh = box_mesh(0.08, 0.06, 0.05)
    config = small_particle_config(200)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)

    start = np.concatenate([[0.0, 0.0, 0.6], [1, 0, 0, 0]]).astype(
        np.float32)
    src = sources.SyntheticSource(
        mesh, cam, linear_trajectory(start, [0.06, 0.0, 0.02]),
        num_frames=12, noise_sigma=0.003, seed=5)
    result = node.run(tracker, src)
    assert result.poses.shape == (12, 1, 7)
    assert result.ground_truth is not None
    errs = result.position_errors()[:, 0]
    assert np.mean(errs[4:]) < 0.02, errs
    assert result.position_rmse() < 0.03
    assert result.metrics.mean_latency() > 0


def test_particle_tracker_obj_config_build(tmp_path):
    """Builder path: config names an .obj on disk (ref builder flow)."""
    obj = tmp_path / "box.obj"
    v = [(-0.04, -0.03, -0.025), (0.04, -0.03, -0.025),
         (0.04, 0.03, -0.025), (-0.04, 0.03, -0.025),
         (-0.04, -0.03, 0.025), (0.04, -0.03, 0.025),
         (0.04, 0.03, 0.025), (-0.04, 0.03, 0.025)]
    lines = [f"v {x} {y} {z}" for x, y, z in v]
    lines += ["f 1 4 3 2", "f 5 6 7 8", "f 1 2 6 5", "f 3 4 8 7",
              "f 2 3 7 6", "f 1 5 8 4"]
    obj.write_text("\n".join(lines))
    config = small_particle_config(32)
    config.object = cfg.ObjectConfig(meshes=[str(obj)])
    config.camera = cfg.CameraConfig(
        camera_matrix=[48.0, 0, 16, 0, 48.0, 16, 0, 0, 1],
        resolution=(32, 32), downsampling_factor=1)
    tracker = ParticleTracker(config)
    assert tracker.meshes[0].num_triangles == 12
    tracker.initialize(np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32))
    z = np.full((32, 32), 2.0, np.float32)
    poses, info = tracker.track(z)
    assert poses.shape == (1, 7)


def test_particle_tracker_smoothing():
    cam = small_camera()
    mesh = box_mesh(0.08, 0.06, 0.05)
    config = small_particle_config(64)
    config.moving_average_update_rate = 0.3
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    pose0 = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)
    tracker.initialize(pose0)
    src = sources.SyntheticSource(mesh, cam,
                                  linear_trajectory(pose0, [0, 0, 0]),
                                  num_frames=3, noise_sigma=0.005, seed=1)
    for frame in src:
        poses, _ = tracker.track(frame.depth)
    assert np.linalg.norm(np.asarray(poses)[0, :3] - pose0[:3]) < 0.01


# ------------------------------------------------- gaussian tracker e2e

def test_gaussian_tracker_closed_loop():
    cam = small_camera()
    mesh = l_shape_mesh()
    config = cfg.GaussianTrackerConfig(
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0,
                                          tail_weight=0.05),
        transition=cfg.TransitionConfig(linear_acceleration_sigma=0.3,
                                        angular_acceleration_sigma=2.0,
                                        damping=4.0))
    tracker = GaussianTracker(config, mesh=mesh, camera=cam)
    start = np.concatenate([[0.0, 0.0, 0.6], [1, 0, 0, 0]]).astype(
        np.float32)
    src = sources.SyntheticSource(
        mesh, cam, linear_trajectory(start, [0.05, 0.0, 0.02]),
        num_frames=12, noise_sigma=0.003, seed=6)
    result = node.run(tracker, src)
    errs = result.position_errors()[:, 0]
    assert np.mean(errs[6:]) < 0.015, errs


def test_gaussian_tracker_two_objects_and_stride():
    """Multi-object Gaussian tracker (joint RGF) with sparse-pixel
    subsampling (pixel_stride=2, the ICRA sparse-sensor trick)."""
    cam = small_camera()
    meshes = [l_shape_mesh(), box_mesh(0.06, 0.10, 0.05)]
    config = cfg.GaussianTrackerConfig(
        pixel_stride=2,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0,
                                          tail_weight=0.05),
        transition=cfg.TransitionConfig(linear_acceleration_sigma=0.3,
                                        angular_acceleration_sigma=2.0,
                                        damping=4.0))
    tracker = GaussianTracker(config, meshes=meshes, camera=cam)
    starts = np.array([[-0.06, 0.01, 0.6, 1, 0, 0, 0],
                       [0.07, -0.01, 0.68, 1, 0, 0, 0]], np.float32)

    def traj(t):
        p = starts.copy()
        p[0, 0] += 0.04 * t / 30.0
        p[1, 2] += 0.03 * t / 30.0
        return p

    src = sources.SyntheticSource(meshes, cam, traj, num_frames=12,
                                  noise_sigma=0.003, seed=6)
    result = node.run(tracker, src)
    errs = result.position_errors()  # (T, K)
    assert np.mean(errs[6:, 0]) < 0.015, errs
    assert np.mean(errs[6:, 1]) < 0.015, errs
    # sparse sensor subset really is smaller
    assert tracker.belief.background.shape[0] == cam.num_pixels // 2


# --------------------------------------------------- replay + recording

def test_replay_source_roundtrip(tmp_path):
    path = str(tmp_path / "seq.npz")
    depth = np.random.rand(5, 8, 8).astype(np.float32) + 0.5
    poses = np.tile(np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32),
                    (5, 1, 1))
    sources.record_npz(path, depth, poses)
    src = sources.ReplaySource(path)
    frames = list(src)
    assert len(frames) == 5
    np.testing.assert_allclose(frames[2].depth, depth[2])
    np.testing.assert_allclose(frames[2].ground_truth, poses[2])


def test_synthetic_records_then_replays(tmp_path):
    cam = small_camera(16)
    mesh = box_mesh(0.08, 0.06, 0.05)
    start = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)
    src = sources.SyntheticSource(mesh, cam,
                                  linear_trajectory(start, [0.05, 0, 0]),
                                  num_frames=4, seed=2)
    frames = list(src)
    path = str(tmp_path / "rec.npz")
    sources.record_npz(path, np.stack([f.depth for f in frames]),
                       np.stack([f.ground_truth for f in frames]))
    replay = list(sources.ReplaySource(path))
    assert len(replay) == 4
    np.testing.assert_allclose(replay[3].depth, frames[3].depth, atol=1e-6)


# --------------------------------------------- checkpoint + publisher

def test_checkpoint_roundtrip_particle(tmp_path):
    import jax
    from dbot_ros_tpu.filters import rbcpf
    b = rbcpf.init_belief(jax.random.PRNGKey(7),
                          jnp.array([0, 0, 0.6, 1, 0, 0, 0.]), 16, 64)
    path = str(tmp_path / "belief.npz")
    checkpoint.save_belief(path, b)
    b2 = checkpoint.load_belief(path)
    assert isinstance(b2, rbcpf.ParticleBelief)
    np.testing.assert_allclose(np.asarray(b2.states), np.asarray(b.states))
    np.testing.assert_allclose(np.asarray(b2.occlusion),
                               np.asarray(b.occlusion))
    np.testing.assert_array_equal(np.asarray(b2.key), np.asarray(b.key))


def test_publisher_records_states(tmp_path):
    cam = small_camera(16)
    mesh = box_mesh(0.08, 0.06, 0.05)
    config = small_particle_config(32)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    start = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)
    src = sources.SyntheticSource(mesh, cam,
                                  linear_trajectory(start, [0, 0, 0]),
                                  num_frames=3, seed=1)
    out = str(tmp_path / "states.jsonl")
    pub = publisher.ObjectStatePublisher(["box"], ["box.obj"], path=out)
    node.run(tracker, src, on_frame=pub)
    pub.close()
    assert len(pub.states) == 3
    lines = open(out).read().strip().splitlines()
    assert len(lines) == 3
    import json
    rec = json.loads(lines[0])
    assert rec["name"] == "box"
    assert len(rec["orientation"]) == 4


def test_metrics_jsonl(tmp_path):
    from dbot_ros_tpu.runtime.metrics import FrameMetrics, MetricsLog
    log = MetricsLog()
    log.append(FrameMetrics(frame=0, latency_s=0.1, ess=10.0))
    log.append(FrameMetrics(frame=1, latency_s=0.2, resampled=True))
    path = str(tmp_path / "m.jsonl")
    log.to_jsonl(path)
    assert len(open(path).readlines()) == 2
    assert log.resample_count() == 1
    assert abs(log.mean_latency() - 0.15) < 1e-9


def test_threaded_source_drop_oldest_external_push():
    """External-push mode: a fast producer fills the ring; the consumer
    must get the FRESHEST frame with an accurate skipped count."""
    from dbot_ros_tpu.runtime.sources import ThreadedSource

    src = ThreadedSource(frame_shape=(4, 4), capacity=4)
    for i in range(10):
        src.push(np.full((4, 4), float(i), np.float32),
                 ground_truth=np.array([[0, 0, 0.5 + i, 1, 0, 0, 0]],
                                       np.float32))
    src.close()
    frames = list(src)
    # ring capacity 4 → at most 4 frames survive; the LAST pushed frame
    # must be among them and must be the final one yielded
    assert frames, "no frames popped"
    assert float(frames[-1].depth[0, 0]) == 9.0
    assert frames[0].skipped >= 6          # push-overwritten drops counted
    assert sum(f.skipped for f in frames) + len(frames) == 10
    # ground truth follows the surviving frame
    assert frames[-1].ground_truth[0, 2] == 0.5 + 9


def test_threaded_source_closed_loop_producer_outruns_tracker():
    """producer thread replays frames flat-out while
    the (slower) tracker consumes through node.run — the tracker must
    drop stale frames, stay on the freshest, and still track."""
    import jax.numpy as jnp

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.sources import SyntheticSource, ThreadedSource
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh
    from dbot_ros_tpu.utils import se3

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    mesh = box_mesh(0.08, 0.06, 0.05)
    config = cfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=0)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    start = jnp.concatenate([jnp.array([0.0, 0.0, 0.6]),
                             se3.quat_identity()])
    n_frames = 60

    def traj(t):
        return (start.at[0].add(0.0008 * t))[None]

    inner = SyntheticSource([mesh], cam, traj, num_frames=n_frames,
                            noise_sigma=0.002, seed=3)
    # warm the jit first (a live camera doesn't wait for compilation),
    # then stream with the producer outrunning the tracker
    warm = next(iter(SyntheticSource([mesh], cam, traj, num_frames=1,
                                     noise_sigma=0.002, seed=3)))
    tracker.initialize(warm.ground_truth)
    tracker.track(warm.depth)
    tracker.initialize(warm.ground_truth)
    src = ThreadedSource(inner, capacity=4, rate_hz=300.0)
    run = node.run(tracker, src)
    assert run.poses.shape[0] < n_frames, "tracker never dropped a frame"
    assert src.skipped_total > 0
    assert run.poses.shape[0] + src.skipped_total == n_frames
    # skipped counts surfaced in the metrics stream
    assert any((m.skipped or 0) > 0 for m in run.metrics.records)
    # stayed on the freshest frames: final estimate matches the final gt
    err = np.linalg.norm(run.poses[-1, 0, :3]
                         - np.asarray(traj(n_frames - 1))[0, :3])
    assert err < 0.02, err


def test_u16_camera_pipeline_tracks():
    """an eval leg through the NATIVE u16 camera
    pipeline — oracle render at native resolution with edge artifacts +
    mm quantization, u16 wire format, preprocess_depth_u16 strided
    downsample — must still track."""
    import jax.numpy as jnp

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.sources import (OracleSource,
                                              U16CameraAdapter,
                                              scale_camera)
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import l_shape_mesh
    from dbot_ros_tpu.utils import se3

    K = np.array([[44.0, 0, 14], [0, 44.0, 12], [0, 0, 1.0]])
    cam = make_camera(K, 24, 28)
    mesh = l_shape_mesh()
    start = jnp.concatenate([jnp.array([0.0, 0.0, 0.55]),
                             se3.quat_identity()])

    def traj(t):
        return (start.at[0].add(0.0015 * t))[None]

    native_cam = scale_camera(cam, 4)           # 96x112 sensor grid
    assert (native_cam.height, native_cam.width) == (96, 112)
    inner = OracleSource(mesh, native_cam, traj, num_frames=15,
                         noise_sigma=0.002, seed=2,
                         edge_artifacts=0.3, quantize_mm=True)
    src = U16CameraAdapter(inner, downsampling=4)

    first = next(iter(src))
    assert first.depth.shape == (24, 28)
    valid = first.depth[np.isfinite(first.depth)]
    assert valid.size > 100      # the frame is substantially valid
    # mm quantization survives the pipeline: values are whole millimeters
    assert np.allclose(valid * 1000, np.round(valid * 1000), atol=1e-3)

    config = cfg.ParticleTrackerConfig(
        evaluation_count=192, max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=0)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)
    run = node.run(tracker, src)
    assert run.position_rmse() < 0.012, run.position_rmse()


def test_describe_trackers():
    """fl::Descriptor analog (F10): assembled composition pretty-print."""
    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.trackers.base import describe
    from dbot_ros_tpu.trackers.gaussian import GaussianTracker
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    meshes = [l_shape_mesh(), box_mesh(0.05, 0.07, 0.03)]
    pt = ParticleTracker(cfg.ParticleTrackerConfig(
        evaluation_count=128, backend="xla"), meshes=meshes, camera=cam)
    d = describe(pt)
    assert "ParticleTracker" in d and "128 particles" in d
    assert "objects[2]" in d and "occlusion chain" in d
    assert "32x32" in d and "damped Wiener" in d
    gt = GaussianTracker(cfg.GaussianTrackerConfig(), meshes=[meshes[0]],
                         camera=cam)
    d2 = describe(gt)
    assert "GaussianTracker" in d2 and "trust_sigma" in d2


# ------------------------------------------------- variable-dt wiring

def test_node_threads_real_dt_on_dropped_frames():
    """node.run must pass dt = (1 + skipped)/frame_rate into track()
    when a push source reports dropped frames (ref D7 dt-aware
    transitions + R5 timestamp tracking)."""
    cam = small_camera()
    mesh = box_mesh(0.08, 0.06, 0.05)
    tracker = ParticleTracker(small_particle_config(32), meshes=[mesh],
                              camera=cam)
    start = np.concatenate([[0.0, 0.0, 0.6], [1, 0, 0, 0]]).astype(
        np.float32)
    inner = sources.SyntheticSource(
        mesh, cam, linear_trajectory(start, [0.0, 0.0, 0.0]),
        num_frames=4, noise_sigma=0.003, seed=5)
    frames = list(inner)
    frames[2].skipped = 3                   # 3 frames dropped before #2

    seen = []
    orig = tracker.track
    tracker.track = lambda d, dt=None: (seen.append(dt), orig(d, dt=dt))[1]
    run = node.run(tracker, frames)
    assert len(seen) == 4
    assert seen[0] is None and seen[1] is None and seen[3] is None
    np.testing.assert_allclose(seen[2], 4.0 / 30.0, rtol=1e-6)
    # metrics carry the skip count for attribution
    assert run.metrics.records[2].skipped == 3


def test_dt_scaling_beats_pinned_dt_on_blackout_stream():
    """Drop-heavy closed loop (the ThreadedSource drop-oldest regime):
    a 15-frame blackout during sustained motion.
    With the real interval threaded into track(), prediction
    extrapolates the motion across the gap AND the transition noise
    inflates to cover it — both filters re-lock immediately. The
    pinned-dt control extrapolates one nominal frame and keeps an
    overconfident belief, so it resumes several pixels off with a
    too-tight cloud/probe and pays a multi-frame catch-up (ref D7:
    the reference's transitions are dt-aware per frame for exactly
    this reason).

    Scenario notes (measured while designing this test): REGULAR
    short gaps are absorbed by either wiring — the filter's velocity
    estimate simply rescales under pinned dt, so RMSE ties; and a
    direction REVERSAL hidden inside a blackout is adversarial to any
    extrapolation (dt-aware overshoots it). Sustained motion through
    a long gap is where honest dt wins outright. The GF additionally
    needs its linearization-probe cap here (filters/rgf.py
    lin_cap_*): before it, the dt-inflated P widened the sigma probe
    past the object and the update diverged."""
    cam = small_camera()
    mesh = l_shape_mesh()

    def build_pf():
        return ParticleTracker(small_particle_config(200),
                               meshes=[mesh], camera=cam)

    def build_gf():
        config = cfg.GaussianTrackerConfig(
            observation=cfg.ObservationConfig(model_sigma=0.005,
                                              sigma_factor=0.0,
                                              tail_weight=0.05),
            transition=cfg.TransitionConfig(linear_acceleration_sigma=0.4,
                                            angular_acceleration_sigma=2.0,
                                            damping=4.0))
        return GaussianTracker(config, mesh=mesh, camera=cam)

    start = np.concatenate([[-0.02, 0.0, 0.6], [1, 0, 0, 0]]).astype(
        np.float32)
    src = sources.SyntheticSource(
        mesh, cam, linear_trajectory(start, [0.12, 0.0, 0.0]),
        num_frames=48, noise_sigma=0.003, seed=7)
    all_frames = list(src)
    keep_idx = list(range(0, 15)) + list(range(30, 48))
    kept = [all_frames[i] for i in keep_idx]
    gaps = [1] + [keep_idx[i + 1] - keep_idx[i]
                  for i in range(len(keep_idx) - 1)]

    for name, build, factor in (("pf", build_pf, 0.55),
                                ("gf", build_gf, 0.55)):
        for fr, g in zip(kept, gaps):
            fr.skipped = g - 1
        run_aware = node.run(build(), kept)
        for fr in kept:
            fr.skipped = 0
        run_pinned = node.run(build(), kept)
        e_aware = run_aware.position_errors()[16:, 0]
        e_pinned = run_pinned.position_errors()[16:, 0]
        assert np.mean(e_aware) < factor * np.mean(e_pinned), \
            (name, np.mean(e_aware), np.mean(e_pinned))
        assert np.mean(e_aware) < 0.016, (name, e_aware)

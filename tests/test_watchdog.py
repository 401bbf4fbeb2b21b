"""Watchdog: divergence detection + automatic re-initialization (§5 aux)."""

import numpy as np
import pytest

from dbot_ros_tpu.runtime.watchdog import (TrackingWatchdog, WatchdogConfig,
                                           reinitialize_particle_tracker)


class FakeInfo:
    def __init__(self, ess=None, mean_loglik=None, mean_beta=None):
        self.ess = ess
        self.mean_loglik = mean_loglik
        self.mean_beta = mean_beta


def test_watchdog_trips_on_sustained_ess_collapse():
    wd = TrackingWatchdog(WatchdogConfig(patience=3, warmup=0))
    for i in range(2):
        assert not wd.update(FakeInfo(ess=1.0), num_particles=1000)
    assert wd.update(FakeInfo(ess=1.0), num_particles=1000)
    assert wd.trip_count == 1


def test_watchdog_does_not_trip_on_healthy_stream():
    wd = TrackingWatchdog()
    for i in range(50):
        assert not wd.update(FakeInfo(ess=500.0, mean_loglik=-100.0
                                      + np.sin(i)), num_particles=1000)


def test_watchdog_trips_on_loglik_drop():
    wd = TrackingWatchdog(WatchdogConfig(patience=2, warmup=0))
    for i in range(10):
        wd.update(FakeInfo(mean_loglik=-100.0))
    assert not wd.update(FakeInfo(mean_loglik=-130.0))
    assert wd.update(FakeInfo(mean_loglik=-130.0))


def test_watchdog_resets_streak_on_recovery():
    wd = TrackingWatchdog(WatchdogConfig(patience=3, warmup=0))
    wd.update(FakeInfo(ess=1.0), num_particles=1000)
    wd.update(FakeInfo(ess=1.0), num_particles=1000)
    wd.update(FakeInfo(ess=900.0), num_particles=1000)  # healthy
    assert not wd.update(FakeInfo(ess=1.0), num_particles=1000)


def test_watchdog_beta_floor():
    wd = TrackingWatchdog(WatchdogConfig(patience=1, warmup=0))
    assert wd.update(FakeInfo(mean_beta=0.01))


# A recorded GF teleport trace (frames 17-34): beta collapses at the
# teleport (4th value) but OSCILLATES
# around the 0.05 beta_min floor, so the consecutive-frame streak kept
# resetting and detection fell through to the 15-frame lock-in tier.
_S33J_TELEPORT_BETA = [
    0.969, 0.864, 0.938,                      # healthy tail
    0.0326, 0.0833, 0.0571, 0.0526, 0.0570,   # teleport at index 3
    0.0598, 0.0594, 0.0637, 0.0461, 0.0560,
    0.0451, 0.0322, 0.0594, 0.0340, 0.0356,
]


def test_watchdog_beta_catastrophic_debounce_session33j():
    """The m-of-n catastrophic detector trips within ~4 frames of the
    session-33j teleport instead of the 14-frame lock-in fallback."""
    wd = TrackingWatchdog(WatchdogConfig(warmup=0))
    tripped_at = None
    for i, b in enumerate(_S33J_TELEPORT_BETA):
        if wd.update(FakeInfo(mean_beta=b)):
            tripped_at = i
            break
    assert tripped_at is not None
    # teleport lands at index 3; count=4-of-5 → earliest trip index 6
    assert tripped_at <= 7, f"detection latency {tripped_at - 3} frames"


def test_watchdog_beta_catastrophic_ignores_brief_full_occlusion():
    """A <= 3-frame full-cover flicker (beta ~ 0) must not fire the
    4-of-5 debounce; healthy recovery clears the window."""
    wd = TrackingWatchdog(WatchdogConfig(warmup=0, patience=4))
    seq = [0.9, 0.85, 0.02, 0.01, 0.03, 0.8, 0.9, 0.02, 0.05, 0.88]
    for b in seq:
        assert not wd.update(FakeInfo(mean_beta=b))


def test_watchdog_beta_catastrophic_not_fired_by_lockin_levels():
    """Wrong-basin lock-in beta (0.40-0.52) stays in the slow
    beta_locked tier, never the catastrophic one."""
    wd = TrackingWatchdog(WatchdogConfig(
        warmup=0, beta_locked_patience=15))
    trip_frame = None
    for i in range(20):
        if wd.update(FakeInfo(mean_beta=0.45 + 0.05 * (i % 2))):
            trip_frame = i
            break
    assert trip_frame is not None and trip_frame >= 14


def test_reinit_recovers_lost_track():
    """End-to-end: teleport the object mid-sequence (tracker loses it),
    watchdog-style reinit at the new pose re-acquires."""
    import jax.numpy as jnp

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.ops.raycast import raycast_depth
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    mesh = box_mesh(0.08, 0.06, 0.05)
    config = cfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=0)
    tracker = ParticleTracker(config, meshes=[mesh], camera=cam)

    pose_a = np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32)
    pose_b = np.array([0.15, 0.1, 0.8, 1, 0, 0, 0], np.float32)  # teleport

    def frame(pose):
        d = raycast_depth(mesh, jnp.asarray(pose), cam.rays, 128)
        return np.asarray(jnp.where(jnp.isfinite(d), d, jnp.nan))

    tracker.initialize(pose_a)
    for _ in range(3):
        poses, info = tracker.track(frame(pose_a))
    # teleported object: the tracker cannot follow a 20cm jump
    for _ in range(3):
        poses, info = tracker.track(frame(pose_b))
    lost_err = np.linalg.norm(np.asarray(poses)[0, :3] - pose_b[:3])
    assert lost_err > 0.05  # genuinely lost

    # recovery: external detector supplies a coarse pose near the truth
    coarse = pose_b.copy()
    coarse[:3] += np.array([0.02, -0.02, 0.03], np.float32)
    reinitialize_particle_tracker(tracker, coarse, spread_pos=0.03,
                                  spread_rot=0.2)
    for _ in range(6):
        poses, info = tracker.track(frame(pose_b))
    err = np.linalg.norm(np.asarray(poses)[0, :3] - pose_b[:3])
    assert err < 0.02, err


def test_watchdog_closed_loop_auto_recovery():
    """the watchdog wired into node.run must TRIP on an
    induced tracking loss (ground-truth teleport), re-initialize via the
    automatic 6-DoF search (initializer.initialize_tracker), and
    re-acquire within a few frames — no human in the loop."""
    import jax.numpy as jnp

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.cli import _trajectory_fn
    from dbot_ros_tpu.runtime.sources import SyntheticSource
    from dbot_ros_tpu.runtime.watchdog import TrackingWatchdog, \
        WatchdogConfig
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

    start = jnp.concatenate([jnp.array([0.03, 0.02, 0.6]),
                             se3.quat_identity()])
    traj = _trajectory_fn("teleport", start, 1)
    source = SyntheticSource([mesh], cam, traj, num_frames=26,
                             noise_sigma=0.002, seed=5)
    wd = TrackingWatchdog(WatchdogConfig(patience=2))
    # trimmed 6-DoF search: the teleport keeps the box's orientation, so
    # a coarse orientation grid re-acquires — full grid costs 100 s of
    # the test suite
    run = node.run(tracker, source, watchdog=wd,
                   reinit_kwargs=dict(n_axes=6, n_spins=2,
                                      refine_particles=128,
                                      refine_steps=3, polish_rounds=1))

    assert run.reinit_frames, "watchdog never tripped"
    assert min(run.reinit_frames) >= 12, run.reinit_frames
    # after recovery the tracker must re-acquire the teleported pose
    errs = run.position_errors()
    assert errs[11, 0] < 0.02            # tracked before the jump
    # genuinely lost when the jump lands (pose recorded pre-recovery)
    assert errs[12:15, 0].max() > 0.05, errs[11:16, 0]
    assert errs[-1, 0] < 0.025, errs[-3:, 0]  # re-acquired by the end


def test_watchdog_closed_loop_two_object_recovery():
    """K=2 scene, one object teleports mid-sequence;
    the watchdog trips and the automatic re-init (now arity-correct:
    runtime.initializer.find_initial_poses) re-acquires BOTH objects."""
    import jax.numpy as jnp

    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.sources import SyntheticSource
    from dbot_ros_tpu.runtime.watchdog import TrackingWatchdog, \
        WatchdogConfig
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh
    from dbot_ros_tpu.utils import se3

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    meshes = [l_shape_mesh(), box_mesh(0.05, 0.07, 0.03)]
    # budgets trimmed r5: 192p/30f -> 144p/24f re-validated (suite
    # wall-clock item) — same trip/re-acquire
    # margins, ~35 % cheaper
    config = cfg.ParticleTrackerConfig(
        evaluation_count=144, max_kl_divergence=0.8,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=0)
    tracker = ParticleTracker(config, meshes=meshes, camera=cam)

    start = jnp.stack([
        jnp.concatenate([jnp.array([-0.07, 0.0, 0.62]),
                         se3.quat_identity()]),
        jnp.concatenate([jnp.array([0.08, 0.02, 0.55]),
                         se3.quat_identity()])])

    def traj(t):
        # object 1 (the box) teleports 12 cm at frame 12; object 0 keeps
        # drifting gently
        p = start.at[:, 0].add(0.001 * t)
        return p.at[1, 1].add(jnp.where(t < 12, 0.0, -0.12))

    source = SyntheticSource(meshes, cam, traj, num_frames=24,
                             noise_sigma=0.002, seed=5)
    wd = TrackingWatchdog(WatchdogConfig(patience=2))
    run = node.run(tracker, source, watchdog=wd,
                   reinit_kwargs=dict(n_axes=6, n_spins=2,
                                      refine_particles=96,
                                      refine_steps=2, polish_rounds=1))

    assert run.reinit_frames, "watchdog never tripped"
    assert min(run.reinit_frames) >= 12, run.reinit_frames
    errs = run.position_errors()              # (T, K)
    assert errs[11].max() < 0.02, errs[11]    # both tracked pre-jump
    assert errs[12:15, 1].max() > 0.05        # box genuinely lost
    # both objects re-acquired by the end
    assert errs[-1, 0] < 0.025, errs[-3:, 0]
    assert errs[-1, 1] < 0.025, errs[-3:, 1]


@pytest.mark.parametrize("seed", [1, 3])
def test_watchdog_beta_depression_recovers_rgf_lockin(seed):
    """GF lock-in detector (round 4) + flip-aware recovery (round 5):
    after an occluder crossing the memoryless RGF
    locks a wrong rotation basin with a PERSISTENTLY depressed inlier
    rate (EVAL.md occluder/rgf note). The sustained-beta watchdog
    signal must trip well after the transient crossing and the re-init
    must re-acquire the TRUE basin on every seed. Seed 3 is the flip
    regression fixture: its 6-DoF search argmax IS the π-flip (near-
    tied likelihood), so recovery must race ≥2 beam hypotheses
    (node.run passes min_hypotheses=2) on the accumulated observation
    log-marginal with the union-masked background seed — before those
    three pieces, this seed re-locked at rot ≈ 3.13 rad. The exact
    sigma backend is PINNED: it is the configuration that reproduces
    the lock-in (the deferred default's smoother candidate silhouettes
    avoid the wrong basin outright on these seeds)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    from eval_suite import build_scene, make_source
    from dbot_ros_tpu.runtime import node
    from dbot_ros_tpu.runtime.watchdog import TrackingWatchdog, \
        WatchdogConfig

    from dbot_ros_tpu import config as _cfg
    from dbot_ros_tpu.trackers.gaussian import GaussianTracker

    cam, mesh, occluder = build_scene()
    # occlusion_memory OFF on purpose: the memoryless GF is what locks
    # in (the default memory chain prevents the lock-in outright —
    # that's its headline win); this test covers the DETECTOR+RECOVERY
    # safety net for wrong-basin states however they arise.
    conf = _cfg.GaussianTrackerConfig(
        observation=_cfg.ObservationConfig(model_sigma=0.005,
                                           sigma_factor=0.0),
        transition=_cfg.TransitionConfig(0.4, 2.5, damping=6.0),
        update_iterations=6, trust_sigma=1.5, occlusion_memory=False,
        sigma_backend="exact")
    tracker = GaussianTracker(conf, meshes=[mesh], camera=cam)
    wd = TrackingWatchdog(WatchdogConfig())
    run = node.run(tracker,
                   make_source("occluder", cam, mesh, occluder, 60,
                               seed=seed),
                   watchdog=wd,
                   reinit_kwargs=dict(n_axes=12, n_spins=4,
                                      refine_particles=128,
                                      refine_steps=3))
    assert run.reinit_frames, "lock-in never detected"
    # trips only AFTER the transient crossing (bar spans frames ~8-40;
    # beta recovers by ~30 on healthy runs)
    assert min(run.reinit_frames) >= 25
    rot = run.rotation_errors()
    assert rot[-1, 0] < 0.3, rot[-5:, 0]
    assert run.position_errors()[-1, 0] < 0.02

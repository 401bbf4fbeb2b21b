"""Streaming tracker loop — the node executable replacement.

Replaces ``particle_tracker_node.cpp`` / ``gaussian_tracker_node.cpp`` +
``ObjectTrackerRos`` (R1/R2/R5): wire a frame source to a tracker, collect
per-frame metrics, optionally checkpoint the belief, and record the
estimated trajectory. The ROS pub/sub process boundary becomes a plain
Python iterator + callback; the "separate tracking thread" concern (P4)
disappears because the device step is async-dispatched by JAX — the host
loop only blocks on the 7-float pose readback.

Also the simulation-node replacement (R3/R4): run() over a
SyntheticSource with ground truth gives the closed-loop evaluation the
reference performs by eyeballing RViz — here it returns pose RMSE.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from dbot_ros_tpu.runtime.metrics import FrameMetrics, MetricsLog
from dbot_ros_tpu.utils import se3


@dataclasses.dataclass
class TrackRun:
    """Result of a streaming run."""

    poses: np.ndarray            # (T, K, 7) estimated model-frame poses
    metrics: MetricsLog
    ground_truth: Optional[np.ndarray] = None   # (T, K, 7) if source had it
    reinit_frames: List[int] = dataclasses.field(default_factory=list)

    def position_errors(self):
        if self.ground_truth is None:
            return None
        return np.linalg.norm(self.poses[..., :3]
                              - self.ground_truth[..., :3], axis=-1)

    def rotation_errors(self, symmetries=None):
        """Per-frame per-object rotation errors (T, K).

        ``symmetries``: optional list of per-object (S, 4) quaternion
        symmetry groups (None entries = exact metric). Errors for an
        object with a group are reported modulo that group
        (se3.rotation_error_symmetric) — a box flipped by its own
        symmetry is NOT an error.
        """
        if self.ground_truth is None:
            return None
        import jax.numpy as jnp
        qe = jnp.asarray(self.poses[..., 3:7])
        qg = jnp.asarray(self.ground_truth[..., 3:7])
        if symmetries is None:
            dq = se3.quat_boxminus(qe, qg)
            return np.asarray(jnp.linalg.norm(dq, axis=-1))
        cols = []
        for k in range(qe.shape[1]):
            if symmetries[k] is None:
                dq = se3.quat_boxminus(qe[:, k], qg[:, k])
                cols.append(np.asarray(jnp.linalg.norm(dq, axis=-1)))
            else:
                cols.append(np.asarray(se3.rotation_error_symmetric(
                    qe[:, k], qg[:, k], symmetries[k])))
        return np.stack(cols, axis=1)

    def position_rmse(self):
        e = self.position_errors()
        return None if e is None else float(np.sqrt(np.mean(e ** 2)))

    def rotation_rmse(self, symmetries=None):
        e = self.rotation_errors(symmetries)
        return None if e is None else float(np.sqrt(np.mean(e ** 2)))


def run(tracker, source, initial_pose=None,
        on_frame: Optional[Callable] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        watchdog=None, reinit_kwargs: Optional[dict] = None,
        service=None) -> TrackRun:
    """Stream a source through a tracker.

    Args:
      tracker: ParticleTracker or GaussianTracker (initialize/track API).
      source: iterable of runtime.sources.Frame.
      initial_pose: model-frame pose(s); defaults to the source's first
        ground truth (simulation mode — ref R3 initializes from gt).
      on_frame: optional callback(frame, poses, info) — the publisher hook
        (ref R6 ObjectStatePublisher slot).
      checkpoint_path/_every: belief checkpointing (aux subsystem, §5).
      watchdog: optional runtime.watchdog.TrackingWatchdog. Fed every
        frame's StepInfo; when it trips (sustained divergence signature),
        the tracker is re-initialized from the *current* frame via the
        automatic 6-DoF search (runtime.initializer.initialize_tracker) —
        the closed-loop failure-recovery path the reference delegates to
        a human re-running the RViz marker (SURVEY.md §5 failure row).
        Tripped frame indices land in TrackRun.reinit_frames.
      reinit_kwargs: forwarded to the 6-DoF search (n_axes, n_spins,
        refine_particles, depth range — speed/robustness trade).
      service: optional runtime.service.TrackerService — the srv/action
        control surface (ref M3): queued commands (reset_pose,
        find_object, checkpoint, shutdown) are applied between frames on
        this thread; pause gates the track step; status snapshots are
        published every frame.
    """
    frames = iter(source)
    first = next(frames)

    already_initialized = (initial_pose is None
                           and getattr(tracker, "belief", None) is not None)
    if not already_initialized:
        if initial_pose is None:
            if first.ground_truth is None:
                raise ValueError(
                    "no initial pose, tracker not initialized, and source "
                    "has no ground truth")
            initial_pose = first.ground_truth
        import inspect
        if "first_frame" in inspect.signature(
                tracker.initialize).parameters:
            tracker.initialize(initial_pose, first_frame=first.depth)
        else:
            tracker.initialize(initial_pose)

    poses_out: List[np.ndarray] = []
    gt_out: List[np.ndarray] = []
    reinit_frames: List[int] = []
    log = MetricsLog()
    num_particles = getattr(getattr(tracker, "config", None),
                            "evaluation_count", None)

    def pump_service(frame):
        """Apply queued control commands; hold here while paused (frames
        are not pulled from the source, so a paused replay resumes where
        it stopped — the rosbag-pause semantic). False = shutdown."""
        if service is None:
            return True
        while True:
            if service.apply_pending(tracker, frame, reinit_kwargs):
                return False
            if not service.paused:
                return True
            time.sleep(0.01)

    # Variable frame-interval wiring (ref D7/R5 — dt-aware transitions +
    # real timestamp tracking): when the source reports dropped frames
    # (ThreadedSource drop-oldest sets frame.skipped), the transition
    # noise and occlusion chains must propagate over the REAL interval
    # (1 + skipped) / frame_rate, or drop-heavy streams leave the belief
    # overconfident. Trackers expose the nominal interval as ``_dt``.
    base_dt = getattr(tracker, "_dt", None)

    def handle(frame):
        if not pump_service(frame):
            return False                          # shutdown requested
        t0 = time.perf_counter()
        trial_n = getattr(tracker, "trial_active", None)
        skipped = getattr(frame, "skipped", None)
        if base_dt is not None and skipped:
            poses, info = tracker.track(frame.depth,
                                        dt=base_dt * (1 + skipped))
        else:
            poses, info = tracker.track(frame.depth)
        poses = np.asarray(poses)
        if poses.ndim == 1:
            poses = poses[None]
        latency = time.perf_counter() - t0
        poses_out.append(poses)
        if frame.ground_truth is not None:
            gt = np.asarray(frame.ground_truth)
            gt_out.append(gt if gt.ndim == 2 else gt[None])
        m = FrameMetrics.from_info(frame.index, info, latency)
        m.skipped = skipped
        m.trial_hypotheses = trial_n
        log.append(m)
        if on_frame is not None:
            on_frame(frame, poses, info)
        if watchdog is not None and watchdog.update(info, num_particles):
            # tracking lost: global re-acquisition on the current frame.
            # Contained: a degenerate frame (all-NaN burst — exactly the
            # frames that trip the dog) must not kill the run; the
            # watchdog re-arms and retries on a later frame.
            from dbot_ros_tpu.runtime.initializer import initialize_tracker
            try:
                # flip-aware recovery: a re-init
                # after a lock-in must race ≥2 beam hypotheses — the
                # wrong basin can win the single-frame search argmax
                initialize_tracker(tracker, frame.depth,
                                   **{"min_hypotheses": 2,
                                      "reuse_background": True,
                                      **(reinit_kwargs or {})})
                reinit_frames.append(frame.index)
            except Exception as e:  # noqa: BLE001 - keep tracking
                import sys as _sys
                print(f"watchdog re-init failed on frame {frame.index}: "
                      f"{type(e).__name__}: {e}", file=_sys.stderr)
        if checkpoint_path and checkpoint_every \
                and (frame.index + 1) % checkpoint_every == 0:
            from dbot_ros_tpu.runtime.checkpoint import save_belief
            save_belief(checkpoint_path, tracker.belief)
        if service is not None:
            service.update_status(frame.index, poses)
        return True

    if handle(first):
        for frame in frames:
            if not handle(frame):
                break

    if service is not None:
        reinit_frames = reinit_frames + list(service.reinit_frames)

    num_objects = len(getattr(tracker, "meshes", [None]))
    return TrackRun(
        poses=(np.stack(poses_out) if poses_out
               else np.zeros((0, num_objects, 7))),
        metrics=log,
        ground_truth=np.stack(gt_out) if gt_out and
        len(gt_out) == len(poses_out) else None,
        reinit_frames=reinit_frames)

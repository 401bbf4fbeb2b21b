"""Tracking-loss detection and automatic recovery (aux subsystem, §5).

The reference has no failure detection: tracking loss is absorbed by the
heavy-tailed model or fixed by a human re-running the interactive
initializer (SURVEY.md §5 "failure detection" row — absence). Here a
watchdog monitors the per-frame metrics stream for divergence signatures
and triggers a re-initialization policy:

  * particle tracker: sustained ESS collapse (posterior concentrated on a
    few particles that still explain the image poorly) together with a
    mean-log-likelihood drop below a running baseline;
  * gaussian tracker: inlier rate (mean body responsibility) collapse.

Recovery re-initializes the tracker at the last good pose with widened
noise — the automated analog of dragging the RViz marker back onto the
object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class WatchdogConfig:
    ess_fraction_min: float = 0.02      # ESS below 2% of P → degenerate
    loglik_drop: float = 3.0            # absolute drop floor vs EMA (nats)
    # A lost object among K is a drop ∝ its pixel share, so the factor
    # must catch diluted per-object signals: a 2-object teleport measured
    # only ~6× the healthy MAD and PERSISTED — persistence is what
    # separates a level shift from noise, so the bar is 3×MAD sustained
    # for `patience` frames (the old one-shot 10× absorbed real losses).
    loglik_mad_factor: float = 3.0      # ... or this × the tracked MAD
    beta_min: float = 0.05              # GF inlier-rate floor
    # Catastrophic GF loss debounce: a teleported / fully-lost Gaussian
    # filter's inlier rate collapses to near the clutter floor but
    # OSCILLATES around it (measured: beta 0.032-0.083 for 15 frames
    # after a teleport — every poke above 0.05 reset the
    # consecutive-frame beta_min streak, and detection fell through to
    # the 15-frame lock-in tier, a 14-frame latency). Healthy tracking
    # sits at 0.83-0.98 and even wrong-basin lock-in at 0.40-0.52, so
    # 0.15 splits the regimes with wide margin; the m-of-n window trips
    # on a sustained collapse without resetting on single noise pokes,
    # while a <= (window - count + 1)-frame full-occlusion flicker
    # cannot fire it. 0 disables.
    beta_catastrophic: float = 0.15
    beta_cat_count: int = 4             # trip when >= count of the last
    beta_cat_window: int = 5            # window frames are below threshold
    # GF lock-in detector: a wrong-basin Gaussian filter keeps a
    # PERSISTENTLY depressed inlier rate (measured beta 0.40-0.52 for
    # 30+ frames after an occluder-crossing rotation lock-in vs >0.7
    # healthy, EVAL.md occluder/rgf note) — innovation RMS does NOT
    # separate the two (the wrong basin fits depth decently). The
    # patience outlasts a transient crossing (~10 frames), which also
    # depresses beta but recovers. 0 disables.
    # The patience must exceed the longest TRANSIENT occlusion expected
    # in the scene (the eval occluder bar depresses beta for ~12 frames
    # on healthy runs — measured; 15 leaves a 3-frame margin while still
    # catching every locked seed, which longer patiences miss because
    # lock-in beta occasionally pokes above the threshold and resets
    # the streak). A slow occluder that covers the object for longer
    # WILL trip a re-init — set beta_locked=0 for scenes with long
    # benign occlusions.
    beta_locked: float = 0.6            # sustained-depression threshold
    beta_locked_patience: int = 15
    # Anti-thrash: if re-inits don't lift beta (a scene whose HEALTHY
    # inlier rate sits below the threshold — heavy clutter, object
    # partly out of frame), stop tripping on it after this many
    # beta-locked trips.
    beta_locked_max_trips: int = 2
    patience: int = 3                   # consecutive bad frames to trip
    ema_rate: float = 0.05              # baseline tracking rate
    warmup: int = 3                     # grace frames after start/re-init


class TrackingWatchdog:
    """Feed per-frame (info, num_particles) → returns True when tripped.

    The first ``warmup`` frames after construction, :meth:`reset`, or a
    trip are a grace window: the filter is still diversifying from a
    point init (ESS transients) or re-converging after recovery, so the
    divergence signatures are expected and must not re-trip the dog.
    """

    def __init__(self, config: Optional[WatchdogConfig] = None):
        self.config = config or WatchdogConfig()
        self._loglik_ema: Optional[float] = None
        self._loglik_mad = 0.0
        self._beta_low_streak = 0
        self._beta_window: list = []
        self._beta_trips = 0
        self._bad_streak = 0
        self._frames = 0
        self.trip_count = 0

    def reset(self):
        """Back to the post-init state (call after an external re-init)."""
        self._loglik_ema = None
        self._loglik_mad = 0.0
        self._beta_low_streak = 0
        self._beta_window = []
        self._bad_streak = 0
        self._frames = 0

    def update(self, info, num_particles: Optional[int] = None) -> bool:
        c = self.config
        self._frames += 1
        if self._frames <= c.warmup:
            # track the baseline during warmup, never trip; seed the MAD
            # from the observed frame-to-frame wobble so the adaptive
            # threshold starts at the stream's own noise scale
            ll = getattr(info, "mean_loglik", None)
            if ll is not None:
                ll = float(ll)
                if self._loglik_ema is not None:
                    self._loglik_mad = max(self._loglik_mad,
                                           abs(ll - self._loglik_ema))
                self._loglik_ema = ll
            return False
        bad = False

        ess = getattr(info, "ess", None)
        if ess is not None and num_particles:
            if float(ess) < c.ess_fraction_min * num_particles:
                bad = True

        ll = getattr(info, "mean_loglik", None)
        if ll is not None:
            ll = float(ll)
            if self._loglik_ema is None:
                self._loglik_ema = ll
            # Noise-adaptive threshold: the image loglik's healthy
            # frame-to-frame wobble depends on pixel count and motion,
            # so a fixed nats threshold false-trips (seen on a healthy
            # circle run). Track the mean absolute deviation and demand
            # a drop that dwarfs it (with the absolute floor for
            # near-constant streams).
            thresh = max(c.loglik_drop,
                         c.loglik_mad_factor * self._loglik_mad)
            if ll < self._loglik_ema - thresh:
                bad = True
            else:
                dev = abs(ll - self._loglik_ema)
                self._loglik_ema = ((1 - c.ema_rate) * self._loglik_ema
                                    + c.ema_rate * ll)
                # Robustified MAD: clip the contribution so a real but
                # sub-threshold level shift cannot inflate the noise
                # estimate and mask itself (mean-abs-dev is not a median;
                # without the clip one outlier raises the threshold that
                # is supposed to catch it).
                dev = min(dev, max(2.0 * self._loglik_mad, c.loglik_drop))
                self._loglik_mad = ((1 - c.ema_rate) * self._loglik_mad
                                    + c.ema_rate * dev)

        beta = getattr(info, "mean_beta", None)
        if beta is not None and float(beta) < c.beta_min:
            bad = True

        # Catastrophic-collapse debounce (see WatchdogConfig): m-of-n
        # window, immune to single pokes above the threshold that reset
        # the consecutive streaks (session-33j teleport signature).
        if beta is not None and c.beta_catastrophic > 0:
            self._beta_window.append(float(beta) < c.beta_catastrophic)
            if len(self._beta_window) > c.beta_cat_window:
                self._beta_window.pop(0)
            if sum(self._beta_window) >= c.beta_cat_count:
                self.reset()
                self.trip_count += 1
                return True

        # GF lock-in: inlier rate depressed for far longer than any
        # transient occlusion (separate long-patience streak).
        if beta is not None and c.beta_locked > 0 \
                and self._beta_trips < c.beta_locked_max_trips:
            if float(beta) < c.beta_locked:
                self._beta_low_streak += 1
            else:
                self._beta_low_streak = 0
            if self._beta_low_streak >= c.beta_locked_patience:
                self._beta_trips += 1   # survives reset(): per-run cap
                beta_trips = self._beta_trips
                self.reset()
                self._beta_trips = beta_trips
                self.trip_count += 1
                return True

        if bad:
            self._bad_streak += 1
        else:
            self._bad_streak = 0

        if self._bad_streak >= c.patience:
            self.reset()
            self.trip_count += 1
            return True
        return False


def reinitialize_particle_tracker(tracker, last_good_pose,
                                  spread_pos: float = 0.05,
                                  spread_rot: float = 0.3):
    """Recovery policy: re-seed the belief around the last good pose with
    widened diversity (exploration burst), keeping the compiled step."""
    import jax
    import jax.numpy as jnp

    from dbot_ros_tpu.filters import rbcpf
    from dbot_ros_tpu.trackers import base
    from dbot_ros_tpu.utils import se3

    poses_model = jnp.asarray(last_good_pose, jnp.float32)
    if poses_model.ndim == 1:
        poses_model = poses_model[None]
    pose_center = base.to_center_frame(poses_model, tracker.centers)
    p = tracker.config.evaluation_count
    key = jax.random.fold_in(jax.random.PRNGKey(tracker.config.seed),
                             17 + getattr(tracker, "_reinit_count", 0))
    tracker._reinit_count = getattr(tracker, "_reinit_count", 0) + 1
    k1, k2 = jax.random.split(key)
    k_objects = poses_model.shape[0]
    dpos = spread_pos * jax.random.normal(k1, (p, k_objects, 3))
    drot = spread_rot * jax.random.normal(k2, (p, k_objects, 3))
    poses = jnp.concatenate(
        [pose_center[None, :, :3] + dpos,
         se3.quat_boxplus(
             jnp.broadcast_to(pose_center[None, :, 3:7],
                              (p, k_objects, 4)), drot)], -1)
    states = jnp.zeros((p, k_objects, 13), jnp.float32).at[..., :7].set(
        poses)
    init_prob = float(tracker.occ_params.initial_occlusion_prob)
    if hasattr(tracker.sensor, "init_occlusion"):
        occ = tracker.sensor.init_occlusion(p, init_prob)
    else:
        occ = jnp.full((p, tracker.camera.num_pixels),
                       jnp.float32(init_prob))
    tracker._trial = None
    tracker.belief = rbcpf.ParticleBelief(
        states=states,
        log_weights=jnp.zeros((p,), jnp.float32),
        occlusion=occ,
        key=jax.random.fold_in(key, 99),
    )
    tracker._smoothed = pose_center

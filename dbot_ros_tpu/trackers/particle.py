"""Particle tracker facade + builder (ref D19 ParticleTracker + D21
ParticleTrackerBuilder).

Host-side stateful wrapper around the jitted RBC-PF step: owns the belief
pytree, the compiled step, moving-average output smoothing, and the
model↔center frame conversions. Everything device-side lives in
filters/rbcpf.py; this class is the user-facing surface a reference user
would reach for (``tracker.initialize(poses); tracker.track(depth)``).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu import config as cfg
from dbot_ros_tpu.filters import rbcpf
from dbot_ros_tpu.models import beam, occlusion, transition
from dbot_ros_tpu.models.sensor import make_rb_sensor
from dbot_ros_tpu.trackers import base
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import (CameraModel, default_kinect_camera,
                                       make_camera, preprocess_depth)
from dbot_ros_tpu.utils.mesh import TriangleMesh, load_obj


def build_camera(camera_cfg: cfg.CameraConfig) -> CameraModel:
    if camera_cfg.camera_matrix is None:
        return default_kinect_camera(camera_cfg.downsampling_factor)
    h, w = camera_cfg.resolution
    return make_camera(np.asarray(camera_cfg.camera_matrix, float),
                       h, w, camera_cfg.downsampling_factor)


def build_meshes(object_cfg: cfg.ObjectConfig) -> List[TriangleMesh]:
    return [load_obj(p, center=object_cfg.center_object,
                     scale=object_cfg.scale)
            for p in object_cfg.mesh_paths()]


class ParticleTracker:
    """User-facing particle tracker (one or more rigid objects).

    Build from a config (like the reference's builder), or pass meshes and
    camera directly for programmatic use.
    """

    def __init__(self, config: cfg.ParticleTrackerConfig,
                 meshes: Optional[List[TriangleMesh]] = None,
                 camera: Optional[CameraModel] = None):
        self.config = config
        self.camera = camera if camera is not None else build_camera(
            config.camera)
        self.meshes = meshes if meshes is not None else build_meshes(
            config.object)
        if not self.meshes:
            raise ValueError("particle tracker needs at least one mesh")

        obs = config.observation
        self.beam_params = beam.make_beam_params(
            tail_weight=obs.tail_weight, model_sigma=obs.model_sigma,
            sigma_factor=obs.sigma_factor, min_depth=obs.min_depth,
            max_depth=obs.max_depth, exponential_rate=obs.exponential_rate)
        self.occ_params = occlusion.make_occlusion_params(
            obs.p_occluded_visible, obs.p_occluded_occluded,
            obs.initial_occlusion_prob)
        tr = config.transition
        self.trans_params = transition.make_transition_params(
            tr.linear_acceleration_sigma, tr.angular_acceleration_sigma,
            tr.damping)
        self.sensor = make_rb_sensor(
            self.meshes, self.camera, self.beam_params, self.occ_params,
            frame_rate=config.camera.frame_rate, backend=config.backend,
            **(config.backend_options or {}))

        self._dt = 1.0 / config.camera.frame_rate
        # Donating the belief lets XLA reuse its buffers (the occlusion
        # map alone is ~P·N·4 bytes) instead of allocating fresh ones
        # every frame. dt is a TRACED argument:
        # drop-heavy streams pass the real frame interval — transition
        # noise and the occlusion chain scale with it (ref D7 dt-aware
        # transitions); distinct dt values do not retrace.
        self._step = jax.jit(functools.partial(
            rbcpf.rbcpf_step,
            loglik_fn=self.sensor,
            trans_params=self.trans_params,
            max_kl_divergence=config.max_kl_divergence),
            donate_argnums=(0,))
        self.belief: Optional[rbcpf.ParticleBelief] = None
        self._smoothed = None  # (K, 7) centered-frame smoothed poses
        # Multi-hypothesis ISLAND trial (see initialize()).
        self._trial = None

        # Chain-free pose score for the island race: each island's
        # posterior-mean state re-evaluated against the frame with the
        # occlusion chain RESET to its initial prior. Racing on the
        # filter's own mean_loglik launders: the D10 chain is the PF's
        # world model, and within ~4 frames it marks a wrong basin's
        # persistent misfit pixels as occluded — measured: a π-flip's
        # per-frame marginal overtook the
        # correct basin's exactly as the chain saturated. Same failure
        # family as the GF's background laundering (learn_world).
        def _pose_score(mean_state, z_obs):
            from dbot_ros_tpu.models.image_loglik import image_loglik
            from dbot_ros_tpu.models.sensor import render_scene
            from dbot_ros_tpu.ops.budget import xla_tri_chunk

            depth = render_scene(
                self.meshes, mean_state[None, :, :7], self.camera.rays,
                xla_tri_chunk(1, self.camera.num_pixels))
            occ0 = jnp.full((1, self.camera.num_pixels), jnp.float32(
                self.occ_params.initial_occlusion_prob))
            ll, _ = image_loglik(depth, z_obs, occ0, self.beam_params,
                                 self.occ_params, 1.0)
            return ll[0]

        self._pose_score = jax.jit(_pose_score)

    @property
    def centers(self):
        return jnp.stack([m.center for m in self.meshes])  # (K, 3)

    @property
    def trial_active(self):
        """Number of racing island hypotheses, or None outside a trial
        (surfaced into FrameMetrics — per-frame latency multiplies by
        it during a trial)."""
        return len(self._trial["beliefs"]) if self._trial else None

    def initialize(self, poses_model, hypotheses=None,
                   hypothesis_logits=None, trial_frames: int = 8,
                   trial_switch_margin: float = 2.0):
        """Set the initial object pose(s), in the original mesh frame.

        Ref: ObjectTracker::initialize + ParticleTracker::on_initialize.

        ``hypotheses`` (H, 7) | (H, K, 7) model-frame poses (the
        automatic initializer's refined beams, flip-aware recovery):
        with H ≥ 2 the hypotheses race as **separate island beliefs**
        for ``trial_frames`` frames; the best accumulated CHAIN-FREE
        pose score (each island's mean state re-scored against the
        frame at the prior occlusion level — see ``_pose_score``) wins
        and the rest are dropped, with the search argmax (slot 0)
        published and kept unless a challenger wins by
        ``trial_switch_margin`` nats/frame.

        Why islands and not the score-weighted particle MIXTURE this
        method used through round 4: the first KL resample annihilates
        any minority block whose beam arrived a few nats under-refined
        — a 9-nat search-noise gap gives its particles e⁻⁹ relative
        weight, so a π-flip that happened to win the single-frame
        search argmax swallowed the whole cloud in ONE step (measured
        at 256 and 10k particles). Islands protect each
        basin from cross-hypothesis resampling while evidence
        accumulates — the PF analog of the Gaussian tracker's
        multi-hypothesis trial, and the island-model machinery of
        parallel/dist_filter at tracker scale.
        """
        poses_model = jnp.asarray(poses_model, jnp.float32)
        if poses_model.ndim == 1:
            poses_model = poses_model[None]
        poses_center = base.to_center_frame(poses_model, self.centers)
        key = jax.random.PRNGKey(self.config.seed)
        self._trial = None
        hyp = None
        if hypotheses is not None:
            hyp = jnp.asarray(hypotheses, jnp.float32)
            if hyp.ndim == 2:
                hyp = hyp[:, None]           # (H, 7) → (H, 1, 7)

        def make_belief(pose_center, k):
            # k=0 keeps the pre-island RNG stream bit-identical for the
            # standard single-pose init; islands fold in their slot
            return rbcpf.init_belief(
                key if k == 0 else jax.random.fold_in(key, k),
                pose_center,
                self.config.evaluation_count, self.camera.num_pixels,
                float(self.occ_params.initial_occlusion_prob),
                sensor=self.sensor)

        if hyp is not None and hyp.shape[0] >= 2:
            order = (list(np.argsort(-np.asarray(hypothesis_logits)))
                     if hypothesis_logits is not None
                     else list(range(hyp.shape[0])))[:4]
            beliefs = [make_belief(
                base.to_center_frame(hyp[i], self.centers), i + 1)
                for i in order]
            self._trial = {"beliefs": beliefs,
                           "scores": [0.0] * len(beliefs),
                           "left": int(trial_frames), "elapsed": 0,
                           "margin": float(trial_switch_margin)}
            self.belief = beliefs[0]
        else:
            self.belief = make_belief(poses_center, 0)
        self._smoothed = poses_center

    def restore(self, belief: rbcpf.ParticleBelief):
        """Resume from a checkpointed belief (runtime/checkpoint.py)."""
        from dbot_ros_tpu.ops import resample as rs
        self._trial = None
        self.belief = belief
        ln, _ = rs.normalize_log_weights(belief.log_weights)
        w = jnp.exp(ln)
        mean = jax.vmap(lambda s: se3.states_mean(s, w),
                        in_axes=1)(belief.states)
        self._smoothed = mean[:, :7]

    def track(self, depth_image, dt=None):
        """One frame → (poses (K, 7) in model frame, StepInfo).

        Ref: ObjectTrackerRos::track → ObjectTracker::track (D18/R5).

        ``dt``: real interval since the previous frame, in seconds
        (default: the configured 1/frame_rate). Pass the true interval
        when frames are dropped — transition noise and the occlusion
        chain propagate by it (ref D7 dt-aware transitions).
        """
        if self.belief is None:
            raise RuntimeError("call initialize(poses) before track()")
        z = preprocess_depth(jnp.asarray(depth_image,
                                         jnp.float32).reshape(-1))
        dt = jnp.float32(self._dt if dt is None else dt)
        trial = self._trial
        if trial:
            infos = []
            for i, b in enumerate(trial["beliefs"]):
                b2, info_i = self._step(b, z, dt=dt)
                trial["beliefs"][i] = b2
                # chain-free pose score (see __init__._pose_score)
                trial["scores"][i] += float(
                    self._pose_score(info_i.mean_state, z))
                infos.append(info_i)
            trial["left"] -= 1
            trial["elapsed"] += 1
            if trial["left"] <= 0:
                # commit ONCE, at trial end (same hysteresis as the GF
                # trial): the search argmax holds unless a challenger
                # wins the accumulated marginal decisively
                best = int(np.argmax(trial["scores"]))
                if best != 0 and (trial["scores"][best]
                                  - trial["scores"][0]
                                  < trial["margin"] * trial["elapsed"]):
                    best = 0
                self.belief = trial["beliefs"][best]
                info = infos[best]
                self._trial = None
            else:
                self.belief = trial["beliefs"][0]
                info = infos[0]
        else:
            self.belief, info = self._step(self.belief, z, dt=dt)
        new_poses = info.mean_state[:, :7]
        self._smoothed = base.moving_average_pose(
            self._smoothed, new_poses,
            self.config.moving_average_update_rate)
        return base.to_model_frame(self._smoothed, self.centers), info

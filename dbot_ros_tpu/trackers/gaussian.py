"""Gaussian tracker facade + builder (ref D20 GaussianTracker + D21
GaussianTrackerBuilder).

Robust-Gaussian-filter tracker; same user surface as the particle
tracker (initialize/track, model-frame poses, EMA smoothing). Multi-object
scenes run the joint RGF (state (K, 13), joint 12K-dim tangent covariance,
min-over-objects render — mutual occlusion is geometric, exactly like the
particle sensors). ``pixel_stride`` evaluates the update on a sparse pixel
subset (the ICRA-2016 paper's sparse-sensor trick), cutting render and
update cost by the stride factor.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu import config as cfg
from dbot_ros_tpu.filters import rgf
from dbot_ros_tpu.models import beam, occlusion, transition
from dbot_ros_tpu.ops.raycast import raycast_depth
from dbot_ros_tpu.trackers import base
from dbot_ros_tpu.trackers.particle import build_camera, build_meshes
from dbot_ros_tpu.utils.camera import CameraModel, preprocess_depth
from dbot_ros_tpu.utils.mesh import TriangleMesh


class GaussianTracker:
    def __init__(self, config: cfg.GaussianTrackerConfig,
                 mesh: Optional[TriangleMesh] = None,
                 camera: Optional[CameraModel] = None,
                 meshes=None):
        self.config = config
        self.camera = camera if camera is not None else build_camera(
            config.camera)
        if meshes is None:
            meshes = [mesh] if mesh is not None else build_meshes(
                config.object)
        self.meshes = list(meshes)
        self.mesh = self.meshes[0]
        self.num_objects = len(self.meshes)
        self._single = self.num_objects == 1

        obs = config.observation
        self.beam_params = beam.make_beam_params(
            tail_weight=obs.tail_weight, model_sigma=obs.model_sigma,
            sigma_factor=obs.sigma_factor, min_depth=obs.min_depth,
            max_depth=obs.max_depth, exponential_rate=obs.exponential_rate)
        tr = config.transition
        self.trans_params = transition.make_transition_params(
            tr.linear_acceleration_sigma, tr.angular_acceleration_sigma,
            tr.damping)

        # Sparse-pixel sensor subset (static → jit-friendly gathers).
        # pixel_stride <= 0 → auto degrade-to-budget (ref D14 analog,
        # ops/budget.rgf_pixel_stride): keeps the sigma-point raycast
        # bounded as K objects / full-resolution pixels grow.
        stride = int(config.pixel_stride)
        if stride <= 0:
            from dbot_ros_tpu.ops.budget import rgf_pixel_stride
            stride = rgf_pixel_stride(
                self.camera.num_pixels,
                max(m.padded_triangles for m in self.meshes),
                self.num_objects, config.update_iterations,
                config.sigma_backend, config.sigma_candidates)
        stride = max(stride, 1)
        self._pixel_idx = (None if stride == 1 else
                           jnp.arange(0, self.camera.num_pixels, stride))
        rays = (self.camera.rays if self._pixel_idx is None
                else self.camera.rays[self._pixel_idx])
        meshes_ = self.meshes
        single = self._single

        # Sigma-point render backend: "deferred"
        # (default) routes the 25 sigma renders through the candidate
        # one-hot matmul pass (ops/deferred.make_sigma_renderer) — the
        # exact scan runs once per iteration at the mean only; "exact"
        # is the full scan-over-triangles for every sigma pose
        # (the oracle path, and the fallback for unusual meshes).
        if config.sigma_backend == "deferred":
            from dbot_ros_tpu.ops.deferred import make_sigma_renderer
            render_fn = make_sigma_renderer(
                self.meshes, self.camera.rays, self.camera.height,
                self.camera.width, pixel_idx=self._pixel_idx,
                radius=config.sigma_radius,
                num_candidates=config.sigma_candidates)
        elif config.sigma_backend == "exact":
            def render_fn(poses):
                # (S, 7) single-object | (S, K, 7) scene → (S, n_sub)
                if single:
                    return raycast_depth(meshes_[0], poses, rays)
                depth = None
                for k, m in enumerate(meshes_):
                    d = raycast_depth(m, poses[..., k, :], rays)
                    depth = d if depth is None else jnp.minimum(depth, d)
                return depth
        else:
            raise ValueError(
                f"unknown sigma_backend {config.sigma_backend!r} "
                "(expected 'deferred' or 'exact')")

        self._dt = 1.0 / config.camera.frame_rate
        self._occ_params = (occlusion.make_occlusion_params(
            obs.p_occluded_visible, obs.p_occluded_occluded,
            obs.initial_occlusion_prob)
            if config.occlusion_memory else None)
        frame_rate = float(config.camera.frame_rate)

        # dt is a TRACED argument: a drop-heavy live
        # stream (ThreadedSource drop-oldest) must scale transition noise
        # AND the occlusion-chain propagation by the real frame interval
        # (ref D7 dt-aware transitions, R5 timestamp tracking) — distinct
        # dt values do not retrace.
        def _step_fn(belief, z, dt, learn_world=True):
            return rgf.rgf_step(
                belief, z, render_fn=render_fn,
                trans_params=self.trans_params, dt=dt,
                bp=self.beam_params, iterations=config.update_iterations,
                trust_sigma=config.trust_sigma,
                lin_floor_pos=config.lin_floor_pos,
                lin_floor_rot=config.lin_floor_rot,
                lin_cap_pos=config.lin_cap_pos,
                lin_cap_rot=config.lin_cap_rot,
                bg_sigma=config.bg_sigma,
                occ_params=self._occ_params,
                occ_dt_frames=dt * frame_rate,
                learn_world=learn_world)

        self._step = jax.jit(_step_fn)
        # multi-hypothesis trials run with the WORLD MODEL FROZEN
        # (background map + occlusion chain): adapting them per
        # hypothesis launders a wrong basin's misfit into its own
        # world and neutralizes the obs_loglik race (filters/rgf.py
        # learn_world note)
        self._step_frozen = jax.jit(functools.partial(
            _step_fn, learn_world=False))
        self.belief: Optional[rgf.GaussianBelief] = None
        self._smoothed = None
        self._trial = None

    @property
    def centers(self):
        return jnp.stack([m.center for m in self.meshes])

    @property
    def trial_active(self):
        """Number of racing init hypotheses, or None outside a trial —
        surfaced into FrameMetrics so per-frame latency spikes during a
        multi-hypothesis trial are attributable (advisor r4)."""
        return len(self._trial["beliefs"]) if self._trial else None

    def _to_center(self, poses_model):
        if self._single:
            return base.to_center_frame(poses_model.reshape(7),
                                        self.mesh.center)
        return base.to_center_frame(
            poses_model.reshape(self.num_objects, 7), self.centers)

    def _make_belief(self, pose_center, first_frame):
        c = self.config
        num_pixels = (self.camera.num_pixels if self._pixel_idx is None
                      else self._pixel_idx.shape[0])
        return rgf.init_belief(
            jax.random.PRNGKey(c.seed), pose_center,
            num_pixels=num_pixels, first_frame=first_frame,
            pos_sigma=c.init_pos_sigma, rot_sigma=c.init_rot_sigma,
            vel_sigma=c.init_vel_sigma,
            background_depth=float(self.beam_params.max_depth),
            initial_occlusion_prob=(
                float(self.config.observation.initial_occlusion_prob)
                if c.occlusion_memory else None))

    def initialize(self, pose_model, first_frame=None, hypotheses=None,
                   hypothesis_logits=None, trial_frames: int = 6,
                   trial_switch_margin: float = 1.0,
                   reuse_background: bool = False):
        """Set the initial pose(s); optionally race init hypotheses.

        ``hypotheses`` (H, 7) | (H, K, 7) model-frame poses (the
        automatic initializer's refined beams): a Gaussian is unimodal
        by construction, so near-symmetric init twins — which the PF
        resolves with a score-weighted particle mixture — get a short
        MULTI-HYPOTHESIS TRIAL instead: every hypothesis runs its own
        belief for the next ``trial_frames`` frames; the best
        ACCUMULATED OBSERVATION LOG-MARGINAL (RgfStepInfo.obs_loglik)
        wins and the rest are dropped. The marginal — not the inlier
        rate — is the race metric: a near-symmetric flip can explain
        ~97 % of predicted-object pixels (beta race ties) yet carries a
        persistent depth-gradient misfit the per-pixel mixture density
        integrates over frames (fixes the flip
        re-lock observed in watchdog recovery).
        ``trial_switch_margin`` is in nats/frame.

        ``reuse_background``: carry the incumbent belief's LEARNED
        background map into the new belief(s) instead of re-seeding
        from ``first_frame`` — the recovery semantics (node.run's
        watchdog re-init sets it): the world model persists across a
        re-initialization; only the object belief resets. Re-seeding
        from the live frame puts the OBJECT ITSELF into every
        hypothesis's background and starves/launders the trial race
        (see the mask note below for the cold-start fallback).
        """
        pose_model = jnp.asarray(pose_model, jnp.float32)
        pose_center = self._to_center(pose_model)
        hyp = None
        if hypotheses is not None:
            hyp = jnp.asarray(hypotheses, jnp.float32)
            if hyp.ndim == 2:
                hyp = hyp[:, None]
        inherited_bg = (self.belief.background
                        if reuse_background and self.belief is not None
                        else None)
        if first_frame is not None:
            first_frame = preprocess_depth(
                jnp.asarray(first_frame, jnp.float32).reshape(-1))
            if self._pixel_idx is not None:
                first_frame = first_frame[self._pixel_idx]
        if first_frame is not None and inherited_bg is None \
                and hyp is not None and hyp.shape[0] >= 2:
            # MULTI-HYPOTHESIS init only: mask the union of all
            # candidate poses' predicted object regions out of the
            # background seed — a pixel any hypothesis may cover says
            # nothing about the scene behind it. Seeding bg from the
            # raw frame let a WRONG hypothesis explain its misfit
            # pixels as "background" at full density — the learned-bg
            # channel absorbed exactly the evidence the trial's
            # obs_loglik race needs (measured: the race was decided by
            # background bookkeeping, not object fit, and a flip won
            # on one seed). With the union mask, uncovered true-object
            # pixels score as clutter for the flip and as object for
            # the correct basin. Single-hypothesis inits keep the raw
            # frame (the calibrated detector/tracking behavior).
            cand_poses = [pose_center] + [self._to_center(h)
                                          for h in hyp]
            rays = (self.camera.rays if self._pixel_idx is None
                    else self.camera.rays[self._pixel_idx])
            covered = jnp.zeros(first_frame.shape, bool)
            for pc in cand_poses:
                pk = pc.reshape(self.num_objects, 7)
                for k, m in enumerate(self.meshes):
                    d = raycast_depth(m, pk[k], rays)
                    covered = covered | jnp.isfinite(d)
            first_frame = jnp.where(covered, jnp.nan, first_frame)

        def build(pc):
            b = self._make_belief(pc, first_frame)
            if inherited_bg is not None:
                import dataclasses as _dc
                b = _dc.replace(b, background=inherited_bg)
            return b

        self.belief = build(pose_center)
        self._smoothed = pose_center
        self._trial = None
        if hyp is not None:
            if hyp.shape[0] >= 2:
                order = (list(np.argsort(-np.asarray(hypothesis_logits)))
                         if hypothesis_logits is not None
                         else list(range(hyp.shape[0])))[:4]
                beliefs = [build(self._to_center(hyp[i]))
                           for i in order]
                self._trial = {"beliefs": beliefs,
                               "scores": [0.0] * len(beliefs),
                               "left": int(trial_frames),
                               "elapsed": 0,
                               "margin": float(trial_switch_margin)}

    def restore(self, belief: rgf.GaussianBelief):
        """Resume from a checkpointed belief (runtime/checkpoint.py).

        A pre-round-4 checkpoint carries no occlusion-memory leaf; with
        occlusion_memory configured on, re-seed it at the initial prior
        rather than silently degrading to the memoryless filter."""
        if belief.occ_prior is None and self._occ_params is not None:
            import dataclasses as _dc
            belief = _dc.replace(belief, occ_prior=jnp.full_like(
                belief.background,
                jnp.float32(self.config.observation.initial_occlusion_prob)))
        self.belief = belief
        self._smoothed = belief.mean[..., :7]
        self._trial = None

    def track(self, depth_image, dt=None):
        """One frame → (pose(s) in model frame, RgfStepInfo).

        ``dt``: real interval since the previous frame, in seconds
        (default: the configured 1/frame_rate). Pass the true interval
        when frames are dropped — transition noise and the occlusion
        chain propagate by it (ref D7/R5)."""
        if self.belief is None:
            raise RuntimeError("call initialize(pose) before track()")
        dt = jnp.float32(self._dt if dt is None else dt)
        z = preprocess_depth(jnp.asarray(depth_image,
                                         jnp.float32).reshape(-1))
        if self._pixel_idx is not None:
            z = z[self._pixel_idx]
        trial = self._trial
        if trial:
            infos = []
            for i, b in enumerate(trial["beliefs"]):
                b2, info_i = self._step_frozen(b, z, dt)
                trial["beliefs"][i] = b2
                trial["scores"][i] += float(info_i.obs_loglik)
                infos.append(info_i)
            trial["left"] -= 1
            trial["elapsed"] += 1
            if trial["left"] <= 0:
                # commit ONCE, at trial end (advisor r4: recomputing the
                # winner every frame let the published pose flip between
                # hypotheses mid-trial, bypassing the output EMA). The
                # init search's full-likelihood argmax (beliefs[0]) is
                # the prior choice; a challenger must win the
                # accumulated-marginal race DECISIVELY (margin nats per
                # trial frame) — a slim edge routinely favors a
                # well-fitting symmetric flip over a still-converging
                # correct basin during its first catch-up frames
                best = int(np.argmax(trial["scores"]))
                if best != 0 and (trial["scores"][best]
                                  - trial["scores"][0]
                                  < trial["margin"] * trial["elapsed"]):
                    best = 0
                self.belief = trial["beliefs"][best]
                info = infos[best]
                self._trial = None
            else:
                # provisional output: the prior choice, held steady for
                # the whole trial
                self.belief = trial["beliefs"][0]
                info = infos[0]
            # follow the held/winning hypothesis directly (EMA blending
            # ACROSS hypotheses would average incompatible orientations)
            self._smoothed = self.belief.mean[..., :7]
        else:
            self.belief, info = self._step(self.belief, z, dt)
        new_pose = self.belief.mean[..., :7]
        self._smoothed = base.moving_average_pose(
            self._smoothed, new_pose,
            self.config.moving_average_update_rate)
        if self._single:
            return (base.to_model_frame(self._smoothed, self.mesh.center),
                    info)
        return base.to_model_frame(self._smoothed, self.centers), info

"""Rao-Blackwellized coordinate particle filter (the flagship estimator).

Replaces ``dbot/rao_blackwell_coordinate_particle_filter.h`` (D17, Wüthrich
et al. IROS 2013): per *sampling block* (one block per tracked object —
coordinate blocking P3), sample the block's pose coordinates from the
transition, evaluate log-likelihoods of the partially-updated states, update
weights with the telescoping log-likelihood delta, and resample when the
KL divergence of the weights from uniform exceeds ``max_kl_divergence``.
The per-pixel occlusion chain is filtered analytically inside the
observation model (models/image_loglik.py) — its posterior map is a leaf of
the belief pytree and follows particle lineages through resampling by a
plain gather.

Everything here is a pure function of (belief, observation) → belief, built
to sit under one ``jax.jit`` (or ``shard_map`` for multi-chip — parallel/).
The observation model is injected as ``loglik_fn`` (the D16 ``RbSensor``
contract): ``loglik_fn(states [P,K,13], occ [P,N], z [N], dt) →
(loglik [P], occ_post [P,N])``, letting the XLA raycast and the fused
Pallas kernel interchange exactly like the reference's CPU/GPU sensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from dbot_ros_tpu.models.transition import TransitionParams, sample_transition
from dbot_ros_tpu.ops import resample as rs
from dbot_ros_tpu.utils import se3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParticleBelief:
    """Belief pytree: weighted particles + RB occlusion maps + RNG state."""

    states: jax.Array       # (P, K, 13) particle poses+velocities, K objects
    log_weights: jax.Array  # (P,) unnormalized log weights
    occlusion: jax.Array    # (P, N) per-pixel occlusion probabilities
    key: jax.Array          # PRNG key

    @property
    def num_particles(self) -> int:
        return self.states.shape[0]

    @property
    def num_objects(self) -> int:
        return self.states.shape[1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StepInfo:
    """Per-frame diagnostics (the reference's PV/ROS_INFO analog, §5)."""

    mean_state: jax.Array    # (K, 13)
    ess: jax.Array           # scalar, after the last block
    kl: jax.Array            # scalar KL(w ‖ uniform) before resampling
    resampled: jax.Array     # bool: any block triggered resampling
    mean_loglik: jax.Array   # scalar


def init_belief(key, initial_poses, num_particles: int, num_pixels: int,
                initial_occlusion_prob=0.1, sensor=None,
                hypothesis_logits=None) -> ParticleBelief:
    """Initialize all particles at the given poses with zero velocity.

    Mirrors ``ParticleTracker::on_initialize`` (D19): set particles to the
    initial pose(s), uniform weights; the first ``track`` call diversifies
    them through the transition noise (the reference additionally resamples
    to ``evaluation_count``, which is a no-op for identical particles).

    Multi-hypothesis init: pass ``initial_poses`` of shape (H, K, 7) with
    ``hypothesis_logits`` (H,) — particles are allocated across the
    hypotheses proportional to ``softmax(logits)`` (systematic, so the
    split is deterministic given the key). The first frames of tracking
    then resolve the ambiguity by likelihood — the Bayesian answer to
    near-symmetric initialization twins (the automatic initializer's
    known failure mode, R9/R11): a clearly-wrong hypothesis dies in a
    few resamples, a genuine tie persists until evidence arrives.

    If ``sensor`` provides ``init_occlusion`` (e.g. the fused Pallas
    sensor with its device-layout occlusion state), the occlusion leaf is
    created by the sensor; otherwise it is the standard (P, N) map.
    """
    initial_poses = jnp.asarray(initial_poses, jnp.float32)
    if hypothesis_logits is not None:
        if initial_poses.ndim == 2:          # (H, 7) single object
            initial_poses = initial_poses[:, None]
        key, k_h = jax.random.split(key)
        logits = jnp.asarray(hypothesis_logits, jnp.float32)
        assign = rs.systematic_indices(k_h, logits, num_particles)
        k = initial_poses.shape[1]
        states = jnp.zeros((num_particles, k, 13), jnp.float32)
        states = states.at[..., :7].set(initial_poses[assign])
    else:
        if initial_poses.ndim == 1:
            initial_poses = initial_poses[None]
        k = initial_poses.shape[0]
        states = jnp.zeros((num_particles, k, 13), jnp.float32)
        states = states.at[..., :7].set(initial_poses[None])
    if sensor is not None and hasattr(sensor, "init_occlusion"):
        occ = sensor.init_occlusion(num_particles, initial_occlusion_prob)
    else:
        occ = jnp.full((num_particles, num_pixels),
                       jnp.float32(initial_occlusion_prob))
    return ParticleBelief(
        states=states,
        log_weights=jnp.zeros((num_particles,), jnp.float32),
        occlusion=occ,
        key=key,
    )


_NEVER_RESAMPLE_KL = 1e8


def _maybe_resample(key, log_w, states, occ, old_loglik, max_kl,
                    occ_gather):
    """KL-triggered systematic resampling of (states, occ, old_loglik).

    ``occ_gather(occ, idx)`` performs the occlusion lineage gather — the
    default particle-axis take, or a sensor-provided device-layout gather
    (the reference's CUDA scatter/gather of persistent occlusion arrays,
    D13, reduced to one hook).

    The trigger is NOT a ``lax.cond``: conditional outputs aliasing
    donated operands force full-map copies of the occlusion state.
    Instead the parent vector is ``where``-selected between systematic
    parents and identity, and the gather runs unconditionally — one
    bandwidth-bound map pass every frame, no copies on resample frames.
    Statically-disabled resampling
    (``max_kl >= 1e8``) skips all of it at trace time.
    """
    kl = rs.kl_to_uniform(log_w)
    if max_kl >= _NEVER_RESAMPLE_KL:
        return (states, occ, old_loglik), log_w, jnp.bool_(False), kl
    p = log_w.shape[-1]
    do = kl > max_kl
    idx = jnp.where(do, rs.systematic_indices(key, log_w, p),
                    jnp.arange(p, dtype=jnp.int32))
    # mode='clip': idx is in-bounds by construction; the default fill
    # mode emits a full-size bounds-guard select over the map
    tree = (jnp.take(states, idx, axis=0, mode="clip"),
            occ_gather(occ, idx),
            jnp.take(old_loglik, idx, axis=0, mode="clip"))
    log_w2 = jnp.where(do, jnp.zeros_like(log_w), log_w)
    return tree, log_w2, do, kl


def rbcpf_step(belief: ParticleBelief, z_obs, loglik_fn: Callable,
               trans_params: TransitionParams, dt,
               max_kl_divergence=1.0):
    """One filter step (one depth frame) → (new belief, StepInfo).

    The block loop is unrolled over the (static, small) object count, exactly
    the reference's sequential coordinate blocks; resampling may trigger
    after every block (D17 behavior), using the intermediate weights.
    """
    num_objects = belief.num_objects
    occ_gather = getattr(loglik_fn, "gather_occlusion", None) or (
        lambda occ, idx: jnp.take(occ, idx, axis=0, mode="clip"))
    key, k_res_base, *block_keys = jax.random.split(
        belief.key, 2 + num_objects)

    states = belief.states
    occ = belief.occlusion
    log_w = belief.log_weights
    old_loglik = jnp.zeros_like(log_w)
    resampled_any = jnp.bool_(False)
    kl_last = jnp.float32(0.0)
    loglik = old_loglik

    for b in range(num_objects):
        # --- sample block b from the transition (only object b moves)
        new_block = sample_transition(block_keys[b], states[:, b], dt,
                                      trans_params)
        states = states.at[:, b].set(new_block)

        # --- evaluate; occlusion posterior only committed on the last block
        update = b == num_objects - 1
        loglik, occ_post = loglik_fn(states, occ, z_obs, dt)
        if update:
            occ = occ_post

        # --- telescoping weight update
        log_w = log_w + loglik - old_loglik
        old_loglik = loglik

        # --- KL-triggered resampling (also remaps the running loglik)
        k_res = jax.random.fold_in(k_res_base, b)
        (states, occ, old_loglik), log_w, did, kl_last = _maybe_resample(
            k_res, log_w, states, occ, old_loglik, max_kl_divergence,
            occ_gather)
        resampled_any = resampled_any | did

    ln, _ = rs.normalize_log_weights(log_w)
    weights = jnp.exp(ln)
    mean_state = jax.vmap(
        lambda s: se3.states_mean(s, weights), in_axes=1)(states)

    new_belief = ParticleBelief(states=states, log_weights=log_w,
                                occlusion=occ, key=key)
    info = StepInfo(mean_state=mean_state,
                    ess=rs.effective_sample_size(log_w),
                    kl=kl_last,
                    resampled=resampled_any,
                    mean_loglik=jnp.sum(weights * loglik))
    return new_belief, info

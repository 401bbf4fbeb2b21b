"""Unscented (sigma-point) transform on the SE(3) state manifold.

Replaces ``fl/filter/gaussian/transform/unscented_transform.hpp`` and
``sigma_point_quadrature.hpp`` (F2): sigma points are generated in the
12-dim tangent space of the 13-dim pose-velocity state (utils/se3 boxplus/
boxminus), so the quaternion stays on the manifold — the batched analog
of the reference's Euler-vector-chart sigma points.

All returns are batched arrays; the 2n+1 = 25 sigma points ride a leading
axis that downstream code treats exactly like a (small) particle axis, so
the Gaussian tracker shares the render/likelihood path with the particle
tracker (same structural sharing as the reference's D5/D9 reuse).
"""

from __future__ import annotations

import jax.numpy as jnp

from dbot_ros_tpu.utils import se3

TANGENT_DIM = se3.TANGENT_DIM  # 12


def unscented_weights(n: int = TANGENT_DIM, alpha: float = 1.0,
                      beta: float = 2.0, kappa: float = 0.0):
    """Standard UT weights (Wan–van der Merwe parametrization).

    Defaults (alpha=1, kappa=0 → lambda=0 ... degenerate) — we use
    kappa = 3 - n semantics via alpha/kappa args; callers use
    :func:`default_ut_params` unless overriding.
    """
    lam = alpha * alpha * (n + kappa) - n
    wm0 = lam / (n + lam)
    wc0 = wm0 + (1.0 - alpha * alpha + beta)
    wi = 1.0 / (2.0 * (n + lam))
    w_mean = jnp.concatenate([jnp.array([wm0]), jnp.full((2 * n,), wi)])
    w_cov = jnp.concatenate([jnp.array([wc0]), jnp.full((2 * n,), wi)])
    return w_mean.astype(jnp.float32), w_cov.astype(jnp.float32), lam


def default_ut_params(n: int = TANGENT_DIM):
    """alpha=1, beta=2 (Gaussian-optimal), kappa=1 → lambda=1 > 0."""
    return dict(alpha=1.0, beta=2.0, kappa=1.0)


def sigma_points(mean_state, cov, alpha=1.0, beta=2.0, kappa=1.0):
    """Generate 2n+1 sigma states around (mean_state (13,), cov (12,12)).

    Returns (states (2n+1, 13), tangents (2n+1, 12), w_mean, w_cov).
    ``tangents`` are the deviations in the tangent space at mean_state —
    exactly what the statistical linearization in the update needs.
    """
    n = cov.shape[-1]
    w_mean, w_cov, lam = unscented_weights(n, alpha, beta, kappa)
    # Cholesky of (n + lam) * cov; jitter for PSD safety.
    scaled = (n + lam) * cov + 1e-12 * jnp.eye(n, dtype=cov.dtype)
    L = jnp.linalg.cholesky(scaled)              # (n, n), lower
    deltas = jnp.concatenate([
        jnp.zeros((1, n), cov.dtype), L.T, -L.T], axis=0)  # (2n+1, n)
    states = se3.state_boxplus(mean_state[None, :], deltas)
    return states, deltas, w_mean, w_cov


def scene_sigma_points(mean_states, cov, alpha=1.0, beta=2.0, kappa=1.0):
    """Sigma points for a K-object scene (joint tangent space).

    Args:
      mean_states: (K, 13); cov: (12K, 12K) joint tangent covariance
        (inter-object correlations welcome — mutual occlusion induces
        them through the joint update).
    Returns (states (2n+1, K, 13), deltas (2n+1, 12K), w_mean, w_cov).
    """
    K = mean_states.shape[0]
    n = cov.shape[-1]
    w_mean, w_cov, lam = unscented_weights(n, alpha, beta, kappa)
    scaled = (n + lam) * cov + 1e-12 * jnp.eye(n, dtype=cov.dtype)
    L = jnp.linalg.cholesky(scaled)
    deltas = jnp.concatenate([
        jnp.zeros((1, n), cov.dtype), L.T, -L.T], axis=0)  # (2n+1, n)
    states = se3.state_boxplus(mean_states[None],
                               deltas.reshape(-1, K, TANGENT_DIM))
    return states, deltas, w_mean, w_cov


def scene_reconstruct_moments(states, ref_states, w_mean, w_cov):
    """Joint tangent moments of scene sigma states (K objects).

    Args: states (S, K, 13), ref_states (K, 13).
    Returns (mean_states (K, 13), cov (12K, 12K), centered (S, 12K)).
    """
    S = states.shape[0]
    tangents = se3.state_boxminus(states, ref_states[None]).reshape(S, -1)
    mean_t = jnp.einsum("s,st->t", w_mean, tangents)
    mean_states = se3.state_boxplus(
        ref_states, mean_t.reshape(-1, TANGENT_DIM))
    centered = tangents - mean_t[None, :]
    cov = jnp.einsum("s,si,sj->ij", w_cov, centered, centered)
    return mean_states, cov, centered


def reconstruct_moments(states, ref_state, w_mean, w_cov):
    """Tangent-space mean/cov of sigma states, referenced at ``ref_state``.

    Returns (mean_state (13,), cov (12,12), centered_tangents (2n+1, 12)).
    """
    tangents = se3.state_boxminus(states, ref_state[None, :])  # (S, 12)
    mean_t = jnp.einsum("s,st->t", w_mean, tangents)
    mean_state = se3.state_boxplus(ref_state, mean_t)
    centered = tangents - mean_t[None, :]
    cov = jnp.einsum("s,si,sj->ij", w_cov, centered, centered)
    return mean_state, cov, centered

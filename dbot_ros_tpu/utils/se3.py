"""Batched SE(3) / SO(3) algebra on JAX arrays.

Batched replacement for the reference pose substrate
(``dbot/include/dbot/pose/pose_vector.h`` — ``PoseVector``/``EulerVector``/
``PoseVelocityVector``): instead of Eigen block-vector classes, poses are plain
arrays with a trailing structure axis, and every function maps over arbitrary
leading batch axes (particles, objects, sigma points) so XLA can vectorize.

Conventions
-----------
* Quaternions are ``(w, x, y, z)``, unit-norm, ``float32`` by default.
* Rotation vectors (axis-angle / so(3) exp-map coordinates) are ``(3,)`` —
  the reference's ``EulerVector`` stores the same chart.
* A pose is ``(7,) = [tx, ty, tz, qw, qx, qy, qz]`` acting as
  ``x_world = R(q) @ x_obj + t``.
* A pose-velocity state is ``(13,) = pose(7) ++ v_lin(3) ++ v_ang(3)``,
  mirroring the reference's 12-dim ``PoseVelocityVector`` (we carry the
  4-component quaternion instead of a 3-component chart in the state, and do
  noise/updates in the 6-dim tangent space).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Small angle threshold below which Taylor expansions are used.
_EPS = 1e-8


# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------

def quat_identity(batch_shape=(), dtype=jnp.float32):
    """Identity quaternion broadcast to ``batch_shape + (4,)``."""
    q = jnp.zeros(tuple(batch_shape) + (4,), dtype).at[..., 0].set(1.0)
    return q


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_multiply(q1, q2):
    """Hamilton product; composition of rotations: R(q1 ⊗ q2) = R(q1) R(q2)."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by quaternions ``q[..., 4]``.

    Uses the 2-cross-product form (15 mul + 15 add), cheaper than building the
    rotation matrix for a single vector.
    """
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_to_matrix(q):
    """Unit quaternion → rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix ``[..., 3, 3]`` → unit quaternion (w ≥ 0 branch-safe).

    Shepperd's method via the four candidate magnitudes, numerically stable for
    all rotations (no trace-only branch).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    # Four candidate (unnormalized) quaternions, one per dominant component.
    qw = jnp.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    diag = jnp.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
         1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = jnp.argmax(diag, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)
    q = q[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# so(3) exp / log maps  (reference: EulerVector axis-angle chart)
# ---------------------------------------------------------------------------

def so3_exp_quat(w):
    """Rotation vector ``w[..., 3]`` → quaternion, small-angle safe."""
    theta_sq = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS * _EPS))
    half = 0.5 * theta
    small = theta_sq < _EPS
    # sin(t/2)/t  with Taylor fallback  1/2 - t^2/48
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
    qw = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([qw, k * w], axis=-1))


def so3_log(q):
    """Quaternion → rotation vector (inverse of :func:`so3_exp_quat`)."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    qw = jnp.clip(q[..., :1], -1.0, 1.0)
    qv = q[..., 1:]
    sin_half = jnp.linalg.norm(qv, axis=-1, keepdims=True)
    half = jnp.arctan2(sin_half, qw)
    small = sin_half < _EPS
    # w = 2*half * qv/sin(half); small angle: qv ≈ (theta/2) axis → w ≈ 2 qv
    scale = jnp.where(small, 2.0, 2.0 * half / jnp.maximum(sin_half, _EPS))
    return scale * qv


def quat_boxplus(q, w):
    """Perturb rotation on the left by tangent vector ``w``: exp(w) ⊗ q."""
    return quat_multiply(so3_exp_quat(w), q)


def quat_boxminus(q1, q2):
    """Left tangent difference: log(q1 ⊗ q2⁻¹) so that q2 ⊞ (q1 ⊟ q2) = q1."""
    return so3_log(quat_multiply(q1, quat_conjugate(q2)))


# ---------------------------------------------------------------------------
# Poses  (7,) = [t(3), q(4)]
# ---------------------------------------------------------------------------

def pose_identity(batch_shape=(), dtype=jnp.float32):
    t = jnp.zeros(tuple(batch_shape) + (3,), dtype)
    return jnp.concatenate([t, quat_identity(batch_shape, dtype)], axis=-1)


def make_pose(t, q):
    return jnp.concatenate([t, q], axis=-1)


def pose_trans(p):
    return p[..., :3]


def pose_quat(p):
    return p[..., 3:7]


def pose_apply(p, v):
    """Apply pose to points ``v[..., 3]``: R v + t."""
    return quat_rotate(pose_quat(p), v) + pose_trans(p)


def pose_compose(p1, p2):
    """(p1 ∘ p2)(x) = p1(p2(x))."""
    t = quat_rotate(pose_quat(p1), pose_trans(p2)) + pose_trans(p1)
    q = quat_multiply(pose_quat(p1), pose_quat(p2))
    return make_pose(t, q)


def pose_inverse(p):
    qi = quat_conjugate(pose_quat(p))
    return make_pose(-quat_rotate(qi, pose_trans(p)), qi)


def pose_to_matrix(p):
    """Pose → homogeneous transform ``[..., 4, 4]``."""
    R = quat_to_matrix(pose_quat(p))
    t = pose_trans(p)[..., :, None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def matrix_to_pose(m):
    return make_pose(m[..., :3, 3], matrix_to_quat(m[..., :3, :3]))


def pose_boxplus(p, xi):
    """Perturb pose by tangent ``xi[..., 6] = [dt(3), dw(3)]``.

    Translation is perturbed additively in world frame, rotation on the left —
    matching the reference's Brownian motion which diffuses position and
    orientation independently (brownian_object_motion_model.h semantics).
    """
    t = pose_trans(p) + xi[..., :3]
    q = quat_boxplus(pose_quat(p), xi[..., 3:6])
    return make_pose(t, q)


def pose_boxminus(p1, p2):
    """Tangent difference s.t. ``p2 ⊞ (p1 ⊟ p2) = p1`` under pose_boxplus."""
    dt = pose_trans(p1) - pose_trans(p2)
    dw = quat_boxminus(pose_quat(p1), pose_quat(p2))
    return jnp.concatenate([dt, dw], axis=-1)


# ---------------------------------------------------------------------------
# Pose-velocity states  (13,) = [pose(7), v_lin(3), v_ang(3)]
# Reference: PoseVelocityVector (12-dim; 3-dim orientation chart).
# ---------------------------------------------------------------------------

STATE_DIM = 13
TANGENT_DIM = 12


def state_identity(batch_shape=(), dtype=jnp.float32):
    v = jnp.zeros(tuple(batch_shape) + (6,), dtype)
    return jnp.concatenate([pose_identity(batch_shape, dtype), v], axis=-1)


def state_pose(s):
    return s[..., :7]


def state_velocity(s):
    """Returns ``[..., 6]`` = [v_lin, v_ang]."""
    return s[..., 7:13]


def make_state(pose, velocity):
    return jnp.concatenate([pose, velocity], axis=-1)


def state_boxplus(s, xi):
    """Perturb a 13-dim state by a 12-dim tangent [dpose(6), dvel(6)]."""
    p = pose_boxplus(state_pose(s), xi[..., :6])
    v = state_velocity(s) + xi[..., 6:12]
    return make_state(p, v)


def state_boxminus(s1, s2):
    dp = pose_boxminus(state_pose(s1), state_pose(s2))
    dv = state_velocity(s1) - state_velocity(s2)
    return jnp.concatenate([dp, dv], axis=-1)


def states_mean(states, weights=None):
    """Weighted mean of states ``[N, ..., 13]`` over the leading axis.

    Position/velocity: arithmetic mean. Orientation: chordal mean via the
    weighted outer-product eigenvector method (Markley), which is exact for
    the quaternion L2 chordal metric and robust to sign ambiguity — the
    batched analog of the reference's ``SumOfDeltas::mean()``.
    """
    if weights is None:
        n = states.shape[0]
        weights = jnp.full((n,), 1.0 / n, states.dtype)
    wshape = (states.shape[0],) + (1,) * (states.ndim - 1)
    w = weights.reshape(wshape)
    lin = jnp.sum(w * states, axis=0)  # fine for t and v; quat needs care
    q = state_pose(states)[..., 3:7]
    A = jnp.sum(w[..., None] * q[..., :, None] * q[..., None, :], axis=0)
    # Principal eigenvector of the 4x4 PSD accumulator by power iteration
    # (a dozen 4-vector matvecs — far cheaper under jit than eigh, and
    # this runs inside the per-frame hot path). Init from the dominant
    # diagonal column; for a concentrated quaternion cloud λ1 ≫ λ2 so
    # convergence is immediate.
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    init = jnp.take_along_axis(
        A, jnp.argmax(diag, axis=-1)[..., None, None].repeat(4, -2),
        axis=-1)[..., 0]
    qm = init / jnp.linalg.norm(init, axis=-1, keepdims=True)
    for _ in range(12):
        qm = jnp.einsum("...ij,...j->...i", A, qm)
        qm = qm / jnp.maximum(jnp.linalg.norm(qm, axis=-1, keepdims=True),
                              1e-20)
    qm = qm * jnp.where(qm[..., :1] < 0, -1.0, 1.0)
    return jnp.concatenate([lin[..., :3], qm, lin[..., 7:13]], axis=-1)


# ---------------------------------------------------------------------------
# Symmetry-aware rotation error (evaluation metric)
# ---------------------------------------------------------------------------

def box_symmetry_quats(include_identity: bool = True):
    """Proper rotational symmetry group of a generic cuboid (distinct
    extents): {identity, pi about x, pi about y, pi about z}.

    A plain-quaternion rotation error is meaningless against a box —
    the pose is only identifiable up to this group (without the
    quotient, two-object box RMSE mixes genuine error with
    symmetry aliasing).
    """
    quats = [jnp.array([1.0, 0.0, 0.0, 0.0])] if include_identity else []
    for ax in range(3):
        v = jnp.zeros((3,)).at[ax].set(jnp.pi)
        quats.append(so3_exp_quat(v))
    return jnp.stack(quats)


def rotation_error_symmetric(q_est, q_gt, sym_quats):
    """Rotation error modulo a discrete symmetry group.

    ``min_s ||log(q_est ⊗ (q_gt ⊗ s)⁻¹)||`` over ``sym_quats`` (S, 4):
    the smallest geodesic distance from the estimate to ANY equivalent
    ground-truth orientation. Shapes: q_est/q_gt (..., 4) broadcast
    against the group axis.
    """
    sym_quats = jnp.asarray(sym_quats, jnp.float32)
    cand = quat_multiply(q_gt[..., None, :],
                         sym_quats[(None,) * (q_gt.ndim - 1)])
    err = jnp.linalg.norm(
        quat_boxminus(q_est[..., None, :], cand), axis=-1)
    return jnp.min(err, axis=-1)

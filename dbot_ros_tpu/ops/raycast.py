"""Batched depth rendering by ray-triangle intersection.

Replacement for the reference's two renderers:

* ``dbot/rigid_body_renderer.cpp`` — CPU triangle rasterizer used by the CPU
  observation model and the simulation nodes;
* ``dbot/gpu/object_rasterizer.cpp`` (OpenGL tiled FBO) feeding
  ``dbot/gpu/cuda_likelihood_evaluator.cu``.

Instead of rasterizing (scatter into a z-buffer — hostile to XLA), we raycast
with a **matmul formulation**: per particle, the pose-transformed
Möller–Trumbore constants form a ``(3T, 3)`` matrix ``G`` such that

    rays (N, 3) @ Gᵀ (3, 3T)  →  (N, 3T) = [u_num | v_num | det] per triangle,

one contraction per (particle, pixel-block, triangle-block); the ray
parameter ``t = t_num / det`` needs no per-ray matmul at all (see
utils/mesh.py for the derivation and the affine pose-update of the
constants). Validity tests and the min-over-triangles depth reduce are
cheap elementwise ops. With z=1 pixel rays, ``t`` equals z-depth directly.

Two implementations:
  * :func:`raycast_oracle` — classic per-ray Möller–Trumbore via transformed
    vertices; slow, used as the golden reference in tests.
  * :func:`raycast_depth` — the production chunked XLA path (scan over
    triangle blocks, running min), memory-bounded for any particle count.

The fused render+likelihood kernel (ops/raycast_pallas.py) reuses the same
constants.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.mesh import TriangleMesh

_DET_EPS = 1e-12
_NEAR = 1e-4
MISS_DEPTH = jnp.inf


# ---------------------------------------------------------------------------
# Pose → per-particle intersection constants
# ---------------------------------------------------------------------------

def pose_tri_constants(mesh: TriangleMesh, poses):
    """Transform object-frame constants by poses ``[..., 7]``.

    Returns ``(G, t_num)`` with ``G [..., T, 3, 3]`` stacking rows
    ``[g_u; g_v; g_det]`` and ``t_num [..., T]``. Cost is O(T) small matmuls
    per pose — done once per filter step, negligible next to the raycast.
    """
    R = se3.quat_to_matrix(se3.pose_quat(poses))          # [..., 3, 3]
    tau = se3.pose_trans(poses)[..., None, :]             # [..., 1, 3]

    def rot(x):  # rows x[t] → R x[t]; tiny matmul, keep full f32 precision
        return jnp.einsum("...ij,tj->...ti", R, x,
                          precision=jax.lax.Precision.HIGHEST)

    Rg_det = rot(mesh.g_det)
    Re1 = rot(mesh.tri_e1)
    Re2 = rot(mesh.tri_e2)
    g_u = rot(mesh.g_u) + jnp.cross(tau, Re2)
    g_v = rot(mesh.g_v) - jnp.cross(tau, Re1)
    t_num = mesh.t_num + jnp.einsum("...ti,...i->...t", Rg_det,
                                    tau[..., 0, :],
                                    precision=jax.lax.Precision.HIGHEST)
    G = jnp.stack([g_u, g_v, Rg_det], axis=-2)            # [..., T, 3, 3]
    return G, t_num


def _intersect_from_numerators(u_num, v_num, det, t_num, near=_NEAR,
                               slack=0.0):
    """Shared hit test: numerators → per-triangle ray parameter (inf = miss).

    Multiplies the barycentric conditions through by sign(det) so both
    winding orientations are hit (the reference renders back faces too —
    depth-only pass with culling disabled) and no division happens before
    validity is known.

    ``slack`` relaxes the inside-test by that many barycentric units,
    accepting hits on the triangle's PLANE near its footprint — used by
    the candidate-set (deferred/fused) paths, where per-pixel candidate
    ids sampled at pixel centers structurally miss sub-pixel triangles
    (see raycast_pallas.FusedSensor.bary_slack). Exact paths use 0.
    """
    s = jnp.sign(det)
    adet = jnp.abs(det)
    sa = slack * adet
    valid = (
        (adet > _DET_EPS)
        & (s * u_num >= -sa)
        & (s * v_num >= -sa)
        & (s * (u_num + v_num) <= adet + sa)
        & (s * t_num > near * adet)
    )
    t = jnp.where(valid, t_num / jnp.where(adet > _DET_EPS, det, 1.0),
                  MISS_DEPTH)
    return t


# ---------------------------------------------------------------------------
# Production path: chunked matmul raycast
# ---------------------------------------------------------------------------

def raycast_depth(mesh: TriangleMesh, poses, rays, tri_chunk: int = 512):
    """Depth per pixel for each pose: ``[..., N]`` (inf where no hit).

    Args:
      mesh: TriangleMesh (padded; degenerate padding never hits).
      poses: ``[..., 7]`` poses (camera frame ← object frame).
      rays: ``(N, 3)`` pixel rays with z = 1 (CameraModel.rays).
      tri_chunk: triangle block size for the scan (bounds live memory at
        ``batch × N × tri_chunk`` floats).
    """
    G, t_num = pose_tri_constants(mesh, poses)            # [...,T,3,3], [...,T]
    T = G.shape[-3]
    tri_chunk = min(tri_chunk, T)
    if T % tri_chunk != 0:
        # Pad with degenerate triangles (g = 0 → det = 0 → never hit).
        pad = tri_chunk - T % tri_chunk
        G = jnp.concatenate(
            [G, jnp.zeros(G.shape[:-3] + (pad, 3, 3), G.dtype)], axis=-3)
        t_num = jnp.concatenate(
            [t_num, jnp.zeros(t_num.shape[:-1] + (pad,), t_num.dtype)],
            axis=-1)
        T += pad
    n_chunks = T // tri_chunk
    batch_shape = G.shape[:-3]
    N = rays.shape[0]

    Gc = G.reshape(batch_shape + (n_chunks, tri_chunk * 3, 3))
    tc = t_num.reshape(batch_shape + (n_chunks, tri_chunk))
    # scan axis first
    Gc = jnp.moveaxis(Gc, -3, 0)
    tc = jnp.moveaxis(tc, -2, 0)

    def body(zmin, chunk):
        g, tn = chunk                                    # [..., 3Tc, 3], [..., Tc]
        # Full f32 products: the GPU's default f32 dot is TF32 (10-bit
        # mantissa), a ~mm depth error at 1 m. This is the reference the
        # candidate-set paths are tested against.
        nums = jnp.einsum("nd,...md->...nm", rays, g,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        nums = nums.reshape(nums.shape[:-1] + (tri_chunk, 3))
        t = _intersect_from_numerators(
            nums[..., 0], nums[..., 1], nums[..., 2], tn[..., None, :])
        return jnp.minimum(zmin, jnp.min(t, axis=-1)), None

    z0 = jnp.full(batch_shape + (N,), MISS_DEPTH, jnp.float32)
    zmin, _ = jax.lax.scan(body, z0, (Gc, tc))
    return zmin


# ---------------------------------------------------------------------------
# Oracle: classic Möller–Trumbore on transformed vertices (test reference)
# ---------------------------------------------------------------------------

def raycast_oracle(mesh: TriangleMesh, pose, rays, near=_NEAR):
    """Golden-path raycast for one pose ``(7,)`` → depth ``(N,)``.

    Independent derivation (transform vertices, textbook pvec/qvec MT) used
    to validate :func:`raycast_depth` and the Pallas kernel.
    """
    v = se3.pose_apply(pose, mesh.vertices)               # (V, 3)
    a = v[mesh.faces[:, 0]]                               # (T, 3)
    b = v[mesh.faces[:, 1]]
    c = v[mesh.faces[:, 2]]
    e1, e2 = b - a, c - a

    def per_ray(d):
        pvec = jnp.cross(d[None, :], e2)                  # (T, 3)
        det = jnp.sum(e1 * pvec, axis=-1)
        tvec = -a                                         # origin 0
        u = jnp.sum(tvec * pvec, axis=-1)
        qvec = jnp.cross(tvec, e1)
        vv = jnp.sum(d[None, :] * qvec, axis=-1)
        tn = jnp.sum(e2 * qvec, axis=-1)
        t = _intersect_from_numerators(u, vv, det, tn, near)
        return jnp.min(t)

    return jax.vmap(per_ray)(rays)


def render_depth_image(mesh: TriangleMesh, poses, camera, tri_chunk=512):
    """Depth images ``[..., H, W]`` for poses, via the production raycast."""
    z = raycast_depth(mesh, poses, camera.rays, tri_chunk)
    return z.reshape(z.shape[:-1] + (camera.height, camera.width))

"""Fused kernel: candidate raycast + beam likelihood + occlusion update.

This is the D12+D13 replacement at full depth (SURVEY.md hard part #1):
where the reference rasterizes every particle into a tiled GL texture and
scores it with a CUDA kernel (round-tripping P×H×W depth through device
memory), this kernel never materializes per-particle depth at all —

    for each (particle tile, pixel chunk) program, for each pixel of the
    chunk, for each candidate triangle: load the tile's transformed
    constants → intersect → min-depth → beam densities → occlusion
    posterior → accumulate log p(z)

with every intermediate in registers. Inputs per frame:

  * ``gt``: (T, 10·Pr, 128) f32 — per-triangle slabs of every particle's
    transformed Möller–Trumbore constants (10 components × P particles,
    particles contiguous). Built by XLA from utils/mesh constants (one
    GEMM per frame).
  * candidate ids (Npad, K) int32 from the deferred reference pass
    (ops/deferred.py); -1 is pre-mapped to the guaranteed-degenerate last
    triangle row (det = 0 → miss).
  * occlusion map in pixel-major kernel layout (Npad·Pr, 128): a pixel's
    particles are contiguous, so a particle tile is one coalesced row
    segment.

The kernel is written for Pallas' Triton route. Its grid is (particle
tiles × pixel chunks); nothing carries between programs: each program
writes its chunk's partial log-likelihood row, and XLA sums the
(n_chunks, P) partials — deterministic, no atomics. Programs load their
pixels' candidate ids and rays themselves.

The beam/occlusion math mirrors models/beam.py + models/image_loglik.py
exactly, except the truncated-Gaussian normalizer is taken as 1 (erf-free;
the truncation correction is < 1e-6 except within ~5σ of the sensor range
limits). :func:`fused_loglik_reference` is the same computation in plain
``jnp`` — the kernel's test oracle.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dbot_ros_tpu.models.beam import BeamParams
from dbot_ros_tpu.models.occlusion import OcclusionParams
from dbot_ros_tpu.utils.mesh import TriangleMesh

_SQRT2PI = 2.5066282746310002
_TINY = 1e-30
_DET_EPS = 1e-12
_NEAR = 1e-4
_BIG = 1e30

# Kernel tiling (see fused_loglik_packed). A program covers
# _LANE_BLOCK particles × _PIX_BLOCK pixels; particle padding rounds to
# _LANE_BLOCK so tiles never need masks. Tuned on an H100 at 10k
# particles (benchmarks/kernel_ab.py --tune): 256 lanes beat 128 and 512
# at 2–4 warps; at the tight compaction level, which the operating point
# runs every frame (448 px → 56 chunks × 40 tiles = 2240 programs),
# 8 or 16 pixels per program with 4 warps and 2 or 3 stages read within
# the spread of repeated readings (PERF.md); 8 / 4 / 2 is kept.
_LANE_BLOCK = 256
_PIX_BLOCK = 8
_NUM_WARPS = 4
_NUM_STAGES = 2


def _round_up(x, m):
    return (x + m - 1) // m * m


def _particle_pads(num_particles: int):
    """(p_pad, pr): the particle axis pads to a multiple of the kernel's
    particle tile (_LANE_BLOCK lanes), viewed as pr rows of 128."""
    p_pad = _round_up(max(num_particles, 1), _LANE_BLOCK)
    return p_pad, p_pad // 128


def resolve_interpret(interpret):
    """The Pallas interpreter runs only when a caller asks for it.

    ``interpret=True`` → interpreter (any backend, e.g. CPU tests);
    otherwise the kernel compiles for the GPU, and any other backend is
    an error rather than a silent slow fallback.
    """
    if interpret:
        return True
    backend = jax.default_backend()
    if backend != "gpu":
        raise ValueError(
            f"the fused likelihood kernel compiles only for the GPU "
            f"(JAX backend is {backend!r}); pass interpret=True to run it "
            f"in the Pallas interpreter")
    return False


# ---------------------------------------------------------------------------
# XLA pre-pass: pack per-particle constants into per-triangle slabs
# ---------------------------------------------------------------------------

def _levi_civita():
    eps = jnp.zeros((3, 3, 3), jnp.float32)
    for (i, j, k), s in (((0, 1, 2), 1.0), ((1, 2, 0), 1.0),
                         ((2, 0, 1), 1.0), ((0, 2, 1), -1.0),
                         ((2, 1, 0), -1.0), ((1, 0, 2), -1.0)):
        eps = eps.at[i, j, k].set(s)
    return eps


def pack_matrix(mesh: TriangleMesh):
    """Static coefficient tensor M (T, 10, 37) of the pack matmul.

    Every transformed Möller–Trumbore constant is linear in the 37-dim
    pose-feature vector F = [1 | vec(R) (9) | vec(τ ⊗ R) (27)]:

        g_u'   = R g_u + τ × (R e2)      g_det' = R g_det
        g_v'   = R g_v − τ × (R e1)      t_num' = t_num + τ · (R g_det)

    so pack = M·F — one GEMM per frame instead of a chain of small
    einsums, bound by its own slab write (0.5 GB at 10k particles ×
    1280 triangles).

    Feature indexing: f=0 constant; f=1+3i+j ↦ R[i,j];
    f=10+9a+3b+l ↦ τ[a]·R[b,l].
    """
    T = mesh.padded_triangles
    eye = jnp.eye(3, dtype=jnp.float32)
    eps = _levi_civita()

    def rot_block(g):  # coeff of output comp i on R[i,j]: g[t, j]
        return jnp.einsum("ik,tj->tikj", eye, g).reshape(T, 3, 9)

    def cross_block(e):  # coeff of (τ × (R e))_i on τ[a]R[b,l]: ε_iab e[t,l]
        return jnp.einsum("iab,tl->tiabl", eps, e).reshape(T, 3, 27)

    M = jnp.zeros((T, 10, 37), jnp.float32)
    M = M.at[:, 0:3, 1:10].set(rot_block(mesh.g_u))
    M = M.at[:, 0:3, 10:37].set(cross_block(mesh.tri_e2))
    M = M.at[:, 3:6, 1:10].set(rot_block(mesh.g_v))
    M = M.at[:, 3:6, 10:37].set(-cross_block(mesh.tri_e1))
    M = M.at[:, 6:9, 1:10].set(rot_block(mesh.g_det))
    M = M.at[:, 9, 0].set(mesh.t_num)
    # τ·(R g_det) = Σ τ[a] R[a,l] g_det[t,l]  → features with b == a
    M = M.at[:, 9, 10:37].set(
        jnp.einsum("ab,tl->tabl", eye, mesh.g_det).reshape(T, 27))
    return M


def pose_features(poses, p_pad: int):
    """poses (P, 7) → pose-feature matrix F (37, Pp) for the pack matmul.

    Padding particles have all-zero features (→ zero constants → det = 0 →
    miss for every ray).
    """
    from dbot_ros_tpu.utils import se3

    P = poses.shape[0]
    R = se3.quat_to_matrix(se3.pose_quat(poses))          # (P, 3, 3)
    tau = se3.pose_trans(poses)                           # (P, 3)
    F = jnp.concatenate([
        jnp.ones((P, 1), jnp.float32),
        R.reshape(P, 9),
        (tau[:, :, None, None] * R[:, None, :, :]).reshape(P, 27),
    ], axis=1)                                            # (P, 37)
    if p_pad != P:
        F = jnp.concatenate(
            [F, jnp.zeros((p_pad - P, 37), jnp.float32)], axis=0)
    return F.T                                            # (37, Pp)


def _pack_dot(M, features):
    """(R, 37K) @ (37K, Pp) in full f32.

    The barrier materializes both operands so the dot runs as one GEMM
    on stored operands. HIGHEST keeps f32 products: the GPU's default
    f32 dot is TF32 (10-bit mantissa), a ~mm geometry error at 1 m.
    """
    M, features = jax.lax.optimization_barrier((M, features))
    return jnp.dot(M, features, precision=jax.lax.Precision.HIGHEST)


def pack_constants(mesh: TriangleMesh, poses, p_pad: int, features=None,
                   M=None):
    """poses (P, 7) → (T, 10·Pr, 128) slabs, Pr = p_pad // 128.

    Slab rows: [g_u(3) | g_v(3) | g_det(3) | t_num] per component block of
    Pr rows; particles are contiguous. Padding particles have zero
    constants (det = 0 → miss for every ray).

    One f32 matmul (10T, 37) @ (37, Pp) straight into the transposed
    (triangle-major, particle-minor) layout: the slab tensor is written
    once.

    Pass a precomputed ``M`` (pack_matrix(mesh), static per mesh) in hot
    paths so its construction is not traced into every step.
    """
    T = mesh.padded_triangles
    if features is None:
        features = pose_features(poses, p_pad)
    if M is None:
        M = pack_matrix(mesh)
    packed = _pack_dot(M.reshape(T * 10, 37), features)   # (10T, Pp)
    return packed.reshape(T, 10 * (p_pad // 128), 128)


# ---------------------------------------------------------------------------
# Per-pixel math, shared by the kernel and the plain reference
# ---------------------------------------------------------------------------

def _intersect(c, dx, dy, dz, slack):
    """Candidate hit depth from its 10 constants (``c[i]`` broadcastable
    arrays); _BIG = miss.

    Barycentric slack: accept plane hits within ``slack`` of the triangle
    footprint. When mesh faces are finer than the pixel grid, the
    reference-pose id image structurally misses most of the triangles a
    displaced particle's ray actually hits (8 % candidate coverage for a
    6.7 mm shift at 10k particles, 80×60); the neighbor face's PLANE
    approximates the surface to O(face²·curvature) ≪ beam σ, so the
    slack restores coverage at no extra memory traffic.
    """
    u = c[0] * dx + c[1] * dy + c[2] * dz
    v = c[3] * dx + c[4] * dy + c[5] * dz
    det = c[6] * dx + c[7] * dy + c[8] * dz
    tn = c[9]
    sgn = jnp.sign(det)
    adet = jnp.abs(det)
    sa = slack * adet
    valid = ((adet > _DET_EPS)
             & (sgn * u >= -sa)
             & (sgn * v >= -sa)
             & (sgn * (u + v) <= adet + sa)
             & (sgn * tn > _NEAR * adet))
    return jnp.where(valid, tn / jnp.where(valid, det, 1.0), _BIG)


def _pixel_update(t, z, occ, age, prm):
    """Min candidate depth ``t`` → (log p(z), occlusion posterior).

    ``prm`` indexes the (16,) parameter vector (make_params_vec); ``occ``
    is the stored occlusion prior, ``age`` its lazy staleness in frames.
    """
    msig, sfac, wt, minz, maxz, lam = (prm(i) for i in range(6))
    p_inv_occ, p_inv_vis, p_inv_bg, occ_pi = (prm(i) for i in range(6, 10))
    inv_range, occ_lg, occ_dtf, occ_sgn = (prm(i) for i in range(11, 15))

    on_sil = t < _BIG * 0.5
    d = jnp.where(on_sil, t, 1.0)
    z_real = z == z                                     # NaN-safe
    z_valid = z_real & (z >= minz) & (z <= maxz)
    zz = jnp.where(z_real, z, 1.0)

    # Occlusion prior propagation (models/occlusion.py), lazily aged: the
    # stored map may be `age` frames stale (pixels the compaction ladder
    # skipped aren't rewritten — SURVEY hard part #3 without any full-map
    # traffic); the chain is propagated by (age + dt) in one closed-form
    # step, exactly equal to the eager per-frame recursion for g in [0, 1].
    geff = occ_sgn * jnp.exp(occ_lg * (age + occ_dtf))
    q = jnp.clip(occ_pi + geff * (occ - occ_pi), 0.0, 1.0)

    # beam densities (models/beam.py, truncation normalizer ≈ 1)
    sig = msig + sfac * d * d
    zn = (zz - d) / sig
    body_vis = jnp.exp(-0.5 * zn * zn) / (sig * _SQRT2PI)
    lik_vis = jnp.where(
        z_valid,
        ((1.0 - wt) * body_vis + wt * inv_range) * (1.0 - p_inv_vis),
        p_inv_vis)

    d_eff = jnp.clip(d, minz, maxz)
    span = jnp.maximum(d_eff - minz, 1e-6)
    norm_occ = jnp.maximum(1.0 - jnp.exp(-lam * span), 1e-6)
    body_occ = lam * jnp.exp(-lam * (zz - minz)) / norm_occ
    in_front = z_valid & (zz <= d_eff)
    lik_occ = jnp.where(
        z_real,
        ((1.0 - wt) * jnp.where(in_front, body_occ, 0.0)
         + wt * jnp.where(z_valid, inv_range, 0.0))
        * (1.0 - p_inv_occ),
        p_inv_occ)

    lik_bg = jnp.where(z_real,
                       jnp.where(z_valid, inv_range, 0.0) * (1.0 - p_inv_bg),
                       p_inv_bg)

    p_on = (1.0 - q) * lik_vis + q * lik_occ
    p_z = jnp.maximum(jnp.where(on_sil, p_on, lik_bg), _TINY)

    occ_post = q * lik_occ / jnp.maximum(p_on, _TINY)
    occ_post = jnp.where(on_sil, jnp.clip(occ_post, 0.0, 1.0), q)
    return jnp.log(p_z), occ_post


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _fused_kernel(cand_ref, pix_ref, params_ref, gt_ref, occ_ref,
                  occ_out_ref, ll_ref, *, K: int, bn: int, bp: int):
    """One program: particles [pt·bp, (pt+1)·bp) × pixels of chunk ch.

    Refs are whole arrays: cand (Npad, K) int32; pix (Npad, 8) f32 =
    [ray x, y, z | z_obs | age | 0…]; params (16,); gt (10T, Pp);
    occ / occ_out (Npad, Pp); ll (n_chunks, Pp) partial sums.
    """
    pt = pl.program_id(0)
    ch = pl.program_id(1)
    lanes = pl.ds(pl.multiple_of(pt * bp, bp), bp)

    params = [params_ref[i] for i in range(16)]
    prm = params.__getitem__
    slack = params[15]

    def body(j, acc):
        n = ch * bn + j
        dx, dy, dz = pix_ref[n, 0], pix_ref[n, 1], pix_ref[n, 2]
        t = None
        for k in range(K):
            row = cand_ref[n, k] * 10
            tk = _intersect([gt_ref[row + c, lanes] for c in range(10)],
                            dx, dy, dz, slack)
            t = tk if t is None else jnp.minimum(t, tk)
        occ = occ_ref[n, lanes].astype(jnp.float32)
        logp, post = _pixel_update(t, pix_ref[n, 3], occ, pix_ref[n, 4],
                                   prm)
        occ_out_ref[n, lanes] = post.astype(occ_out_ref.dtype)
        return acc + logp

    ll_ref[ch, lanes] = jax.lax.fori_loop(
        0, bn, body, jnp.zeros((bp,), jnp.float32))


# ---------------------------------------------------------------------------
# Host wrapper / sensor factory
# ---------------------------------------------------------------------------

def occ_to_kernel(occ_pn, nb: int = 64):
    """(P, N) particle-major occlusion → kernel layout (n_pad·pr, 128).

    The kernel layout is pixel-major: row ``n·pr + c`` lane ``l`` holds
    particle ``c·128 + l`` of pixel ``n`` — i.e. a free reshape of the
    padded (N, P) transpose. The fused sensor keeps its occlusion state
    in this layout ACROSS frames: converting every step would add a
    full-map transpose to every frame.
    """
    P, N = occ_pn.shape
    p_pad, pr = _particle_pads(P)
    n_pad = _round_up(N, nb)
    o = jnp.pad(occ_pn.T, ((0, n_pad - N), (0, p_pad - P)))
    return o.reshape(n_pad * pr, 128)


def occ_from_kernel(occ_k, num_pixels: int, num_particles: int,
                    nb: int = 64):
    """Inverse of :func:`occ_to_kernel` (diagnostics / checkpointing)."""
    p_pad, pr = _particle_pads(num_particles)
    n_pad = occ_k.shape[0] // pr
    return occ_k.reshape(n_pad, p_pad)[:num_pixels, :num_particles].T


def grouped_lane_gather(q, idx, n_pad: int, pr: int):
    """``out[n, p'] = q[n, idx[p']]`` on the flat kernel layout.

    XLA lowers a minor-axis ``take`` on the (n_pad, p_pad) view to
    transpose → gather → transpose. Systematic-resampling parents are
    *sorted*, so each 128-lane output group draws from few consecutive
    source row-groups:

      * span 1 (the degenerate/ESS-collapse regime — every resample at
        the tracked-object operating point): ONE row gather (rows move
        intact on the (n_pad, pr, 128) view) + one batched one-hot
        contraction for the intra-group lane permutation;
      * span ≤ 2 (near-uniform weights): two-group variant;
      * larger spans (scattered weight clusters): exact fallback to the
        take path.

    Exact for any ``idx`` (ladder predicates are data-dependent scalars;
    every branch computes the same permutation). ``q`` must be
    all-finite — a NaN anywhere poisons the one-hot contraction
    (occlusion maps are [0, 1]; padding rows are written finite by the
    kernel).
    """
    gb = (idx // 128).reshape(pr, 128)
    lane = (idx % 128).reshape(pr, 128)
    glo = jnp.min(gb, axis=1)
    span = jnp.max(gb - glo[:, None]) + 1
    l_ar = jnp.arange(128, dtype=jnp.int32)

    def make_grouped(G):
        def grouped(q):
            base = jnp.arange(n_pad, dtype=jnp.int32)[:, None, None] * pr
            k_ar = jnp.arange(G, dtype=jnp.int32)
            gidx = jnp.minimum(glo[None, :, None]
                               + k_ar[None, None, :], pr - 1)
            rows = (base + gidx).reshape(-1)
            A = jnp.take(q, rows, axis=0, mode="clip").reshape(
                n_pad, pr, G, 128)
            # E[k, r, l, m] = 1 iff output lane (r, m)'s parent is
            # source lane (glo[r]+k, l); clamped duplicate rows get a
            # zero column, so they contribute nothing.
            hitg = gb[None] == glo[None, :, None] + k_ar[:, None, None]
            E = (hitg[:, :, None, :]
                 & (lane[None, :, None, :] == l_ar[None, None, :, None])
                 ).astype(q.dtype)                     # (G, pr, l, m)
            out = jnp.einsum("nrkl,krlm->nrm", A, E,
                             precision=jax.lax.Precision.HIGHEST)
            return out.reshape(n_pad * pr, 128)
        return grouped

    def fallback(q):
        view = q.reshape(n_pad, pr * 128)
        return jnp.take(view, idx, axis=1, mode="clip").reshape(
            n_pad * pr, 128)

    chain = fallback
    for G in (2, 1):
        chain = (lambda q, G=G, nxt=chain:
                 jax.lax.cond(span <= G, make_grouped(G), nxt, q))
    return chain(q)


def scatter_pixel_rows(q, vals, sel, pr: int):
    """Pixel-row scatter: ``q[sel[j]·pr:(sel[j]+1)·pr] =
    vals[j·pr:(j+1)·pr]`` for every selected pixel j.

    ``sel`` entries must be distinct (they are: the compaction ladder's
    selection ranks are a permutation prefix). Each pixel's particle
    tile is one contiguous row of the (pixels, Pp) view, so XLA scatters
    whole rows. Inside the compaction ladder's ``lax.cond`` the scatter
    is NOT in place even with the belief donated: the compiled step
    copies the whole map before it in each compacted branch (PERF.md
    Findings; moving the merge out of the cond is ROADMAP Speed 6).
    """
    n_pix = q.shape[0] // pr
    rows = vals.reshape(sel.shape[0], pr * 128)
    out = q.reshape(n_pix, pr * 128).at[sel].set(
        rows, unique_indices=True)
    return out.reshape(q.shape)


def gather_pixel_rows(q, sel, pr: int):
    """Pixel-row gather: ``out[j·pr:(j+1)·pr] = q[sel[j]·pr:(sel[j]+1)·pr]``
    — the read-side mirror of :func:`scatter_pixel_rows`, one contiguous
    (Pp,) row per selected pixel."""
    n_pix = q.shape[0] // pr
    out = jnp.take(q.reshape(n_pix, pr * 128), sel, axis=0)
    return out.reshape(sel.shape[0] * pr, 128)


def _kernel_inputs(gt, occ_k, z_obs, cand, rays, num_particles, nb, ages):
    """Validate and pad the per-pixel inputs to the kernel's pixel grid.

    Padding pixels carry z = NaN and the degenerate candidate, so each
    contributes log p_invalid_background to every particle's loglik and
    keeps its (aged) occlusion prior.
    """
    N = z_obs.shape[0]
    p_pad, pr = _particle_pads(num_particles)
    if gt.shape[1] != 10 * pr:
        raise ValueError(
            f"gt slab rows {gt.shape[1]} != 10·Pr = {10 * pr}")
    n_pad = _round_up(N, nb)
    if occ_k.shape != (n_pad * pr, 128):
        raise ValueError(
            f"occ_k must be kernel layout {(n_pad * pr, 128)}, got "
            f"{occ_k.shape}; use occ_to_kernel")
    age = (jnp.zeros((N,), jnp.float32) if ages is None
           else ages.astype(jnp.float32))
    pix = jnp.concatenate([
        rays.astype(jnp.float32), z_obs.astype(jnp.float32)[:, None],
        age[:, None], jnp.zeros((N, 3), jnp.float32)], axis=1)
    pad = n_pad - N
    pix = jnp.concatenate(
        [pix, jnp.zeros((pad, 8), jnp.float32).at[:, 3].set(jnp.nan)])
    cand_in = jnp.pad(cand.astype(jnp.int32), ((0, pad), (0, 0)),
                      constant_values=gt.shape[0] - 1)
    return (cand_in, pix, gt.reshape(-1, p_pad),
            occ_k.reshape(n_pad, p_pad), p_pad, n_pad)


def fused_loglik_packed(gt, occ_k, z_obs, cand, rays, params_vec,
                        num_particles: int, nb: int = 64,
                        interpret=None, ages=None):
    """Run the fused kernel on pre-packed constant slabs.

    Args:
      gt: (T, 10·Pr, 128) packed slabs (pack_constants; multi-object =
        concatenation of per-object slabs along the triangle axis).
      occ_k: kernel-layout occlusion (occ_to_kernel).
      z_obs: (N,); cand: (N, K) int32 global triangle ids with misses
        already mapped to a degenerate row; rays: (N, 3).
      params_vec: (16,) f32 (see make_params_vec).
      nb: pixel padding granularity of the occlusion layout.
      interpret: True = Pallas interpreter; otherwise compiled for the
        GPU (see resolve_interpret).
      ages: optional (N,) f32 per-pixel staleness of occ_k in frame
        units (lazy aging — see FusedSensor); None = all fresh.
    Returns (loglik (P,), occ_post in kernel layout).
    """
    interpret = resolve_interpret(interpret)
    cand_in, pix, gt2, occ2, p_pad, n_pad = _kernel_inputs(
        gt, occ_k, z_obs, cand, rays, num_particles, nb, ages)
    bn = math.gcd(nb, _PIX_BLOCK)
    n_chunks = n_pad // bn
    kernel = functools.partial(_fused_kernel, K=cand.shape[1], bn=bn,
                               bp=_LANE_BLOCK)
    occ_out, ll = pl.pallas_call(
        kernel,
        grid=(p_pad // _LANE_BLOCK, n_chunks),
        out_shape=[
            # occ posterior keeps the stored dtype (bf16 storage halves
            # every occ-touching pass; the kernel computes in f32)
            jax.ShapeDtypeStruct((n_pad, p_pad), occ_k.dtype),
            jax.ShapeDtypeStruct((n_chunks, p_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="fused_loglik",
    )(cand_in, pix, params_vec.astype(jnp.float32), gt2, occ2)
    loglik = jnp.sum(ll, axis=0)[:num_particles]
    return loglik, occ_out.reshape(occ_k.shape)


def fused_loglik_reference(gt, occ_k, z_obs, cand, rays, params_vec,
                           num_particles: int, nb: int = 64, ages=None):
    """:func:`fused_loglik_packed` in plain ``jnp`` (same inputs, same
    padding, same outputs) — the oracle the kernel is tested against."""
    cand_in, pix, gt2, occ2, p_pad, n_pad = _kernel_inputs(
        gt, occ_k, z_obs, cand, rays, num_particles, nb, ages)
    T = gt2.shape[0] // 10
    g = jnp.take(gt2.reshape(T, 10, p_pad), cand_in, axis=0)  # (n,K,10,Pp)
    col = [pix[:, c, None] for c in range(5)]                 # (n, 1) each
    t = None
    for k in range(cand_in.shape[1]):
        tk = _intersect([g[:, k, c] for c in range(10)], col[0], col[1],
                        col[2], params_vec[15])
        t = tk if t is None else jnp.minimum(t, tk)
    logp, post = _pixel_update(t, col[3], occ2.astype(jnp.float32),
                               col[4], lambda i: params_vec[i])
    loglik = jnp.sum(logp, axis=0)[:num_particles]
    return loglik, post.astype(occ_k.dtype).reshape(occ_k.shape)


def fused_loglik(mesh: TriangleMesh, poses, occ_k, z_obs, cand, rays,
                 params_vec, nb: int = 64, interpret=None):
    """Single-object convenience wrapper: pack + run the fused kernel.

    ``cand`` is (N, K) int32 with -1 already mapped to the degenerate
    (last) row of the mesh.
    """
    P = poses.shape[0]
    gt = pack_constants(mesh, poses, _particle_pads(P)[0])
    return fused_loglik_packed(gt, occ_k, z_obs, cand, rays, params_vec,
                               P, nb=nb, interpret=interpret)


def make_params_vec(bp: BeamParams, op: OcclusionParams, dt_frames,
                    bary_slack=0.0):
    """Pack model parameters + propagated-chain coefficients into (16,).

    The kernel propagates the occlusion chain as
    ``sign(g) * exp(log|g| * (age + dt_frames))`` — for ``age = 0`` this
    equals the classic one-step ``sign(g)*|g|^dt``; nonzero lazy ages
    require g >= 0 (sign would alternate per step; FusedSensor only
    enables lazy aging for g >= 0, the physical regime).

    ``bary_slack`` relaxes the candidate inside-test by that many
    barycentric units (see _intersect; FusedSensor.bary_slack).
    """
    g = op.p_occluded_occluded - op.p_occluded_visible
    pi = op.p_occluded_visible / jnp.maximum(1.0 - g, 1e-12)
    gdt = jnp.sign(g) * jnp.power(jnp.abs(g), dt_frames)
    lg = jnp.log(jnp.maximum(jnp.abs(g), 1e-30))
    return jnp.stack([
        bp.model_sigma, bp.sigma_factor, bp.tail_weight, bp.min_depth,
        bp.max_depth, bp.exponential_rate, bp.p_invalid_occluded,
        bp.p_invalid_visible, bp.p_invalid_background, pi, gdt,
        1.0 / (bp.max_depth - bp.min_depth),
        lg, jnp.asarray(dt_frames, jnp.float32), jnp.sign(g),
        jnp.asarray(bary_slack, jnp.float32),
    ]).astype(jnp.float32)


class FusedSensor:
    """RbSensor-contract sensor backed by the fused kernel.

    Callable with ``(states, occ, z_obs, dt)`` like every sensor, but the
    occlusion state it consumes/produces lives in the **kernel layout**
    (see occ_to_kernel) for transpose-free frame-to-frame feedback. The
    filter treats occlusion as an opaque leaf; the extra hooks —
    ``init_occlusion`` and ``gather_occlusion`` — cover the two places
    the filter must touch it (initialization, resampling lineage gather).

    Multi-object scenes (``FreeFloatingRigidBodiesState`` semantics, D1/P7)
    run through the *same* kernel on the union triangle list: per-object
    slabs are concatenated along the triangle axis, the reference pass
    min-combines per-object raycasts into global candidate ids, and the
    kernel's min-over-candidates realizes mutual occlusion between tracked
    objects exactly like the exact renderer's min-over-objects.

    **Active-set compaction** (``levels``): pixels whose candidate set is
    all-degenerate are misses for *every* particle — their likelihood is a
    particle-independent background constant and their occlusion update is
    the closed-form prior propagation; likewise only candidate triangles
    need constant-packing. Each compaction level is a static (pixel,
    triangle) budget pair compiled as its own kernel; per frame the
    smallest fitting level runs (nested ``lax.cond``), falling back to the
    full kernel for oversized silhouettes. Exact at every level: the
    background constant is added back and the propagated occlusion is
    written elementwise. A reference-class scene (hand-held object,
    ~1–10 % frame fill) hits the tight level.

    ``interpret``: True runs the kernel in the Pallas interpreter (CPU
    tests); otherwise it compiles for the GPU and any other backend
    raises (resolve_interpret).
    """

    def __init__(self, meshes, camera, bp, op, frame_rate=30.0,
                 num_candidates=2, radius=2, nb=64, interpret=None,
                 active_cap_frac=None, tri_cap_frac=None, levels=None,
                 lineage_gather="take", bary_slack=None,
                 bary_slack_px=0.25, merge="scatter",
                 occ_dtype=jnp.bfloat16, reference_poses=1):
        self.meshes = ([meshes] if isinstance(meshes, TriangleMesh)
                       else list(meshes))
        self.camera = camera
        if levels is None:
            if active_cap_frac is not None or tri_cap_frac is not None:
                # legacy single-level API
                levels = [(1.0 if active_cap_frac is None
                           else float(active_cap_frac),
                           1.0 if tri_cap_frac is None
                           else float(tri_cap_frac))]
            else:
                levels = [(1.0 / 12.0, 0.2), (0.5, 0.75)]
        self.levels = [(float(a), float(t)) for a, t in levels]
        # Static per-mesh pack matrices, concrete at trace time (see
        # pack_constants: not rebuilt inside every traced step).
        self._pack_M = [jax.device_put(pack_matrix(m)) for m in self.meshes]
        K = len(self.meshes)
        blocks = []
        for k, Mk in enumerate(self._pack_M):
            b = jnp.zeros((Mk.shape[0], 10, 37 * K), jnp.float32)
            blocks.append(b.at[:, :, 37 * k:37 * (k + 1)].set(Mk))
        self._pack_M_union = jax.device_put(
            jnp.concatenate(blocks, axis=0))          # (Tu, 10, 37K)
        self.bp = bp
        self.op = op
        self.frame_rate = frame_rate
        self.num_candidates = num_candidates
        self.radius = radius
        # Reference poses per object for the candidate pass (default 1 =
        # the posterior mean). A MULTI-HYPOTHESIS particle cloud (init /
        # flip-aware recovery races) is bimodal, and candidates built
        # around its mean cover a ghost pose between the modes — the
        # race is then decided by candidate-coverage noise, not
        # likelihood (a π-flip won a 10k-particle recovery race the
        # exact XLA sensor resolves correctly). With R > 1 the reference
        # pass renders R
        # index-strided particles per object (systematic hypothesis
        # seeding allocates contiguous blocks, so strides hit every
        # mode) and min-combines all id images; the tracker uses an
        # R=4 sensor for the first frames after a hypothesis init.
        self.reference_poses = int(reference_poses)
        self.nb = nb
        self.interpret = resolve_interpret(interpret)
        if lineage_gather not in ("grouped", "windowed", "take"):
            raise ValueError(f"unknown lineage_gather: {lineage_gather!r}")
        self.lineage_gather = lineage_gather
        if merge not in ("scatter", "select"):
            raise ValueError(f"unknown merge mode: {merge!r}")
        self.merge = merge
        # Candidate inside-test slack. The deferred reference pass samples
        # triangle ids at pixel centers; for meshes whose faces are finer
        # than a pixel, a displaced particle's ray hits triangles that
        # appear at NO pixel center (8-25 % candidate coverage measured at
        # reference operating points) and would read as misses (~10
        # nats/pixel penalty → the filter locks onto the stale pose).
        # Accepting hits on a candidate's PLANE within a slack of its
        # barycentric footprint closes the gaps with
        # O((slack·face)²·curvature) depth error — sub-mm ≪ beam σ.
        # The natural unit is PIXELS (silhouette inflation is then
        # resolution-bounded regardless of tessellation): per frame the
        # barycentric slack is bary_slack_px · pixel_footprint(z̄) /
        # median_edge — two independent operating points measured optimal
        # at ≈0.25 px. ``bary_slack`` (barycentric units) overrides the
        # auto rule when not None; 0.0 = exact inside-test.
        self.bary_slack = None if bary_slack is None else float(bary_slack)
        self.bary_slack_px = float(bary_slack_px)
        # shared auto-slack rule with the deferred backend (ops/slack.py)
        from dbot_ros_tpu.ops import slack as slack_mod
        self._min_median_edge = slack_mod.median_edge(self.meshes)
        self._fx = float(jnp.asarray(camera.camera_matrix)[0, 0])
        # Occlusion storage dtype. The kernel always computes in f32;
        # the stored (n_pad·Pr, 128) map is the single biggest buffer
        # the step touches (~197 MB at 10k particles × 4800 px in f32),
        # and every hot pass over it — kernel read+write, the resample
        # lineage take, exchange permutes — is memory-bandwidth-bound.
        # bf16 halves all of them; an occlusion probability is a
        # smoothed [0, 1] latent, so the ~0.4 % relative quantization is
        # far below the beam model's noise (bf16-vs-f32 tracking parity
        # is tested). Pass jnp.float32 for exact parity runs.
        self.occ_dtype = jnp.dtype(occ_dtype)
        # Lazy per-pixel occlusion aging (the occlusion leaf becomes a
        # (q, age) tuple; see __call__). Requires g >= 0 so the closed
        # form g^k keeps its sign — true for any physical occlusion
        # chain (p_occluded_occluded >= p_occluded_visible).
        self._lazy = float(op.p_occluded_occluded
                           - op.p_occluded_visible) >= 0.0

    def _pads(self, num_particles):
        p_pad, pr = _particle_pads(num_particles)
        n_pad = _round_up(self.camera.num_pixels, self.nb)
        return p_pad, n_pad, pr

    def init_occlusion(self, num_particles, initial_prob):
        """Fresh occlusion leaf: lazy (q, age) tuple (or raw q for g<0).

        ``q`` is the kernel-layout map; ``age`` (n_pad,) f32 counts the
        frame-units elapsed since each PIXEL's row of q was last written
        by the kernel. Pixels skipped by the compaction ladder are never
        rewritten — their closed-form prior propagation happens inside
        the kernel when they next become active (and in occlusion_as_pn
        for diagnostics), so the common path never touches the full map.
        """
        p_pad, n_pad, pr = self._pads(num_particles)
        q = jnp.full((n_pad * pr, 128), initial_prob, self.occ_dtype)
        if not self._lazy:
            return q
        return (q, jnp.zeros((n_pad,), jnp.float32))

    @staticmethod
    def _unpack_occ(occ):
        if isinstance(occ, (tuple, list)):
            return occ[0], occ[1]
        return occ, None

    def particle_stride(self, num_particles: int) -> int:
        """Padded lane count of a ``num_particles`` block — the index
        stride exchange code must use for concat results (_particle_pads
        rounds to the kernel's particle tile)."""
        return self._pads(num_particles)[0]

    def gather_occlusion(self, occ_k, parent_idx, num_in=None):
        """Particle-lineage gather in kernel layout (resampling).

        ``lineage_gather`` modes:

          * ``"take"`` (default): the plain XLA lane gather on the
            (n_pad, p_pad) view;
          * ``"grouped"``: :func:`grouped_lane_gather` — flat-layout
            row gather + one-hot contraction with a span ladder, kept
            for A/B;
          * ``"windowed"``: ops.resample.windowed_lane_gather (aligned
            slab + one-hot contraction per 128-lane block), kept for
            A/B.

        ``num_in`` (optional): total source LANES when gathering from a
        foreign source (the distributed exchanges' concat'd surplus
        buffers — parallel/dist_filter); indices then address that lane
        space directly. ``None`` → the sensor's own P-particle map.
        """
        from dbot_ros_tpu.ops import resample as rs

        occ_k, age = self._unpack_occ(occ_k)
        p_out = parent_idx.shape[0]
        p_pad_out, n_pad, pr_out = self._pads(p_out)
        p_pad_in = p_pad_out if num_in is None else int(num_in)
        # pad lanes map to pad lanes when shapes allow (keeps the padded
        # particles' rows stable); otherwise clamp into range — padding
        # content is arbitrary but must stay finite
        pad_idx = jnp.minimum(jnp.arange(p_out, p_pad_out, dtype=jnp.int32),
                              p_pad_in - 1)
        idx_full = jnp.concatenate(
            [parent_idx.astype(jnp.int32), pad_idx])
        same = num_in is None
        if self.lineage_gather == "grouped" and same:
            out = grouped_lane_gather(occ_k, idx_full, n_pad, pr_out)
        elif self.lineage_gather == "windowed" and same:
            view = occ_k.reshape(n_pad, p_pad_in)
            out = rs.windowed_lane_gather(view, idx_full).reshape(
                n_pad * pr_out, 128)
        else:
            view = occ_k.reshape(n_pad, p_pad_in)
            out = jnp.take(view, idx_full, axis=1, mode="clip").reshape(
                n_pad * pr_out, 128)
        # age is per-pixel (particle-independent) → lineage-invariant
        return out if age is None else (out, age)

    def concat_occlusion(self, blocks, num_each):
        """Concatenate occlusion blocks along the particle (lane) axis.

        Each block holds ``num_each`` particles in kernel layout; the
        result holds ``len(blocks) * pads(num_each)`` lanes (padding
        lanes stay interleaved — callers index with a stride of
        ``pads(num_each)``). Used by the count-redistribution exchange
        to fuse the per-hop surplus buffers into one gather source.
        """
        p_pad, n_pad, _ = self._pads(num_each)
        qs, age = [], None
        for blk in blocks:
            q, a = self._unpack_occ(blk)
            age = a if age is None else age
            qs.append(q.reshape(n_pad, p_pad))
        cat = jnp.concatenate(qs, axis=1)
        out = cat.reshape(-1, 128)
        return out if age is None else (out, age)

    def where_occlusion(self, particle_mask, a, b):
        """Per-particle select between two occlusion maps (kernel layout).

        Used by the distributed ring-exchange resampler: ``mask`` is
        (P,) bool over particles; lanes of padded particles take ``b``.
        """
        a, age_a = self._unpack_occ(a)
        b, _ = self._unpack_occ(b)
        p = particle_mask.shape[0]
        p_pad, n_pad, pr = self._pads(p)
        m = jnp.concatenate(
            [particle_mask, jnp.zeros((p_pad - p,), particle_mask.dtype)])
        mk = jnp.broadcast_to(m[None, :], (n_pad, p_pad))
        out = jnp.where(mk.reshape(n_pad * pr, 128), a, b)
        # ages are identical across shards (selection is replicated)
        return out if age_a is None else (out, age_a)

    def occlusion_as_pn(self, occ_k, num_particles):
        """Diagnostic view of the occlusion state as (P, N), materialized
        to 'now' (lazy ages applied via the closed-form propagation)."""
        occ_k, age = self._unpack_occ(occ_k)
        occ_k = occ_k.astype(jnp.float32)
        q = occ_from_kernel(occ_k, self.camera.num_pixels,
                            num_particles, self.nb)
        if age is None:
            return q
        g = self.op.p_occluded_occluded - self.op.p_occluded_visible
        pi = self.op.p_occluded_visible / jnp.maximum(1.0 - g, 1e-12)
        geff = jnp.exp(jnp.log(jnp.maximum(g, 1e-30))
                       * age[:self.camera.num_pixels])        # g >= 0
        q_now = pi + geff[None, :] * (q - pi)
        return jnp.clip(jnp.where(geff[None, :] == 1.0, q, q_now),
                        0.0, 1.0)

    @property
    def union_triangles(self) -> int:
        return sum(m.padded_triangles for m in self.meshes)

    def candidates(self, states):
        """Reference pass → per-pixel global candidate triangle ids (N, K).

        Raycasts each object at its posterior-mean pose, min-combines
        depths into a global (union-offset) id image, dilates into
        candidate sets; misses map to the union's degenerate last row.
        """
        from dbot_ros_tpu.ops import deferred
        from dbot_ros_tpu.utils import se3

        P = states.shape[0]
        z_best = None
        ids_best = None
        offset = 0
        for k, mesh in enumerate(self.meshes):
            if self.reference_poses <= 1:
                refs = [se3.states_mean(states[:, k])[:7]]
            else:
                # index-strided particles: one per hypothesis block
                # (see __init__ reference_poses note)
                refs = [states[(r * P) // self.reference_poses, k, :7]
                        for r in range(self.reference_poses)]
            for ref_k in refs:
                z_k, ids_k = deferred.raycast_ids(mesh, ref_k,
                                                  self.camera.rays)
                ids_k = jnp.where(ids_k >= 0, ids_k + offset, -1)
                if z_best is None:
                    z_best, ids_best = z_k, ids_k
                else:
                    closer = z_k < z_best
                    z_best = jnp.where(closer, z_k, z_best)
                    ids_best = jnp.where(closer, ids_k, ids_best)
            offset += mesh.padded_triangles

        cand = deferred.candidate_ids(ids_best, self.camera.height,
                                      self.camera.width, self.radius,
                                      self.num_candidates)
        return jnp.where(cand >= 0, cand,
                         self.union_triangles - 1).astype(jnp.int32)

    def _active_cap(self, num_pixels: int, frac: float):
        """Static kernel-pixel budget for one level (None = no compaction)."""
        if frac >= 1.0:
            return None
        cap = _round_up(int(math.ceil(num_pixels * frac)), self.nb)
        return None if cap >= num_pixels else cap

    def _tri_cap(self, frac: float):
        """Static packed-triangle budget (None = pack all triangles).

        Bounds the number of distinct candidate triangles per frame —
        for closed meshes only front-facing triangles (≲60 %) can appear
        in the reference id image, so 0.75 is a safe upper level; frames
        that exceed a level escalate to the next (exactness preserved).
        """
        if frac >= 1.0:
            return None
        cap = _round_up(
            int(math.ceil(self.union_triangles * frac)), 8)
        return None if cap >= self.union_triangles else cap

    def _pack_full(self, states, p_pad):
        return jnp.concatenate(
            [pack_constants(mesh, states[:, k, :7], p_pad,
                            M=self._pack_M[k])
             for k, mesh in enumerate(self.meshes)], axis=0)

    def _pack_selected(self, states, p_pad, uniq):
        """Pack only the ``uniq`` (sorted, deg-padded) triangle slots.

        One matmul (10·tcap, 37K) @ (37K, Pp): each union triangle's
        coefficient rows live in its object's 37-feature block, so a
        K-object scene still packs in a single GEMM.
        """
        K = len(self.meshes)
        tcap = uniq.shape[0]
        M_sel = jnp.take(self._pack_M_union, uniq,
                         axis=0).reshape(tcap * 10, 37 * K)
        F_all = jnp.concatenate(
            [pose_features(states[:, k, :7], p_pad)
             for k in range(K)], axis=0)                  # (37K, Pp)
        packed = _pack_dot(M_sel, F_all)
        return packed.reshape(tcap, 10 * (p_pad // 128), 128)

    def __call__(self, states, occ_k, z_obs, dt):
        """Sensor call. The occlusion leaf ``occ_k`` is either the lazy
        (q, age) tuple produced by :meth:`init_occlusion` (g >= 0), or a
        raw kernel-layout array (legacy/eager semantics: every pixel's
        occlusion is propagated and rewritten each frame). With lazy
        aging the compaction ladder's common path touches ONLY the
        selected pixels' rows — no full-map propagate/merge/relayout.
        """
        from dbot_ros_tpu.models import occlusion as occ_mod

        P = states.shape[0]
        p_pad, pr = _particle_pads(P)
        cand = self.candidates(states)
        dtf = dt * self.frame_rate
        if self.bary_slack is not None:
            slack = jnp.float32(self.bary_slack)
        else:
            # auto: bary_slack_px pixels of footprint at the cloud's
            # depth, in barycentric units of the finest mesh — the rule
            # shared with the deferred backend (ops/slack.py)
            from dbot_ros_tpu.ops import slack as slack_mod
            slack = slack_mod.auto_bary_slack(
                slack_mod.cloud_depth(states[..., 2]), 1.0 / self._fx,
                self._min_median_edge, self.bary_slack_px)
        params_vec = make_params_vec(self.bp, self.op, dtf, slack)
        N = z_obs.shape[0]
        n_pad = _round_up(N, self.nb)
        deg = self.union_triangles - 1
        lazy = isinstance(occ_k, (tuple, list))
        if lazy and not self._lazy:
            raise ValueError(
                "lazy (q, age) occlusion leaf requires "
                "p_occluded_occluded >= p_occluded_visible")

        def full(occ):
            q, age = self._unpack_occ(occ)
            ll, q_post = fused_loglik_packed(
                self._pack_full(states, p_pad), q, z_obs, cand,
                self.camera.rays, params_vec, P, nb=self.nb,
                interpret=self.interpret,
                ages=None if age is None else age[:N])
            if not lazy:
                return ll, q_post
            return ll, (q_post, jnp.zeros_like(age))

        # Resolve ladder levels to concrete static caps (tightest first).
        caps = []
        for pf, tf in self.levels:
            pcap = self._active_cap(N, pf)
            tcap = self._tri_cap(tf)
            if pcap is None and tcap is None:
                break          # this level IS the full kernel
            caps.append((pcap, tcap))
        if not caps:
            return full(occ_k)

        # Compaction bookkeeping, sort- and scatter-free: the selection
        # is expressed as cumsum ranks + blocked-rank searchsorted
        # (ops/resample.sorted_searchsorted_left) over the (ascending)
        # cumsums — dense elementwise work only.
        from dbot_ros_tpu.ops import resample as _rs
        if any(p is not None for p, _ in caps):
            active = jnp.any(cand != deg, axis=1)
            af = active.astype(jnp.float32)
            ca = jnp.cumsum(af)                  # (N,) 1-based active rank
            ci = jnp.cumsum(1.0 - af)            # (N,) 1-based inactive rank
            n_active = ca[-1]
            # selection rank of every pixel: actives first (in index
            # order), then inactives — the old stable argsort's rank
            slot_dense = jnp.where(active, ca - 1.0,
                                   n_active + ci - 1.0).astype(jnp.int32)
        if any(t is not None for _, t in caps):
            tid = jnp.arange(self.union_triangles, dtype=jnp.int32)
            pres = jnp.any(cand.reshape(1, -1) == tid[:, None], axis=1)
            cp = jnp.cumsum(pres.astype(jnp.float32))  # (T,) ascending
            n_uniq = cp[-1]
            inv_dense = cp.astype(jnp.int32) - 1   # slot of present ids

        # Unselected-pixel background loglik, same math as the kernel's
        # off-silhouette branch (shared by every compact level).
        bp = self.bp
        inv_range = 1.0 / (bp.max_depth - bp.min_depth)
        z_real = z_obs == z_obs
        z_val = z_real & (z_obs >= bp.min_depth) & (z_obs <= bp.max_depth)
        lik_bg = jnp.where(
            z_real, jnp.where(z_val, inv_range, 0.0)
            * (1.0 - bp.p_invalid_background),
            bp.p_invalid_background)
        ll_bg = jnp.log(jnp.maximum(lik_bg, _TINY))
        log_pib = jnp.log(jnp.maximum(bp.p_invalid_background, _TINY))

        def make_level(pcap, tcap):
            if pcap is not None:
                # sel[j] = the j-th selected pixel: the (j+1)-th active
                # pixel while j < n_active, then inactive pixels as
                # padding — rank inversion via blocked searchsorted on
                # the (ascending) cumulative active/inactive counts.
                jpos = jnp.arange(pcap, dtype=jnp.float32) + 0.5
                sa = _rs.sorted_searchsorted_left(ca, jpos)
                si = _rs.sorted_searchsorted_left(ci, jpos - n_active)
                sel = jnp.clip(jnp.where(jpos < n_active, sa, si),
                               0, N - 1).astype(jnp.int32)
                sel_mask = slot_dense < pcap
            if tcap is not None:
                # uniq[s] = the (s+1)-th present triangle id; slots past
                # n_uniq clip to T-1 = the degenerate row (safe pad)
                uniq = jnp.clip(
                    _rs.sorted_searchsorted_left(
                        cp, jnp.arange(tcap, dtype=jnp.float32) + 0.5),
                    0, self.union_triangles - 1).astype(jnp.int32)
            fits = jnp.bool_(True)
            if pcap is not None:
                fits = fits & (n_active <= pcap)
            if tcap is not None:
                fits = fits & (n_uniq < tcap)

            if tcap is not None:
                # Slot lookup: every id in `cand` is present, so the
                # dense cumsum rank covers all lookups (no search or
                # scatter-built inverse).
                inv = jnp.clip(inv_dense, 0, tcap - 1)

            def branch(occ):
                q_k, age = self._unpack_occ(occ)
                if tcap is not None:
                    gt = self._pack_selected(states, p_pad, uniq)
                    cand_use = jnp.take(inv, cand, axis=0, mode="clip")
                else:
                    gt = self._pack_full(states, p_pad)
                    cand_use = cand
                if pcap is None:
                    ll, q_post = fused_loglik_packed(
                        gt, q_k, z_obs, cand_use, self.camera.rays,
                        params_vec, P, nb=self.nb,
                        interpret=self.interpret,
                        ages=None if age is None else age[:N])
                    if not lazy:
                        return ll, q_post
                    return ll, (q_post, jnp.zeros_like(age))

                n_pad_c = _round_up(pcap, self.nb)
                scalar = (jnp.sum(jnp.where(sel_mask, 0.0, ll_bg))
                          + (n_pad - N) * log_pib
                          - (n_pad_c - pcap) * log_pib)
                if lazy:
                    # Gather ONLY the selected pixels' q rows (the
                    # kernel layout keeps a pixel's particles in one
                    # contiguous row); unselected pixels just age.
                    n_pix_q = q_k.shape[0] // pr
                    occ_sel = gather_pixel_rows(
                        q_k, jnp.clip(sel, 0, n_pix_q - 1), pr)
                    ll, occ_post = fused_loglik_packed(
                        gt, occ_sel, z_obs[sel],
                        jnp.take(cand_use, sel, axis=0),
                        jnp.take(self.camera.rays, sel, axis=0),
                        params_vec, P, nb=self.nb,
                        interpret=self.interpret, ages=age[sel])
                    selm = jnp.pad(sel_mask, (0, n_pad - N))
                    age_out = jnp.where(selm, 0.0, age + dtf)
                    if self.merge == "scatter":
                        # Row scatter of the selected pixels' rows
                        # (scatter_pixel_rows). Inside this cond XLA
                        # copies the full map before it (not in place;
                        # ROADMAP Speed 6); the take+where merge below
                        # reads and writes the full map as well.
                        q_out = scatter_pixel_rows(q_k, occ_post, sel, pr)
                        return ll + scalar, (q_out, age_out)
                    # "select" merge (kept for A/B): inverse row gather
                    # + fused select, one full-map write. slot/selm come
                    # straight from the dense selection rank.
                    slot = jnp.pad(jnp.clip(slot_dense, 0, pcap - 1),
                                   (0, n_pad - N))
                    src_rows = (slot[:, None] * pr
                                + jnp.arange(pr, dtype=jnp.int32)[None, :]
                                ).reshape(-1)
                    vals = jnp.take(occ_post, src_rows, axis=0, mode="clip")
                    mrows = jnp.repeat(selm, pr)[:, None]
                    q_out = jnp.where(mrows, vals, q_k)
                    return ll + scalar, (q_out, age_out)

                occ_view = q_k.reshape(n_pad, p_pad)
                occ_sel = jnp.take(occ_view, sel, axis=0, mode="clip")
                ll, occ_post = fused_loglik_packed(
                    gt, occ_sel.reshape(pcap * pr, 128), z_obs[sel],
                    jnp.take(cand_use, sel, axis=0),
                    jnp.take(self.camera.rays, sel, axis=0),
                    params_vec, P, nb=self.nb, interpret=self.interpret)
                prop = occ_mod.propagate(
                    occ_view.astype(jnp.float32), self.op,
                    dtf).astype(q_k.dtype)
                out_view = prop.at[sel].set(occ_post.reshape(pcap, p_pad))
                return ll + scalar, out_view.reshape(n_pad * pr, 128)

            return fits, branch

        chain = full
        for pcap, tcap in reversed(caps):
            fits, branch = make_level(pcap, tcap)
            chain = (lambda occ_k, fits=fits, branch=branch, nxt=chain:
                     jax.lax.cond(fits, branch, nxt, occ_k))
        return chain(occ_k)


def make_fused_sensor(meshes, camera, bp: BeamParams, op: OcclusionParams,
                      frame_rate: float = 30.0, num_candidates: int = 2,
                      radius: int = 2, nb: int = 64,
                      interpret=None,
                      active_cap_frac: float = None,
                      tri_cap_frac: float = None,
                      levels=None,
                      lineage_gather: str = "take",
                      bary_slack: float = None,
                      bary_slack_px: float = 0.25,
                      merge: str = "scatter",
                      occ_dtype=jnp.bfloat16,
                      reference_poses: int = 1) -> FusedSensor:
    """Fused sensor factory (the flagship large-particle config).

    Accepts one mesh or a list of per-object meshes (multi-object scenes
    share the kernel via the union triangle list — see FusedSensor).
    ``interpret=True`` runs the kernel in the Pallas interpreter (the CPU
    tests); otherwise it compiles for the GPU (resolve_interpret).
    ``levels``: compaction ladder as (pixel_frac, triangle_frac) pairs,
    tightest first (default ``[(1/12, 0.2), (0.5, 0.75)]``); the legacy
    ``active_cap_frac``/``tri_cap_frac`` pair defines a single level.
    ``bary_slack``/``bary_slack_px``: candidate inside-test slack
    (default: auto, 0.25 px of footprint — see FusedSensor); pass
    ``bary_slack=0.0`` for the exact inside-test (oracle-parity tests).
    """
    return FusedSensor(meshes, camera, bp, op, frame_rate, num_candidates,
                       radius, nb, interpret, active_cap_frac,
                       tri_cap_frac, levels, lineage_gather, bary_slack,
                       bary_slack_px, merge, occ_dtype, reference_poses)

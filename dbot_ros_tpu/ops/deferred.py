"""Deferred (candidate-set) raycast for large particle batches.

The reference scales particle likelihoods by rasterizing every particle on
a GPU (D12/D13: tiled FBO + CUDA). A direct port of either approach to
XLA is wrong-shaped: per-particle rasterization needs z-buffer scatter,
and exhaustive ray×triangle testing costs O(P·N·T) ≈ 6·10¹¹ ops/frame for
the 10k-particle north star.

Redesign — put the work into matrix products:

1. **Reference pass** (once per frame): exact raycast at one reference pose
   (the belief mean) returning the *nearest triangle id* per pixel
   (ops/raycast.py, argmin variant). Particles are small perturbations of
   the reference, so each pixel's intersecting triangle is almost always
   in a small neighborhood of its reference assignment.
2. **Candidate sets**: per pixel, K candidate triangle ids = its own
   assignment plus dilated neighbors (window max over the id image) —
   capturing silhouette shifts of several pixels in any direction.
3. **Per-particle intersection as one-hot matmuls**: each candidate set k
   defines a one-hot selection matrix S_k (N × T), constant per frame.
   With per-particle transformed constants G(p) (T × 10)
   (= [g_u | g_v | g_det | t_num], utils/mesh.py), the per-pixel
   constants are S_k @ G(p) — batched over particles this is
   (N × T) @ (T × 10·P): one dense contraction (K = T = padded
   triangle count). Validity tests + depth-min over candidates are cheap
   elementwise ops. Total ≈ 2·N·T·10·P·K_sets FLOPs.

Exactness: a pixel whose true intersecting triangle (under a particle's
pose) is outside its candidate set reads as miss/approximate — only
possible when a particle's silhouette shifts by more than the dilation
radius (default 2 px, configurable). The exact path (ops/raycast.py)
remains the oracle and the small-batch (sigma point) path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu.ops import raycast
from dbot_ros_tpu.utils.mesh import TriangleMesh

_DET_EPS = 1e-12
_NEAR = 1e-4


# ---------------------------------------------------------------------------
# Reference pass: nearest-triangle ids
# ---------------------------------------------------------------------------

def raycast_ids(mesh: TriangleMesh, pose, rays, tri_chunk: int = 512):
    """Exact raycast of one pose → (depth (N,), tri_id (N,) int32, -1=miss)."""
    G, t_num = raycast.pose_tri_constants(mesh, pose)    # (T,3,3), (T,)
    T = G.shape[-3]
    tri_chunk = min(tri_chunk, T)
    pad = (-T) % tri_chunk
    if pad:
        G = jnp.concatenate([G, jnp.zeros((pad, 3, 3), G.dtype)], axis=0)
        t_num = jnp.concatenate([t_num, jnp.zeros((pad,), t_num.dtype)])
        T += pad
    n_chunks = T // tri_chunk
    Gc = G.reshape(n_chunks, tri_chunk * 3, 3)
    tc = t_num.reshape(n_chunks, tri_chunk)
    N = rays.shape[0]

    def body(carry, inp):
        zmin, idmin = carry
        (g, tn), chunk_idx = inp
        # full f32 (the GPU's default f32 dot is TF32, ~mm at 1 m)
        nums = jnp.einsum("nd,md->nm", rays, g,
                          precision=jax.lax.Precision.HIGHEST)
        nums = nums.reshape(N, tri_chunk, 3)
        t = raycast._intersect_from_numerators(
            nums[..., 0], nums[..., 1], nums[..., 2], tn[None, :])
        tbest = jnp.min(t, axis=-1)
        ibest = jnp.argmin(t, axis=-1).astype(jnp.int32) \
            + chunk_idx * tri_chunk
        better = tbest < zmin
        return (jnp.where(better, tbest, zmin),
                jnp.where(better, ibest, idmin)), None

    z0 = jnp.full((N,), raycast.MISS_DEPTH, jnp.float32)
    i0 = jnp.full((N,), -1, jnp.int32)
    (z, ids), _ = jax.lax.scan(
        body, (z0, i0), ((Gc, tc), jnp.arange(n_chunks)))
    return z, jnp.where(jnp.isfinite(z), ids, -1)


# ---------------------------------------------------------------------------
# Candidate construction (id-image dilation)
# ---------------------------------------------------------------------------

def candidate_ids(ids, height: int, width: int, radius: int = 2,
                  num_candidates: int = 4):
    """Per-pixel candidate triangle ids (N, K) from the reference ids.

    Candidates = own id + ids sampled from a (2r+1)² neighborhood at
    increasing offsets (axis-aligned and diagonal picks), deduplicated
    against slot 0 only (duplicates merely waste a test, never hurt
    correctness). Miss pixels (-1) inherit neighbors — that is what makes
    "particle silhouette grows into this pixel" representable.
    """
    img = ids.reshape(height, width)

    def shift(dy, dx):
        return jnp.roll(img, (dy, dx), axis=(0, 1))

    # Preference order: self, then ring-1 neighbors, then ring-r.
    offsets = [(0, 0)]
    for r in range(1, radius + 1):
        offsets += [(0, r), (0, -r), (r, 0), (-r, 0),
                    (r, r), (-r, -r), (r, -r), (-r, r)]
    cand = []
    for dy, dx in offsets:
        s = shift(dy, dx)
        # prefer a *valid* id: if the shifted pixel missed, keep own id
        cand.append(jnp.where(s >= 0, s, img))
    stack = jnp.stack(cand, axis=-1).reshape(ids.shape[0], -1)  # (N, n_off)

    # Greedy slot fill: pick the first num_candidates distinct-ish entries.
    out = [stack[:, 0]]
    taken = stack[:, 0:1]
    for j in range(1, stack.shape[1]):
        if len(out) >= num_candidates:
            break
        col = stack[:, j]
        dup = jnp.any(col[:, None] == taken, axis=1)
        pick = jnp.where(dup, out[0], col)
        out.append(pick)
        taken = jnp.concatenate([taken, pick[:, None]], axis=1)
    while len(out) < num_candidates:
        out.append(out[0])
    return jnp.stack(out[:num_candidates], axis=-1)  # (N, K)


def candidate_ids_dynamic(ids, height: int, width: int, spread_px,
                          num_candidates: int = 6,
                          num_triangles: int = 4094):
    """Spread-adaptive candidate ids (N, K): offsets scale with the
    (traced) sigma-cloud pixel footprint.

    The static :func:`candidate_ids` samples a FIXED (2r+1)²
    neighborhood — correct while the sigma spread stays under r pixels,
    but a Gaussian filter's spread is state-dependent: after a dropped-
    frame gap (dt-aware prediction inflates P by Q(dt)) or at recovery
    init the spread reaches many pixels and fixed-radius candidates
    miss the true silhouette entirely (measured: the dt-aware GF
    DIVERGED on a drop-heavy stream while the exact render tracked).
    Here the three sampling rings sit at ⌈spread·{⅓,⅔,1}⌉ pixels —
    traced integer gather offsets, clipped at the image border — so
    coverage follows the belief at identical cost.
    """
    # Everything below is a handful of batched ops by design: the GF
    # step is dominated by op count, not compute, and this function runs
    # once per object per IPLF iteration. Hence EDGE-PADDED DYNAMIC
    # SLICES for the shifted id images (no per-offset loops, no gather),
    # and a PAYLOAD-PACKED DOUBLE SORT for the per-pixel first-K-distinct
    # fill (no take_along_axis; values ride inside the sort keys).
    img = ids.reshape(height, width)
    spread = jnp.maximum(jnp.asarray(spread_px, jnp.float32), 1.0)
    pad = max(1, int(0.5 * max(height, width)))
    spread = jnp.minimum(spread, float(pad))
    radii = [jnp.maximum(jnp.round(spread * f), float(i + 1))
             .astype(jnp.int32)
             for i, f in enumerate((1 / 3, 2 / 3, 1.0))]
    padded = jnp.pad(img, pad, mode="edge")
    # direction-major offset order (self first) so the first distinct
    # ids span directions before refining radii; each shift is one
    # dynamic_slice of the edge-padded image (≡ border-clamped shift)
    shifts = [img]
    for uy, ux in ((0, 1), (0, -1), (1, 0), (-1, 0),
                   (1, 1), (-1, -1), (1, -1), (-1, 1)):
        for r in radii:
            shifts.append(jax.lax.dynamic_slice(
                padded, (pad + uy * r, pad + ux * r), (height, width)))
    stack = jnp.stack(shifts)                              # (C, H, W)
    stack = jnp.where(stack >= 0, stack, img[None])
    C = stack.shape[0]                                     # 25 offsets
    stack = stack.reshape(C, -1).T                         # (N, C)

    # Sort 1: key = (value, preference col) — duplicates adjacent, the
    # earliest-preference occurrence first. Decode elementwise (no
    # permutation ops needed: value and col both live in the key).
    col = jnp.arange(C, dtype=jnp.int32)[None, :]
    key = (stack + 1) * C + col                 # stack ∈ [-1, T) → ≥ 0
    skey = jnp.sort(key, axis=1)
    sv = skey // C                              # value + 1, sorted
    scol = skey % C                             # preference rank
    firsts = jnp.concatenate(
        [jnp.ones(sv[:, :1].shape, bool), sv[:, 1:] != sv[:, :-1]],
        axis=1)
    # Sort 2: key = (first-occurrence preference rank, value) — the K
    # smallest entries per pixel are the K preferred distinct ids, and
    # the value payload comes back out of the key with a modulo.
    vbits = 1 << max(12, int(num_triangles + 2).bit_length())
    key2 = jnp.where(firsts, scol, C + 1) * vbits + sv
    key2 = jnp.sort(key2, axis=1)[:, :num_candidates]
    cand = key2 % vbits - 1                     # (N, K) candidate ids
    # unfilled slots (fewer than K distinct ids) duplicate the pixel's
    # own id (harmless re-test)
    return jnp.where(key2 >= (C + 1) * vbits, stack[:, 0:1], cand)


def one_hot_selectors(cand, num_triangles: int):
    """Candidate ids (N, K) → K one-hot matrices (K, N, T) (bf16-able).

    Miss (-1) rows are all-zero → selected constants are zero → det = 0 →
    no hit, mirroring the mesh-padding convention.
    """
    T = num_triangles
    return jax.nn.one_hot(cand.T, T, dtype=jnp.float32)   # (K, N, T)


# ---------------------------------------------------------------------------
# Per-particle candidate intersection (the matmul pass)
# ---------------------------------------------------------------------------

def deferred_depth(mesh: TriangleMesh, poses, rays, selectors,
                   precision=jax.lax.Precision.HIGHEST, bary_slack=0.0,
                   barrier=False):
    """Depth for a particle batch via candidate one-hot matmuls.

    Args:
      poses: (P, 7).
      rays: (N, 3).
      selectors: (K, N, T) one-hot candidate selectors (one_hot_selectors).
      precision: of the one-hot selection dot. HIGHEST (the default)
        passes the f32 constants through unrounded; the GPU's default
        f32 dot is TF32, which would round them to 10 mantissa bits.
      bary_slack: barycentric slack of the inside-test (candidate-coverage
        fix for sub-pixel faces — see FusedSensor.bary_slack).
    Returns:
      depth (P, N), inf = miss (w.r.t. the candidate sets).
    """
    G, t_num = raycast.pose_tri_constants(mesh, poses)    # (P,T,3,3),(P,T)
    P, T = t_num.shape
    # Pack per-particle constants: (T, 10P)
    packed = jnp.concatenate(
        [G.reshape(P, T, 9), t_num[..., None]], axis=-1)  # (P, T, 10)
    packed = packed.transpose(1, 0, 2).reshape(T, P * 10)

    # All K candidate sets in ONE contraction (a per-candidate Python
    # loop costs K separate matmul+intersect kernel chains; the GF step
    # that calls this is dominated by op count):
    # (K·N, T) @ (T, 10P) → (K, N, P, 10).
    K, N, _ = selectors.shape
    S2 = selectors.reshape(K * N, T)
    if barrier:
        # Small-batch (sigma-point) callers: stop XLA from fusing the
        # traced one-hot construction INTO the dot operand, which turns
        # the contraction into large elementwise fusions. The PF deferred
        # backend does not set it: at P = 10⁴ XLA's fusion there is
        # load-bearing.
        S2, packed = jax.lax.optimization_barrier((S2, packed))
    sel = jnp.einsum("nt,tm->nm", S2, packed, precision=precision)
    sel = sel.reshape(K, N, P, 10)
    g = sel[..., :9].reshape(K, N, P, 3, 3)
    tn = sel[..., 9]                                      # (K, N, P)
    nums = jnp.einsum("nd,knpid->knpi", rays, g,
                      precision=jax.lax.Precision.HIGHEST)
    t = raycast._intersect_from_numerators(
        nums[..., 0], nums[..., 1], nums[..., 2], tn, slack=bary_slack)
    return jnp.min(t, axis=0).T                           # (P, N)


def deferred_depth_gather(mesh: TriangleMesh, poses, rays, cand,
                          bary_slack=0.0):
    """Candidate-set depth via a DIRECT GATHER of per-candidate
    constants — the small-batch (sigma-point) twin of
    :func:`deferred_depth`.

    The one-hot matmul formulation earns its keep at particle counts
    (one (N,T)@(T,10P) pass amortized over P ≈ 10⁴); at P ≈ 25 the
    traced one-hot selector instead fuses into the dot operand, while
    the gather is a single bandwidth-bound op over K·N·10P floats.

    Args:
      cand: (N, K) candidate triangle ids; -1 = none (routed to the
        mesh's degenerate padding row → det 0 → miss).
    Returns: depth (P, N), inf = miss w.r.t. the candidate sets.
    """
    G, t_num = raycast.pose_tri_constants(mesh, poses)    # (P,T,3,3),(P,T)
    P, T = t_num.shape
    packed = jnp.concatenate(
        [G.reshape(P, T, 9), t_num[..., None]], axis=-1)  # (P, T, 10)
    packed = packed.transpose(1, 0, 2)                    # (T, P, 10)
    safe = jnp.where(cand >= 0, cand, T - 1)              # pad row: miss
    sel = jnp.take(packed, safe.reshape(-1), axis=0,
                   mode="clip")                           # (N·K, P, 10)
    N, K = cand.shape
    sel = sel.reshape(N, K, P, 10)
    g = sel[..., :9].reshape(N, K, P, 3, 3)
    tn = sel[..., 9]                                      # (N, K, P)
    nums = jnp.einsum("nd,nkpid->nkpi", rays, g,
                      precision=jax.lax.Precision.HIGHEST)
    t = raycast._intersect_from_numerators(
        nums[..., 0], nums[..., 1], nums[..., 2], tn, slack=bary_slack)
    return jnp.min(t, axis=1).T                           # (P, N)


def make_sigma_renderer(meshes, rays, height: int, width: int,
                        pixel_idx=None, radius: int = 3,
                        num_candidates: int = 6, tri_chunk: int = 512,
                        bary_slack: float = None,
                        bary_slack_px: float = 0.25):
    """Candidate-set renderer for *sigma-point* batches (the GF hot path).

    Returns ``render_fn(poses)`` matching the RGF render contract
    (filters/rgf.py update(): poses (S, 7) single-object | (S, K, 7)
    scene → depth (S, n_sub); inf = miss). Sigma point 0 is by
    construction the UT mean (ops/sigma_points.py: deltas[0] = 0), so
    ``poses[0]`` serves as the per-call reference pose — the exact
    reference pass re-runs at the *current* iterate every IPLF
    iteration, and the candidate dilation only has to cover the sigma
    spread around it (≈3.6 marginal stds), not cumulative trust-region
    motion.

    This replaces the exact scan-over-triangles render of all 25 sigma
    poses (the GF's dominant cost — SURVEY §3.2 hot loop)
    with 1 exact single-pose scan + one-hot candidate matmuls:
    per-sigma-render work drops by ~T/num_candidates (≈200× for the
    1408-triangle benchmark mesh). The reference shares its CPU
    renderer (D5) between both filters the same way the PF's deferred
    backend is shared here.

    Args:
      meshes: list of TriangleMesh (K objects; min-depth composition).
      rays: FULL camera ray grid (N, 3) — the reference pass and the
        candidate dilation need image structure even when the update
        runs on a pixel subset.
      pixel_idx: optional (n_sub,) indices into the flattened grid
        (the tracker's pixel_stride subset); None = all pixels.
      radius: MINIMUM candidate ring radius in pixels — the actual
        rings scale with the sigma cloud's pixel footprint per call
        (candidate_ids_dynamic), so coverage follows the belief
        through dropped-frame gaps and recovery inits.
      num_candidates: candidate triangle ids per pixel.
    """
    from dbot_ros_tpu.ops import slack as slack_mod
    from dbot_ros_tpu.utils import se3

    pitch = slack_mod.ray_pitch(rays, height, width)
    med_edge = slack_mod.median_edge(meshes)
    rays_sub = rays if pixel_idx is None else rays[pixel_idx]
    meshes = list(meshes)
    bound_r = [float(np.linalg.norm(np.asarray(m.vertices), axis=1).max())
               for m in meshes]

    def render(poses):
        single = poses.ndim == 2
        depth = None
        for k, m in enumerate(meshes):
            p = poses if single else poses[:, k, :]
            _, ids = raycast_ids(m, p[0], rays, tri_chunk)
            # sigma-cloud pixel footprint: worst translation offset plus
            # worst rotation angle × mesh bounding radius, in pixels at
            # the reference depth — the candidate rings scale with it
            # (state-dependent spread: dropped-frame gaps and recovery
            # inits reach many pixels; see candidate_ids_dynamic)
            t_spread = jnp.max(jnp.linalg.norm(p[:, :3] - p[0, :3],
                                               axis=-1))
            ang = jnp.max(jnp.linalg.norm(
                se3.quat_boxminus(p[:, 3:7], p[0, 3:7]), axis=-1))
            z0 = jnp.maximum(p[0, 2], 0.2)
            spread_px = (t_spread + ang * bound_r[k]) / (pitch * z0)
            spread_px = jnp.clip(spread_px, float(radius),
                                 0.5 * max(height, width))
            cand = candidate_ids_dynamic(ids, height, width, spread_px,
                                         num_candidates,
                                         m.padded_triangles)
            if pixel_idx is not None:
                cand = cand[pixel_idx]
            if bary_slack is not None:
                slack = jnp.float32(bary_slack)
            else:
                zbar = slack_mod.cloud_depth(p[..., 2])
                slack = slack_mod.auto_bary_slack(zbar, pitch, med_edge,
                                                  bary_slack_px)
            sel = one_hot_selectors(cand, m.padded_triangles)
            d = deferred_depth(m, p, rays_sub, sel, bary_slack=slack,
                               barrier=True)
            depth = d if depth is None else jnp.minimum(depth, d)
        return depth

    return render


def make_deferred_renderer(mesh: TriangleMesh, rays, height: int,
                           width: int, radius: int = 2,
                           num_candidates: int = 4, tri_chunk: int = 512,
                           bary_slack: float = None,
                           bary_slack_px: float = 0.25):
    """Returns render_fn(reference_pose, poses (P,7)) → depth (P, N).

    ``bary_slack``/``bary_slack_px``: the deferred path shares the fused
    sensor's candidate-coverage failure mode for sub-pixel faces (see
    FusedSensor.bary_slack). Default (``bary_slack=None``) auto-derives
    the slack per frame as ``bary_slack_px`` pixels of footprint at the
    cloud's depth, in barycentric units of the mesh's median edge — so
    silhouette inflation stays resolution-bounded: negligible for faces
    coarser than a pixel, coverage-restoring for sub-pixel faces. Pass
    ``bary_slack=0.0`` for the exact inside-test (oracle-parity tests).
    """
    from dbot_ros_tpu.ops import slack as slack_mod

    pitch = slack_mod.ray_pitch(rays, height, width)   # == 1/fx
    med_edge = slack_mod.median_edge([mesh])

    def render(reference_pose, poses):
        _, ids = raycast_ids(mesh, reference_pose, rays, tri_chunk)
        cand = candidate_ids(ids, height, width, radius, num_candidates)
        sel = one_hot_selectors(cand, mesh.padded_triangles)
        if bary_slack is not None:
            slack = jnp.float32(bary_slack)
        else:
            # shared rule with the fused sensor (ops/slack.py) so both
            # backends apply identical slack for the same scene
            zbar = slack_mod.cloud_depth(poses[..., 2])
            slack = slack_mod.auto_bary_slack(zbar, pitch, med_edge,
                                              bary_slack_px)
        return deferred_depth(mesh, poses, rays, sel,
                              bary_slack=slack)

    return render

"""Particle weight bookkeeping and resampling.

Replaces ``fl/distribution/discrete_distribution.hpp`` (F1: categorical
sampling, entropy/KL utilities — the machinery behind D17's
KL-divergence-triggered resampling) and ``sum_of_deltas.hpp``.

All functions take *log* weights (unnormalized) — the filter works purely in
log space; normalization happens via logsumexp. Systematic resampling is the
sorted-uniform + searchsorted formulation, which XLA lowers to a vectorized
binary search (no host loop), and the same code runs under shard_map with
a psum-based global logsumexp (parallel/).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def normalize_log_weights(log_w):
    """Return (normalized log weights, logsumexp) along the last axis."""
    lse = jax.scipy.special.logsumexp(log_w, axis=-1, keepdims=True)
    return log_w - lse, lse[..., 0]


def effective_sample_size(log_w):
    """ESS = 1 / Σ wᵢ² of the normalized weights."""
    ln, _ = normalize_log_weights(log_w)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * ln, axis=-1))


def kl_to_uniform(log_w):
    """KL(w ‖ uniform) = Σ wᵢ log wᵢ + log N — the reference's resampling
    trigger (``max_kl_divergence`` in rao_blackwell_coordinate_particle_filter).
    """
    ln, _ = normalize_log_weights(log_w)
    n = log_w.shape[-1]
    w = jnp.exp(ln)
    return jnp.sum(w * jnp.where(w > 0, ln, 0.0), axis=-1) + jnp.log(
        jnp.float32(n))


def sorted_searchsorted_left(cdf, pos):
    """``searchsorted(cdf, pos, side='left')`` — blocked-rank, sort-free.

    ``jnp.searchsorted`` lowers to a while-loop binary search (one
    sequential iteration per bit), and a merged-sort formulation pays a
    2(N+M)-element multi-operand ``lax.sort``. Since ``cdf`` is already
    sorted, the rank decomposes exactly into dense elementwise work with
    no sort and no scatter:

      * split ``cdf`` into 128-wide blocks; a block contributes all 128
        elements iff its *last* element < pos (block maxima are the
        per-block tails of a sorted array);
      * ``nfull[j]`` = Σ_b (bmax_b < pos_j): one (M, B) compare-reduce;
      * only block ``nfull[j]`` straddles pos_j — row-gather its 128
        values and count the strict ``<`` within.

    Exact for any ``pos`` order (ascending not required — multinomial
    parents work too). Ties: strict ``<`` count == side='left'.
    """
    n = cdf.shape[0]
    pad = (-n) % 128
    if pad:
        # pad with a finite sentinel above any real cdf value (cdf ≤ 1 +
        # rounding); padded entries never count as '< pos'
        cdf = jnp.concatenate(
            [cdf, jnp.full((pad,), jnp.float32(jnp.finfo(jnp.float32).max))])
    blocks = cdf.reshape(-1, 128)                  # (B, 128)
    bmax = blocks[:, -1]                           # (B,)
    nfull = jnp.sum((bmax[None, :] < pos[:, None]).astype(jnp.int32),
                    axis=1)                        # (M,)
    bj = jnp.clip(nfull, 0, blocks.shape[0] - 1)
    rows = jnp.take(blocks, bj, axis=0)            # (M, 128)
    within = jnp.sum((rows < pos[:, None]).astype(jnp.int32), axis=1)
    return bj * 128 + within


def systematic_indices(key, log_w, num_samples: int):
    """Systematic (low-variance) resampling → parent indices [num_samples].

    One uniform u; thresholds (i + u)/M against the weight CDF, ranked by
    one merged sort (sorted_searchsorted_left — the queries are ascending
    by construction); deterministic given the key; preserves particle
    order (parents come out sorted), which keeps downstream gathers
    coalesced.
    """
    ln, _ = normalize_log_weights(log_w)
    cdf = jnp.cumsum(jnp.exp(ln), axis=-1)
    u = jax.random.uniform(key, ())
    pos = (jnp.arange(num_samples, dtype=jnp.float32) + u) / num_samples
    idx = sorted_searchsorted_left(cdf, pos)
    return jnp.clip(idx, 0, log_w.shape[-1] - 1).astype(jnp.int32)


def multinomial_indices(key, log_w, num_samples: int):
    """IID categorical resampling (reference: DiscreteDistribution sampling)."""
    ln, _ = normalize_log_weights(log_w)
    return jax.random.categorical(key, ln, shape=(num_samples,)).astype(
        jnp.int32)


def windowed_lane_gather(view, par, windows=(256, 1024), sanitize=False):
    """``out[:, j] = view[:, par[j]]`` — a windowed minor-axis gather.

    XLA may lower a gather along the minor axis of a large array to
    transpose → gather → transpose. Systematic resampling, however,
    produces
    *sorted* parent indices (ops/resample.systematic_indices), so within
    each 128-lane output block the parents span a narrow contiguous
    window. This exploits that:

      * per 128-lane output block, take one contiguous ``dynamic_slice``
        of ``W`` source lanes (a plain copy, bandwidth bound) and
        apply the block's permutation as a one-hot (W, 128) matmul —
        exact for finite values (one-hot operand; HIGHEST precision
        pinned so the f32 values pass through unrounded, never TF32);
      * a ladder of window sizes (like the fused kernel's compaction
        ladder): the smallest window whose span fits runs; pathological
        spans (e.g. multinomial/unsorted parents) fall back to the exact
        ``jnp.take``.

    Used by the fused sensor's occlusion lineage gather (D13's
    persistent-array scatter/gather on resample) when its
    ``lineage_gather="windowed"`` mode is selected.

    **Finiteness precondition:** the one-hot matmul computes
    ``Σ view·onehot``; any ``inf``/``NaN`` lane *inside the selected
    window* turns ``x·0`` into ``NaN`` and poisons the whole 128-lane
    output block. ``view`` must therefore be all-finite (occlusion
    probabilities in [0, 1] are), or pass ``sanitize=True`` to zero
    non-finite lanes before the matmul and restore them (as gathered by
    an exact mask matmul) afterwards — do NOT use the raw fast path on
    log-space arrays where ``-inf`` is routine.

    Args:
      view: (R, C) f32, C a multiple of 128 (particles on lanes).
        Must be all-finite unless ``sanitize=True``.
      par: (Co,) int32 parent lane ids, Co a multiple of 128. Fast iff
        sorted (or blockwise narrow); correct for any order. Out-of-range
        ids are clamped to [0, C) up front, so the fast path and the
        fallback agree exactly (raw ``jnp.take`` under jit would instead
        wrap negatives and NaN-fill past-the-end ids).
      windows: ascending ladder of window widths (multiples of 128).
      sanitize: handle non-finite ``view`` values exactly (extra
        mask matmuls; off on the hot path).
    Returns:
      (R, Co) gathered array.
    """
    R, C = view.shape
    co = par.shape[0]
    if co % 128:
        raise ValueError(f"par length {co} not a multiple of 128")
    # Clamp once so the fast path and the jnp.take fallback agree on
    # out-of-range parents (take clamps under jit; an unclamped one-hot
    # column would silently produce zeros instead).
    par = jnp.clip(par.astype(jnp.int32), 0, C - 1)
    if sanitize:
        finite = jnp.isfinite(view)
        isnan = jnp.isnan(view)
        safe = jnp.where(finite, view, 0.0)
        sign = jnp.where(view > 0, 1.0, -1.0)
        out = windowed_lane_gather(safe, par, windows)
        nan_g = windowed_lane_gather(isnan.astype(view.dtype), par,
                                     windows)
        inf_g = windowed_lane_gather(
            jnp.where(finite, 0.0, sign).astype(view.dtype), par, windows)
        out = jnp.where(jnp.abs(inf_g) > 0.5,
                        jnp.sign(inf_g) * jnp.inf, out)
        return jnp.where(nan_g > 0.5, jnp.nan, out)
    pb = par.reshape(-1, 128)
    lo = jnp.min(pb, axis=1)
    hi = jnp.max(pb, axis=1)
    # All window starts are rounded DOWN to a 128-lane boundary, so
    # every slice starts on an aligned block. A window w therefore covers
    # a block iff the block's parents fit in [align(lo), align(lo) + w).
    lo_al = (lo // 128) * 128
    span_al = jnp.max(hi - lo_al) + 1          # per-block, aligned
    g0 = (jnp.min(lo) // 128) * 128
    span_glob = jnp.max(hi) - g0 + 1           # one window for ALL blocks

    def fallback(_):
        return jnp.take(view, par, axis=1, mode="clip")

    def make_global(w):
        """One aligned slab + one (w, Co) one-hot dot for the whole
        map — the degenerate/low-ESS regime (all parents in one narrow
        range), where per-block slabs would re-read the same lanes."""
        start = jnp.minimum(g0, C - w)
        iw = jnp.arange(w, dtype=jnp.int32)

        def glob(_):
            slab = jax.lax.dynamic_slice(view, (0, start), (R, w))
            onehot = (iw[:, None] == (par - start)[None, :]).astype(
                view.dtype)
            return jax.lax.dot(slab, onehot,
                               precision=jax.lax.Precision.HIGHEST)
        return glob

    def make_fast(w):
        starts = jnp.minimum(lo_al, C - w)
        iw = jnp.arange(w, dtype=jnp.int32)

        def fast(_):
            def body(out, b):
                s = starts[b]
                slab = jax.lax.dynamic_slice(view, (0, s), (R, w))
                onehot = (iw[:, None] == (pb[b] - s)[None, :]).astype(
                    view.dtype)
                blk = jax.lax.dot(slab, onehot,
                                  precision=jax.lax.Precision.HIGHEST)
                return jax.lax.dynamic_update_slice(out, blk,
                                                    (0, b * 128)), None
            out, _ = jax.lax.scan(
                body, jnp.zeros((R, co), view.dtype),
                jnp.arange(pb.shape[0], dtype=jnp.int32))
            return out
        return fast

    branch = fallback
    for w in sorted({int(x) for x in windows if x <= C}, reverse=True):
        branch = functools.partial(
            lambda w, nxt, _: jax.lax.cond(span_al <= w, make_fast(w),
                                           nxt, None),
            w, branch)
    wg = min(int(windows[-1]), C)
    branch = functools.partial(
        lambda w, nxt, _: jax.lax.cond(span_glob <= w, make_global(w),
                                       nxt, None),
        wg, branch)
    return branch(None)


def resample_pytree(tree, indices):
    """Gather every leaf's leading (particle) axis by ``indices``.

    This single ``jnp.take`` per leaf is what replaces the reference's
    trickiest invariant — the persistent per-particle occlusion arrays on
    the GPU, scattered/gathered by CUDA on every resample
    (cuda_likelihood_evaluator.cu): here the occlusion map is just another
    leaf of the belief pytree.
    """
    return jax.tree_util.tree_map(lambda x: jnp.take(x, indices, axis=0),
                                  tree)

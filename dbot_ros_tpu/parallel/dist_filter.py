"""Multi-chip / multi-host particle filtering with shard_map.

(SURVEY.md §2.5, P1/P3/P5-P7.)

The reference's only scaling axis is GPU-tile data parallelism over
particles inside one process (D12-D14). Here particles shard across a
``jax.sharding.Mesh`` axis ("p" — the cards of one host, joined all to
all by NVLink on an H100 machine); the whole filter
step runs under ``shard_map`` with explicit collectives:

  * likelihood evaluation: embarrassingly parallel per shard (the compute-
    dominant term — scaling efficiency lives here);
  * weight normalization / ESS / KL trigger: ``psum`` of shard-local
    logsumexp partials;
  * systematic resampling: ``all_gather`` of the (tiny: P floats) weight
    vector → identical global parent indices on every shard → each shard
    materializes its slice of offspring, fetching parent *state* via an
    all_gather of pose states (P×K×13 floats — small) and parent
    occlusion rows via one of the ``exchange`` strategies (the O(P·N_pix)
    movement — SURVEY.md hard part #2). The default ``"counts"`` exchange
    redistributes *surplus particles only*: traffic ∝ distinct parents
    moved, not P. :func:`make_island_step` removes the per-particle
    exchange from the common path entirely (island-model PF).

Multi-object scenes run the reference's coordinate-block loop (D17/P3)
inside shard_map: per object, sample the block, evaluate the union-scene
likelihood, telescope the weights, and resample globally when the KL
trigger fires — identical semantics to the single-device
``filters.rbcpf.rbcpf_step``.

Multi-scene batching (P7) composes on a second mesh axis:
:func:`make_multi_scene_step` runs S independent scenes on a 2-D
``Mesh(("host", "chip"))`` — scenes data-parallel over "host" (zero
cross-scene collectives, so the axis may span hosts), particles over
"chip" (all per-frame collectives) — the SURVEY §7 layer-8 layout. The
same code runs multi-process
under ``jax.distributed`` (tests/test_multihost.py drives 2 CPU
processes × 4 virtual devices each through it).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dbot_ros_tpu.filters.rbcpf import ParticleBelief
from dbot_ros_tpu.models.transition import TransitionParams, sample_transition
from dbot_ros_tpu.ops import resample as rs

EXCHANGES = ("counts", "neighbor", "ring", "all_gather")


def make_particle_mesh(n_devices: int = None, axis: str = "p") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_scene_mesh(n_scene: int, n_particle: int,
                    axis_names=("host", "chip")) -> Mesh:
    """2-D mesh: scenes/objects on the first axis, particles on the
    second — SURVEY.md §7 layer 8's ``Mesh(("host","chip"))``.

    Across hosts ``jax.devices()`` orders devices host-major, so the
    reshape puts whole hosts on the scene axis: the particle collectives
    (psum/ppermute every frame) stay among one host's cards (all to all
    over NVLink on an H100 machine) while the scene axis carries no
    collectives at all (pure data parallelism across the network).
    """
    devs = jax.devices()
    need = n_scene * n_particle
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_scene, n_particle),
                axis_names)


def _round_up128(n: int) -> int:
    return -(-int(n) // 128) * 128


def _occ_hooks(loglik_fn):
    """Occlusion-leaf hooks: sensor-provided (opaque device layout, e.g.
    the fused Pallas sensor's kernel layout) or the (P, N) defaults.

    Returns (gather, where, concat, stride):
      * gather(occ, idx, num_in=None): particle-axis gather; ``num_in``
        is the source particle count when it differs from ``len(idx)``;
      * where(mask, a, b): per-particle select between two maps;
      * concat(blocks, num_each): concatenate equal-size particle
        blocks along the particle axis;
      * stride(n): the padded lane count of one n-particle block —
        the index stride inside a concat result, and the ``num_in``
        unit for gathers from concat'd sources (opaque layouts may pad
        beyond 128-lane multiples; the plain layout doesn't pad).
    """
    sensor_gather = getattr(loglik_fn, "gather_occlusion", None)
    if sensor_gather is None:
        def gather(occ, idx, num_in=None):
            return jnp.take(occ, idx, axis=0, mode="clip")
    else:
        def gather(occ, idx, num_in=None):
            return sensor_gather(occ, idx, num_in=num_in)
    where = getattr(loglik_fn, "where_occlusion", None) or (
        lambda mask, a, b: jnp.where(
            mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b))
    concat = getattr(loglik_fn, "concat_occlusion", None)
    if concat is None:
        stride = lambda n: n  # noqa: E731
        concat = lambda blocks, num_each: jnp.concatenate(  # noqa: E731
            blocks, axis=0)
    else:
        stride = getattr(loglik_fn, "particle_stride", _round_up128)
    return gather, where, concat, stride


def init_distributed_belief(key, initial_poses, num_particles: int,
                            mesh: Mesh, num_pixels: int = None,
                            initial_occlusion_prob=0.1, sensor=None,
                            axis: str = "p") -> ParticleBelief:
    """Sharded belief whose occlusion leaf is per-shard sensor blocks.

    With a sensor that owns its occlusion layout (``init_occlusion``
    hook), the global leaf is the concatenation of the per-shard local
    blocks along axis 0 — each shard sees exactly the local layout the
    sensor expects. Otherwise this is init_belief + shard_belief.
    """
    from dbot_ros_tpu.filters.rbcpf import init_belief

    n_shards = mesh.shape[axis]
    if num_particles % n_shards:
        raise ValueError(f"num_particles {num_particles} not divisible by "
                         f"mesh axis size {n_shards}")
    belief = init_belief(key, initial_poses, num_particles,
                         num_pixels or 0, initial_occlusion_prob)
    if sensor is not None and hasattr(sensor, "init_occlusion"):
        local = sensor.init_occlusion(num_particles // n_shards,
                                      initial_occlusion_prob)
        # the occlusion leaf may be a pytree (e.g. the fused sensor's
        # lazy (q, age) tuple) — stack every leaf shard-wise so the
        # particle-axis sharding splits it back into the local blocks
        occ = jax.tree_util.tree_map(
            lambda x: jnp.concatenate([x] * n_shards, axis=0), local)
        belief = ParticleBelief(states=belief.states,
                                log_weights=belief.log_weights,
                                occlusion=occ, key=belief.key)
    return shard_belief(belief, mesh, axis)


def shard_belief(belief: ParticleBelief, mesh: Mesh,
                 axis: str = "p") -> ParticleBelief:
    """Place particle-axis leaves across the mesh (key replicated)."""
    pspec = NamedSharding(mesh, P(axis))
    rspec = NamedSharding(mesh, P())
    return ParticleBelief(
        states=jax.device_put(belief.states, pspec),
        log_weights=jax.device_put(belief.log_weights, pspec),
        occlusion=jax.device_put(belief.occlusion, pspec),
        key=jax.device_put(belief.key, rspec),
    )


def _global_log_normalizers(log_w, axis):
    """(logsumexp, sum of squared weights, KL) across all shards."""
    m_local = jnp.max(log_w)
    m = jax.lax.pmax(m_local, axis)
    s1 = jax.lax.psum(jnp.sum(jnp.exp(log_w - m)), axis)
    lse = m + jnp.log(s1)
    ln = log_w - lse
    w = jnp.exp(ln)
    s2 = jax.lax.psum(jnp.sum(w * w), axis)
    p_total = jax.lax.psum(jnp.float32(log_w.shape[0]), axis)
    kl = jax.lax.psum(jnp.sum(w * jnp.where(w > 0, ln, 0.0)), axis) \
        + jnp.log(p_total)
    return lse, s2, kl, p_total


def _psum_mean_state(states, w, axis, power_iters=12):
    """Global weighted mean over sharded particles → (K, 13).

    Linear part by psum; per-object quaternion mean as the principal
    eigenvector of the psum'd 4×4 outer-product matrix by power iteration
    (see se3.states_mean — eigh on tiny matrices is disproportionately
    slow under jit).
    """
    lin = jax.lax.psum(jnp.einsum("p,pkd->kd", w, states), axis)
    q = states[..., 3:7]                                     # (P, K, 4)
    A = jax.lax.psum(jnp.einsum("p,pki,pkj->kij", w, q, q), axis)
    qm = A[..., 0]
    qm = qm / jnp.maximum(jnp.linalg.norm(qm, axis=-1, keepdims=True),
                          1e-12)
    for _ in range(power_iters):
        qm = jnp.einsum("kij,kj->ki", A, qm)
        qm = qm / jnp.maximum(jnp.linalg.norm(qm, axis=-1, keepdims=True),
                              1e-20)
    qm = qm * jnp.where(qm[..., :1] < 0, -1.0, 1.0)
    return jnp.concatenate([lin[:, :3], qm, lin[:, 7:13]], axis=-1)


def _resample_block(states, log_w, occ, old_loglik, *, do, ln, k_res,
                    idx, n_shards, p_local, axis, exchange, max_hops,
                    capacity, hooks):
    """Global systematic resampling of one coordinate block's aftermath.

    Returns (states, log_w, occ, old_loglik). All exchange modes produce
    the all_gather resampler's output bit-for-bit (same key → same
    parents); they differ only in how parent occlusion rows cross shards
    (see make_distributed_step's docstring).

    The KL trigger ``do`` is NOT a ``lax.cond`` over the belief: a cond
    whose operands include the occlusion map adds cond-boundary full-map
    copies (DESIGN.md anti-pattern #1). Instead the parent vector is
    ``where``-selected between systematic parents and the global
    identity, and the gathers/collectives run unconditionally — on
    no-resample frames every exchange reduces to an identity gather and
    (counts mode) empty surplus buffers, keeping collective order
    uniform across shards (the shard_map correctness requirement). This
    is the distributed analog of ``rbcpf._maybe_resample``.
    """
    occ_gather, occ_where, occ_concat, occ_stride = hooks
    w_all = jax.lax.all_gather(jnp.exp(ln), axis, tiled=True)
    cdf = jnp.cumsum(w_all)
    u = jax.random.uniform(k_res, ())  # same key → same u everywhere
    total = w_all.shape[0]

    def shard_parents(shard):
        """Where-selected global parent indices of shard ``shard``:
        systematic parents on resample frames, identity otherwise."""
        ar = jnp.arange(p_local, dtype=jnp.float32)
        pos = (ar + shard * p_local + u) / total
        # pos is ascending -> rank by the blocked compare-reduce instead
        # of the while-loop binary search (see resample.py notes)
        p_rs = jnp.clip(rs.sorted_searchsorted_left(cdf, pos),
                        0, total - 1)
        return jnp.where(do, p_rs,
                         shard * p_local + jnp.arange(p_local,
                                                      dtype=jnp.int32))

    parents = shard_parents(idx)
    # Parent states + running loglik: tiny, always all_gather.
    st_all = jax.lax.all_gather(states, axis, tiled=True)
    new_states = jnp.take(st_all, parents, axis=0)
    ll_all = jax.lax.all_gather(old_loglik, axis, tiled=True)
    new_old_loglik = jnp.take(ll_all, parents, axis=0)
    new_log_w = jnp.where(do, jnp.zeros_like(log_w), log_w)

    owner = parents // p_local
    local_idx = jnp.clip(parents - idx * p_local, 0, p_local - 1)

    if n_shards == 1:
        # Axis-size-1 mesh: every parent is local — the exchange
        # degenerates (at trace time) to the single-device lineage
        # gather. No collectives, no select, no cond.
        new_occ = occ_gather(occ, local_idx)
        return new_states, new_log_w, new_occ, new_old_loglik

    def pluck(out, blk, src):
        """Copy rows of `parents` owned by shard `src` from blk."""
        src_idx = jnp.clip(parents - src * p_local, 0, p_local - 1)
        mask = ((parents >= src * p_local)
                & (parents < (src + 1) * p_local))
        return occ_where(mask, occ_gather(blk, src_idx), out)

    def full_ring(occ):
        # At round r shard `idx` holds shard (idx+r)%S's block; it
        # copies the rows of parents owned by that shard, then passes
        # the block along the ring.
        ring = [(i, (i - 1) % n_shards) for i in range(n_shards)]

        def round_body(r, carry):
            held, out = carry
            out = pluck(out, held, (idx + r) % n_shards)
            held = jax.lax.ppermute(held, axis, ring)
            return held, out

        zero = jax.tree_util.tree_map(jnp.zeros_like, occ)
        _, new_occ = jax.lax.fori_loop(0, n_shards, round_body,
                                       (occ, zero))
        return new_occ

    if exchange == "all_gather":
        def gather_path(occ):
            stride = occ_stride(p_local)
            occ_all = jax.tree_util.tree_map(
                lambda x: jax.lax.all_gather(x, axis), occ)  # (S, ...)
            blocks = [jax.tree_util.tree_map(lambda x, s=s: x[s], occ_all)
                      for s in range(n_shards)]
            combined = occ_concat(blocks, p_local)
            gidx = owner * stride + (parents - owner * p_local)
            return occ_gather(combined, gidx, num_in=n_shards * stride)

        # A/B modes keep an occ-only cond (the full exchange every frame
        # would cost more traffic than the cond-boundary copy); the
        # uniform `do` predicate keeps collective order consistent.
        new_occ = jax.lax.cond(do, gather_path, lambda o: o, occ)
    elif exchange == "ring" or (exchange == "neighbor"
                                and n_shards <= 2 * max_hops + 1):
        new_occ = jax.lax.cond(do, full_ring, lambda o: o, occ)
    elif exchange == "neighbor":
        # Bounded-hop whole-block exchange: parents are sorted, so this
        # shard needs rows from owner shards within [d_min, d_max] hops.
        # The hop span is reduced globally (pmax — uniform predicate) so
        # every shard takes the same branch; overflow frames run the
        # exact full ring.
        d = owner - idx
        span = jax.lax.pmax(jnp.maximum(jnp.max(d), -jnp.min(d)), axis)

        def neighbor(occ):
            out = jax.tree_util.tree_map(jnp.zeros_like, occ)
            out = pluck(out, occ, idx)
            for h in range(1, max_hops + 1):
                for s in (h, -h):
                    # blk on shard i = shard (i+s) mod S's block
                    perm = [((i + s) % n_shards, i)
                            for i in range(n_shards)]
                    blk = jax.lax.ppermute(occ, axis, perm)
                    out = pluck(out, blk, (idx + s) % n_shards)
            return out

        new_occ = jax.lax.cond(
            do,
            lambda o: jax.lax.cond(span <= max_hops, neighbor,
                                   full_ring, o),
            lambda o: o, occ)
    else:
        # Count-redistribution (SURVEY §7 hard part #2: "redistribute
        # counts then shuffle only surplus particles") — the production
        # mode, and the only one that is COND-FREE on the common path:
        #
        #   * locally-owned parent rows (all of them on no-resample
        #     frames, most of them on resample frames — systematic
        #     parents are sorted) come from one unconditional lineage
        #     gather, exactly the single-device fast path;
        #   * remote rows ride per-hop C-row surplus buffers: every
        #     shard recomputes each hop-neighbor's parent list from the
        #     shared (cdf, u) — no extra communication — compacts the
        #     *distinct* rows that neighbor needs from it, and ships
        #     only the buffers (one small ppermute per hop, identical
        #     every frame → uniform collective order). The plans are
        #     gated on `do`, so no-resample frames ship empty buffers
        #     and the final merge select keeps the local gather.
        #
        # Interconnect traffic ∝ distinct parents moved, not P. Frames
        # whose hop
        # span or distinct-parent count overflow run the exact full
        # ring via a rare occ-only cond — skipped at trace time when
        # (capacity, max_hops) make overflow impossible.
        C = capacity if capacity is not None else max(128, p_local // 8)
        C = min(_round_up128(C), _round_up128(p_local))
        # s ≡ 0 (mod S) would "ship" a shard its own rows — the local
        # gather already covers those (and on identity frames such a
        # plan would spuriously overflow the capacity check). Hops
        # congruent mod S reach the same neighbor — keep one per
        # residue (smallest |s|) or a 2-shard mesh ships every buffer
        # twice.
        hops, seen = [], set()
        for s_ in sorted(range(-max_hops, max_hops + 1), key=abs):
            r = s_ % n_shards
            if r != 0 and r not in seen:
                seen.add(r)
                hops.append(s_)
        half = n_shards // 2
        dw = (owner - idx + half) % n_shards - half  # minimal signed hop
        span = jax.lax.pmax(jnp.max(jnp.abs(dw)), axis)

        # Sender-side compaction plans: for each hop, the distinct local
        # rows the destination shard needs from this shard ((L,) vector
        # math — cheap).
        plans = []
        m_max = jnp.int32(0)
        for s in hops:
            dest = (idx + s) % n_shards
            p_d = shard_parents(dest)
            mine = (p_d // p_local) == idx
            chg = jnp.concatenate(
                [jnp.ones((1,), bool), p_d[1:] != p_d[:-1]])
            first = mine & chg
            slot = jnp.cumsum(first.astype(jnp.int32)) - 1
            # compact: rows[slot] = local parent row, only where `first`
            # (out-of-bounds targets are dropped)
            rows = jnp.zeros((C,), jnp.int32).at[
                jnp.where(first, slot, C)].set(
                jnp.where(first, p_d - idx * p_local, 0), mode="drop")
            plans.append(rows)
            m_max = jnp.maximum(m_max, jnp.sum(first.astype(jnp.int32)))
        m_max = jax.lax.pmax(m_max, axis)

        # Receiver-side slots into the fused buffer (one C-particle
        # block per hop, lane stride occ_stride(C)): offspring j's parent
        # sits at slot = its distinct-rank within the run of parents
        # owned by the source shard (cumsum of first-occurrence flags —
        # duplicates inherit the preceding first's rank).
        Cs = occ_stride(C)
        chg_mine = jnp.concatenate(
            [jnp.ones((1,), bool), parents[1:] != parents[:-1]])
        cidx = jnp.zeros((p_local,), jnp.int32)
        for h, s in enumerate(hops):
            src = (idx - s) % n_shards
            mask = owner == src
            slotm = jnp.cumsum((mask & chg_mine).astype(jnp.int32)) - 1
            cidx = jnp.where(mask, h * Cs + slotm, cidx)

        loc = occ_gather(occ, local_idx)

        def counts_path(loc):
            bufs = []
            for s, rows in zip(hops, plans):
                buf = occ_gather(occ, rows, num_in=occ_stride(p_local))
                perm = [(i, (i + s) % n_shards)
                        for i in range(n_shards)]
                buf = jax.lax.ppermute(buf, axis, perm)
                bufs.append(buf)
            combined = occ_concat(bufs, C)
            remote = occ_gather(combined, cidx, num_in=Cs * len(hops))
            return occ_where(owner != idx, remote, loc)

        if max_hops >= n_shards // 2 and C >= p_local:
            # overflow statically impossible: no fallback cond at all
            new_occ = counts_path(loc)
        else:
            ok = (span <= max_hops) & (m_max <= C)
            new_occ = jax.lax.cond(ok, counts_path,
                                   lambda _loc: full_ring(occ), loc)

    return new_states, new_log_w, new_occ, new_old_loglik


def _make_step_local(loglik_fn, trans_params, dt, max_kl_divergence,
                     axis, exchange, max_hops, capacity):
    """Per-scene local step body: (states, log_w, occ, key (2,), z_obs)
    → (states, log_w, occ, key', mean_state (K,13), ess). Collectives
    reference ``axis`` by name; shared by the 1-D particle step and the
    2-D scene×particle step (where it runs under a scene vmap)."""
    hooks = _occ_hooks(loglik_fn)
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode: {exchange!r}")

    def step_one(states, log_w, occ, key, z_obs):
        idx = jax.lax.axis_index(axis)
        n_shards = jax.lax.axis_size(axis)
        p_local = states.shape[0]
        num_objects = states.shape[1]

        key_next, k_trans, k_res_base = jax.random.split(key, 3)
        old_loglik = jnp.zeros_like(log_w)

        # --- the reference's coordinate-block loop (D17/P3), unrolled
        for b in range(num_objects):
            k_b = jax.random.fold_in(
                jax.random.fold_in(k_trans, b), idx)
            new_block = sample_transition(k_b, states[:, b], dt,
                                          trans_params)
            states = states.at[:, b].set(new_block)

            # evaluate; occlusion posterior committed on the last block
            loglik, occ_post = loglik_fn(states, occ, z_obs, dt)
            if b == num_objects - 1:
                occ = occ_post
            log_w = log_w + loglik - old_loglik
            old_loglik = loglik

            # --- global weight stats (psum over the particle axis)
            lse, s2, kl, p_total = _global_log_normalizers(log_w, axis)
            ln = log_w - lse

            # --- KL-triggered global systematic resampling. NOT a
            # lax.cond over the belief (DESIGN.md anti-pattern #1 —
            # cond-boundary copies of the occlusion map): the trigger rides into _resample_block as a
            # where-select on the parent indices, and the gathers +
            # collectives run unconditionally in uniform order.
            k_res = jax.random.fold_in(k_res_base, b)
            states, log_w, occ, old_loglik = _resample_block(
                states, log_w, occ, old_loglik,
                do=kl > max_kl_divergence, ln=ln, k_res=k_res, idx=idx,
                n_shards=n_shards, p_local=p_local, axis=axis,
                exchange=exchange, max_hops=max_hops,
                capacity=capacity, hooks=hooks)

        # --- weighted mean state over all K objects (psum-reduced);
        # recompute the normalizer after the potential resample
        lse2, s2b, _, _ = _global_log_normalizers(log_w, axis)
        w = jnp.exp(log_w - lse2)
        mean_state = _psum_mean_state(states, w, axis)
        return states, log_w, occ, key_next, mean_state, 1.0 / s2b

    return step_one


def make_distributed_step(mesh: Mesh, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          axis: str = "p", exchange: str = "counts",
                          max_hops: int = 1, capacity: int = None):
    """Build a jitted multi-chip RBC-PF step (K objects per scene).

    Returns step(belief_sharded, z_obs) → (belief_sharded, mean_state
    (K, 13), ess). The observation ``z_obs`` is replicated; all
    particle-axis leaves stay sharded in and out. The input belief is
    DONATED (its buffers are invalidated — keep the returned belief;
    to step the same belief through several step functions, e.g. for
    exchange-mode A/B, rebuild or copy it first).
    Multi-object scenes run the reference's sequential coordinate blocks
    (D17/P3) with per-block KL-triggered global resampling — semantics
    identical to the single-device ``rbcpf_step``.

    ``exchange`` picks how resampling fetches parent occlusion maps
    across shards (the O(P·N_pix) movement — SURVEY.md hard part #2):

      * ``"counts"`` (default): count-redistribution. Systematic parents
        are globally sorted, so shard s's offspring draw from a narrow
        contiguous parent range, and most offspring descend from few
        distinct parents. Every shard recomputes every hop-neighbor's
        parent list from the all_gather'd weights (P floats), compacts
        the *distinct* rows that neighbor needs from it into a
        ``capacity``-row surplus buffer, and ships only those buffers
        (one ppermute per hop, ≤ ``max_hops`` each way). Traffic is
        (2·max_hops+1)·capacity rows instead of the ring's S·L —
        proportional to particles actually moved. Frames whose hop span
        or distinct-parent count overflow fall back to the exact full
        ring, so every mode equals the all_gather resampler bit-for-bit.
      * ``"neighbor"``: bounded-hop whole-block exchange — (2H+1) block
        ppermutes; kept for A/B comparison.
      * ``"ring"``: S-step ppermute ring — peak memory O(2 local
        blocks); the occlusion map never materializes unsharded.
      * ``"all_gather"``: gather the full map then take (simplest;
        bounded by per-chip HBM).

    ``capacity`` (counts mode) is the surplus-buffer row count; rounded
    up to a multiple of 128 (uniform lane stride for opaque kernel
    layouts); default ``max(128, L/8)`` for L local particles.

    Parent *states* are always fetched via all_gather — (P, K, 13)
    floats is negligible. Works with any sensor, including the fused
    Pallas sensor whose occlusion leaf lives in an opaque kernel layout
    (hooks ``gather_occlusion``/``where_occlusion``/``concat_occlusion``).
    """
    inner = _make_step_local(loglik_fn, trans_params, dt,
                             max_kl_divergence, axis, exchange,
                             max_hops, capacity)

    def step_local(states, log_w, occ, key, z_obs):
        st, lw, occ2, k2, mean_state, ess = inner(states, log_w, occ,
                                                  key[0], z_obs)
        return st, lw, occ2, k2[None], mean_state, ess

    pspec = P(axis)
    rspec = P()
    sharded = shard_map(
        step_local, mesh=mesh,
        in_specs=(pspec, pspec, pspec, rspec, rspec),
        out_specs=(pspec, pspec, pspec, rspec, rspec, rspec),
        check_vma=False)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(belief: ParticleBelief, z_obs):
        states, log_w, occ, key, mean_state, ess = sharded(
            belief.states, belief.log_weights, belief.occlusion,
            belief.key[None], z_obs)
        return (ParticleBelief(states=states, log_weights=log_w,
                               occlusion=occ, key=key[0]),
                mean_state, ess)

    return step


# ---------------------------------------------------------------------------
# 2-D mesh: scenes on "host", particles on "chip"
# ---------------------------------------------------------------------------

def init_multi_scene_belief(key, initial_poses, num_scenes: int,
                            num_particles: int, mesh: Mesh,
                            num_pixels: int = None,
                            initial_occlusion_prob=0.1, sensor=None,
                            scene_axis: str = "host",
                            particle_axis: str = "chip") -> ParticleBelief:
    """Batched belief for S independent scenes on a 2-D mesh.

    Leaves gain a leading scene axis: states (S, P, K, 13), log_weights
    (S, P), occlusion (S, ...), key (S, 2). ``initial_poses`` may be
    (7,) / (K, 7) (same start everywhere) or (S, K, 7).
    """
    from dbot_ros_tpu.filters.rbcpf import init_belief

    n_p = mesh.shape[particle_axis]
    n_s = mesh.shape[scene_axis]
    if num_particles % n_p:
        raise ValueError(f"num_particles {num_particles} not divisible "
                         f"by particle axis size {n_p}")
    if num_scenes % n_s:
        raise ValueError(f"num_scenes {num_scenes} not divisible by "
                         f"scene axis size {n_s}")
    poses = jnp.asarray(initial_poses, jnp.float32)
    if poses.ndim == 1:
        poses = poses[None]
    if poses.ndim == 2:
        poses = jnp.broadcast_to(poses[None], (num_scenes,) + poses.shape)
    keys = jax.random.split(key, num_scenes)

    def one(k, p):
        b = init_belief(k, p, num_particles, num_pixels or 0,
                        initial_occlusion_prob)
        if sensor is not None and hasattr(sensor, "init_occlusion"):
            local = sensor.init_occlusion(num_particles // n_p,
                                          initial_occlusion_prob)
            occ = jax.tree_util.tree_map(
                lambda x: jnp.concatenate([x] * n_p, axis=0), local)
            b = ParticleBelief(states=b.states,
                               log_weights=b.log_weights,
                               occlusion=occ, key=b.key)
        return b

    belief = jax.vmap(one)(keys, poses)
    sp = NamedSharding(mesh, P(scene_axis, particle_axis))
    ss = NamedSharding(mesh, P(scene_axis))
    return ParticleBelief(
        states=jax.device_put(belief.states, sp),
        log_weights=jax.device_put(belief.log_weights, sp),
        occlusion=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sp), belief.occlusion),
        key=jax.device_put(belief.key, ss),
    )


def make_multi_scene_step(mesh: Mesh, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          scene_axis: str = "host",
                          particle_axis: str = "chip",
                          exchange: str = "counts", max_hops: int = 1,
                          capacity: int = None):
    """Multi-host/multi-scene step over ``Mesh((scene_axis, particle_axis))``.

    Each scene runs the full distributed RBC-PF over the particle axis
    (psum normalization, KL-triggered exchange resampling); the scene
    axis carries **no collectives** — scenes are pure data parallelism,
    so the step scales across hosts independent of the network between
    them (north star #3). Runs unchanged under ``jax.distributed``
    with the scene
    axis spanning processes (tests/test_multihost.py).

    Note: the per-block resampling path is cond-free (where-selected
    parents, unconditional collectives — see ``_resample_block``) for
    the default ``counts`` exchange when (capacity, max_hops) make
    overflow statically impossible, so it vmaps over scenes without
    branch linearization; collective order is uniform across the
    particle axis by construction. The all_gather/ring/neighbor modes
    and the counts overflow fallback still wrap their collectives in an
    occ-only ``lax.cond`` that linearizes to a select under the scene
    vmap (both branches paid) — prefer counts with ample capacity for
    multi-scene meshes (advisor r4).

    step(belief, z_obs) → (belief, mean_states (S, K, 13), ess (S,)),
    where z_obs is (S, N) sharded over the scene axis.
    """
    inner = _make_step_local(loglik_fn, trans_params, dt,
                             max_kl_divergence, particle_axis, exchange,
                             max_hops, capacity)

    def scenes_local(states, log_w, occ, keys, z_obs):
        # leading axis = local scenes; collectives inside run over the
        # particle axis only (vmap over a positional axis is transparent
        # to named-axis collectives)
        return jax.vmap(inner)(states, log_w, occ, keys, z_obs)

    sp = P(scene_axis, particle_axis)
    ss = P(scene_axis)
    sharded = shard_map(
        scenes_local, mesh=mesh,
        in_specs=(sp, sp, sp, ss, ss),
        out_specs=(sp, sp, sp, ss, ss, ss),
        check_vma=False)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(belief: ParticleBelief, z_obs):
        states, log_w, occ, keys, mean_states, ess = sharded(
            belief.states, belief.log_weights, belief.occlusion,
            belief.key, z_obs)
        return (ParticleBelief(states=states, log_weights=log_w,
                               occlusion=occ, key=keys),
                mean_states, ess)

    return step


# ---------------------------------------------------------------------------
# Island-model distributed PF: zero collectives on the common path
# ---------------------------------------------------------------------------

def make_island_step(mesh: Mesh, loglik_fn: Callable,
                     trans_params: TransitionParams, dt: float,
                     max_kl_divergence: float = 1.0,
                     island_max_kl: float = 0.5,
                     axis: str = "p"):
    """Island-model RBC-PF step (Vergé et al., "island particle filter").

    The plain distributed step (make_distributed_step) pays a collective
    exchange of occlusion rows on every KL-triggered resample. The
    island model removes it from the common path:

      * each shard ("island") runs a complete local PF: local
        likelihoods, local KL-triggered systematic resampling per
        coordinate block — **no communication** (occlusion lineage
        gathers use the sensor's ``gather_occlusion`` hook, so the fused
        Pallas sensor's kernel-layout occlusion state works unchanged
        inside shard_map);
      * the island itself carries a log-weight ``b_i`` (its share of the
        global marginal likelihood), updated with the island's local
        logsumexp increment each block (telescoping across coordinate
        blocks);
      * only when the *island* weights degenerate (KL over n_islands
        exceeds ``island_max_kl``) are whole island blocks exchanged —
        a block-regular collective (all_gather + select of equal-size
        blocks), far rarer than particle-level resampling.

    Posterior queries (mean state, ESS) weight island-locally-normalized
    particles by the island weights via psum — exact, cheap.

    Belief layout: identical to the plain step, plus the island
    log-weight folded into ``log_weights`` (each shard's block carries
    its island offset added to every local log weight, so the global
    weight vector remains exactly the importance weights of the full
    filter).
    """
    occ_gather, _, _, _ = _occ_hooks(loglik_fn)

    def step_local(states, log_w, occ, key, z_obs):
        idx = jax.lax.axis_index(axis)
        n_islands = jax.lax.axis_size(axis)
        p_local = states.shape[0]
        num_objects = states.shape[1]

        key_next, k_trans, k_res, k_isl = jax.random.split(key[0], 4)
        k_trans = jax.random.fold_in(k_trans, idx)
        k_res = jax.random.fold_in(k_res, idx)

        # --- coordinate-block loop: transition + likelihood + local
        # per-block resampling, no comms. The island's log-weight
        # increment telescopes: b_acc = Σ_blocks logsumexp of the
        # block-updated local weights (the incoming log_w of block 0
        # still carries the island's global offset, so b_acc absorbs
        # the island history exactly).
        old_loglik = jnp.zeros_like(log_w)
        b_acc = jnp.float32(0.0)
        ln_local = log_w
        for blk in range(num_objects):
            k_b = jax.random.fold_in(k_trans, blk)
            new_block = sample_transition(k_b, states[:, blk], dt,
                                          trans_params)
            states = states.at[:, blk].set(new_block)
            loglik, occ_post = loglik_fn(states, occ, z_obs, dt)
            if blk == num_objects - 1:
                occ = occ_post
            ln_local = ln_local + loglik - old_loglik
            old_loglik = loglik

            # island decomposition: b = local logsumexp, ln sums to 1
            m_loc = jnp.max(ln_local)
            b = m_loc + jnp.log(jnp.sum(jnp.exp(ln_local - m_loc)))
            b_acc = b_acc + b
            ln_local = ln_local - b

            kl_local = jnp.sum(
                jnp.exp(ln_local) * jnp.where(jnp.exp(ln_local) > 0,
                                              ln_local, 0.0)) \
                + jnp.log(jnp.float32(p_local))

            # Local KL-triggered resample, cond-free (the rbcpf
            # where-select pattern — DESIGN.md anti-pattern #1): the
            # predicate is island-local (no collectives touched), so a
            # non-uniform where is safe.
            do_l = kl_local > max_kl_divergence
            k_blk = jax.random.fold_in(k_res, blk)
            parents = jnp.where(
                do_l,
                jnp.clip(rs.sorted_searchsorted_left(
                    jnp.cumsum(jnp.exp(ln_local)),
                    (jnp.arange(p_local, dtype=jnp.float32)
                     + jax.random.uniform(k_blk, ())) / p_local),
                    0, p_local - 1),
                jnp.arange(p_local, dtype=jnp.int32))
            states = jnp.take(states, parents, axis=0, mode="clip")
            occ = occ_gather(occ, parents)
            old_loglik = jnp.take(old_loglik, parents, axis=0,
                                  mode="clip")
            ln_local = jnp.where(
                do_l, -jnp.log(jnp.float32(p_local)), ln_local)

        # --- island-level bookkeeping (scalar collectives only)
        b = b_acc
        m_b = jax.lax.pmax(b, axis)
        sum_b = jax.lax.psum(jnp.exp(b - m_b), axis)
        bn = b - (m_b + jnp.log(sum_b))               # normalized island lw
        w_isl = jnp.exp(bn)
        kl_islands = jax.lax.psum(
            w_isl * jnp.where(w_isl > 0, bn, 0.0), axis) \
            + jnp.log(jnp.float32(n_islands))

        # --- rare island resampling: exchange whole blocks
        def island_resample(args):
            states, occ, ln_local, bn = args
            bn_all = jax.lax.all_gather(bn, axis)              # (S,)
            cdf = jnp.cumsum(jnp.exp(bn_all))
            u = jax.random.uniform(k_isl, ())  # same everywhere
            pos = (jnp.float32(idx) + u) / n_islands
            src = jnp.clip(jnp.searchsorted(cdf, pos, side="left"),
                           0, n_islands - 1)
            st_all = jax.lax.all_gather(states, axis)          # (S, L, ...)
            # occ may be a pytree (lazy (q, age) tuple) — gather/index
            # each leaf
            occ_sel = jax.tree_util.tree_map(
                lambda x: jax.lax.all_gather(x, axis)[src], occ)
            ln_all = jax.lax.all_gather(ln_local, axis)
            return (st_all[src], occ_sel, ln_all[src],
                    -jnp.log(jnp.float32(n_islands)))

        def no_island_resample(args):
            states, occ, ln_local, bn = args
            return states, occ, ln_local, bn

        states, occ, ln_local, bn = jax.lax.cond(
            kl_islands > island_max_kl, island_resample,
            no_island_resample, (states, occ, ln_local, bn))

        # --- globally consistent weights: w(p on island i) ∝ bn_i + ln
        log_w_out = bn + ln_local

        # --- posterior mean + ESS (psum reductions)
        lse2, s2, _, _ = _global_log_normalizers(log_w_out, axis)
        w = jnp.exp(log_w_out - lse2)
        mean_state = _psum_mean_state(states, w, axis, power_iters=10)
        ess = 1.0 / s2

        return (states, log_w_out, occ, key_next[None], mean_state, ess)

    pspec = P(axis)
    rspec = P()
    sharded = shard_map(
        step_local, mesh=mesh,
        in_specs=(pspec, pspec, pspec, rspec, rspec),
        out_specs=(pspec, pspec, pspec, rspec, rspec, rspec),
        check_vma=False)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(belief: ParticleBelief, z_obs):
        states, log_w, occ, key, mean_state, ess = sharded(
            belief.states, belief.log_weights, belief.occlusion,
            belief.key[None], z_obs)
        return (ParticleBelief(states=states, log_weights=log_w,
                               occlusion=occ, key=key[0]),
                mean_state, ess)

    return step

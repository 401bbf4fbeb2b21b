"""Hand-written kernels vs XLA inside the chained filter step, on the GPU.

Usage: python benchmarks/kernel_ab.py [--tune] [--trace DIR] [--hlo]

At the bench's operating point (10k particles, 80×60, icosphere of 1280
triangles) this times the jitted ``rbcpf_step`` (production KL trigger,
belief donated, 20-step windows ended by ``block_until_ready``) and the
sensor-only step for each variant, in alternating rounds:

  * ``kernel``: the production sensor (fused Triton kernel, XLA row
    gather/scatter);
  * ``xla``: the fused likelihood replaced by its plain ``jnp``
    formulation (ops/raycast_pallas.fused_loglik_reference).

Each variant's first sensor loglik is compared with the production one.

``--tune [LxPxWxS,...]`` first sweeps the kernel's tile sizes (lanes L,
pixels P), warps W and stages S on the kernel alone, ``--tune-repeats``
times (default: the whole grid), at the full level (every pixel, the
whole mesh's slabs) and at the tight compaction level as production runs
it (the selected pixels and the compacted slabs of their triangles,
``chip_smoke.tight_level``); ``--trace DIR`` writes a profiler trace of
the production step and prints its per-op table; ``--hlo`` lists the
copies of 1 MiB or more in the compiled production step (a full-map copy
there means an update did not land in place).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

P = 10_000            # the bench's operating point: 10k particles,
DOWNSAMPLING = 8      # 80×60 px,
SUBDIVISIONS = 3      # a 1280-triangle icosphere
ITERS = 20            # steps per timing window
WINDOWS = 5           # windows per variant and round


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def windows_ms(fn, state, n_windows, iters):
    """Run ``state = fn(state)`` in windows; per-step ms of each window."""
    import jax

    out = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            state = fn(state)
        jax.block_until_ready(state)
        out.append(1e3 * (time.perf_counter() - t0) / iters)
    return out, state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tune", nargs="?", const="all", default=None)
    ap.add_argument("--tune-repeats", type=int, default=1)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--hlo", action="store_true")
    args = ap.parse_args()

    import jax
    import numpy as np

    from dbot_ros_tpu.filters import rbcpf
    from dbot_ros_tpu.models import transition
    from dbot_ros_tpu.ops import raycast_pallas as rp
    from dbot_ros_tpu.utils.compile_cache import configure_compile_cache

    import chip_smoke

    configure_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    cam, mesh, bp, op, ref, states, z_obs = chip_smoke._scene(
        P, DOWNSAMPLING, SUBDIVISIONS, spread=(0.01, 0.0))
    tp = transition.make_transition_params(0.1, 0.5, damping=4.0)

    if args.tune:
        tune(rp, mesh, cam, bp, op, states, z_obs, args)

    def xla_loglik(*a, interpret=None, **kw):
        return rp.fused_loglik_reference(*a, **kw)

    def filter_step():
        """Sensor, jitted production ``rbcpf_step`` and a fresh belief."""
        sensor = rp.make_fused_sensor(mesh, cam, bp, op)
        fstep = jax.jit(functools.partial(
            rbcpf.rbcpf_step, loglik_fn=sensor, trans_params=tp,
            dt=1.0 / 30.0, max_kl_divergence=1.0), donate_argnums=(0,))
        belief = rbcpf.init_belief(jax.random.PRNGKey(0), ref, P,
                                   cam.num_pixels, sensor=sensor)
        return sensor, fstep, belief

    variants = {
        "kernel": {},
        "xla": dict(fused_loglik_packed=xla_loglik),
    }
    results = {name: {"sensor": [], "kl": []} for name in variants}
    first_ll = {}
    for rnd in range(args.rounds):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for name in order:
            with patched(rp, **variants[name]):
                sensor, fstep, belief = filter_step()
                sstep = jax.jit(lambda s, o, z: sensor(s, o, z, 1 / 30.0),
                                donate_argnums=(1,))
                occ = sensor.init_occlusion(P, 0.1)
                t0 = time.perf_counter()
                ll, occ = sstep(states, occ, z_obs)
                jax.block_until_ready(occ)
                c_sensor = time.perf_counter() - t0
                first_ll.setdefault(name, np.asarray(ll))
                w, _ = windows_ms(lambda o: sstep(states, o, z_obs)[1],
                                  occ, WINDOWS, ITERS)
                results[name]["sensor"] += w

                t0 = time.perf_counter()
                belief, _ = fstep(belief, z_obs)
                jax.block_until_ready(belief)
                c_step = time.perf_counter() - t0
                w2, _ = windows_ms(lambda b: fstep(b, z_obs)[0], belief,
                                   WINDOWS, ITERS)
                results[name]["kl"] += w2
            print(f"round {rnd} {name}: sensor {min(w):.4f} ms/step "
                  f"(compile {c_sensor:.1f} s), rbcpf_step kl "
                  f"{min(w2):.4f} ms/step (compile {c_step:.1f} s)",
                  flush=True)

    for name, ll in first_ll.items():
        print(f"  {name:7s} loglik max |diff| vs kernel "
              f"{np.abs(ll - first_ll['kernel']).max():.4g} "
              f"(|loglik| <= {np.abs(first_ll['kernel']).max():.4g})")
    if args.rounds:
        print("summary (ms per step over all windows: min / median / max):")
    for name, r in results.items():
        for leg, ws in r.items() if args.rounds else ():
            print(f"  {name:7s} {leg:6s} {min(ws):.4f} / "
                  f"{statistics.median(ws):.4f} / {max(ws):.4f} "
                  f"(n={len(ws)})")

    if args.hlo:
        _, fstep, belief = filter_step()
        big_copies(fstep.lower(belief, z_obs).compile().as_text())

    if args.trace:
        from benchmarks import parse_trace

        _, fstep, belief = filter_step()
        for _ in range(3):
            belief, _ = fstep(belief, z_obs)
        jax.block_until_ready(belief)
        with jax.profiler.trace(args.trace):
            for _ in range(10):
                belief, _ = fstep(belief, z_obs)
            jax.block_until_ready(belief)
        data, path = parse_trace.load(args.trace)
        print(f"trace: {path} (10 steps)")
        parse_trace.summarize(data, 25)


_HLO_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
              "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8}


def big_copies(hlo_text, min_bytes=1 << 20):
    """Print every copy instruction of at least ``min_bytes`` in an
    optimized HLO module: its computation, its operand, and the
    instructions that call that computation (e.g. a conditional branch)."""
    import re

    pat = re.compile(r"%?(\S+) = (\w+)\[([\d,]*)\]\S* (copy|copy-start)\("
                     r"([^)]*)\)")
    found, comps, comp = 0, set(), None
    lines = hlo_text.splitlines()
    for line in lines:
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = line.split()[1 if line.startswith("ENTRY") else 0]
        m = pat.search(line)
        if not m:
            continue
        name, dtype, dims, op, operand = m.groups()
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        size = n * _HLO_BYTES.get(dtype, 4)
        if size < min_bytes:
            continue
        found += 1
        comps.add(comp)
        print(f"  {op} {name}: {dtype}[{dims}] {size / 2**20:.1f} MiB in "
              f"{comp}, of {operand.split()[-1]}")
    for c in sorted(comps):
        for line in lines:
            if re.search(re.escape(c) + r"[,}\s]", line) and " = " in line:
                head = line.strip().split("(")[0]
                print(f"  {c} is called by: {head[:160]}")
    print(f"hlo: {found} copies of >= {min_bytes / 2**20:.0f} MiB")


def tune(rp, mesh, cam, bp, op, states, z_obs, args):
    """Kernel-alone time per (lane block, pixel block, warps, stages)."""
    import jax
    import jax.numpy as jnp
    import chip_smoke

    pv = rp.make_params_vec(bp, op, jnp.float32(1.0), 0.0)
    if args.tune == "all":
        grid = list(itertools.product((128, 256, 512), (8, 16, 32),
                                      (2, 4, 8), (2,)))
        grid += [(256, 16, 4, 1), (256, 16, 4, 3)]
    else:
        grid = [tuple(int(v) for v in c.split("x"))
                for c in args.tune.split(",")]
    for lanes, pix, warps, stages in grid * args.tune_repeats:
        with patched(rp, _LANE_BLOCK=lanes, _PIX_BLOCK=pix,
                     _NUM_WARPS=warps, _NUM_STAGES=stages):
            sensor = rp.make_fused_sensor(mesh, cam, bp, op)
            p_pad, pr = rp._particle_pads(P)
            n = cam.num_pixels
            cand = sensor.candidates(states)
            gt_c, sel, cand_c, _ = chip_smoke.tight_level(sensor, states,
                                                          cand)
            occ = jnp.full((rp._round_up(n, sensor.nb) * pr, 128), 0.1,
                           jnp.bfloat16)
            levels = [
                (sensor._pack_full(states, p_pad), occ, z_obs, cand,
                 cam.rays),
                (gt_c, rp.gather_pixel_rows(occ, sel, pr), z_obs[sel],
                 cand_c, cam.rays[sel]),
            ]
            row = []
            for a in levels:
                f = jax.jit(functools.partial(
                    rp.fused_loglik_packed, num_particles=P, nb=sensor.nb))
                jax.block_until_ready(f(*a, pv))
                ws, _ = windows_ms(lambda _: f(*a, pv), None, 3, ITERS)
                row.append(min(ws))
        print(f"tune lanes={lanes} pix={pix} warps={warps} "
              f"stages={stages}: full {row[0]:.4f} ms, tight "
              f"{row[1]:.4f} ms", flush=True)


if __name__ == "__main__":
    main()

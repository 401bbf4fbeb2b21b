"""Per-op GPU time from a jax.profiler trace.

Usage: python benchmarks/parse_trace.py <log_dir> [top_n]

Reads the newest ``*.xplane.pb`` under ``log_dir`` with
``jax.profiler.ProfileData`` and, for each ``/device:GPU:*`` plane, sums
event durations per line (CUDA streams, XLA ops, modules) and per op
name on the busiest stream line, plus that line's busy share of the
traced window (union of its event intervals over first-start..last-end).
"""

from __future__ import annotations

import collections
import glob
import os
import sys


def load(log_dir):
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    return ProfileData.from_file(path), path


def busy_share(intervals):
    """(busy_ns, window_ns) of a list of (start_ns, duration_ns)."""
    if not intervals:
        return 0.0, 0.0
    intervals = sorted(intervals)
    busy, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][0]
    for s, d in intervals:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    window = max(s + d for s, d in intervals) - intervals[0][0]
    return busy, window


def summarize(pd, top_n=30):
    """Print and return {plane: {line: total_ns}} for the GPU planes."""
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {}
        ops = {}
        spans = {}
        for line in plane.lines:
            tot = collections.Counter()
            iv = []
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
                iv.append((ev.start_ns, ev.duration_ns))
            lines[line.name] = sum(tot.values())
            ops[line.name] = tot
            spans[line.name] = iv
        out[plane.name] = lines
        print(f"== {plane.name}: lines (ms) ==")
        for name, ns in sorted(lines.items(), key=lambda kv: -kv[1]):
            print(f"{ns / 1e6:12.3f}  {name}")
        streams = [n for n in lines if "stream" in n.lower()] or list(lines)
        if not streams:
            continue
        top = max(streams, key=lambda n: lines[n])
        busy, window = busy_share(spans[top])
        if window:
            print(f"busiest stream line {top!r}: busy {busy / 1e6:.3f} ms "
                  f"of a {window / 1e6:.3f} ms window "
                  f"(idle share {1 - busy / window:.3f})")
        print(f"== top {top_n} ops on {top!r} (ms, count) ==")
        counts = collections.Counter()
        for ev in next(l for l in plane.lines if l.name == top).events:
            counts[ev.name] += 1
        for name, ns in ops[top].most_common(top_n):
            print(f"{ns / 1e6:10.3f}  x{counts[name]:<5d} {name[:110]}")
    return out


if __name__ == "__main__":
    data, path = load(sys.argv[1] if len(sys.argv) > 1 else "trace")
    print(f"trace: {path}")
    summarize(data, int(sys.argv[2]) if len(sys.argv) > 2 else 30)

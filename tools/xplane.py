"""Trace-to-metrics reduction for ``jax.profiler`` captures.

Reads an ``.xplane.pb`` with ``jax.profiler.ProfileData`` and reduces the
device planes to the numbers the bench reports:

* device time and event count per op name (the kernels XLA launched);
* busy time: the union of the op intervals, across streams;
* window: first op start to last op end on those planes;
* idle share: 1 - busy / window.

Device planes are chosen by an explicit name predicate, by default the
GPU's (``/device:GPU:<n>``); lines by a second predicate, by default every
line except the profiler's derived summaries (module/step/framework lines
repeat the kernels' time). No matching plane, or no event on the chosen
lines, is an error, never an empty result.

    python tools/xplane.py <trace dir or .xplane.pb> [--top 30]
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict

GPU_PLANE_PREFIX = "/device:GPU:"
DERIVED_LINE_PREFIXES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps",
                         "Framework", "TensorFlow", "Source", "Launch Stats")


def is_gpu_plane(name: str) -> bool:
    return name.startswith(GPU_PLANE_PREFIX)


def is_op_line(name: str) -> bool:
    return not name.startswith(DERIVED_LINE_PREFIXES)


def find_xplane(path: str) -> str:
    """``path`` itself, or the newest ``*.xplane.pb`` under it."""
    if os.path.isfile(path):
        return path
    found = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not found:
        raise FileNotFoundError(f"no .xplane.pb under {path}")
    return found[-1]


def _union_ns(intervals) -> int:
    busy = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def reduce_trace(path: str, plane=is_gpu_plane, line=is_op_line) -> dict:
    """Per-op device time and busy/idle share of one trace (see module doc).

    Returns ``{"planes", "lines", "ops": {name: (ns, count)}, "n_events",
    "busy_ns", "window_ns", "idle_share"}``; ``ops`` is sorted by time."""
    from jax.profiler import ProfileData

    profile = ProfileData.from_file(find_xplane(path))
    planes = [p for p in profile.planes if plane(p.name)]
    if not planes:
        names = [p.name for p in profile.planes]
        raise ValueError(f"no trace plane matches; planes are {names}")
    ops = defaultdict(lambda: [0, 0])
    intervals = []
    lines = []
    for p in planes:
        for ln in p.lines:
            if not line(ln.name):
                continue
            lines.append(f"{p.name}/{ln.name}")
            for ev in ln.events:
                dur = float(ev.duration_ns)
                start = float(ev.start_ns)
                acc = ops[ev.name]
                acc[0] += dur
                acc[1] += 1
                intervals.append((start, start + dur))
    if not intervals:
        raise ValueError(f"no events on the chosen lines of planes "
                         f"{[p.name for p in planes]}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _union_ns(intervals)
    return {
        "planes": [p.name for p in planes],
        "lines": lines,
        "ops": dict(sorted(((k, (v[0], v[1])) for k, v in ops.items()),
                           key=lambda kv: -kv[1][0])),
        "n_events": len(intervals),
        "busy_ns": busy,
        "window_ns": window,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    r = reduce_trace(args.path)
    print(f"planes {r['planes']}; lines {r['lines']}")
    print(f"{r['n_events']} device events; busy {r['busy_ns'] / 1e6:.3f} ms "
          f"of a {r['window_ns'] / 1e6:.3f} ms window "
          f"(idle share {r['idle_share']:.4f})")
    for name, (ns, cnt) in list(r["ops"].items())[:args.top]:
        print(f"  {ns / 1e6:10.3f} ms  x{cnt:<7d} {name[:110]}")


if __name__ == "__main__":
    main()

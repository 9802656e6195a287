"""Reading a ``torch.profiler`` trace (its Chrome trace JSON) into the
numbers the per-layer metrics and the result's ``breakdown`` take.

Windows are the spans the harness marked around each profiled drain
(``SPAN``). Within them: the time some operation ran on the device (the
union of kernels, copies and sets), the time two or more streams ran at
once, each kernel's time and count, and each idle gap of the device named
by the innermost host event open at its middle on the drain's thread.
Timestamps are microseconds.
"""
from __future__ import annotations

import bisect
import json

SPAN = "kbench.drain"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10
NAME_CHARS = 96          # a breakdown entry's name, cut to this length


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(a, b, windows):
    """The parts of [a, b) inside the merged ``windows``."""
    i = max(bisect.bisect_right([w[0] for w in windows], a) - 1, 0)
    parts = []
    for lo, hi in windows[i:]:
        if lo >= b:
            break
        if hi > a:
            parts.append((max(a, lo), min(b, hi)))
    return parts


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _multi_stream(per_stream) -> float:
    """Time during which two or more streams are busy."""
    edges = []
    for ivs in per_stream.values():
        for a, b in ivs:
            edges += [(a, 1), (b, -1)]
    edges.sort()
    busy, last, total = 0, None, 0.0
    for x, step in edges:
        if busy >= 2:
            total += x - last
        busy += step
        last = x
    return total


def _innermost(host, points) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    event open there (``host`` sorted by start, nested as one thread's
    are), by one sweep with a stack of open events."""
    names, stack, i = [], [], 0
    for x in points:
        while i < len(host) and host[i]["ts"] <= x:
            ev = host[i]
            while stack and stack[-1][0] <= ev["ts"]:
                stack.pop()
            stack.append((ev["ts"] + ev.get("dur", 0), ev["name"]))
            i += 1
        while stack and stack[-1][0] <= x:
            stack.pop()
        names.append(stack[-1][1] if stack else "no host event")
    return names


def summarize(events, span: str = SPAN) -> dict:
    """Device time in the ``span`` windows: ``window_s``, ``busy_s``,
    ``overlap_s`` (two or more streams at once), ``kernels`` {name:
    [seconds, count]}, and ``breakdown``: the device operations that took
    most time and the idle gaps summed by what the host was doing, each
    the top ``TOP`` as [name, seconds]."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if not marks:
        return None
    windows = _union((e["ts"], e["ts"] + e["dur"]) for e in marks)
    tid = marks[0].get("tid")
    device, per_stream, ops = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        for a, b in _clip(e["ts"], e["ts"] + e.get("dur", 0), windows):
            device.append((a, b))
            stream = (e.get("args") or {}).get("stream")
            per_stream.setdefault(stream, []).append((a, b))
            got = ops.setdefault(e["name"], [0.0, 0])
            got[0] += (b - a) * 1e-6
            got[1] += 1
    busy = _union(device)
    per_stream = {s: _union(v) for s, v in per_stream.items()}
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != span), key=lambda e: e["ts"])
    idle = []
    for lo, hi in windows:
        cursor = lo
        for a, b in _clip(lo, hi, busy) + [(hi, hi)]:
            if a > cursor:
                idle.append((cursor, a))
            cursor = max(cursor, b)
    gaps: dict = {}
    names = _innermost(host, [(a + b) / 2 for a, b in idle])
    for (a, b), name in zip(idle, names):
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": _length(windows) * 1e-6,
            "busy_s": _length(busy) * 1e-6,
            "overlap_s": _multi_stream(per_stream) * 1e-6,
            "streams": len(per_stream),
            "kernels": ops,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top_ops],
                "idle_gaps": [[n[:NAME_CHARS], v] for n, v in top_gaps]}}


def kernel_time(kernels: dict, *symbols):
    """(seconds, launches) summed over the kernels whose name holds one of
    ``symbols``; launches counted on the first symbol only."""
    seconds, count = 0.0, 0
    for name, (s, n) in kernels.items():
        if any(sym in name for sym in symbols):
            seconds += s
            if symbols[0] in name:
                count += n
    return seconds, count

"""The program's own spans in a ``torch.profiler`` trace, read into the
``spans`` key of what ``trace.summarize`` returns.

The port marks its serving path with ``user_annotation`` spans
(``repro_torch.spans``: ``serve.drain``, ``serve.step.decode``,
``model.mixer`` ...). For each such name on the drain's thread inside the
harness's windows (``trace.SPAN``), ``totals`` gives ``count``, ``host_s``
(the spans' summed durations), ``idle_s`` (device-idle time inside the
union of the name's spans), ``launches`` (runtime or driver calls inside
those spans whose ``correlation`` one or more device operations share: a
graph launch counts once) and ``device_s`` (the union of those device
operations). Timestamps are microseconds.

``install()`` makes ``trace.summarize`` add the key; the readers that need
it call it when they are loaded. Every other key of the summary is
``trace.summarize``'s own, unchanged. A trace with no program span gives
an empty ``spans``, and the readers then report nothing.
"""
from __future__ import annotations

import bisect

from kbench import trace

_summarize = trace.summarize


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, merged lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def totals(events, span: str = trace.SPAN) -> dict:
    """{name: {count, host_s, idle_s, launches, device_s}} for each
    ``user_annotation`` name but ``span`` on the drain's thread that
    starts in the ``span`` windows; None where the trace has no window."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if not marks:
        return None
    windows = trace._union((e["ts"], e["ts"] + e["dur"]) for e in marks)
    starts = [w[0] for w in windows]
    tid = marks[0].get("tid")

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts < windows[i][1]

    device, ran = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        parts = trace._clip(e["ts"], e["ts"] + e.get("dur", 0), windows)
        device += parts
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            ran.setdefault(corr, []).extend(parts)
    idle = []
    for lo, hi in windows:
        cursor = lo
        for a, b in trace._clip(lo, hi, trace._union(device)) + [(hi, hi)]:
            if a > cursor:
                idle.append((cursor, a))
            cursor = max(cursor, b)
    calls = sorted((e["ts"], (e.get("args") or {}).get("correlation"))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("tid") == tid)
    calls = [(ts, corr) for ts, corr in calls if corr in ran]
    call_ts = [ts for ts, _ in calls]
    by_name: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("tid") == tid and e.get("name") != span \
                and inside(e["ts"]):
            by_name.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    out = {}
    for name, ivs in by_name.items():
        merged = trace._union(ivs)
        ops, launches = [], 0
        for a, b in merged:
            for _, corr in calls[bisect.bisect_left(call_ts, a):
                                 bisect.bisect_left(call_ts, b)]:
                launches += 1
                ops += ran[corr]
        out[name] = {"count": len(ivs), "host_s": trace._length(ivs) * 1e-6,
                     "idle_s": _overlap(merged, idle) * 1e-6,
                     "launches": launches,
                     "device_s": trace._length(trace._union(ops)) * 1e-6}
    return out


def summarize(events, span: str = trace.SPAN) -> dict:
    """``trace.summarize``'s summary with ``spans`` added."""
    out = _summarize(events, span)
    if out is not None:
        out["spans"] = totals(events, span)
    return out


def install() -> None:
    """Make ``trace.summarize``, which the harness calls on the profiled
    drains, add ``spans``."""
    trace.summarize = summarize

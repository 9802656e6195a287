"""Named spans on the serving path, for ``torch.profiler`` traces.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records, and one shared no-op context otherwise: off, a span costs one C
check and an empty ``with``. A profiler writes each span into its Chrome
trace as a ``user_annotation`` event on the calling thread, on the clock of
the device records; a kernel links back to the span whose runtime call
launched it by the ``correlation`` id the two share. One ``serve.drain``
span holds everything a drain did.

The names are this module's constants, one place for each: the serving
loop's (``DRAIN`` ... ``SYNC``, ``STEP`` by a job's phase, ``REPLAYS``
by a job's phase around a captured step's graph replay: ``REPLAY`` a
decode step's, ``REPLAY_PREFILL`` a prompt's) and the model's (``EMBED``
... ``HEAD``, inside a MoE FFN ``ROUTE`` and ``EXPERTS``, and ``WINDOW``
around a sliding-window block's attention). ``NAMES`` is every one of
them.
"""
from __future__ import annotations

import contextlib

import torch

DRAIN = "serve.drain"
PLAN = "serve.plan"
DECIDE = "serve.decide"
ROUND = "serve.round"
SYNC = "serve.sync"
REPLAY = "serve.replay"
REPLAY_PREFILL = "serve.replay.prefill"
REPLAYS = {"prefill": REPLAY_PREFILL, "decode": REPLAY,
           "train": "serve.replay.train"}
STEP = {phase: f"serve.step.{phase}"
        for phase in ("prefill", "decode", "train")}
EMBED = "model.embed"
VIEWS = "model.views"
MIXER = "model.mixer"
FFN = "model.ffn"
HEAD = "model.head"
ROUTE = "model.route"
EXPERTS = "model.experts"
WINDOW = "model.window"
NAMES = frozenset({DRAIN, PLAN, DECIDE, ROUND, SYNC, *REPLAYS.values(),
                   *STEP.values(), EMBED, VIEWS, MIXER, FFN, HEAD, ROUTE,
                   EXPERTS, WINDOW})

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks ``name`` in the trace of a profiler that is
    recording, else the shared no-op context."""
    return torch.profiler.record_function(name) if _recording() else _OFF

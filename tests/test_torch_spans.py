"""The port's spans: off, a span is the shared no-op context; under a
profiler, a drain's Chrome trace holds one ``serve.drain`` with the plan,
each round's decision, round and synchronize, one step span a slice run and
the model's spans inside each step, all named from ``spans.NAMES``; and the
profiler changes no output; a server whose jobs, profiles and steps are set
directly, without ``submit``, drains with its step spans all the same."""
import dataclasses
import inspect
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as TS

JOBS = [("a-phi3-prefill", "phi3-mini-3.8b", "prefill", 2, 1, 32),
        ("b-phi3-decode", "phi3-mini-3.8b", "decode", 4, 2, 32)]
JOB_SLICES = {name: n for name, _, _, n, _, _ in JOBS}
LAYERS = reduced(get_config("phi3-mini-3.8b")).num_layers


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_IPC_CACHE",
                  str(tmp_path_factory.mktemp("ipc")))
        srv = TS.SharedPodServer(device="cpu")
        for job in JOBS:
            srv.submit(TS.Job(*job))
        yield srv


def _requeue(srv):
    for name, _, _, n, _, _ in JOBS:
        srv.jobs[name].num_slices = n


def _profiled_drain(srv, tmp_path):
    """A drain under the CPU profiler: (its result, the exported trace's
    program spans on the drain's thread as (name, start, end))."""
    _requeue(srv)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = srv.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return res, [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in marks]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_a_span_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.REPLAY == "serve.replay" and spans.REPLAY in spans.NAMES
    got = [spans.span(name) for name in sorted(spans.NAMES)]
    assert all(s is spans._OFF for s in got)
    with spans.span("serve.drain") as inside:
        assert inside is None
    # a profiler started afterwards sees none of them
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.events() if e.name in spans.NAMES]


def test_a_profiled_drain_holds_every_span(server, tmp_path):
    res, marks = _profiled_drain(server, tmp_path)
    names = [m[0] for m in marks]
    assert set(names) <= spans.NAMES
    by = {n: [m for m in marks if m[0] == n] for n in spans.NAMES}
    rounds = len(res["rounds"])
    assert rounds >= 1
    (drain,) = by["serve.drain"]
    (plan,) = by["serve.plan"]
    assert _within(plan, drain)
    for name in ("serve.decide", "serve.round", "serve.sync"):
        assert len(by[name]) == rounds, name
        assert all(_within(m, drain) for m in by[name]), name
    ran = dict.fromkeys(server.jobs, 0)
    for k1, k2, n1, n2, _ in res["rounds"]:
        ran[k1] += n1
        if k2 is not None:
            ran[k2] += n2
    steps = by["serve.step.prefill"] + by["serve.step.decode"]
    assert not by[spans.REPLAY]          # on the CPU every step runs eagerly
    assert len(by["serve.step.prefill"]) == ran["a-phi3-prefill"] == 2
    assert len(by["serve.step.decode"]) == ran["b-phi3-decode"] == 4
    for m in steps + by["serve.sync"]:
        assert any(_within(m, r) for r in by["serve.round"]), m
    model = [m for m in marks if m[0].startswith("model.")]
    assert model and all(any(_within(m, s) for s in steps) for m in model)
    for s in steps:
        inner = [m[0] for m in model if _within(m, s)]
        assert inner.count("model.embed") == inner.count("model.head") == 1
        assert inner.count("model.mixer") == LAYERS
        assert inner.count("model.ffn") == LAYERS
        assert inner.count("model.views") >= 1


def _leaves(srv):
    """The decode tenant's cache tensors, which its step writes in place
    (its step closure carries them as a default argument)."""
    step = srv._exec["b-phi3-decode"]
    out, todo = [], [inspect.signature(step).parameters["caches"].default]
    while todo:
        tree = todo.pop()
        if isinstance(tree, dict):
            todo += tree.values()
        else:
            out.append(tree)
    return out


def _state(srv):
    """Each tenant's logits from one more step call, and copies of the
    decode tenant's caches after it."""
    logits = {name: srv._exec[name]().clone() for name in srv.jobs}
    return logits, [c.clone() for c in _leaves(srv)]


def test_the_profiler_changes_no_output(server, tmp_path):
    caches = _leaves(server)
    before = [c.clone() for c in caches]

    def run(profiled):
        # the caches are inference tensors, written only in that mode
        with torch.inference_mode():
            for c, b in zip(caches, before):
                c.copy_(b)
        if not profiled:
            _requeue(server)
            server.drain()
            return _state(server)
        _profiled_drain(server, tmp_path)
        with profile(activities=[ProfilerActivity.CPU]):
            return _state(server)

    off_logits, off_caches = run(False)
    on_logits, on_caches = run(True)
    for name in off_logits:
        assert torch.equal(off_logits[name], on_logits[name]), name
    assert len(off_caches) > 0
    assert all(torch.equal(a, b) for a, b in zip(off_caches, on_caches))


@pytest.mark.parametrize("profiled", [False, True])
def test_a_server_built_without_submit_drains(server, profiled):
    """A twin over ``server``'s tenants, built as a server that plans on
    another hardware model is (jobs, profiles and steps set directly),
    drains every pending slice, one step span a slice under a profiler."""
    twin = TS.SharedPodServer(device="cpu")
    ran = dict.fromkeys(server.jobs, 0)
    for name, job in server.jobs.items():
        twin.jobs[name] = dataclasses.replace(job, num_slices=JOB_SLICES[name])
        twin.profiles[name] = TS.job_profile(twin.jobs[name], twin.spec,
                                             twin.profile_fn)
        twin._exec[name] = lambda name=name: ran.__setitem__(
            name, ran[name] + 1)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            twin.drain(plan_first=False)
        steps = [e.name for e in prof.events()
                 if e.name.startswith("serve.step.")]
        assert sorted(steps) == sorted(
            spans.STEP[job.phase] for name, job in twin.jobs.items()
            for _ in range(JOB_SLICES[name]))
    else:
        twin.drain(plan_first=False)
    assert ran == JOB_SLICES
    assert all(j.num_slices == 0 for j in twin.jobs.values())

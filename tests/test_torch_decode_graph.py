"""A decode tenant's step as ``SharedPodServer`` runs it. The step carries
its caches and token as default arguments (``kbench.harness`` reaches the
caches there), and ``submit`` runs it exactly once. On the CPU it stays
eager. On the card it is captured into one CUDA graph at ``submit``: the
replays give the eager step's logits and caches, each call's logits are
its own, a drain replays once a slice inside a ``serve.replay`` span, and
a step that waits on the host stays eager.

The cases marked ``cuda`` skip where there is no CUDA device:

  PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py
"""
import dataclasses
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kbench import harness
from repro_torch import spans
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as TS
from repro_torch.models import transformer as T

ARCHS = ("phi3-mini-3.8b", "rwkv6-1.6b", "deepseek-v2-lite",
         "mellum2-12b-a2.5b")
BATCH, SEQ, SLICES = 2, 32, 4
T_POS = SEQ // 2                   # the position every decode call writes
TOL = dict(atol=2e-2, rtol=2e-2)   # bf16, as tests/test_torch_cuda.py's


def _on(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


@pytest.fixture(autouse=True)
def _ipc_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    return _on(request.param)


@pytest.fixture
def cuda():
    return _on("cuda")


def _served(arch, device):
    """A server on ``device`` with one decode tenant of reduced ``arch``
    on weights drawn here: (server, tenant, params, cfg)."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    srv = TS.SharedPodServer(device=device)
    name = f"{arch}-decode"
    srv.submit(TS.Job(name, arch, "decode", SLICES, BATCH, SEQ),
               params=params, cfg=cfg)
    return srv, name, params, cfg


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _token(srv, name):
    return inspect.signature(srv._exec[name]).parameters["tok"].default


def _assert_caches_close(got, want):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        torch.testing.assert_close(g.float(), w.float(), **TOL)


def _eager_steps(params, cfg, tok, device, n):
    """Fresh caches after ``n`` eager decode steps, and the last logits."""
    caches = T.init_decode_caches(cfg, BATCH, SEQ, device=device)
    logits = None
    for _ in range(n):
        logits, _ = T.decode_step(params, cfg, caches, tok, T_POS)
    return caches, logits


def test_the_step_carries_the_caches_it_writes(device):
    srv, name, params, cfg = _served("phi3-mini-3.8b", device)
    step = srv._exec[name]
    args = inspect.signature(step).parameters
    caches = harness.decode_caches(srv, name)
    assert caches is args["caches"].default
    assert _token(srv, name).shape == (BATCH,)
    with torch.inference_mode():
        for leaf in _leaves(caches):
            leaf.fill_(7)
    want = _clone(caches)
    T.decode_step(params, cfg, want, _token(srv, name), T_POS)
    step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    _assert_caches_close(caches, want)
    k = caches["stage0"]["sub0"]["k"]
    assert not bool((k[:, :, T_POS] == 7).all())       # row t written
    off = torch.cat([k[:, :, :T_POS], k[:, :, T_POS + 1:]], dim=2)
    assert bool((off == 7).all())                       # no other row


def test_submit_runs_the_step_exactly_once(device):
    """A recurrent tenant's state after ``submit`` is one decode step from
    zeros, not two: a capture launches nothing."""
    srv, name, params, cfg = _served("rwkv6-1.6b", device)
    caches = harness.decode_caches(srv, name)
    tok = _token(srv, name)
    once, _ = _eager_steps(params, cfg, tok, device, 1)
    _assert_caches_close(caches, once)
    twice, _ = _eager_steps(params, cfg, tok, device, 2)
    state = caches["stage0"]["sub0"]["state"]
    assert not torch.allclose(state.float(),
                              twice["stage0"]["sub0"]["state"].float(),
                              **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_on_the_cpu_the_step_stays_eager(arch):
    cpu = torch.device("cpu")
    srv, name, params, cfg = _served(arch, cpu)
    assert srv.captures == {}
    want_caches = _clone(harness.decode_caches(srv, name))
    want, _ = T.decode_step(params, cfg, want_caches, _token(srv, name),
                            T_POS)
    assert torch.equal(srv._exec[name](), want)
    for g, w in zip(_leaves(harness.decode_caches(srv, name)),
                    _leaves(want_caches), strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_match_the_eager_step(cuda, arch):
    srv, name, params, cfg = _served(arch, cuda)
    assert srv.captures == {name: None}
    caches = harness.decode_caches(srv, name)
    eager = _clone(caches)
    tok = _token(srv, name)
    for _ in range(4):
        got = srv._exec[name]()
        want, _ = T.decode_step(params, cfg, eager, tok, T_POS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        _assert_caches_close(caches, eager)


def test_the_capture_report_names_each_outcome():
    srv = TS.SharedPodServer(device=torch.device("cpu"))
    for name, arch in (("a", "phi3-mini-3.8b"), ("b", "rwkv6-1.6b")):
        srv.jobs[name] = TS.Job(name, arch, "decode", SLICES, BATCH, SEQ)
    assert srv.capture_report() == ("decode steps as one CUDA graph: none; "
                                    "eager, the capture failed: none")
    srv.captures = {"a": None, "b": "RuntimeError: a sync"}
    assert srv.capture_report() == (
        "decode steps as one CUDA graph: a (phi3-mini-3.8b); eager, the "
        "capture failed: b (rwkv6-1.6b): RuntimeError: a sync")


@pytest.mark.cuda
def test_replays_count_their_launches(cuda):
    """``ops.LAUNCHES`` counts the kernels that ran: D1 once a layer in the
    warm-up and in each replay, and not in the capture, which runs
    nothing."""
    ops.reset_launches()
    srv, name, _, cfg = _served("phi3-mini-3.8b", cuda)
    assert srv.captures == {name: None}
    assert ops.LAUNCHES["decode_attention"] == cfg.num_layers
    for _ in range(2):
        srv._exec[name]()
    assert ops.LAUNCHES["decode_attention"] == 3 * cfg.num_layers


@pytest.mark.cuda
def test_each_call_keeps_its_logits(cuda):
    """A recurrent tenant's logits move from call to call; call n's stay as
    they were after call n + 1 replays over the graph's own output."""
    srv, name, _, _ = _served("rwkv6-1.6b", cuda)
    assert srv.captures == {name: None}
    first = srv._exec[name]()
    kept = first.clone()
    second = srv._exec[name]()
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


@pytest.mark.cuda
def test_a_drain_replays_once_a_slice(cuda):
    """A profiled drain runs each decode slice as one replay on the
    tenant's stream, inside its step span and with no model span; the
    state after it is submit's step and one a slice."""
    srv, name, params, cfg = _served("rwkv6-1.6b", cuda)
    assert srv.captures == {name: None}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = srv.drain()
        torch.cuda.synchronize()
    assert sum(n1 for _, _, n1, _, _ in res["rounds"]) == SLICES
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count(spans.STEP["decode"]) == SLICES
    assert names.count(spans.REPLAY) == SLICES
    assert not [n for n in names if n.startswith("model.")]
    want, _ = _eager_steps(params, cfg, _token(srv, name), cuda, 1 + SLICES)
    _assert_caches_close(harness.decode_caches(srv, name), want)


@pytest.mark.cuda
def test_a_step_that_waits_on_the_host_stays_eager(cuda, monkeypatch):
    real = T.decode_step

    def syncing(params, cfg, caches, token, t):
        logits, caches = real(params, cfg, caches, token, t)
        float(logits.float().sum())                  # a copy to the host
        return logits, caches

    monkeypatch.setattr(T, "decode_step", syncing)
    srv, name, params, cfg = _served("rwkv6-1.6b", cuda)
    assert srv.captures[name]                          # why it failed
    # the failed capture left the caller's stream and the card's generator
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert torch.randn(4, device=cuda).isfinite().all()
    tok = _token(srv, name)
    caches = harness.decode_caches(srv, name)
    eager, _ = _eager_steps(params, cfg, tok, cuda, 1)
    _assert_caches_close(caches, eager)                # the warm-up alone
    got = srv._exec[name]()
    want, _ = real(params, cfg, eager, tok, T_POS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    _assert_caches_close(caches, eager)


@pytest.mark.cuda
def test_a_deepseek_lite_replay_runs_d2_once_a_layer(cuda):
    """Reduced DeepSeek-V2-Lite at its 27 layers: the step is captured, its
    replays equal the eager step, and each launches D2 (the latent
    attention) 27 times, once an MLA layer, and D1 never."""
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite")),
                              num_layers=27)
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    srv = TS.SharedPodServer(device=cuda)
    name = "deepseek-v2-lite-decode"
    ops.reset_launches()
    srv.submit(TS.Job(name, "deepseek-v2-lite", "decode", SLICES, BATCH, SEQ),
               params=params, cfg=cfg)
    assert srv.captures == {name: None}
    assert ops.LAUNCHES["mla_decode"] == 27          # the warm-up
    caches = harness.decode_caches(srv, name)
    eager = _clone(caches)
    tok = _token(srv, name)
    for i in range(2):
        got = srv._exec[name]()
        assert ops.LAUNCHES["mla_decode"] == 27 * (2 + 2 * i)
        want, _ = T.decode_step(params, cfg, eager, tok, T_POS)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["mla_decode"] == 27 * (3 + 2 * i)
        torch.testing.assert_close(got.float(), want.float(), **TOL)
        _assert_caches_close(caches, eager)
    assert ops.LAUNCHES["decode_attention"] == 0

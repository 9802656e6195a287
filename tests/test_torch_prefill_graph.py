"""A prefill tenant's step as ``SharedPodServer`` runs it. On the CPU it
stays eager and gives ``T.forward``'s logits. On the card ``submit``
captures it into one CUDA graph, as a decode step is captured: the replays
give the eager prompt's logits, a drain replays once a prefill slice
inside a ``serve.replay.prefill`` span while the decode slices keep their
``serve.replay``, and a prompt that waits on the host stays eager.

The cases marked ``cuda`` skip where there is no CUDA device:

  PYTHONPATH=src python -m pytest -q tests/test_torch_prefill_graph.py
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import serve as TS
from repro_torch.models import transformer as T

ARCHS = ("phi3-mini-3.8b", "rwkv6-1.6b", "deepseek-v2-lite",
         "mellum2-12b-a2.5b")
BATCH, SEQ, SLICES = 2, 32, 3
TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_torch_decode_graph.py's


@pytest.fixture(autouse=True)
def _ipc_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_IPC_CACHE", str(tmp_path / "ipc"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _served(arch, device):
    """A server on ``device`` with one prefill tenant of reduced ``arch``
    on weights drawn here: (server, tenant, params, cfg, the tenant's
    batch as ``T.forward`` takes it)."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    srv = TS.SharedPodServer(device=device)
    name = f"{arch}-prefill"
    srv.submit(TS.Job(name, arch, "prefill", SLICES, BATCH, SEQ),
               params=params, cfg=cfg)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in make_batch(cfg, BATCH, SEQ).items() if k != "labels"}
    return srv, name, params, cfg, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_on_the_cpu_the_prompt_stays_eager(arch):
    srv, name, params, cfg, batch = _served(arch, torch.device("cpu"))
    assert srv.captures == {}
    want, _, _ = T.forward(params, cfg, batch)
    assert torch.equal(srv._exec[name](), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_match_the_eager_prompt(cuda, arch):
    srv, name, params, cfg, batch = _served(arch, cuda)
    assert srv.captures == {name: None}
    for _ in range(2):
        got = srv._exec[name]()
        want, _, _ = T.forward(params, cfg, batch)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
def test_a_mixed_drain_replays_once_a_prefill_slice(cuda):
    """A profiled drain of a prompt beside a decode tenant runs each
    prefill slice as one replay inside its step span, under its own
    name, and each decode slice as one ``serve.replay``; no model span
    appears."""
    srv, name, params, cfg, _ = _served("phi3-mini-3.8b", cuda)
    srv.submit(TS.Job("decode", "phi3-mini-3.8b", "decode", 4, BATCH, SEQ),
               params=params, cfg=cfg)
    assert srv.captures == {name: None, "decode": None}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = srv.drain()
        torch.cuda.synchronize()
    ran = dict.fromkeys(srv.jobs, 0)
    for k1, k2, n1, n2, _ in res["rounds"]:
        ran[k1] += n1
        if k2 is not None:
            ran[k2] += n2
    assert ran == {name: SLICES, "decode": 4}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    by = {n: [e.time_range for e in events if e.name == n]
          for n in (spans.STEP["prefill"], spans.REPLAY_PREFILL,
                    spans.STEP["decode"], spans.REPLAY)}
    assert len(by[spans.STEP["prefill"]]) == SLICES
    assert len(by[spans.REPLAY_PREFILL]) == SLICES
    assert len(by[spans.STEP["decode"]]) == len(by[spans.REPLAY]) == 4
    for r in by[spans.REPLAY_PREFILL]:
        assert any(s.start <= r.start and r.end <= s.end
                   for s in by[spans.STEP["prefill"]]), r
    assert not [e for e in events if e.name.startswith("model.")]


@pytest.mark.cuda
def test_a_prompt_that_waits_on_the_host_stays_eager(cuda, monkeypatch):
    real = T.forward

    def syncing(params, cfg, batch, **kw):
        logits, caches, aux = real(params, cfg, batch, **kw)
        float(logits.float().sum())                  # a copy to the host
        return logits, caches, aux

    monkeypatch.setattr(T, "forward", syncing)
    srv, name, params, cfg, batch = _served("phi3-mini-3.8b", cuda)
    assert srv.captures[name]                          # why it failed
    assert "eager, the capture failed: " + name in srv.capture_report()
    # the failed capture left the caller's stream and the card's generator
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert torch.randn(4, device=cuda).isfinite().all()
    got = srv._exec[name]()
    want, _, _ = real(params, cfg, batch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL)

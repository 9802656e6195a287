"""The references against the port's CPU path, float32 at toy size: the
same weights (``kbench.weights``) and tokens into both. The port is
imported here; the references never import it."""
from __future__ import annotations

import importlib

import pytest
import torch

from kbench import harness, weights
from kbench.reference.common import Precision
from kbench.tests import tiny

TOL = 1e-4       # float32 both sides; summation order differs (~1e-6)


def _setup(config, seed=2**31 + 17):
    m = config["model"]
    ref = importlib.import_module(f"kbench.reference.{config['reference']}")
    tree = weights.build(ref.leaves(m), seed, "cpu")
    return m, ref, tree, harness.port_config(config)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.RWKV6],
                         ids=["dense", "rwkv6"])
def test_prefill_matches_the_port(config):
    from repro_torch.models import transformer as T
    m, ref, tree, cfg = _setup(config)
    toks = torch.as_tensor(harness.tenant_tokens(m["vocab_size"], 2, 64)
                           ).long()
    got, _, _ = T.forward(tree, cfg, {"tokens": toks})
    want = ref.prefill(ref.prepare(tree, m, Precision()), m, toks,
                       Precision())
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.RWKV6],
                         ids=["dense", "rwkv6"])
def test_decode_steps_and_state_match_the_port(config):
    from repro_torch.models import transformer as T
    m, ref, tree, cfg = _setup(config)
    b, seq, steps = 3, 64, 5
    t = seq // 2
    tok = torch.as_tensor(harness.tenant_tokens(m["vocab_size"], b, seq)
                          [:, 0]).long()
    caches = T.init_decode_caches(cfg, b, seq, device="cpu")
    for _ in range(steps):
        got, _ = T.decode_step(tree, cfg, caches, tok, t)
    w = ref.prepare(tree, m, Precision())
    want, state = ref.decode(w, m, tok, t, steps, Precision())
    assert _rel(got, want) < TOL
    prog, exact = ref.program_state(caches, m, t)
    for key, value in state.items():
        assert _rel(prog[key], value) < TOL, key
    assert all(v == 0 for v in exact.values()), exact


def test_decode_over_a_written_context_matches_the_port():
    """The context set-up writes into the caches (rows before t drawn from
    the seed, rows after t far larger) is read back by the reference, and
    every row but t stays as written."""
    from repro_torch.models import transformer as T
    m, ref, tree, cfg = _setup(tiny.DENSE)
    b, seq, steps, seed = 3, 64, 2, 2**31 + 29
    t = seq // 2
    tok = torch.as_tensor(harness.tenant_tokens(m["vocab_size"], b, seq)
                          [:, 0]).long()
    caches = T.init_decode_caches(cfg, b, seq, device="cpu")
    ref.fill_past(caches, m, t, tiny.PAST, seed)
    for _ in range(steps):
        got, _ = T.decode_step(tree, cfg, caches, tok, t)
    w = ref.prepare(tree, m, Precision())
    want, state = ref.decode(w, m, tok, t, steps, Precision(), tiny.PAST,
                             seed)
    assert _rel(got, want) < TOL
    zero, _ = ref.decode(w, m, tok, t, steps, Precision())
    assert _rel(zero, want) > 0.1             # the context is read
    prog, exact = ref.program_state(caches, m, t, tiny.PAST, seed)
    for key, value in state.items():
        assert _rel(prog[key], value) < TOL, key
    assert exact == {"changed": 0}
    _, other = ref.program_state(caches, m, t, tiny.PAST, seed + 1)
    assert other["changed"] > 0


def test_chunked_wkv_is_the_recurrence():
    from kbench.reference import rwkv6
    g = torch.Generator().manual_seed(3)
    b, s, h, n = 2, 40, 3, 8
    r, k, v = (torch.randn(b, s, h, n, generator=g) for _ in range(3))
    w_log = -torch.rand(b, s, h, n, generator=g) * 2
    u = torch.randn(h, n, generator=g)
    s0 = torch.randn(b, h, n, n, generator=g)
    out, final = rwkv6.wkv_chunked(r, k, v, w_log, u, s0, chunk=16)
    state, want = s0, []
    for i in range(s):
        o, state = rwkv6.wkv_step(r[:, i], k[:, i], v[:, i], w_log[:, i], u,
                                  state)
        want.append(o)
    assert _rel(out, torch.stack(want, 1)) < 1e-5
    assert _rel(final, state) < 1e-5


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    m, ref = tiny.RWKV6["model"], importlib.import_module(
        "kbench.reference.rwkv6")
    a = weights.build(ref.leaves(m), 2**31 + 5, "cpu")
    b = weights.build(ref.leaves(m), 2**31 + 5, "cpu")
    c = weights.build(ref.leaves(m), 2**31 + 6, "cpu")
    leaf = ("stage0", "sub0", "tmix", "wr")
    assert torch.equal(weights.get(a, leaf), weights.get(b, leaf))
    assert not torch.equal(weights.get(a, leaf), weights.get(c, leaf))
    for leaf in ref.leaves(m):
        assert tuple(weights.get(a, leaf.path).shape) == leaf.shape
        assert weights.get(a, leaf.path).dtype == weights.DTYPES[leaf.dtype]

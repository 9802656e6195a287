"""Qwen2-VL (M-RoPE, the patch prefix) and Whisper (encoder, learned
positions, cross-attention) in the port against the reference package, on
the same inputs (numpy from a seed) and the same weights
(``repro_torch.convert.params_from_jax``), in f32 on the CPU; and both
archs' tenants served by both packages' ``SharedPodServer``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import make_batch
from repro.launch import serve as JS
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as TS
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("qwen2-vl-7b", "whisper-small")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return cfg, reduced(tconfigs.get_config(request.param)), jp, tp


def _count_flash(monkeypatch):
    """Record (S, D, causal) of every ops.flash_attention call."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, *, causal=True, **kw):
        calls.append((q.shape[2], q.shape[3], causal))
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(ops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("head_dim,want", [(32, (4, 6, 6)),
                                           (128, (16, 24, 24)),
                                           (64, None), (80, None)])
def test_mrope_sections_match(head_dim, want):
    """(16, 24, 24) at head_dim 128 is Qwen2-VL's published split; the
    reduced head_dim 32 gives (4, 6, 6)."""
    got = L.mrope_sections(head_dim)
    assert got == JL.mrope_sections(head_dim)
    assert sum(got) == head_dim // 2
    if want is not None:
        assert got == want


@pytest.mark.parametrize("head_dim", [32, 128])
def test_apply_mrope_with_distinct_ids_matches(head_dim):
    """Distinct temporal, height and width ids, as an image's patches carry
    them, each rotating its own band of frequencies."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 3, head_dim)).astype(np.float32)
    p3 = rng.integers(0, 4096, (2, 3, 9)).astype(np.int32)
    got = L.apply_mrope(t(x), torch.from_numpy(p3), 1e6)
    close(got, JL.apply_mrope(x, p3, 1e6), 1e-5)
    one = p3.copy()
    one[:, 1:] = one[:, :1]      # the same ids on every axis: not this
    assert not np.allclose(got.numpy(), L.apply_mrope(
        t(x), torch.from_numpy(one), 1e6).numpy(), atol=1e-3)


def test_mrope_at_text_ids_equals_rope():
    """``positional`` broadcasts 1-D ids to three equal rows, so text-only
    M-RoPE is RoPE, in the port and in the reference."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    got = L.positional(t(x), torch.from_numpy(pos.copy()), "mrope", 1e6)
    close(got, L.apply_rope(t(x), torch.from_numpy(pos.copy()), 1e6), 1e-5)
    close(got, JL.positional(x, pos, "mrope", 1e6), 1e-5)


def test_gqa_cross_attention_matches(monkeypatch):
    """``kv_source``: k/v from the encoder output (16 rows) under 8 decoder
    queries, no positions, the plain full attention and no K3 call (its
    q, k and v must share one length)."""
    cfg = reduced(get_config("whisper-small"))
    tcfg = reduced(tconfigs.get_config("whisper-small"))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jblk = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                  jp["stage0"]["sub0"]["xattn"])
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 8, cfg.d_model)) * 0.5).astype(np.float32)
    src = (rng.standard_normal((2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    calls = _count_flash(monkeypatch)
    want, _ = JA.gqa_forward(x, jblk, cfg, pos, causal=False, kv_source=src)
    got, cache = A.gqa_forward(t(x), {k: t(v) for k, v in jblk.items()}, tcfg,
                               torch.from_numpy(pos), causal=False,
                               kv_source=t(src))
    assert calls == [] and cache is None
    close(got, want, 1e-5)


def test_encode_matches(monkeypatch):
    """Whisper's encoder: frames (cast to the config's dtype, as the
    reference does) plus learned positions, non-causal blocks through K3's
    full path once a layer, the final norm."""
    cfg = reduced(get_config("whisper-small"))
    tcfg = reduced(tconfigs.get_config("whisper-small"))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    audio = make_batch(cfg, 2, 32)["audio"]
    calls = _count_flash(monkeypatch)
    got = T.encode(tp, tcfg, torch.from_numpy(audio))
    assert calls == [(cfg.encoder_seq, cfg.head_dim, False)] * \
        cfg.encoder_layers
    close(got, JT.encode(jp, cfg, jnp.asarray(audio)), 2e-4)


def test_forward_with_frontend_matches(model, monkeypatch):
    """Logits with ``patches`` (Qwen2-VL: 16 rows replace the prefix, S
    unchanged) or ``audio`` (Whisper: encoder, then cross-attention in each
    decoder block) against JAX ``forward`` within 2e-4; K3 once a decoder
    layer (causal) and once an encoder layer (full)."""
    cfg, tcfg, jp, tp = model
    raw = make_batch(cfg, 2, 32)
    keys = [k for k in raw if k != "labels"]
    assert len(keys) == 2
    calls = _count_flash(monkeypatch)
    want, _, _ = JT.forward(jp, cfg, {k: jnp.asarray(raw[k]) for k in keys})
    got, _, _ = T.forward(tp, tcfg, {k: torch.from_numpy(raw[k])
                                     for k in keys})
    assert got.shape == (2, 32, cfg.vocab_size)
    close(got, want, 2e-4)
    want_calls = [(32, cfg.head_dim, True)] * cfg.num_layers
    if cfg.is_encoder_decoder:
        want_calls = [(cfg.encoder_seq, cfg.head_dim, False)] * \
            cfg.encoder_layers + want_calls
    assert calls == want_calls
    plain, _, _ = T.forward(tp, tcfg, {"tokens": torch.from_numpy(
        raw["tokens"])})
    assert not torch.allclose(plain, got, atol=1e-3)   # the stub counts


def test_patches_replace_the_prefix_in_the_embeddings_dtype():
    tcfg = reduced(tconfigs.get_config("qwen2-vl-7b"))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.arange(12)[None] % tcfg.vocab_size
    patches = torch.full((1, 5, tcfg.d_model), 0.25, dtype=torch.float64)
    pos = torch.arange(12)[None]
    x = T._embed(tp, tcfg, tokens, pos, patches)
    assert x.shape == (1, 12, tcfg.d_model) and x.dtype == tp["embed"].dtype
    assert bool((x[:, :5] == 0.25).all())
    assert torch.equal(x[:, 5:], tp["embed"][tokens[:, 5:]])


def test_decode_steps_match(model):
    """Prefill 16 (with 8 patches, or the audio, as tests/test_archs.py:
    65-91) then decode token by token to 32: each step within 5e-4 of the
    reference's step and of the port's own teacher-forced forward. Whisper's
    prefill writes the cross K/V into the cache, and its decode steps read
    them from there."""
    cfg, tcfg, jp, tp = model
    b, s, prompt = 2, 32, 16
    raw = make_batch(cfg, b, s)
    fwd = {"tokens": raw["tokens"]}
    if "patches" in raw:
        fwd["patches"] = raw["patches"][:, :8]
    if "audio" in raw:
        fwd["audio"] = raw["audio"]
    full, _, _ = T.forward(tp, tcfg, {k: torch.from_numpy(np.ascontiguousarray(
        v)) for k, v in fwd.items()})
    pre = dict(fwd, tokens=fwd["tokens"][:, :prompt])
    jc = JT.init_decode_caches(cfg, b, s, dtype=jnp.float32)
    tc = T.init_decode_caches(tcfg, b, s, dtype=torch.float32, device="cpu")
    jl, jc = JT.prefill(jp, cfg, {k: jnp.asarray(v) for k, v in pre.items()},
                        jc)
    tl, tc = T.prefill(tp, tcfg, {k: torch.from_numpy(np.ascontiguousarray(
        v)) for k, v in pre.items()}, tc)
    close(tl, jl, 2e-4)
    close(tl[:, -1], full[:, prompt - 1], 5e-4)
    if cfg.is_encoder_decoder:
        sub = tc["stage0"]["sub0"]
        assert sub["xk"].shape[2] == cfg.encoder_seq
        close(sub["xk"], jc["stage0"]["sub0"]["xk"], 1e-5)
        assert float(sub["xv"].abs().max()) > 0
    step = jax.jit(lambda p, c, tok, tt: JT.decode_step(p, cfg, c, tok, tt))
    for pos in range(prompt, s):
        jl, jc = step(jp, jc, jnp.asarray(raw["tokens"][:, pos]),
                      jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, tc,
                               torch.from_numpy(raw["tokens"][:, pos]), pos)
        close(tl, jl, 5e-4)
        close(tl, full[:, pos], 5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_leaf_for_leaf(arch):
    """The port's ``init_params`` and the reference's converted weights are
    one tree, leaf for leaf: Whisper's ``enc`` subtree, both ``pos_embed``
    tables (32768 and encoder_seq rows) and each block's ``norm_x`` and
    ``xattn``; ``convert`` needs nothing new."""
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")

    def leaves(tree):
        return jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), a.dtype), tree))
    assert leaves(tp) == leaves(conv)
    assert ("enc" in tp) == ("pos_embed" in tp) == (arch == "whisper-small")
    if arch == "whisper-small":
        assert tp["pos_embed"].shape == (32768, cfg.d_model)
        assert tp["enc"]["pos_embed"].shape == (cfg.encoder_seq, cfg.d_model)
        assert "xattn" in tp["stage0"]["sub0"]
        assert "xattn" not in tp["enc"]["stage0"]["sub0"]
    assert T.count_params(tp) == sum(int(np.prod(a.shape)) for a in
                                     jax.tree_util.tree_leaves(jp))


# the four tenants of chip_smoke.py's phase 3e, at reduced size
MM_JOBS = [("l-qwen2vl-prefill", "qwen2-vl-7b", "prefill", 4, 1, 32),
           ("l-qwen2vl-decode", "qwen2-vl-7b", "decode", 8, 2, 32),
           ("m-whisper-prefill", "whisper-small", "prefill", 4, 2, 32),
           ("m-whisper-decode", "whisper-small", "decode", 8, 2, 32)]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers over the four tenants, each package with a fresh store
    of its own; the port's tenants of one arch share the reference's
    weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_IPC_CACHE", str(tmp_path_factory.mktemp("ref")))
        mp.setenv("REPRO_TORCH_IPC_CACHE",
                  str(tmp_path_factory.mktemp("port")))
        ref_srv = JS.SharedPodServer()
        port = TS.SharedPodServer(device="cpu")
        weights = {arch: params_from_jax(jax.tree_util.tree_map(
            np.asarray, JT.init_params(reduced(get_config(arch)),
                                       jax.random.PRNGKey(0))), device="cpu")
            for arch in ARCHS}
        for job in MM_JOBS:
            ref_srv.submit(JS.Job(*job))
            port.submit(TS.Job(*job), params=weights[job[1]])
        yield ref_srv, port


def test_multimodal_rounds_equal_reference(servers):
    ref_srv, port = servers
    want, got = ref_srv.drain(), port.drain()
    assert got["rounds"] == want["rounds"]
    assert any(k2 is not None for _, k2, *_ in got["rounds"])
    assert all(j.num_slices == 0 for j in port.jobs.values())
    assert got["predicted_gain"] == want["predicted_gain"]
    assert got["plan"]["predicted_makespan_cycles"] == \
        want["plan"]["predicted_makespan_cycles"]
    assert [ev[1:] for ev in port.log] == [ev[1:] for ev in ref_srv.log]


def test_multimodal_step_outputs_match_reference(servers, monkeypatch):
    """Every tenant's step on the reference's bf16 weights, the prefill
    steps with their patches or audio, the Whisper decode over a cross cache
    nobody filled (as the reference's server). Tolerance: the error's norm
    within 3e-2 of the reference's logits' norm (XLA and PyTorch round bf16
    intermediates at different places; the f32 tests above hold 2e-4). K3:
    once a decoder layer, and once an encoder layer for Whisper's prefill;
    never at decode."""
    ref_srv, port = servers
    calls = _count_flash(monkeypatch)
    for name, arch, phase, *_ in MM_JOBS:
        calls.clear()
        want = np.asarray(ref_srv._exec[name](), np.float32)
        got = port._exec[name]()
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        err = np.linalg.norm(got.float().numpy() - want)
        assert err < 3e-2 * np.linalg.norm(want), (name, err)
        cfg = reduced(get_config(arch))
        n = cfg.num_layers + cfg.encoder_layers if phase == "prefill" else 0
        assert len(calls) == n, (name, calls)

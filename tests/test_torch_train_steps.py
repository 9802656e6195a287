"""The port's train step and training loop against the reference's, in f32
on the CPU: three ``make_train_step`` steps on the same ``SyntheticLoader``
batches and weights for every arch, ``train()`` through a failure and a
restore (``tests/test_substrates.py:149-157``), the command line, and the
serve and prefill steps."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.data.synthetic import SyntheticLoader
from repro.launch.steps import make_train_step as ref_train_step
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as TA

ROOT = Path(__file__).resolve().parent.parent


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy().copy()}
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_train_steps_match_reference(arch):
    """Three steps of the port's ``make_train_step`` against the
    reference's, jitted, on the same batches: loss and grad norm each step
    within 1e-5 relative, and each leaf's params after three steps within
    5% of its largest single step, both as L2 norms. (An element whose
    gradient is near AdamW's eps (1e-8) moves by up to a whole step when
    its gradient changes by 1e-6 of the leaf's largest, which the gradient
    test allows, so the elementwise max is no measure here; the norms
    agree within 1e-3.)"""
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    kw = dict(warmup_steps=2, total_steps=10)
    jc, tc = JA.OptConfig(**kw), TA.OptConfig(**kw)
    js, ts = JA.init(jc, jp), TA.init(tc, tp)
    jstep = jax.jit(ref_train_step(cfg, jc))
    tstep = S.make_train_step(tcfg, tc)
    loader = SyntheticLoader(cfg, 2, 32, seed=0)
    traj = [_flat(jp)]
    for i in range(3):
        raw = loader.load(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in raw.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in raw.items()})
        traj.append(_flat(jp))
        assert set(tm) == set(jm), (set(tm), set(jm))
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= 1e-5 * abs(want), (i, key)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-7
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    got = _flat(tp)
    for key, want in traj[-1].items():
        step = max(np.linalg.norm(b[key] - a[key])
                   for a, b in zip(traj, traj[1:]))
        assert np.linalg.norm(got[key] - want) <= 0.05 * step, key


def test_train_step_leaves_the_callers_params_without_grad():
    cfg = reduced(tconfigs.get_config("phi3-mini-3.8b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    before = params["lm_head"].clone()
    opt = TA.OptConfig(warmup_steps=1)
    state = TA.init(opt, params)
    raw = SyntheticLoader(cfg, 2, 16).load(0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    p2, _, m = S.make_train_step(cfg, opt)(params, state, batch)
    assert p2 is params and not params["lm_head"].requires_grad
    assert not torch.equal(params["lm_head"], before)   # updated in place
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(v.grad_fn is None for v in m.values())
    assert callable(S.make_train_step(cfg, opt, moe_group=2))


def test_train_loop_end_to_end(tmp_path):
    """Few-step training on a reduced arch: loss decreases, and a crash
    at step 5 resumes from the checkpoint saved at step 5 (8 losses, none
    run again) and completes."""
    res = TR.train("stablelm-3b", use_reduced=True, steps=8, batch=4,
                   seq=32, ckpt_dir=str(tmp_path), fail_at={5: 1},
                   device="cpu")
    assert res["steps"] == 8
    losses = res["losses"]
    assert len(losses) == 8
    assert losses[-1] < losses[0]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000005.npz",
                                            "ckpt_00000008.npz",
                                            "manifest.json"]
    # the first batch's loss falls over training (across batches the
    # losses differ by ~0.1, so the first and last run's order is the
    # seed's)
    cfg = res["cfg"]
    first = {k: torch.from_numpy(v) for k, v in
             SyntheticLoader(cfg, 4, 32, seed=0).load(0).items()}
    init = T.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with torch.no_grad():
        before = float(T.train_loss(init, cfg, first)[0])
        after = float(T.train_loss(res["params"], cfg, first)[0])
    assert before == pytest.approx(losses[0], rel=1e-6) and after < before


def test_train_runs_on_the_card_unless_told_and_has_no_mesh(tmp_path):
    """No card: ``train`` raises unless told the CPU. It makes its host
    mesh over a process group it creates, and leaves no mesh or group
    behind."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TR.train("stablelm-3b", steps=1, ckpt_dir=str(tmp_path))
    TR.train("stablelm-3b", steps=1, batch=2, seq=16, model_parallel=2,
             device="cpu", ckpt_dir=str(tmp_path))
    assert not torch.distributed.is_initialized()
    assert SH.current_mesh() is None
    cfg, opt = TR.build("phi3-mini-3.8b", True)
    assert cfg == reduced(tconfigs.get_config("phi3-mini-3.8b"))
    assert opt == TA.OptConfig()


def test_command_line(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "rwkv6-1.6b", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("arch=rwkv6-1.6b steps=2 loss[0]=") and \
        "loss[-1]=" in line, line


def test_serve_and_prefill_steps_wrap_the_model():
    cfg = reduced(tconfigs.get_config("phi3-mini-3.8b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    caches = T.init_decode_caches(cfg, 2, 16, device="cpu",
                                  dtype=torch.float32)
    logits, caches = S.make_prefill_step(cfg)(params, caches,
                                              {"tokens": tokens})
    full, _, _ = T.forward(params, cfg, {"tokens": tokens})
    torch.testing.assert_close(logits, full)
    nxt = logits[:, -1].argmax(-1)
    step, caches = S.make_serve_step(cfg)(params, caches, nxt, 8)
    want, _, _ = T.forward(params, cfg, {"tokens": torch.cat(
        [tokens, nxt[:, None]], 1)})
    torch.testing.assert_close(step, want[:, -1], atol=1e-4, rtol=1e-4)


def test_grouped_moe_train_step_matches_reference():
    """``make_train_step(moe_group=16)`` on reduced deepseek-v2 (64 tokens
    routed in 4 groups of 16, each with its own capacity) against the
    reference's jitted step: loss, grad norm and every leaf after one
    step, at the tolerances of the three-step test."""
    arch = "deepseek-v2-236b"
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    kw = dict(warmup_steps=2, total_steps=10)
    jc, tc = JA.OptConfig(**kw), TA.OptConfig(**kw)
    js, ts = JA.init(jc, jp), TA.init(tc, tp)
    raw = SyntheticLoader(cfg, 2, 32, seed=0).load(0)
    before = _flat(jp)
    jp, js, jm = jax.jit(ref_train_step(cfg, jc, moe_group=16))(
        jp, js, {k: jnp.asarray(v) for k, v in raw.items()})
    tp, ts, tm = S.make_train_step(tcfg, tc, moe_group=16)(
        tp, ts, {k: torch.from_numpy(v) for k, v in raw.items()})
    for key in ("loss", "grad_norm", "aux"):
        want = float(jm[key])
        assert abs(float(tm[key]) - want) <= 1e-5 * abs(want), key
    with torch.no_grad():              # the groups' capacities matter
        _, ungrouped = T.train_loss(
            params_from_jax(_unflat(before), device="cpu"), tcfg,
            {k: torch.from_numpy(v) for k, v in raw.items()})
    assert float(ungrouped["aux"]) != pytest.approx(float(tm["aux"]),
                                                    rel=1e-3)
    want, got = _flat(jp), _flat(tp)
    for key in want:
        step = np.linalg.norm(want[key] - before[key])
        assert np.linalg.norm(got[key] - want[key]) <= 0.05 * step, key


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.strip("/").split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_model_parallel_train_on_one_rank_equals_one(tmp_path):
    """On one CPU rank ``make_host_mesh(2)`` is the (1, 1) mesh, as the
    reference's is on one device: the same losses and weights."""
    runs = [TR.train("stablelm-3b", steps=3, batch=2, seq=16,
                     model_parallel=mp, device="cpu",
                     ckpt_dir=str(tmp_path / f"mp{mp}")) for mp in (1, 2)]
    assert runs[0]["losses"] == runs[1]["losses"]
    a, b = _flat(runs[0]["params"]), _flat(runs[1]["params"])
    assert all(np.array_equal(a[k], b[k]) for k in a)

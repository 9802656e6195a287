"""Training with the mesh's ``model`` axis splitting the work: on 4 ``gloo``
ranks and the (2, 2) and (1, 4) meshes, each rank of the port's
``make_train_step`` computes only its token block of the global batch —
its rows over dp and its 1/m of the sequence over ``model`` — with
attention on its heads and the recurrent scans on its heads or channels;
three steps of eleven reduced cases, each a feature the split touches, are
held to the reference's jitted step under the same mesh on 4 forced host
devices, in f32:

- phi3 (GQA heads over ``model``);
- DeepSeek-V2 on the plain MoE route at a capacity that drops pairs (the
  global capacity in row-major (row, position) order), and on the EP route
  (the sequence block is the EP shard);
- DeepSeek-V3 (the multi-token prediction's shift across blocks, the
  sigmoid router, EP);
- RWKV6 (heads over ``model``, the layernorm over all of D, the token
  shift's halo);
- RecurrentGemma (the RG-LRU's channels, the conv's halo of 3 positions,
  the local MQA with its one kv head projected on every rank, a window
  shorter than the sequence);
- Qwen2-VL (M-RoPE positions given in the batch, a patch prefix that ends
  inside a block);
- Whisper (the encoder whole on every ``model`` rank, cross-attention on
  this rank's heads);
- three sizes ``model`` does not divide on (1, 4), where every rank then
  computes all of them (``ODD``): GQA heads, RWKV6 heads and RG-LRU
  channels.

A sequence that ``model`` does not divide stays whole over it, and
``train()`` runs the split step through a failure and a restore; every
rank ends bit for bit the same. The harness is
``tests/test_torch_dp_train.py``'s: the reference runs in subprocesses
(JAX fixes its device count at first use), ``REF_PARTS`` of the runs and
``train()`` each at once, while the port's 4 ranks, spawned once for the
module, meet through a ``FileStore`` in the test's tmp dir; each side
writes an npz."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_dp_train import KEEP, _moved, _rel
from test_torch_ep import _flatten, _unflatten

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (1, 4)]
ARCH = {"phi3": "phi3-mini-3.8b", "ds_plain": "deepseek-v2-236b",
        "ds_ep": "deepseek-v2-236b", "ds3": "deepseek-v3-671b",
        "rwkv6": "rwkv6-1.6b", "rg": "recurrentgemma-9b",
        "qwen": "qwen2-vl-7b", "whisper": "whisper-small",
        "phi3_h6": "phi3-mini-3.8b", "rwkv6_n64": "rwkv6-1.6b",
        "rg_w130": "recurrentgemma-9b"}
CASES = tuple(ARCH)
# sizes that ``model`` does not divide on (1, 4), where every rank computes
# them all: 6 q heads over 3 kv heads, RWKV6's 2 heads of 64, an RG-LRU 130
# channels wide
ODD = {"phi3_h6": dict(num_heads=6, num_kv_heads=3),
       "rwkv6_n64": dict(rwkv_head_dim=64), "rg_w130": dict(lru_width=130)}
# (mesh, case) of the stepped runs
STEPPED = [(m, c) for c in CASES[:-len(ODD)] for m in MESHES] + [
    ((1, 4), c) for c in ODD]
BATCH, SEQ, STEPS = 4, 16, 3
DROP_FACTOR = 0.5        # the plain route drops pairs whatever the routing
WINDOW = 6               # RecurrentGemma's local window, < a (2, 2) block
PATCHES = 6              # Qwen2-VL's patch prefix ends inside a block
# a split the reference's rules leave whole, model not dividing S: (case,
# mesh, B, S)
WHOLE = {"s15": ("phi3", (1, 4), BATCH, SEQ - 1)}
TRAIN = ("rwkv6", 4)     # train(): arch key and model_parallel
TRAIN_STEPS, FAIL_AT = 8, {7: 1}     # checkpoint at 5, restart there
FLOPS = ("phi3", "rg", "whisper")
# RWKV6's bonus u, drawn instead of the init's zeros: with u = 0 every
# sequence's first WKV output is exactly 0, so the layernorm over D after
# it runs at variance 0 < eps and passes rsqrt(eps) ~ 316 times the
# gradient into u (norm ~3e4); the third step's grad norm is then chaotic
# at 1e-5 in either package alone (4.9e-4 apart on one device)
U_SCALE = 0.5
REF_PARTS = 6            # reference processes for the steps, at once


def _name(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _cfg(configs, case):
    """``case``'s reduced config, from either package's ``configs``."""
    cfg = configs.reduced(configs.get_config(ARCH[case]))
    if case == "ds_plain":
        cfg = dataclasses.replace(cfg, moe_impl="dense", moe=dataclasses
                                  .replace(cfg.moe,
                                           capacity_factor=DROP_FACTOR))
    if case == "rg":
        cfg = dataclasses.replace(cfg, local_window=WINDOW)
    return dataclasses.replace(cfg, **ODD.get(case, {}))


def _batches(synthetic, cfg, case, batch=BATCH, seq=SEQ):
    """``STEPS`` batches from ``synthetic``'s loader, the labels masked
    unevenly by ``KEEP``; Qwen2-VL's with a shorter patch prefix and
    positions of its own."""
    loader = synthetic.SyntheticLoader(cfg, batch, seq, seed=0)
    out = []
    for i in range(STEPS):
        raw = loader.load(i)
        for r in range(batch):
            raw["labels"][r, KEEP[r % len(KEEP)]:] = -1
        if case == "qwen":
            raw["patches"] = raw["patches"][:, :PATCHES]
            raw["positions"] = (np.arange(seq)[None] + 5 * np.arange(
                batch)[:, None]).astype(np.int32)
        out.append(raw)
    return out


def _runs():
    """(key, case, mesh shape, B, S) of every stepped run."""
    out = [(f"{c}_{_name(m)}", c, m, BATCH, SEQ) for m, c in STEPPED]
    return out + [(k, c, m, b, s) for k, (c, m, b, s) in WHOLE.items()]


def _opt_kw():
    return dict(warmup_steps=2, total_steps=10)


def _reference(out_path, tmp, part):
    """The reference on 4 forced host devices (run as a script): three
    jitted steps of every ``REF_PARTS``-th run from ``part``, or with
    ``part`` "run" ``train()`` through a failure."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data import synthetic
    from repro.launch import train as JTR
    from repro.launch.steps import make_train_step
    from repro.models import sharding as JSH
    from repro.models import transformer as JT
    from repro.optim import adamw as JA
    assert len(jax.devices()) == 4, jax.devices()
    res = {}

    def load(case):
        return jax.tree_util.tree_map(jnp.asarray, _unflatten(dict(
            np.load(os.path.join(tmp, f"params_{case}.npz")))))
    opt = JA.OptConfig(**_opt_kw())
    for key, case, shape, b, s in (_runs()[int(part)::REF_PARTS]
                                   if part != "run" else ()):
        cfg = _cfg(configs, case)
        # Auto axes: jax.make_mesh's Explicit ones are refused by the
        # model's with_sharding_constraint (ROADMAP fault 15)
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 ("data", "model"))
        with mesh, JSH.use_mesh(mesh):
            step = jax.jit(make_train_step(cfg, opt))
            pp = load(case)
            st = JA.init(opt, pp)
            for i, raw in enumerate(_batches(synthetic, cfg, case, b, s)):
                pp, st, m = step(pp, st, {k: jnp.asarray(v)
                                          for k, v in raw.items()})
                for k in ("loss", "aux", "grad_norm"):
                    res[f"{key}/{i}/{k}"] = np.asarray(m[k])
        for leaf, v in _flatten({"p": pp, "mu": st["mu"],
                                 "nu": st["nu"]}).items():
            res[f"{key}/{leaf}"] = np.asarray(v)
    if part != "run":
        np.savez(out_path, **res)
        return

    arch, mp = ARCH[TRAIN[0]], TRAIN[1]
    params = load(TRAIN[0])
    JT.init_params = lambda cfg, key, dtype=None: params
    JTR.make_host_mesh = lambda model_parallel: jax.sharding.Mesh(
        np.array(jax.devices()).reshape(4 // model_parallel,
                                        model_parallel), ("data", "model"))
    run = JTR.train(arch, steps=TRAIN_STEPS, batch=BATCH, seq=SEQ,
                    model_parallel=mp, fail_at=dict(FAIL_AT),
                    ckpt_dir=os.path.join(tmp, "ref_ckpt"))
    res["run/losses"] = np.array(run["losses"])
    for leaf, v in _flatten(run["params"]).items():
        res[f"run/p/{leaf}"] = np.asarray(v)
    np.savez(out_path, **res)


def _rank_main(rank, world, store_path, tmp):
    """One gloo rank: three steps of every run, the FLOPs of a step on
    each mesh and on one rank, and ``train()`` through a failure."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw as TA
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        meshes = {shape: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for shape in MESHES}
        opt = TA.OptConfig(**_opt_kw())

        def load(case):
            return _unflatten(dict(np.load(os.path.join(
                tmp, f"params_{case}.npz"))))

        def run(cfg, mesh, batches, params):
            """Steps from ``params`` on ``batches`` under ``mesh``:
            (params, state, [metrics], FLOPs of the first step)."""
            pp = params_from_jax(params, device="cpu")
            st = TA.init(opt, pp)
            step = S.make_train_step(cfg, opt)
            ms, flops = [], None
            with SH.use_mesh(mesh):
                for raw in batches:
                    with FlopCounterMode(display=False) as fc:
                        pp, st, m = step(pp, st, {k: torch.from_numpy(v)
                                                  for k, v in raw.items()})
                    flops = flops or fc.get_total_flops()
                    ms.append(m)
            return pp, st, ms, flops

        for key, case, shape, b, s in _runs():
            cfg = _cfg(configs, case)
            batches = _batches(synthetic, cfg, case, b, s)
            params = load(case)
            pp, st, ms, flops = run(cfg, meshes[shape], batches, params)
            for i, m in enumerate(ms):
                for k in ("loss", "aux", "grad_norm"):
                    res[f"{key}/{i}/{k}"] = m[k].numpy()
            for leaf, v in _flatten({"p": pp, "mu": st["mu"],
                                     "nu": st["nu"]}).items():
                res[f"{key}/{leaf}"] = v.numpy()
            res[f"flops/{key}"] = np.array(flops)
            block = SH.token_block(meshes[shape], b, s)
            res[f"block/{key}"] = np.array(
                (-1, -1) if block is None else
                (block.flat_index, block.n_blocks))
            if case in FLOPS and key == f"{case}_{_name(MESHES[0])}":
                res[f"flops/{case}_one"] = np.array(
                    run(cfg, None, batches[:1], params)[3])

        arch, mp = ARCH[TRAIN[0]], TRAIN[1]
        params = load(TRAIN[0])
        real_init = TR.T.init_params
        TR.T.init_params = lambda cfg, gen, device: params_from_jax(
            params, device="cpu")
        try:
            out = TR.train(arch, steps=TRAIN_STEPS, batch=BATCH, seq=SEQ,
                           model_parallel=mp, device="cpu",
                           fail_at=dict(FAIL_AT),
                           ckpt_dir=os.path.join(tmp, "ckpt"))
        except RuntimeError as e:   # ResilientLoop: the ranks' states differ
            res["run/error"] = np.array(str(e))
        else:
            res["run/losses"] = np.array(out["losses"])
            res["run/steps"] = np.array(out["steps"])
            for leaf, v in _flatten(out["params"]).items():
                res[f"run/p/{leaf}"] = v.numpy()
        finally:
            TR.T.init_params = real_init
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [each port rank's results], tmp dir). The
    weights are the port's seeded init (both packages keep one layout),
    which is ten times faster here than the reference's."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    tmp = tmp_path_factory.mktemp("sp_train")
    for case in CASES:
        cfg = _cfg(configs, case)
        params = _flatten(T._tree_map(lambda t: t.numpy(), T.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32)))
        for k in params:
            if k.endswith("tmix/u"):
                params[k] = (np.random.default_rng(0).normal(
                    size=params[k].shape) * U_SCALE).astype(np.float32)
        np.savez(tmp / f"params_{case}.npz", **params)
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_JAX_CACHE": "0"}
    parts = [str(i) for i in range(REF_PARTS)] + ["run"]
    refs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_sp_train as t; "
         "t._reference(*sys.argv[1:])", str(tmp / f"ref_{part}.npz"),
         str(tmp), part],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in parts]
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(4, str(tmp / "store"), str(tmp)),
            nprocs=4, start_method="spawn")
        logs = [ref.communicate(timeout=600)[0] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log[-3000:]
    want = {}
    for part in parts:
        want.update(np.load(tmp / f"ref_{part}.npz"))
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return want, got, tmp


def _check_steps(want, got, tmp, key, case):
    """Loss, aux and grad norm each step within 1e-5 relative (aux exactly
    0 without MoE), and every parameter and moment after three steps
    within 0.2% of how far its leaf moved."""
    for i in range(STEPS):
        for k in ("loss", "aux", "grad_norm"):
            if k == "aux" and not case.startswith("ds"):
                assert float(got[0][f"{key}/{i}/aux"]) == 0.0
                continue
            _rel(got[0][f"{key}/{i}/{k}"], want[f"{key}/{i}/{k}"], (i, k))
    init = dict(np.load(tmp / f"params_{case}.npz"))
    leaves = [k for k in want if k.split("/")[0] == key
              and k.split("/")[1] in ("p", "mu", "nu")]
    assert len(leaves) > 20, leaves
    for k in leaves:
        kind, _, leaf = k[len(key) + 1:].partition("/")
        _moved(got[0][k], want[k], init[leaf] if kind == "p" else 0.0, k)


@pytest.mark.parametrize("mesh, case", STEPPED,
                         ids=[f"{_name(m)}-{c}" for m, c in STEPPED])
def test_train_steps_on_token_blocks_equal_the_reference(runs, mesh, case):
    """Three steps, each rank on its token block (rows over dp, 1/m of the
    sequence over ``model``) of the unevenly masked batch, equal the
    reference's jitted steps under the same mesh."""
    want, got, tmp = runs
    key = f"{case}_{_name(mesh)}"
    assert tuple(got[0][f"block/{key}"])[1] == 4
    _check_steps(want, got, tmp, key, case)


def test_a_sequence_model_does_not_divide_stays_whole(runs):
    """S = 15 on (1, 4): ``model`` does not divide the sequence, so every
    rank runs the whole batch (no token block), and the step equals the
    reference's under the same mesh."""
    want, got, tmp = runs
    for res in got:
        assert tuple(res["block/s15"]) == (-1, -1), res["block/s15"]
    _check_steps(want, got, tmp, "s15", WHOLE["s15"][0])


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_every_rank_ends_bit_identical(runs, mesh):
    """The gradients are summed over the blocks in the same order on every
    rank, so losses, params and moments are rank 0's bit for bit; each
    rank's block is its mesh coordinate, dp-major."""
    _, got, _ = runs
    keys = [k for k in got[0] if k.split("/")[0].endswith(_name(mesh))
            and not k.startswith(("flops/", "block/"))]
    assert any("/mu/" in k for k in keys) and any("rwkv6" in k for k in keys)
    for rank, res in enumerate(got):
        for k in keys:
            np.testing.assert_array_equal(res[k], got[0][k], err_msg=k)
        assert tuple(res[f"block/phi3_{_name(mesh)}"]) == (rank, 4)


@pytest.mark.parametrize("case", ["rg", "whisper"])
def test_replicated_parts_keep_a_rank_within_its_dp_share(runs, case):
    """RecurrentGemma's local MQA projects its one kv head on every
    ``model`` rank and Whisper's encoder runs whole on each: a rank's
    ``FlopCounterMode`` count of a step on (2, 2), printed as a share of
    the one-rank step's, is at most 1/dp = 1/2 of it."""
    _, got, _ = runs
    for rank, res in enumerate(got):
        share = float(res[f"flops/{case}_2x2"]) / float(
            res[f"flops/{case}_one"])
        print(f"[flops] {case} (2, 2) rank {rank}: {share:.4f} of one rank")
        assert share <= 0.5, (case, rank, share)


def test_train_through_a_failure_equals_the_reference(runs):
    """``train(model_parallel=4)`` of RWKV6 on 4 ranks, the (1, 4) mesh
    (the sequence over ``model``), from the reference's weights, a failure
    at step 7 and a restart from the checkpoint of step 5: the 10 losses
    within 1e-5 relative of the reference's ``train()`` on 4 host devices
    through the same failure, every weight within 0.2% of how far its leaf
    moved, every rank the same bit for bit; rank 0 wrote the
    checkpoints."""
    want, got, tmp = runs
    init = dict(np.load(tmp / f"params_{TRAIN[0]}.npz"))
    losses = want["run/losses"]
    assert len(losses) == TRAIN_STEPS + 2     # steps 5 and 6 run again
    for rank, res in enumerate(got):
        assert "run/error" not in res, res["run/error"]
        assert int(res["run/steps"]) == TRAIN_STEPS
        for i, (g, w) in enumerate(zip(res["run/losses"], losses)):
            _rel(g, w, (rank, i))
        for k in res:
            if k.startswith("run/p/"):
                np.testing.assert_array_equal(res[k], got[0][k], err_msg=k)
                _moved(res[k], want[k], init[k[len("run/p/"):]], k)
    assert sorted(os.listdir(tmp / "ckpt")) == [
        "ckpt_00000005.npz", "ckpt_00000008.npz", "manifest.json"]

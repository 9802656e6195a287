"""Serving under a mesh: on 4 ``gloo`` ranks and the (2, 2) and (1, 4)
meshes, the port's ``make_prefill_step`` computes each rank's token block
of the global prompt (its rows over dp, its 1/m of the sequence over
``model``) and writes only that rank's shard of the caches, which
``init_decode_caches`` allocates under the mesh; ``make_serve_step`` then
decodes this rank's rows over its cache shards, attention over an S-split
cache through the split-K combine over ``model``. A prefill and 8 decode
steps of each reduced case are held to the reference's jitted
``make_prefill_step`` and ``make_serve_step`` under the same mesh on 4
forced host devices, with ``in_shardings`` from ``param_shardings``,
``cache_shardings`` and ``batch_shardings``, in f32:

- phi3 (GQA: the prompt's k/v exchanged from this rank's heads to every
  head of its cache rows);
- DeepSeek-V2 (MLA's latents by rows, the absorbed decode in latent space,
  the MoE's EP route on the prefill's sequence block), and its ``expand``
  decode on (1, 4);
- RWKV6 (the state's heads and the width of ``x_last_*`` over ``model``,
  the layernorm over all heads, the global last row from the last block);
- RecurrentGemma (the RG-LRU's ``h`` and ``conv`` over ``model``; the
  local ring's 8 slots split over ``model``, a window shorter than
  ``max_len``, wrapped by the decode steps);
- Whisper (the cross cache's rows over dp, whole over ``model``);
- sizes ``model`` does not divide on (1, 4) (``ODD``), whose leaf stays
  whole on every rank: ``max_len`` 14 with 6 heads over 3 kv heads, RWKV6's
  2 heads of 64 (``state`` whole, ``x_last_*`` split), an RG-LRU 130
  channels wide, and a 2-token prompt that ``model`` does not split.

The prompt is 4 tokens into caches of ``MAX_LEN`` = 12 rows, so on (2, 2)
the 8 decode steps (t = 4..11) write into both ranks' blocks of 6 rows,
and on (1, 4) into ranks 1-3's blocks of 3 rows (the prompt's 4 rows are
rank 0's 3 and one of rank 1's); the 2-token prompt's steps t = 2..9 reach
every rank's block. A rank whose rows all lie beyond t brings an empty
block to the combine. RWKV6's bonus ``u`` is drawn (``U_SCALE``), as in
``tests/test_torch_sp_train.py``: with the init's zero ``u`` the layernorm
after the first position's zero WKV output runs at variance 0 (ROADMAP
fault 16).

The harness is ``tests/test_torch_sp_train.py``'s: the reference runs in
``REF_PARTS`` subprocesses at once (JAX fixes its device count at first
use), while the port's 4 ranks, spawned once for the module, meet through
a ``FileStore`` in the test's tmp dir; each side writes an npz."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_ep import _flatten, _unflatten

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (1, 4)]
ARCH = {"phi3": "phi3-mini-3.8b", "ds": "deepseek-v2-236b",
        "rwkv6": "rwkv6-1.6b", "rg": "recurrentgemma-9b",
        "whisper": "whisper-small", "ds_expand": "deepseek-v2-236b",
        "phi3_h6_l14": "phi3-mini-3.8b", "rwkv6_n64": "rwkv6-1.6b",
        "rg_w130": "recurrentgemma-9b", "phi3_s2": "phi3-mini-3.8b"}
BASE = ("phi3", "ds", "rwkv6", "rg", "whisper")
# on (1, 4) only: MLA's expand decode, and sizes 'model' does not divide,
# each leaf then whole on every rank
ODD = {"ds_expand": dict(mla_decode="expand"),
       "phi3_h6_l14": dict(num_heads=6, num_kv_heads=3),
       "rwkv6_n64": dict(rwkv_head_dim=64), "rg_w130": dict(lru_width=130),
       "phi3_s2": {}}
RUNS = [(m, c) for c in BASE for m in MESHES] + [((1, 4), c) for c in ODD]
B, S, MAX_LEN, STEPS = 4, 4, 12, 8
LENS = {"phi3_h6_l14": 14}          # max_len 14: 'model' = 4 does not divide
PROMPTS = {"phi3_s2": 2}            # 2 tokens: the prompt stays whole
WINDOW = 8                          # RecurrentGemma's ring: < MAX_LEN, 4 | 8
U_SCALE = 0.5                       # RWKV6's u, drawn (fault 16)
REF_PARTS = 6
TOL = 1e-5


def _name(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _key(mesh, case):
    return f"{case}_{_name(mesh)}"


def _cfg(configs, case):
    """``case``'s reduced config, from either package's ``configs``."""
    cfg = configs.reduced(configs.get_config(ARCH[case]))
    if ARCH[case] == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, local_window=WINDOW)
    return dataclasses.replace(cfg, **ODD.get(case, {}))


def _inputs(cfg, case):
    """(prompt batch, (STEPS, B) decode tokens), numpy, from one seed."""
    rng = np.random.default_rng(1)
    s = PROMPTS.get(case, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["audio"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    return batch, rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)


def _reference(out_path, tmp, part):
    """The reference on 4 forced host devices (run as a script): the
    jitted prefill and 8 decode steps of every ``REF_PARTS``-th run from
    ``part``, their logits and the global caches after the last step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro import configs
    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models import sharding as JSH
    from repro.models import transformer as JT
    assert len(jax.devices()) == 4, jax.devices()
    res = {}
    for mesh_shape, case in RUNS[int(part)::REF_PARTS]:
        key = _key(mesh_shape, case)
        cfg = _cfg(configs, case)
        batch, toks = _inputs(cfg, case)
        s = batch["tokens"].shape[1]
        # Auto axes: jax.make_mesh's Explicit ones are refused by the
        # model's with_sharding_constraint (ROADMAP fault 15)
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(mesh_shape),
                                 ("data", "model"))
        with mesh, JSH.use_mesh(mesh):
            params = jax.tree_util.tree_map(jnp.asarray, _unflatten(dict(
                np.load(os.path.join(tmp, f"params_{case}.npz")))))
            caches = JT.init_decode_caches(cfg, B, LENS.get(case, MAX_LEN),
                                           dtype=jnp.float32)
            p_sh = JSH.param_shardings(params, mesh)
            c_sh = JSH.cache_shardings(caches, mesh)
            b_sh = JSH.batch_shardings(batch, mesh)
            prefill = jax.jit(make_prefill_step(cfg),
                              in_shardings=(p_sh, c_sh, b_sh))
            logits, caches = prefill(params, caches,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            res[f"{key}/logits/0"] = np.asarray(logits)
            tok_sh = JSH.batch_shardings({"token": toks[0]}, mesh)["token"]
            serve = jax.jit(make_serve_step(cfg), in_shardings=(
                p_sh, c_sh, tok_sh, NamedSharding(mesh, PartitionSpec())))
            for i in range(STEPS):
                # back onto cache_shardings: the jitted steps' outputs
                # carry the shardings GSPMD chose for them
                caches = jax.device_put(caches, c_sh)
                logits, caches = serve(params, caches, jnp.asarray(toks[i]),
                                       jnp.int32(s + i))
                res[f"{key}/logits/{i + 1}"] = np.asarray(logits)
        for leaf, v in _flatten(caches).items():
            res[f"{key}/cache/{leaf}"] = np.asarray(v)
    np.savez(out_path, **res)


def _rank_main(rank, world, store_path, tmp):
    """One gloo rank: the prefill and decode steps of every run under its
    mesh, this rank's logits blocks and cache shards, and the FLOPs of
    phi3's prefill on (2, 2) and with no mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import steps as St
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        meshes = {shape: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for shape in MESHES}

        def serve(cfg, case, params, mesh):
            """(prefill FLOPs, [logits], caches) of a prefill and the
            decode steps under ``mesh``."""
            batch, toks = _inputs(cfg, case)
            s, max_len = batch["tokens"].shape[1], LENS.get(case, MAX_LEN)
            with SH.use_mesh(mesh):
                caches = T.init_decode_caches(cfg, B, max_len,
                                              dtype=torch.float32,
                                              device="cpu")
                with FlopCounterMode(display=False) as fc:
                    logits, caches = St.make_prefill_step(
                        cfg, max_len=max_len)(params, caches, {
                            k: torch.from_numpy(v) for k, v in batch.items()})
                out = [logits]
                step = St.make_serve_step(cfg, max_len=max_len)
                for i in range(STEPS):
                    logits, caches = step(params, caches,
                                          torch.from_numpy(toks[i]), s + i)
                    out.append(logits)
            return fc.get_total_flops(), out, caches

        for mesh_shape, case in RUNS:
            key = _key(mesh_shape, case)
            cfg = _cfg(configs, case)
            params = params_from_jax(_unflatten(dict(np.load(os.path.join(
                tmp, f"params_{case}.npz")))), device="cpu")
            flops, logits, caches = serve(cfg, case, params,
                                          meshes[mesh_shape])
            for i, lg in enumerate(logits):
                res[f"{key}/logits/{i}"] = lg.numpy()
            for leaf, v in _flatten(caches).items():
                res[f"{key}/cache/{leaf}"] = v.numpy()
            s = PROMPTS.get(case, S)
            block = SH.token_block(meshes[mesh_shape], B, s)
            rows = block.rows(B) if block is not None else slice(0, B)
            seq = block.share(s) if block is not None else slice(0, s)
            res[f"block/{key}"] = np.array((rows.start, rows.stop, seq.start,
                                            seq.stop))
            if key == "phi3_2x2":
                res["flops/phi3_2x2"] = np.array(flops)
                res["flops/phi3_one"] = np.array(
                    serve(cfg, case, params, None)[0])
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [each port rank's results]). The weights are
    the port's seeded init (both packages keep one layout)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    tmp = tmp_path_factory.mktemp("sp_serve")
    for case in ARCH:
        params = _flatten(T._tree_map(lambda t: t.numpy(), T.init_params(
            _cfg(configs, case), torch.Generator().manual_seed(0),
            device="cpu", dtype=torch.float32)))
        for k in params:
            if k.endswith("tmix/u"):
                params[k] = (np.random.default_rng(0).normal(
                    size=params[k].shape) * U_SCALE).astype(np.float32)
        np.savez(tmp / f"params_{case}.npz", **params)
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_JAX_CACHE": "0"}
    refs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_sp_serve as t; "
         "t._reference(*sys.argv[1:])", str(tmp / f"ref_{part}.npz"),
         str(tmp), str(part)],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in range(REF_PARTS)]
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
    for part in range(REF_PARTS):
        want.update(np.load(tmp / f"ref_{part}.npz"))
    return want, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _close(got, want, msg):
    """Within ``TOL`` of the reference's largest magnitude (exact for
    integers: the ring's positions)."""
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=msg)
        return
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= TOL * max(scale, 1e-30), (msg, err, scale)


def _shard(want, spec, mesh_shape, rank):
    """The slice of the global ``want`` that ``rank`` holds under
    ``spec`` on a ("data", "model") mesh of ``mesh_shape``."""
    coord = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    size = dict(zip(("data", "model"), mesh_shape))
    idx = []
    for n, e in zip(want.shape, spec):
        if e is None:
            idx.append(slice(None))
            continue
        per = n // size[e]
        idx.append(slice(coord[e] * per, (coord[e] + 1) * per))
    return want[tuple(idx)]


def _specs(want, key, mesh_shape):
    """{leaf: the port's ``cache_shardings`` spec} of run ``key``'s global
    caches on a ``ShapeMesh`` of ``mesh_shape``."""
    from repro_torch.models import sharding as SH
    prefix = f"{key}/cache/"
    caches = _unflatten({k[len(prefix):]: v for k, v in want.items()
                         if k.startswith(prefix)})
    mesh = SH.ShapeMesh(("data", "model"), mesh_shape)
    return {k: sh for k, sh in _flatten(SH.cache_shardings(caches,
                                                           mesh)).items()}


@pytest.mark.parametrize("mesh, case", RUNS,
                         ids=[f"{_name(m)}-{c}" for m, c in RUNS])
def test_prefill_and_decode_logits_equal_the_reference(runs, mesh, case):
    """Each rank's prefill logits are its (B/d, S/m, V) block of the
    reference's, whole over the vocabulary, and its 8 decode steps' logits
    its (B/d, V) rows, each within 1e-5 of the reference's largest; the
    ranks that share rows decode the same logits bit for bit."""
    want, got = runs
    key = _key(mesh, case)
    for rank, res in enumerate(got):
        r0, r1, s0, s1 = (int(v) for v in res[f"block/{key}"])
        _close(res[f"{key}/logits/0"], want[f"{key}/logits/0"][r0:r1, s0:s1],
               (rank, "prefill"))
        for i in range(1, STEPS + 1):
            _close(res[f"{key}/logits/{i}"], want[f"{key}/logits/{i}"][r0:r1],
                   (rank, "decode", i))
            peer = got[rank - rank % mesh[1]]      # model coordinate 0
            np.testing.assert_array_equal(res[f"{key}/logits/{i}"],
                                          peer[f"{key}/logits/{i}"])
    if mesh == (2, 2) and case in BASE:       # the blocks split both ways
        assert tuple(got[3][f"block/{key}"]) == (2, 4, 2, 4)


@pytest.mark.parametrize("mesh, case", RUNS,
                         ids=[f"{_name(m)}-{c}" for m, c in RUNS])
def test_cache_shards_equal_the_reference_slices(runs, mesh, case):
    """After the prefill and 8 decode steps each rank's cache shard
    equals the slice of the reference's global cache that
    ``cache_shardings`` gives it (within 1e-5 of the leaf's largest; the
    ring's positions exactly), and ``init_decode_caches`` allocated just
    that: its bytes are ``shard_bytes`` of the leaf's spec."""
    from repro_torch.models import sharding as SH
    want, got = runs
    key = _key(mesh, case)
    specs = _specs(want, key, mesh)
    split = 0
    for leaf, sh in specs.items():
        whole = want[f"{key}/cache/{leaf}"]
        split += any(e is not None for e in sh.spec)
        for rank, res in enumerate(got):
            shard = res[f"{key}/cache/{leaf}"]
            assert shard.nbytes == SH.shard_bytes(torch.from_numpy(whole),
                                                  sh), (leaf, rank)
            _close(shard, _shard(whole, sh.spec, mesh, rank), (leaf, rank))
    # every leaf of max_len 14 with one dp row block is whole on (1, 4)
    assert bool(split) == (case != "phi3_h6_l14"), (key, split)


@pytest.mark.parametrize("case, leaves", [
    ("phi3_h6_l14", ("k", "v")), ("rwkv6_n64", ("state",)),
    ("rg_w130", ("h", "conv"))])
def test_a_size_model_does_not_divide_keeps_its_leaf_whole(runs, case,
                                                           leaves):
    """On (1, 4) a leaf whose S rows, heads or width ``model`` does not
    divide is whole on every rank, equal to the reference's whole leaf;
    the others still split (RWKV6's ``x_last_*`` over D = 128, the ring's
    8 slots; phi3's caches hold only k and v)."""
    want, got = runs
    key = _key((1, 4), case)
    specs = _specs(want, key, (1, 4))
    named = {leaf: sh for leaf, sh in specs.items()
             if leaf.split("/")[-1] in leaves}
    assert named
    for leaf, sh in named.items():
        assert "model" not in sh.spec, (leaf, sh.spec)
        for res in got:
            _close(res[f"{key}/cache/{leaf}"], want[f"{key}/cache/{leaf}"],
                   leaf)
    assert any("model" in sh.spec for sh in specs.values()) == (
        case != "phi3_h6_l14"), specs


def test_a_prompt_model_does_not_divide_reaches_every_rank_block(runs):
    """The 2-token prompt on (1, 4) stays whole on every rank (its block
    is the whole sequence), and its decode steps t = 2..9 write into each
    rank's block of 3 cache rows, which then differs from zero."""
    want, got = runs
    key = _key((1, 4), "phi3_s2")
    for rank, res in enumerate(got):
        assert tuple(res[f"block/{key}"]) == (0, B, 0, 2)
        k = res[f"{key}/cache/stage0/sub0/k"]
        assert k.shape[2] == MAX_LEN // 4
        assert np.abs(k).max() > 0, rank


def test_a_rank_prefill_computes_its_share_of_the_flops(runs):
    """Dense phi3 on (2, 2): attention runs this rank's half of the heads
    over its half of the rows, and the projections, MLP and logits its
    quarter of the tokens, so a rank's ``FlopCounterMode`` count of the
    prefill, printed as a share of the one-rank prefill's, is exactly a
    quarter of it (1/(d·m); the k/v exchange and the gathers count no
    FLOPs)."""
    _, got = runs
    for rank, res in enumerate(got):
        share = float(res["flops/phi3_2x2"]) / float(res["flops/phi3_one"])
        print(f"[flops] phi3 prefill (2, 2) rank {rank}: {share:.4f} of one "
              f"rank")
        assert share == 0.25, (rank, share)


@pytest.mark.parametrize("case", BASE)
def test_a_one_by_one_mesh_serves_as_no_mesh(case):
    """Under a (1, 1) gloo ``DeviceMesh`` (one rank) the prefill and 8
    decode steps give logits and caches ``torch.equal`` to the same calls
    with no mesh: m = d = 1 cuts nothing, and the caches are whole."""
    from repro_torch import configs
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    cfg = _cfg(configs, case)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    batch, toks = _inputs(cfg, case)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def serve(mesh):
        with SH.use_mesh(mesh):
            caches = T.init_decode_caches(cfg, B, MAX_LEN,
                                          dtype=torch.float32, device="cpu")
            out, caches = St.make_prefill_step(cfg, max_len=MAX_LEN)(
                params, caches, batch)
            out = [out]
            for i in range(STEPS):
                lg, caches = St.make_serve_step(cfg, max_len=MAX_LEN)(
                    params, caches, torch.from_numpy(toks[i]), S + i)
                out.append(lg)
        return out, _flatten(caches)

    assert not dist.is_initialized()
    mesh = make_host_mesh(1, device="cpu")
    try:
        assert tuple(mesh.shape) == (1, 1)
        got, got_c = serve(mesh)
    finally:
        dist.destroy_process_group()
    want, want_c = serve(None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got_c.keys() == want_c.keys()
    for k in want_c:
        assert torch.equal(got_c[k], want_c[k]), k


@pytest.mark.parametrize("case", ["phi3", "ds"])
def test_a_token_past_the_cache_raises(case):
    """A decode step at t = max_len has no cache row to write: the port
    raises (ROADMAP fault 17), where the reference's
    ``dynamic_update_slice`` clamps the write into the last row and
    attends as if the cache were longer."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = _cfg(configs, case)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    batch, toks = _inputs(cfg, case)
    caches = T.init_decode_caches(cfg, B, S, dtype=torch.float32,
                                  device="cpu")
    T.prefill(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])},
              caches)
    with pytest.raises(ValueError, match="fault 17"):
        T.decode_step(params, cfg, caches, torch.from_numpy(toks[0]), S)

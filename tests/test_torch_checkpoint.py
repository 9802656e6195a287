"""The port's checkpoint store (``repro_torch.checkpoint.store``) against the
reference's file format in both directions, and ports of the reference's
store, loop and data tests (``tests/test_substrates.py:62-140``) for the
port's ``checkpoint``, ``runtime.fault_tolerance`` and ``data.synthetic``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config, reduced
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.models import sharding as SH
from repro_torch.optim import adamw as TA
from repro_torch.runtime.fault_tolerance import (HostFailure, ResilientLoop,
                                                 StragglerBalancer,
                                                 elastic_mesh_shape)


def _loop_state(arch="phi3-mini-3.8b"):
    """The reference's and the port's training-loop state, (params,
    opt_state), for one reduced arch: bf16 params (the config's dtype),
    f32 moments after one update, the same numbers in both."""
    cfg, tcfg = reduced(get_config(arch)), reduced(tconfigs.get_config(arch))
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    js = JA.init(JA.OptConfig(), jp)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, js, _ = JA.update(JA.OptConfig(), jp, grads, js)
    np_tree = jax.tree_util.tree_map(np.asarray, (jp, js))
    tp = params_from_jax(np_tree[0], device="cpu")
    ts = {"step": torch.tensor(int(js["step"]), dtype=torch.int32),
          "mu": params_from_jax(np_tree[1]["mu"], device="cpu"),
          "nu": params_from_jax(np_tree[1]["nu"], device="cpu")}
    assert tp["embed"].dtype == torch.bfloat16 == \
        getattr(torch, str(jp["embed"].dtype))
    return (jp, js), (tp, ts), tcfg


def _pairs(jtree, ttree):
    """(key path, reference leaf, port leaf) over the reference's tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    for path, leaf in flat:
        t = ttree
        for p in path:
            t = t[p.key] if hasattr(p, "key") else t[p.idx]
        yield "/".join(jstore._seg(p) for p in path), leaf, t


def test_key_paths_equal_the_reference():
    jstate, tstate, _ = _loop_state()
    want, _ = jstore._flatten(jstate)
    got = store._flatten(tstate)
    assert list(got) == list(want)
    assert "#0/stage0/sub0/attn/wq" in got and "#1/mu/embed" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate, _ = _loop_state()
    jstore.save(str(tmp_path), 7, jstate)
    template = jax.tree_util.tree_map(torch.zeros_like, tstate)
    got, step = store.restore(str(tmp_path), template)
    assert step == 7 and store.latest_step(str(tmp_path)) == 7
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 1
    n = 0
    for key, want, leaf in _pairs(jstate, got):
        assert leaf.dtype == getattr(torch, str(want.dtype)), key
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(want, np.float32), err_msg=key)
        n += 1
    assert n == len(store._flatten(tstate))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate, _ = _loop_state()
    store.save(str(tmp_path), 9, tstate)
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    got, step = jstore.restore(str(tmp_path), template)
    assert step == 9 and jstore.latest_step(str(tmp_path)) == 9
    assert got[1]["step"].dtype == np.int32 and int(got[1]["step"]) == 1
    for key, want, leaf in _pairs(got, tstate):
        assert str(want.dtype) == str(leaf.dtype).removeprefix("torch."), key
        np.testing.assert_array_equal(
            np.asarray(want, np.float32), leaf.float().numpy(), err_msg=key)


def test_restore_puts_each_leaf_on_the_template(tmp_path):
    """The template's dtype wins (an f32 array restores into bf16 and
    int32); numpy leaves and sequences restore as the reference's do;
    ``shardings=`` that replicate every leaf leave plain tensors; a missing
    checkpoint raises."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "l": [np.ones(2, np.float32), torch.tensor(3, dtype=torch.int32)]}
    store.save(str(tmp_path), 1, tree)
    template = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
                "l": [np.zeros(2, np.float64), torch.zeros((),
                                                           dtype=torch.int64)]}
    got, _ = store.restore(str(tmp_path), template)
    assert got["a"].dtype == torch.bfloat16 and got["a"].shape == (2, 3)
    assert isinstance(got["l"], list) and got["l"][0].dtype == np.float64
    assert got["l"][1].dtype == torch.int64 and int(got["l"][1]) == 3
    mesh = SH.ShapeMesh(("data", "model"), (1, 1))
    repl = {"a": SH.NamedSharding(mesh, SH.spec(None, None)),
            "l": [SH.NamedSharding(mesh, SH.spec(None)),
                  SH.NamedSharding(mesh, SH.spec())]}
    got2, _ = store.restore(str(tmp_path), template, shardings=repl)
    assert type(got2["a"]) is torch.Tensor and torch.equal(got2["a"],
                                                           got["a"])
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "none"), template)
    assert store.latest_step(str(tmp_path / "none")) is None


# ---- ports of tests/test_substrates.py:62-140 -------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}
    store.save(str(tmp_path), 3, tree)
    restored, step = store.restore(str(tmp_path), tree)
    assert step == 3
    for (p1, l1), (p2, l2) in zip(store._items(tree),
                                  store._items(restored)):
        assert p1 == p2 and l1.dtype == l2.dtype
        assert torch.equal(l1, l2)


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        store.save(str(tmp_path), s, tree, keep=2)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 2
    assert store.latest_step(str(tmp_path)) == 5


class _CountingLoader:
    def __init__(self):
        self.calls = []

    def load(self, step):
        self.calls.append(step)
        return {"x": np.full((2,), float(step))}


def test_resilient_loop_restarts_exactly(tmp_path):
    """After injected failures the loop resumes from the checkpoint (the
    default store, this package's) and the final state equals a
    failure-free run."""
    def step_fn(state, batch):
        return state + float(batch["x"].sum()), {}

    loader = _CountingLoader()
    loop = ResilientLoop(step_fn, torch.zeros(()), loader, str(tmp_path),
                         ckpt_every=4)
    state, end = loop.run(12, fail_at={6: 1, 10: 2})
    ref = 0.0
    for s in range(12):
        ref += 2 * s
    assert end == 12
    assert float(state) == ref
    assert loop.store is store
    assert loader.calls.count(4) == 2 and loader.calls.count(8) == 3


def test_resilient_loop_gives_up(tmp_path):
    loop = ResilientLoop(lambda s, b: (s, {}), 0, _CountingLoader(),
                         str(tmp_path), max_retries=2)
    with pytest.raises(HostFailure):
        loop.run(5, fail_at={0: 99})    # fails before any progress


def test_straggler_balancer_rebalances():
    bal = StragglerBalancer(n_hosts=4, total_slices=64)
    for _ in range(20):
        for h, lat in enumerate((1.0, 1.0, 1.0, 3.0)):   # host 3 is slow
            bal.observe(h, lat)
    shares = bal.rebalance()
    assert shares.sum() == 64
    assert shares[3] < shares[0]                          # slow host offloaded
    equal_makespan = 16 * 3.0
    assert bal.makespan() < equal_makespan


def test_elastic_mesh_shape():
    assert elastic_mesh_shape(32, 16, 16) == (32, 16)
    assert elastic_mesh_shape(31, 16, 16) == (31, 16)     # lost a host
    with pytest.raises(RuntimeError):
        elastic_mesh_shape(1, 4, 16)


def test_synthetic_loader_sharded_deterministic():
    cfg = reduced(tconfigs.get_config("phi3-mini-3.8b"))
    full = SyntheticLoader(cfg, 8, 16, seed=3)
    h0 = SyntheticLoader(cfg, 8, 16, seed=3, host_index=0, host_count=2)
    h1 = SyntheticLoader(cfg, 8, 16, seed=3, host_index=1, host_count=2)
    b_full = full.load(5)
    np.testing.assert_array_equal(b_full["tokens"][:4], h0.load(5)["tokens"])
    np.testing.assert_array_equal(b_full["tokens"][4:], h1.load(5)["tokens"])


def test_adamw_state_checkpoints_through_the_loop_template(tmp_path):
    """An optimizer state of this package (int32 step, bf16 moments and
    err) saves and restores into itself with every dtype kept."""
    params = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(
        0)).bfloat16()}
    cfg = TA.OptConfig(moment_dtype="bfloat16", compress_grads=True)
    st = TA.init(cfg, params)
    _, st, _ = TA.update(cfg, params, {"w": torch.ones(3, 4)}, st)
    store.save(str(tmp_path), 1, (params, st))
    (p2, s2), _ = store.restore(str(tmp_path), (params, st))
    assert s2["step"].dtype == torch.int32 and int(s2["step"]) == 1
    for a, b in ((params["w"], p2["w"]), (st["mu"]["w"], s2["mu"]["w"]),
                 (st["err"]["w"], s2["err"]["w"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _restore_rank(rank, world, store_path, ckpt_dir, out_dir):
    """One gloo rank: restore the params onto a (1, 2) mesh by
    ``param_shardings`` and save this rank's local shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as T
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg = reduced(tconfigs.get_config("deepseek-v2-236b"))
        template = T.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        sh = SH.param_shardings(template, mesh)
        got, _ = store.restore(ckpt_dir, template, shardings=sh)
        local, specs = {}, {}
        for (path, leaf), (_, s) in zip(store._items(got), store._items(sh)):
            key = "/".join(path)
            local[key] = (leaf.to_local() if isinstance(leaf, DTensor)
                          else leaf).float().numpy()
            specs[key] = s.spec
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **local)
        if rank == 0:
            with open(os.path.join(out_dir, "specs.txt"), "w") as f:
                f.write(repr(specs))
    finally:
        dist.destroy_process_group()


def test_restore_onto_a_two_rank_mesh_gives_each_rank_its_shard(tmp_path):
    """The reduced deepseek-v2 params saved, then restored on 2 gloo ranks
    with ``shardings=`` from ``param_shardings`` on a (1, 2) mesh: a leaf
    whose spec names 'model' comes back as each rank's ``Shard`` of it, bit
    for bit; every other leaf whole."""
    import ast

    from repro_torch.models import transformer as T
    cfg = reduced(tconfigs.get_config("deepseek-v2-236b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    store.save(str(tmp_path / "ckpt"), 1, params)
    torch.multiprocessing.start_processes(
        _restore_rank, args=(2, str(tmp_path / "store"),
                             str(tmp_path / "ckpt"), str(tmp_path)),
        nprocs=2, start_method="spawn")
    specs = ast.literal_eval((tmp_path / "specs.txt").read_text())
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    n_sharded = 0
    for path, leaf in store._items(params):
        key = "/".join(path)
        full = leaf.float().numpy()
        dims = [i for i, e in enumerate(specs[key]) if e == "model"]
        if not dims:
            for r in ranks:
                np.testing.assert_array_equal(r[key], full)
            continue
        n_sharded += 1
        for i, part in enumerate(np.split(full, 2, axis=dims[0])):
            np.testing.assert_array_equal(ranks[i][key], part)
    assert n_sharded >= 10

"""Data-parallel training: the mesh's batch axes split a step's work. On 4
``gloo`` ranks and the (4, 1), (2, 2) and (1, 4) meshes, each rank of the
port's ``make_train_step`` computes only its block of the global batch's
rows (and, where ``model`` divides S, of its sequence:
``tests/test_torch_sp_train.py``) and the gradients are summed over the
blocks; three steps of reduced phi3 and reduced DeepSeek-V2 (the plain MoE
route at a capacity that drops pairs, and the EP route) are held to the
reference's jitted step under the same mesh on 4 forced host devices, in
f32. The global statistics (the masked cross-entropy's token count over
unevenly masked blocks, the Switch aux, the ungrouped MoE's capacity
drops) are the reference's; a batch that neither the dp size nor
``model`` divides stays whole; ``train()`` runs through a failure and a
restore against the reference's ``train()``.

The harness is ``tests/test_torch_ep_train.py``'s: the reference runs in a
subprocess (JAX fixes its device count at first use) while the port's 4
ranks, spawned once for the module, meet through a ``FileStore`` in the
test's tmp dir; each side writes an npz."""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_ep import _flatten, _inputs, _unflatten

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(4, 1), (2, 2), (1, 4)]
CASES = ("phi3", "ds_plain", "ds_ep")
ARCH = {"phi3": "phi3-mini-3.8b", "ds_plain": "deepseek-v2-236b",
        "ds_ep": "deepseek-v2-236b"}
BATCH, SEQ, STEPS = 4, 16, 3
# the plain route's capacity factor: below E / k = 4, and at half the
# pairs' mean per expert, so pairs drop whatever the routing
DROP_FACTOR = 0.5
# the first step's moments (the gradient summed over the dp axes, and its
# square): each leaf within 1e-5 of its largest value (the gradient tests'
# form, tests/test_torch_train.py); losses, aux and grad norms within 1e-5
# relative
TOL = 1e-5
# after several steps: each leaf's error norm within 0.2% of how far the
# leaf moved. AdamW moves an element whose gradient is near its eps by up
# to a whole step when the gradient changes by 1e-6 of the leaf's largest
# (tests/test_torch_train_steps.py), so no elementwise bound holds there;
# the worst leaf measured 1.8e-4
MOVE_TOL = 2e-3
# labels masked unevenly over the batch's rows, so the dp blocks of both
# dp sizes hold unequal token counts: row r keeps positions < KEEP[r]
KEEP = (4, 16, 1, 11)
FLOP_TOL = 0.01
# a batch that the dp size does not divide, per mesh with dp > 1, as (B,
# S): on (2, 2) an S that ``model`` does not divide either, else the
# sequence would split over it
WHOLE = {(4, 1): (2, SEQ), (2, 2): (3, SEQ - 1)}
TRAIN_STEPS, FAIL_AT = 8, {7: 1}     # checkpoint at 5, restart there
MOE_GROUP = 16                       # one group a rank's 16 tokens at dp 4


def _name(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _cfg(configs, case):
    """``case``'s reduced config, from either package's ``configs``."""
    cfg = configs.reduced(configs.get_config(ARCH[case]))
    if case == "ds_plain":
        cfg = dataclasses.replace(cfg, moe_impl="dense", moe=dataclasses
                                  .replace(cfg.moe,
                                           capacity_factor=DROP_FACTOR))
    return cfg


def _batch(loader, i, batch=BATCH):
    """``loader``'s batch ``i`` with its labels masked by ``KEEP``."""
    raw = loader.load(i)
    for r in range(batch):
        raw["labels"][r, KEEP[r % len(KEEP)]:] = -1
    return raw


def _opt_kw():
    return dict(warmup_steps=2, total_steps=10)


def _pairs(rows, xs, seg, keep, offset=0):
    """(kept, dropped) (token, expert) pairs of one ``moe_ffn`` call from
    its sorted pair rows ``xs``, found among the token ``rows``."""
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    tok = [offset + index[r.tobytes()] for r in xs]
    pairs = np.array([(i, int(e)) for i, e in zip(tok, seg)]).reshape(-1, 2)
    return pairs[keep], pairs[~keep]


def _reference(out_path, tmp, part):
    """The reference on 4 forced host devices (run as a script), one
    ``part`` a process: a mesh's name, three jitted steps of each case on
    it; or ``"run"``, the ungrouped ``moe_ffn``'s kept and dropped pairs
    and ``train()`` through a failure."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data.synthetic import SyntheticLoader
    from repro.launch import train as JTR
    from repro.launch.steps import make_train_step
    from repro.models import moe as JM
    from repro.models import sharding as JSH
    from repro.models import transformer as JT
    from repro.optim import adamw as JA
    assert len(jax.devices()) == 4, jax.devices()
    res = {}

    def load(arch):
        return jax.tree_util.tree_map(jnp.asarray, _unflatten(dict(
            np.load(os.path.join(tmp, f"params_{arch}.npz")))))
    opt = JA.OptConfig(**_opt_kw())
    for case in CASES if part != "run" else ():
        cfg = _cfg(configs, case)
        params = load(ARCH[case])
        loader = SyntheticLoader(cfg, BATCH, SEQ, seed=0)
        for shape in [m for m in MESHES if _name(m) == part]:
            n = _name(shape)
            mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                     ("data", "model"))
            with mesh, JSH.use_mesh(mesh):
                step = jax.jit(make_train_step(cfg, opt))
                pp, st = params, JA.init(opt, params)
                for i in range(STEPS):
                    batch = {k: jnp.asarray(v)
                             for k, v in _batch(loader, i).items()}
                    pp, st, m = step(pp, st, batch)
                    for key in ("loss", "aux", "grad_norm"):
                        res[f"{case}_{n}/{i}/{key}"] = np.asarray(m[key])
                    if i == 0:
                        for leaf, v in _flatten({"mu": st["mu"],
                                                 "nu": st["nu"]}).items():
                            res[f"{case}_{n}/first/{leaf}"] = np.asarray(v)
            for leaf, v in _flatten({"p": pp, "mu": st["mu"],
                                     "nu": st["nu"]}).items():
                res[f"{case}_{n}/{leaf}"] = np.asarray(v)

    if part != "run":
        np.savez(out_path, **res)
        return
    # the ungrouped route's drops: one global sort, eagerly, with a spy
    cfg = _cfg(configs, "ds_plain")
    p, x, _ = _inputs()
    calls = []
    real = JM._bucketed_expert_compute

    def spy(xs, seg, pos, e, cap, *rest):
        calls.append((np.asarray(xs), np.asarray(seg),
                      np.asarray(pos) < cap))
        return real(xs, seg, pos, e, cap, *rest)
    JM._bucketed_expert_compute = spy
    out, aux = JM.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), cfg)
    JM._bucketed_expert_compute = real
    res["drops/kept"], res["drops/dropped"] = _pairs(
        x.reshape(-1, x.shape[-1]), *calls[0])
    res["drops/out"], res["drops/aux"] = np.asarray(out), np.asarray(aux)

    # train() from the test's weights, on its host mesh with Auto axes:
    # the mesh of jax.make_mesh has Explicit ones in this JAX, which the
    # model's with_sharding_constraint refuses (ROADMAP fault 15)
    params = load(ARCH["ds_ep"])
    JT.init_params = lambda cfg, key, dtype=None: params
    JTR.make_host_mesh = lambda model_parallel: jax.sharding.Mesh(
        np.array(jax.devices()).reshape(4 // model_parallel,
                                        model_parallel), ("data", "model"))
    run = JTR.train(ARCH["ds_ep"], steps=TRAIN_STEPS, batch=BATCH, seq=SEQ,
                    model_parallel=2, fail_at=dict(FAIL_AT),
                    ckpt_dir=os.path.join(tmp, "ref_ckpt"))
    res["run/losses"] = np.array(run["losses"])
    for leaf, v in _flatten(run["params"]).items():
        res[f"run/p/{leaf}"] = np.asarray(v)
    np.savez(out_path, **res)


def _rank_main(rank, world, store_path, tmp):
    """One gloo rank: three steps of each case on each mesh, the FLOPs of
    a step on each mesh and on one rank, a batch the dp size does not
    divide, the grouped MoE, the ungrouped ``moe_ffn`` on this rank's
    block, and ``train()`` through a failure."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models import moe as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
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

        def load(arch):
            return _unflatten(dict(np.load(os.path.join(
                tmp, f"params_{arch}.npz"))))

        def run(cfg, mesh, batches, params, **kw):
            """Steps from ``params`` on ``batches`` under ``mesh``:
            (params, state, [metrics], FLOPs of the steps)."""
            pp = params_from_jax(params, device="cpu")
            st = TA.init(opt, pp)
            step = S.make_train_step(cfg, opt, **kw)
            ms = []
            with SH.use_mesh(mesh), FlopCounterMode(display=False) as fc:
                for raw in batches:
                    pp, st, m = step(pp, st, {k: torch.from_numpy(v)
                                              for k, v in raw.items()})
                    if not ms:     # the moments are updated in place
                        m["first"] = T._tree_map(torch.clone, {
                            "mu": st["mu"], "nu": st["nu"]})
                    ms.append(m)
            return pp, st, ms, fc.get_total_flops()

        for case in CASES:
            cfg = _cfg(configs, case)
            params = load(ARCH[case])
            loader = SyntheticLoader(cfg, BATCH, SEQ, seed=0)
            batches = [_batch(loader, i) for i in range(STEPS)]
            for shape, mesh in meshes.items():
                n = _name(shape)
                pp, st, ms, flops = run(cfg, mesh, batches, params)
                for i, m in enumerate(ms):
                    for key in ("loss", "aux", "grad_norm"):
                        res[f"{case}_{n}/{i}/{key}"] = m[key].numpy()
                for leaf, v in _flatten(ms[0]["first"]).items():
                    res[f"{case}_{n}/first/{leaf}"] = v.numpy()
                for leaf, v in _flatten({"p": pp, "mu": st["mu"],
                                         "nu": st["nu"]}).items():
                    res[f"{case}_{n}/{leaf}"] = v.numpy()
                res[f"flops/{case}_{n}"] = np.array(flops)
                block = SH.dp_block(mesh, BATCH)
                res[f"block/{n}"] = np.array(-1 if block is None
                                             else block.index)
            res[f"flops/{case}_one"] = np.array(
                run(cfg, None, batches, params)[3])

        # a batch that the dp size does not divide: whole on every rank
        cfg = _cfg(configs, "phi3")
        params = load(ARCH["phi3"])
        for shape, (b, s) in WHOLE.items():
            batches = [_batch(SyntheticLoader(cfg, b, s, seed=0), 0, b)]
            for key, mesh in (("mesh", meshes[shape]), ("one", None)):
                pp, _, ms, flops = run(cfg, mesh, batches, params)
                for leaf, v in _flatten(pp).items():
                    res[f"whole_{_name(shape)}/{key}/p/{leaf}"] = v.numpy()
                res[f"whole_{_name(shape)}/{key}/loss"] = ms[0]["loss"] \
                    .numpy()
                res[f"whole_{_name(shape)}/{key}/flops"] = np.array(flops)

        # the EP route on the global view cannot split such a batch over
        # dp, as the reference's shard_map cannot
        cfg = _cfg(configs, "ds_ep")
        p, x, _ = _inputs()
        try:
            M.moe_ffn_ep_sharded(torch.from_numpy(x[:3]), params_from_jax(
                p, device="cpu"), cfg, meshes[(2, 2)])
            res["whole_2x2/ep"] = np.array("no raise")
        except ValueError as e:
            res["whole_2x2/ep"] = np.array(str(e))

        # the grouped MoE: one group a rank at dp 4 equals one rank's
        # groups; a group straddling two ranks' blocks raises
        cfg = _cfg(configs, "ds_plain")
        params = load(ARCH["ds_plain"])
        batches = [_batch(SyntheticLoader(cfg, BATCH, SEQ, seed=0), 0)]
        for key, mesh in (("mesh", meshes[(4, 1)]), ("one", None)):
            pp, _, ms, _ = run(cfg, mesh, batches, params,
                               moe_group=MOE_GROUP)
            for leaf, v in _flatten(pp).items():
                res[f"grouped/{key}/p/{leaf}"] = v.numpy()
            for k in ("loss", "aux"):
                res[f"grouped/{key}/{k}"] = ms[0][k].numpy()
        try:
            run(cfg, meshes[(4, 1)], batches, params,
                moe_group=2 * MOE_GROUP)
            res["grouped/straddle"] = np.array("no raise")
        except ValueError as e:
            res["grouped/straddle"] = np.array(str(e))

        # the ungrouped route on this rank's block, with a spy
        p, x, _ = _inputs()
        tp = params_from_jax(p, device="cpu")
        real = M._bucketed_expert_compute
        for shape, mesh in meshes.items():
            n = _name(shape)
            block = SH.dp_block(mesh, x.shape[0])
            rows = block.rows(x.shape[0]) if block else slice(None)
            calls = []

            def spy(xs, seg, pos, e, cap, *rest):
                calls.append((xs.numpy(), seg.numpy(), (pos < cap).numpy()))
                return real(xs, seg, pos, e, cap, *rest)
            M._bucketed_expert_compute = spy
            with SH.use_mesh(mesh), SH.use_dp_block(block):
                out, aux = M.moe_ffn(torch.from_numpy(x[rows]), tp, cfg)
            M._bucketed_expert_compute = real
            res[f"drops_{n}/kept"], res[f"drops_{n}/dropped"] = _pairs(
                x[rows].reshape(-1, x.shape[-1]), *calls[0],
                offset=(rows.start or 0) * x.shape[1])
            res[f"drops_{n}/out"] = out.numpy()
            res[f"drops_{n}/rows"] = np.arange(x.shape[0])[rows]
            res[f"drops_{n}/aux"] = (block.sum_(aux.clone()) if block
                                     else aux).numpy()

        # train() on the (2, 2) mesh from the reference's weights
        params = load(ARCH["ds_ep"])
        real_init = TR.T.init_params
        TR.T.init_params = lambda cfg, gen, device: params_from_jax(
            params, device="cpu")
        try:
            out = TR.train(ARCH["ds_ep"], steps=TRAIN_STEPS, batch=BATCH,
                           seq=SEQ, model_parallel=2, device="cpu",
                           fail_at=dict(FAIL_AT),
                           ckpt_dir=os.path.join(tmp, "ckpt"))
        finally:
            TR.T.init_params = real_init
        res["run/losses"] = np.array(out["losses"])
        res["run/steps"] = np.array(out["steps"])
        for leaf, v in _flatten(out["params"]).items():
            res[f"run/p/{leaf}"] = v.numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [each port rank's results], tmp dir)."""
    import jax

    from repro import configs
    from repro.models import transformer as JT
    tmp = tmp_path_factory.mktemp("dp_train")
    for arch in sorted(set(ARCH.values())):
        cfg = configs.reduced(configs.get_config(arch))
        params = JT.init_params(cfg, jax.random.PRNGKey(0), dtype="float32")
        np.savez(tmp / f"params_{arch}.npz", **_flatten(
            jax.tree_util.tree_map(np.asarray, params)))
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_JAX_CACHE": "0"}
    parts = [_name(m) for m in MESHES] + ["run"]
    refs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_dp_train as t; "
         "t._reference(*sys.argv[1:])", str(tmp / f"ref_{part}.npz"),
         str(tmp), part],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in parts]
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(4, str(tmp / "store"), str(tmp)),
            nprocs=4, start_method="spawn")
        logs = [ref.communicate(timeout=300)[0] for ref in refs]
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


def _close(got, want, msg):
    tol = TOL * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=msg)


def _rel(got, want, msg):
    assert abs(float(got) - float(want)) <= TOL * abs(float(want)), (
        msg, float(got), float(want))


def _moved(got, want, start, msg):
    err = np.linalg.norm(got - want)
    assert err <= MOVE_TOL * np.linalg.norm(want - start), (
        msg, err, np.linalg.norm(want - start))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_train_steps_on_dp_blocks_equal_the_reference(runs, mesh, case):
    """Three steps, each rank on its dp block of the unevenly masked
    batch: loss (the global masked mean), aux and grad norm each step
    within 1e-5 relative; the first step's moments, each element within
    1e-5 of its leaf's largest value; and every parameter and moment
    after three steps within 0.2% of how far its leaf moved."""
    want, got, tmp = runs
    n = f"{case}_{_name(mesh)}"
    for i in range(STEPS):
        for key in ("loss", "aux", "grad_norm"):
            if case == "phi3" and key == "aux":
                assert float(got[0][f"{n}/{i}/aux"]) == 0.0
                continue
            _rel(got[0][f"{n}/{i}/{key}"], want[f"{n}/{i}/{key}"],
                 (i, key))
    first = [k for k in want if k.startswith(f"{n}/first/")]
    assert any("/moe/" in k for k in first) == (case != "phi3")
    for k in first:
        _close(got[0][k], want[k], k)
    init = dict(np.load(tmp / f"params_{ARCH[case]}.npz"))
    for k in want:
        kind, _, leaf = k[len(n) + 1:].partition("/")
        if k.startswith(f"{n}/") and kind in ("p", "mu", "nu"):
            start = init[leaf] if kind == "p" else 0.0
            _moved(got[0][k], want[k], start, k)


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_every_rank_ends_bit_identical(runs, mesh):
    """The gradients are summed over the dp axes in the same order on
    every rank, so losses, params and moments are rank 0's bit for bit;
    each rank's block is its dp coordinate, major axis first."""
    _, got, _ = runs
    n = _name(mesh)
    keys = [k for k in got[0] if k.split("/")[0] in
            [f"{c}_{n}" for c in CASES]]
    assert any("/mu/" in k for k in keys)
    for rank, res in enumerate(got):
        for k in keys:
            np.testing.assert_array_equal(res[k], got[0][k], err_msg=k)
        want = {(4, 1): rank, (2, 2): rank // 2, (1, 4): -1}[mesh]
        assert int(res[f"block/{n}"]) == want, (rank, res[f"block/{n}"])


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_each_rank_computes_its_block_only(runs, mesh):
    """Dense phi3: a rank's ``FlopCounterMode`` count of the three steps
    is 1/(dp·m) of the one-rank steps' on the whole batch, within 1%: the
    rows split over dp and the sequence over ``model``."""
    _, got, _ = runs
    n = mesh[0] * mesh[1]
    for res in got:
        one = float(res["flops/phi3_one"])
        mine = float(res[f"flops/phi3_{_name(mesh)}"])
        assert abs(mine - one / n) <= FLOP_TOL * one / n, (mine, one)


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_ungrouped_moe_drops_the_reference_pairs_on_blocks(runs, mesh):
    """The plain route at capacity factor 0.5 on each rank's block: the
    kept and dropped (token, expert) pairs over all ranks are the ones
    the reference's single global sort keeps and drops (drops present),
    each rank's output rows are the reference's, and the aux shares sum
    to the reference's aux."""
    want, got, _ = runs
    n = _name(mesh)

    def pairs(a):
        return {tuple(map(int, p)) for p in a}
    assert len(want["drops/dropped"]) >= 16, want["drops/dropped"]
    for key in ("kept", "dropped"):
        union = set().union(*(pairs(r[f"drops_{n}/{key}"]) for r in got))
        assert union == pairs(want[f"drops/{key}"]), key
    for res in got:
        _close(res[f"drops_{n}/out"], want["drops/out"][
            res[f"drops_{n}/rows"]], "out")
        _rel(res[f"drops_{n}/aux"], want["drops/aux"], "aux")


@pytest.mark.parametrize("mesh", sorted(WHOLE), ids=_name)
def test_a_batch_the_dp_size_does_not_divide_stays_whole(runs, mesh):
    """B = 2 on (4, 1) and B = 3 with S = 15 on (2, 2): every rank runs
    the whole batch and sums nothing, so a step under the mesh is the step
    without one, bit for bit, with the same FLOPs. The EP route on the
    global view of such a batch raises, as the reference's ``shard_map``
    does."""
    _, got, _ = runs
    n = f"whole_{_name(mesh)}"
    for res in got:
        assert "does not split over the dp size 2" in str(
            res["whole_2x2/ep"]), res["whole_2x2/ep"]
        keys = [k for k in res if k.startswith(f"{n}/mesh/")]
        assert len(keys) > 10
        for k in keys:
            np.testing.assert_array_equal(
                res[k], res[k.replace("/mesh/", "/one/")], err_msg=k)


def test_grouped_moe_on_blocks_equals_one_rank(runs):
    """``moe_group=16`` at dp 4: each rank's 16 tokens are one of the
    global batch's four groups, so one step under the mesh equals the
    one-rank grouped step within 1e-5 (params, loss and the aux, the
    groups' mean); a group of 32 straddles two ranks' blocks and raises,
    naming the reason."""
    _, got, _ = runs
    for res in got:
        for k in ("loss", "aux"):
            _rel(res[f"grouped/mesh/{k}"], res[f"grouped/one/{k}"], k)
        for k in res:
            if k.startswith("grouped/mesh/p/"):
                _close(res[k], res[k.replace("/mesh/", "/one/")], k)
        assert "would not be the reference's" in str(
            res["grouped/straddle"]), res["grouped/straddle"]


def test_train_through_a_failure_equals_the_reference(runs):
    """``train(model_parallel=2)`` on 4 ranks, the (2, 2) mesh (dp 2, EP
    over ``model``) from the reference's weights, a failure at step 7
    and a restart from the checkpoint of step 5: the 10 losses within
    1e-5 relative of the reference's ``train()`` on 4 host devices
    through the same failure, every weight within 0.2% of how far its
    leaf moved, every rank the same bit for bit; rank 0 wrote the
    checkpoints."""
    want, got, tmp = runs
    init = dict(np.load(tmp / f"params_{ARCH['ds_ep']}.npz"))
    losses = want["run/losses"]
    assert len(losses) == TRAIN_STEPS + 2     # steps 5 and 6 run again
    for rank, res in enumerate(got):
        assert int(res["run/steps"]) == TRAIN_STEPS
        for i, (g, w) in enumerate(zip(res["run/losses"], losses)):
            _rel(g, w, (rank, i))
        for k in res:
            if k.startswith("run/p/"):
                np.testing.assert_array_equal(res[k], got[0][k], err_msg=k)
                _moved(res[k], want[k], init[k[len("run/p/"):]], k)
    assert sorted(os.listdir(tmp / "ckpt")) == [
        "ckpt_00000005.npz", "ckpt_00000008.npz", "manifest.json"]


def test_remat_recomputes_under_the_forwards_mesh_in_any_thread():
    """On the card autograd runs a backward on its own thread, where the
    recompute of a remat block must still see the forward's mesh: reduced
    DeepSeek-V2 with remat on a shape-only (1, 2) mesh (the EP route), its
    gradients taken on another thread equal those taken on this one."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(_cfg(configs, "ds_ep"), remat=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, 2, SEQ).items()}
    leaves = []
    T._tree_map(lambda p: leaves.append(p.requires_grad_()), params)
    mesh = SH.ShapeMesh(("data", "model"), (1, 2))
    out = []
    with SH.use_mesh(mesh):
        here = torch.autograd.grad(T.train_loss(params, cfg, batch)[0],
                                   leaves, allow_unused=True,
                                   materialize_grads=True)
        loss = T.train_loss(params, cfg, batch)[0]
    worker = threading.Thread(target=lambda: out.append(torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    worker.start()
    worker.join()
    assert len(out) == 1 and len(here) > 20
    for a, b in zip(out[0], here):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

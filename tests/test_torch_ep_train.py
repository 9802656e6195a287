"""Training across ranks: the port's expert-parallel MoE under autograd and
``make_train_step`` / ``train()`` on 4 ``gloo`` ranks, against the
reference's ``jax.grad`` through its ``shard_map`` route and its jitted
step on 4 forced host devices, on reduced DeepSeek-V2 in f32.

As in ``tests/test_torch_ep.py``, the reference runs in a subprocess (JAX
fixes its device count at first use) and writes an npz, and the port's 4
ranks are spawned here and meet through a ``FileStore`` in the test's tmp
dir; one module-scoped fixture runs both at once. The EP cases run at the
default ``capacity_factor``, so pairs drop, with the bf16 all-to-all; the
int8 one refuses autograd in the port (ROADMAP fault 14), and the
reference's int8 gradient is shown wrong against ``moe_ffn``'s at a
capacity where nothing drops."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_ep import _flatten, _inputs, _unflatten

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(1, 4), (2, 2)]
# the EP gradient against jax.grad: every element within 1e-5 of its
# leaf's largest value (the gradient tests' form, tests/test_torch_train.py)
GRAD_TOL = 1e-5
# the train steps: tests/test_torch_train_steps.py's norms
LOSS_REL = 1e-5
PARAM_STEP = 0.05
STEPS = 3
BATCH, SEQ = 2, 16
NO_DROP = 8.0            # capacity factor at which no pair drops
AUX_WEIGHT = 3.0         # the loss sum(out * ct) + AUX_WEIGHT * aux
FAIL_AT = {7: 1}         # train(): 8 steps, checkpoint at 5, restart there
TRAIN_STEPS = 8
GRAD_LEAVES = ("x", "router", "wi", "wg", "wo", "shared/wi", "shared/wg",
               "shared/wo")


def _name(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _cotangent(x):
    return np.random.default_rng(7).normal(size=x.shape).astype(np.float32)


def _opt_kw():
    return dict(warmup_steps=2, total_steps=10)


def _reference(out_path, params_path):
    """The reference on 4 forced host devices (run as a script): the EP
    gradient on each mesh, the int8 and ``moe_ffn`` gradients where
    nothing drops, and three jitted train steps on each mesh."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.data.synthetic import SyntheticLoader
    from repro.launch.steps import make_train_step
    from repro.models import moe as JM
    from repro.models import sharding as JSH
    from repro.optim import adamw as JA
    assert len(jax.devices()) == 4, jax.devices()

    def make_mesh(shape):
        return jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 ("data", "model"))
    cfg = reduced(get_config("deepseek-v2-236b"))
    p, x, _ = _inputs()
    ct = jnp.asarray(_cotangent(x))
    p = jax.tree_util.tree_map(jnp.asarray, p)
    res = {}

    def grads(fn, c):
        def loss(xx, pp):
            out, aux = fn(xx, pp, c)
            return jnp.sum(out * ct) + AUX_WEIGHT * aux
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), p)
        return {"x": np.asarray(gx), **_flatten(
            jax.tree_util.tree_map(np.asarray, gp))}

    def with_moe(**kw):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **kw))
    for shape in MESHES:
        mesh = make_mesh(shape)

        def ep(xx, pp, c, mesh=mesh):
            return JM.moe_ffn_ep_sharded(xx, pp, c, mesh)
        for key, c in (("ep", cfg), ("nodrop_bf16", with_moe(
                capacity_factor=NO_DROP)), ("nodrop_int8", with_moe(
                capacity_factor=NO_DROP, a2a_dtype="int8"))):
            for leaf, g in grads(ep, c).items():
                res[f"{key}_{_name(shape)}/{leaf}"] = g
    for leaf, g in grads(JM.moe_ffn, with_moe(
            capacity_factor=NO_DROP)).items():
        res[f"moe_ffn/{leaf}"] = g

    params = jax.tree_util.tree_map(
        jnp.asarray, _unflatten(dict(np.load(params_path))))
    opt = JA.OptConfig(**_opt_kw())
    loader = SyntheticLoader(cfg, BATCH, SEQ, seed=0)
    for shape in MESHES:
        mesh = make_mesh(shape)
        with mesh, JSH.use_mesh(mesh):
            step = jax.jit(make_train_step(cfg, opt))
            pp, state = params, JA.init(opt, params)
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in loader.load(i).items()}
                pp, state, m = step(pp, state, batch)
                for key in ("loss", "grad_norm"):
                    res[f"train_{_name(shape)}/{i}/{key}"] = np.asarray(
                        m[key])
                for leaf, v in _flatten(jax.tree_util.tree_map(
                        np.asarray, pp)).items():
                    res[f"train_{_name(shape)}/{i}/p/{leaf}"] = v
    np.savez(out_path, **res)


def _port_grads(M, fn, cfg, x, tp, ct):
    """The gradient of sum(out * ct) + AUX_WEIGHT * aux for x and every
    weight, through ``fn``, as flat numpy arrays."""
    live = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_())
            for k, v in tp.items()}
    xx = x.clone().requires_grad_()
    out, aux = fn(xx, live, cfg)
    loss = (out * ct).sum() + AUX_WEIGHT * aux
    leaves = [xx] + list(M._leaves(live))
    gs = torch.autograd.grad(loss, leaves)
    names = ["x"] + list(_flatten(live))
    return {n: g.numpy() for n, g in zip(names, gs)}


def _rank_main(rank, world, store_path, out_dir, params_path):
    """One gloo rank: the EP gradients, the int8 refusal, three train
    steps on each mesh, and ``train()`` with and without failures."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models import moe as M
    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw as TA
    from repro_torch.runtime.fault_tolerance import ResilientLoop
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg = reduced(get_config("deepseek-v2-236b"))
        p, x, _ = _inputs()
        tp = params_from_jax(p, device="cpu")
        tx, ct = torch.from_numpy(x), torch.from_numpy(_cotangent(x))
        res = {}
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))

            def ep(xx, pp, c, mesh=mesh):
                return M.moe_ffn_ep_sharded(xx, pp, c, mesh)
            for leaf, g in _port_grads(M, ep, cfg, tx, tp, ct).items():
                res[f"ep_{_name(shape)}/{leaf}"] = g
            int8 = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, a2a_dtype="int8"))
            try:
                _port_grads(M, ep, int8, tx, tp, ct)
                res[f"int8_{_name(shape)}"] = np.array("no raise")
            except NotImplementedError as e:
                res[f"int8_{_name(shape)}"] = np.array(str(e))

        params = _unflatten(dict(np.load(params_path)))
        opt = TA.OptConfig(**_opt_kw())
        loader = SyntheticLoader(cfg, BATCH, SEQ, seed=0)
        step = S.make_train_step(cfg, opt)
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            pp = params_from_jax(params, device="cpu")
            state = TA.init(opt, pp)
            with SH.use_mesh(mesh):
                for i in range(STEPS):
                    batch = {k: torch.from_numpy(v)
                             for k, v in loader.load(i).items()}
                    pp, state, m = step(pp, state, batch)
                    for key in ("loss", "grad_norm"):
                        res[f"train_{_name(shape)}/{i}/{key}"] = \
                            m[key].numpy()
            for leaf, v in _flatten({"p": pp, "mu": state["mu"],
                                     "nu": state["nu"]}).items():
                res[f"train_{_name(shape)}/{leaf}"] = v.float().numpy()

        for key, fail in (("free", None), ("fail", FAIL_AT)):
            out = TR.train("deepseek-v2-236b", steps=TRAIN_STEPS,
                           batch=BATCH, seq=SEQ, model_parallel=2,
                           device="cpu", fail_at=fail,
                           ckpt_dir=os.path.join(out_dir, f"ckpt_{key}"))
            res[f"run_{key}/losses"] = np.array(out["losses"])
            res[f"run_{key}/steps"] = np.array(out["steps"])
            for leaf, v in _flatten(out["params"]).items():
                res[f"run_{key}/p/{leaf}"] = v.float().numpy()
        res["mesh"] = np.array(tuple(TR.make_host_mesh(2, device="cpu")
                                     .shape))
        w = torch.zeros(4)
        w[1] = 1e-30 if rank == 3 else 0.0       # rank 3 drifted
        loop = ResilientLoop(lambda st, batch: (st, {}), {"w": w}, loader,
                             os.path.join(out_dir, "ckpt_drift"),
                             ckpt_every=1)
        try:
            loop.run(1)
            res["drift"] = np.array("no raise")
        except RuntimeError as e:
            res["drift"] = np.array(str(e))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [each port rank's results], tmp dir)."""
    import jax

    from repro.configs import get_config, reduced
    from repro.models import transformer as JT
    tmp = tmp_path_factory.mktemp("ep_train")
    cfg = reduced(get_config("deepseek-v2-236b"))
    params = JT.init_params(cfg, jax.random.PRNGKey(0), dtype="float32")
    params_path = str(tmp / "params.npz")
    np.savez(params_path, **_flatten(jax.tree_util.tree_map(np.asarray,
                                                            params)))
    ref_path = str(tmp / "ref.npz")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_JAX_CACHE": "0"}
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_ep_train as t; "
         "t._reference(sys.argv[1], sys.argv[2])", ref_path, params_path],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(4, str(tmp / "store"), str(tmp), params_path),
            nprocs=4, start_method="spawn")
        log, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-3000:]
    want = dict(np.load(ref_path))
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return want, got, tmp


def _assert_grad(got, want, msg):
    tol = GRAD_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_ep_gradient_on_four_gloo_ranks_equals_jax_grad(runs, mesh):
    """x, router, experts and shared expert: the port's autograd through
    ``moe_ffn_ep_sharded`` against ``jax.grad`` through the reference's
    ``shard_map``, pairs dropping, on every rank."""
    want, got, _ = runs
    for rank, res in enumerate(got):
        for leaf in GRAD_LEAVES:
            _assert_grad(res[f"ep_{_name(mesh)}/{leaf}"],
                         want[f"ep_{_name(mesh)}/{leaf}"],
                         f"rank {rank} {leaf}")


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_ep_train_steps_on_four_gloo_ranks_equal_the_reference(runs, mesh):
    """Three ``make_train_step`` steps under the mesh, the MoE block on
    the EP route: loss and grad norm each step within 1e-5 relative, and
    each leaf's params after three steps within 5% of its largest single
    step, as L2 norms (``tests/test_torch_train_steps.py``)."""
    want, got, _ = runs
    n = _name(mesh)
    traj = [{k[len(f"train_{n}/{i}/p/"):]: v for k, v in want.items()
             if k.startswith(f"train_{n}/{i}/p/")} for i in range(STEPS)]
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            w = float(want[f"train_{n}/{i}/{key}"])
            g = float(got[0][f"train_{n}/{i}/{key}"])
            assert abs(g - w) <= LOSS_REL * abs(w), (i, key, g, w)
    for leaf, w in traj[-1].items():
        step = max(np.linalg.norm(b[leaf] - a[leaf])
                   for a, b in zip(traj, traj[1:]))
        g = got[0][f"train_{n}/p/{leaf}"]
        assert np.linalg.norm(g - w) <= PARAM_STEP * step, leaf
    moe = [k for k in traj[-1] if "/moe/" in k]
    assert moe, "no MoE leaf trained"


@pytest.mark.parametrize("mesh", MESHES, ids=_name)
def test_every_rank_ends_bit_identical(runs, mesh):
    """No gradient reduction in the step: the EP route's backward sums
    each rank's part, so every rank's gradients, losses, params and
    moments are rank 0's bit for bit."""
    _, got, _ = runs
    n = _name(mesh)
    keys = [k for k in got[0] if k.startswith((f"ep_{n}/", f"train_{n}/"))]
    assert any("/mu/" in k for k in keys) and any("/p/" in k for k in keys)
    for res in got[1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], got[0][k], err_msg=k)


def test_train_across_ranks_through_failures_equals_failure_free(runs):
    """``train(model_parallel=2)`` on 4 ranks (the (2, 2) mesh, EP in
    every step): a failure at step 7 restarts from the checkpoint of step
    5 on every rank, reruns steps 5 and 6 with their first losses, and
    ends on the failure-free run's params, bit for bit. Only rank 0
    wrote the one checkpoint directory the ranks share."""
    _, got, tmp = runs
    free = got[0]["run_free/losses"]
    assert len(free) == TRAIN_STEPS
    for rank, res in enumerate(got):
        assert tuple(res["mesh"]) == (2, 2)
        assert int(res["run_fail/steps"]) == TRAIN_STEPS
        fail = res["run_fail/losses"]
        np.testing.assert_array_equal(
            fail, np.concatenate([free[:7], free[5:]]), err_msg=str(rank))
        for k in res:
            if k.startswith("run_free/p/"):
                np.testing.assert_array_equal(
                    res["run_fail/p/" + k[len("run_free/p/"):]], res[k],
                    err_msg=f"rank {rank} {k}")
                np.testing.assert_array_equal(res[k], got[0][k])
    for key in ("free", "fail"):
        assert sorted(os.listdir(tmp / f"ckpt_{key}")) == [
            "ckpt_00000005.npz", "ckpt_00000008.npz", "manifest.json"]


def test_a_rank_that_drifted_is_caught_before_the_checkpoint(runs):
    """``ResilientLoop`` on 4 ranks whose states differ in one bit-level
    value on rank 3 raises on every rank before it saves, and writes no
    checkpoint; the ``train()`` runs above passed the same check at each
    of theirs."""
    _, got, tmp = runs
    for rank, res in enumerate(got):
        assert "states differ at step 1" in str(res["drift"]), (
            rank, res["drift"])
    assert not os.path.exists(tmp / "ckpt_drift" / "manifest.json")


def test_reference_int8_ep_gradient_is_wrong_and_the_port_raises(runs):
    """ROADMAP fault 14, pinned as fault 8 is: with no pair dropped, the
    reference's bf16 EP gradient is ``moe_ffn``'s within 1e-5, and its
    int8 one departs from it by more than half its norm on every expert
    leaf (``jnp.round`` passes no gradient); the port refuses int8 under
    autograd on every rank and mesh, naming the fault."""
    want, got, _ = runs
    for mesh in MESHES:
        n = _name(mesh)
        for leaf in GRAD_LEAVES:
            _assert_grad(want[f"nodrop_bf16_{n}/{leaf}"],
                         want[f"moe_ffn/{leaf}"], f"{n} {leaf}")
        for leaf in ("wi", "wg", "wo"):
            ref = want[f"moe_ffn/{leaf}"]
            err = np.linalg.norm(want[f"nodrop_int8_{n}/{leaf}"] - ref)
            assert err > 0.5 * np.linalg.norm(ref), (n, leaf, err)
        for res in got:
            assert "fault 14" in str(res[f"int8_{n}"]), res[f"int8_{n}"]

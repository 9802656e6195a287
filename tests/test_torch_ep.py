"""The port's expert-parallel MoE (``moe_ffn_ep``, ``moe_ffn_ep_sharded``)
against the reference's ``shard_map`` route, on reduced DeepSeek-V2 in f32.

The reference runs in a subprocess with 4 forced host devices (JAX fixes
its device count at first use, and another test in the same worker may
have used it) and writes an npz; the port runs the same numpy-seeded inputs
on 4 ``gloo`` ranks, spawned here, meeting through a ``FileStore`` in the
test's tmp dir. Both at the default ``capacity_factor``, so each shard's
capacity drops pairs, and the port must drop the same ones: output and aux
within 1e-5. The same cases run on the port's shape-only mesh, where one
process holds every shard (the dry run's route)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
# int8 all-to-all: the expert outputs that the return trip quantizes come
# from XLA's and torch's matmuls, which sum in other orders, so a value
# within an ulp of a rounding tie (x.5) can round to the neighbouring int8
# in one package and not the other; that element then differs by one
# quantization step (its row's max / 127, times the pair's routing weight).
# Such elements are allowed, at most 0.1% of them, each within one step of
# the output's largest value; every other element is held to TOL.
INT8_FLIPS = 1e-3


def _assert_close(got, want, a2a, err_msg=""):
    if a2a != "int8":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **TOL)
        return
    diff = np.abs(got - want)
    off = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.mean() <= INT8_FLIPS, (err_msg, int(off.sum()))
    assert diff.max() <= np.abs(want).max() / 127, (err_msg, diff.max())
# (mesh shape, a2a dtype) of the sharded MoE cases; the whole model's
# forward runs on the (1, 4) mesh
CASES = [((1, 4), "bf16"), ((1, 4), "int8"), ((2, 2), "bf16"),
         ((2, 2), "int8")]
FWD_MESH = (1, 4)


def _case_name(mesh, a2a):
    return f"moe_{mesh[0]}x{mesh[1]}_{a2a}"


def _inputs():
    """Reduced deepseek-v2's MoE weights, an activation batch (4, 16, D)
    and a token batch (2, 16), from a numpy seed."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("deepseek-v2-236b"))
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    fs = f * m.num_shared_experts
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.normal(0.0, shape[-2] ** -0.5, shape).astype(np.float32)
    p = {"router": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
         "wo": w(e, f, d),
         "shared": {"wi": w(d, fs), "wg": w(d, fs), "wo": w(fs, d)}}
    x = rng.normal(size=(4, 16, d)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return p, x, tokens


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _reference(out_path, params_path):
    """The reference's EP on 4 forced host devices (run as a script)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.models import moe as JM
    from repro.models import sharding as JSH
    from repro.models import transformer as JT
    assert len(jax.devices()) == 4, jax.devices()

    def make_mesh(shape):            # Auto axes, as ``constrain`` needs
        return jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 ("data", "model"))
    cfg = reduced(get_config("deepseek-v2-236b"))
    p, x, tokens = _inputs()
    res = {}
    for mesh_shape, a2a in CASES:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             a2a_dtype=a2a))
        mesh = make_mesh(mesh_shape)
        fn = jax.jit(lambda xx, pp, c=c, mesh=mesh:
                     JM.moe_ffn_ep_sharded(xx, pp, c, mesh))
        out, aux = fn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
        name = _case_name(mesh_shape, a2a)
        res[name + "/out"], res[name + "/aux"] = np.asarray(out), \
            np.asarray(aux)
    params = {k: np.asarray(v) for k, v in np.load(params_path).items()}
    mesh = make_mesh(FWD_MESH)
    with mesh, JSH.use_mesh(mesh):
        logits, _, aux = jax.jit(lambda pp, tt: JT.forward(
            pp, cfg, {"tokens": tt}))(
            jax.tree_util.tree_map(jnp.asarray, _unflatten(params)),
            jnp.asarray(tokens))
    res["forward/logits"], res["forward/aux"] = np.asarray(logits), \
        np.asarray(aux)
    np.savez(out_path, **res)


def _rank_main(rank, world, store_path, out_dir, params_path):
    """One gloo rank of the port's EP: every case, then the forward."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg = reduced(get_config("deepseek-v2-236b"))
        p, x, tokens = _inputs()
        tp = params_from_jax(p, device="cpu")
        res = {}
        with torch.inference_mode():
            for mesh_shape, a2a in CASES:
                c = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, a2a_dtype=a2a))
                mesh = init_device_mesh("cpu", mesh_shape,
                                        mesh_dim_names=("data", "model"))
                out, aux = M.moe_ffn_ep_sharded(torch.from_numpy(x), tp, c,
                                                mesh)
                name = _case_name(mesh_shape, a2a)
                res[name + "/out"], res[name + "/aux"] = out.numpy(), \
                    aux.numpy()
            params = params_from_jax(_unflatten(dict(np.load(params_path))),
                                     device="cpu")
            mesh = init_device_mesh("cpu", FWD_MESH,
                                    mesh_dim_names=("data", "model"))
            with SH.use_mesh(mesh):
                logits, _, aux = T.forward(
                    params, cfg, {"tokens": torch.from_numpy(tokens)})
            res["forward/logits"], res["forward/aux"] = logits.numpy(), \
                aux.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [each port rank's results]), the reference's
    subprocess running while the port's ranks do."""
    import jax

    from repro.configs import get_config, reduced
    from repro.models import transformer as JT
    tmp = tmp_path_factory.mktemp("ep")
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
        [sys.executable, "-c", "import sys, test_torch_ep as t; "
         "t._reference(sys.argv[1], sys.argv[2])", ref_path, params_path],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(4, str(tmp / "store"), str(tmp), params_path),
            nprocs=4, start_method="spawn")
        log, _ = ref.communicate(timeout=240)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-3000:]
    want = dict(np.load(ref_path))
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return want, got


@pytest.mark.parametrize("mesh,a2a", CASES,
                         ids=[_case_name(*c) for c in CASES])
def test_ep_sharded_on_four_gloo_ranks_equals_the_reference(runs, mesh, a2a):
    want, got = runs
    name = _case_name(mesh, a2a)
    for rank, res in enumerate(got):        # every rank holds the whole
        _assert_close(res[name + "/out"], want[name + "/out"], a2a,
                      f"rank {rank}")
        np.testing.assert_allclose(res[name + "/aux"], want[name + "/aux"],
                                   err_msg=f"rank {rank}", **TOL)


def test_ep_forward_on_four_gloo_ranks_equals_the_reference(runs):
    want, got = runs
    for res in got:
        np.testing.assert_allclose(res["forward/logits"],
                                   want["forward/logits"], **TOL)
        np.testing.assert_allclose(res["forward/aux"], want["forward/aux"],
                                   **TOL)


def test_the_default_capacity_drops_pairs(runs):
    """The cases hold EP's drops: its per-shard capacities drop pairs
    that ``moe_ffn`` keeps, so its output differs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe as M
    want, _ = runs
    cfg = reduced(get_config("deepseek-v2-236b"))
    p, x, _ = _inputs()
    with torch.inference_mode():
        out, _ = M.moe_ffn(torch.from_numpy(x),
                           params_from_jax(p, device="cpu"), cfg)
    assert np.abs(out.numpy() - want["moe_1x4_bf16/out"]).max() > 1e-2


@pytest.mark.parametrize("mesh,a2a", CASES,
                         ids=[_case_name(*c) for c in CASES])
def test_ep_on_the_shape_only_mesh_equals_the_reference(runs, mesh, a2a):
    """Every shard in one process, the all-to-all a transpose: the dry
    run's route gives the reference's numbers too."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe as M
    from repro_torch.models import sharding as SH
    want, _ = runs
    cfg = reduced(get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           a2a_dtype=a2a))
    p, x, _ = _inputs()
    with torch.inference_mode():
        out, aux = M.moe_ffn_ep_sharded(
            torch.from_numpy(x), params_from_jax(p, device="cpu"), cfg,
            SH.ShapeMesh(("data", "model"), mesh))
    name = _case_name(mesh, a2a)
    _assert_close(out.numpy(), want[name + "/out"], a2a)
    np.testing.assert_allclose(aux.numpy(), want[name + "/aux"], **TOL)


def test_quant_rows_bit_for_bit():
    import jax.numpy as jnp

    from repro.models import moe as JM
    from repro_torch.models import moe as M
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0                                  # the 1e-12 floor
    x[1, 1, :4] = [127.5, -127.5, 0.5, 1.5]        # halves round to even
    jq, jsc = JM._quant_rows(jnp.asarray(x))
    tq, tsc = M._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = M._dequant_rows(tq, tsc, dtype).float().numpy()
        want = np.asarray(JM._dequant_rows(jq, jsc, jdt)).astype(np.float32)
        np.testing.assert_array_equal(got, want)


def test_ep_at_world_size_one_equals_moe_ffn():
    """One gloo rank (the card's NCCL case on the CPU): with no pair
    dropped, EP is ``moe_ffn``, forward and gradient (x and every
    weight, within 1e-5 of each leaf's largest value); the int8 exchange
    under autograd raises (ROADMAP fault 14); the send buffers' bytes
    follow the capacity."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import _tree_map as T_map
    cfg = reduced(get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    p, x, _ = _inputs()
    tp, tx = params_from_jax(p, device="cpu"), torch.from_numpy(x)
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, device="cpu")
    try:
        assert mesh.shape == (1, 1)
        with torch.inference_mode():
            want, want_aux = M.moe_ffn(tx, tp, cfg)
            out, aux = M.moe_ffn_ep(tx, tp, cfg,
                                    group=mesh.get_group("model"))
            out2, aux2 = M.moe_ffn_ep_sharded(tx, tp, cfg, mesh)
        for o, a in ((out, aux), (out2, aux2)):
            torch.testing.assert_close(o, want, **TOL)
            torch.testing.assert_close(a, want_aux, **TOL)
        grads = []
        for fn in (lambda xx, pp: M.moe_ffn(xx, pp, cfg),
                   lambda xx, pp: M.moe_ffn_ep(
                       xx, pp, cfg, group=mesh.get_group("model"))):
            xx = tx.clone().requires_grad_()
            pp = T_map(lambda w: w.clone().requires_grad_(), tp)
            o, a = fn(xx, pp)
            leaves = [xx] + list(M._leaves(pp))
            grads.append(torch.autograd.grad(o.square().sum() + 3 * a,
                                             leaves))
        assert len(grads[1]) == 8
        for g, want in zip(*grads[::-1]):
            torch.testing.assert_close(
                g, want, rtol=0, atol=1e-5 * float(want.abs().max()))
        int8 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, a2a_dtype="int8"))
        with pytest.raises(NotImplementedError, match="fault 14"):
            M.moe_ffn_ep(tx.requires_grad_(), tp, int8,
                         group=mesh.get_group("model"))
    finally:
        dist.destroy_process_group()
    tokens = 64
    cap = int(np.ceil(tokens * 2 / 1 * 8.0))
    assert M.ep_send_bytes(cfg, tokens, 1, 4) == 2 * cap * 128 * 4 + cap * 4

"""The port's sharding rules and input specs (``repro_torch.models.sharding``,
``repro_torch.launch.specs``, ``repro_torch.launch.mesh``) against the
reference's, leaf by leaf, for every arch at full width: the reference on
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` stand-ins, the port on
its shape-only mesh over meta tensors. Specs must be equal exactly."""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro.launch import specs as JSP
from repro.models import sharding as JSH
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as TSP
from repro_torch.models import sharding as TSH

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), TSH.ShapeMesh(names, sizes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JSP.params_specs(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TSP.params_specs(tconfigs.get_config(arch))


def _ref_specs(tree):
    """{key path: spec tuple} of a tree of the reference's NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(s.spec) for path, s in flat}


def _port_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree.spec}


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_production_mesh_is_the_references_shape():
    assert TM.make_production_mesh().shape == {"data": 16, "model": 16}
    assert TM.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "resident"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_the_reference(arch, mesh, fsdp):
    jmesh, tmesh = _meshes(mesh)
    want = _ref_specs(JSH.param_shardings(_ref_params(arch), jmesh,
                                          fsdp=fsdp))
    got = _port_specs(TSH.param_shardings(_port_params(arch), tmesh,
                                          fsdp=fsdp))
    assert got == want
    if fsdp and mesh == "pod1":          # the stand-ins themselves
        jshapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                   _ref_specs_leaves(_ref_params(arch)).items()}
        assert _shapes(_port_params(arch)) == jshapes


def _ref_specs_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_batch_and_opt_shardings_equal_the_reference(arch, mesh,
                                                           layout):
    """Decode caches at decode_32k, batches and the decode token at every
    applicable shape, the optimizer's moments and ``moe_group_size``,
    under each layout (which sets the dp axes)."""
    jmesh, tmesh = _meshes(mesh)
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    dec = SHAPES["decode_32k"]
    with JSH.use_mesh(jmesh, layout), TSH.use_mesh(tmesh, layout):
        want = _ref_specs(JSH.cache_shardings(JSP.cache_specs(cfg, dec),
                                              jmesh))
        got = _port_specs(TSH.cache_shardings(TSP.cache_specs(tcfg, dec),
                                              tmesh))
        assert got == want
        for shape in applicable_shapes(cfg):
            want = _ref_specs(JSH.batch_shardings(
                JSP.batch_specs(cfg, shape), jmesh))
            got = _port_specs(TSH.batch_shardings(
                TSP.batch_specs(tcfg, shape), tmesh))
            assert got == want, shape.name
            want = _ref_specs(JSH.batch_shardings(
                JSP.decode_input_specs(cfg, shape), jmesh))
            got = _port_specs(TSH.batch_shardings(
                TSP.decode_input_specs(tcfg, shape), tmesh))
            assert got == want, shape.name
            assert TSP.moe_group_size(tcfg, shape, tmesh) == \
                JSP.moe_group_size(cfg, shape, jmesh), shape.name
    jp = JSH.param_shardings(_ref_params(arch), jmesh)
    tp = TSH.param_shardings(_port_params(arch), tmesh)
    jopt = JSP.default_opt_config(cfg)
    topt = TSP.default_opt_config(tcfg)
    assert topt.moment_dtype == jopt.moment_dtype
    want = _ref_specs(JSP.opt_shardings(
        JSP.opt_specs(cfg, _ref_params(arch), jopt), _ref_params(arch), jp,
        jmesh))
    got = _port_specs(TSP.opt_shardings(
        TSP.opt_specs(tcfg, _port_params(arch), topt), _port_params(arch),
        tp, tmesh))
    assert got == want


def test_input_specs_per_phase_match_the_reference():
    """``input_specs``' argument trees and shardings for one arch of each
    phase's kind, on the 256-way mesh."""
    jmesh, tmesh = _meshes("pod1")
    for arch, shape in (("stablelm-3b", "train_4k"),
                        ("deepseek-v2-236b", "prefill_32k"),
                        ("rwkv6-1.6b", "long_500k")):
        cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
        jargs, jsh = JSP.input_specs(cfg, SHAPES[shape], jmesh)
        targs, tsh = TSP.input_specs(tcfg, SHAPES[shape], tmesh)
        assert len(targs) == len(jargs) == len(tsh) == len(jsh)
        for ja, ta, js, ts in zip(jargs, targs, jsh, tsh):
            if isinstance(js, jax.sharding.NamedSharding):
                assert ts.spec == tuple(js.spec)
                assert tuple(ta.shape) == tuple(ja.shape)
                continue
            assert _port_specs(ts) == _ref_specs(js), (arch, shape)
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in _ref_specs_leaves(ja).items()}
            assert _shapes(ta) == want, (arch, shape)


def test_constrain_returns_the_same_tensor():
    x = torch.randn(4, 8, 16)
    assert TSH.constrain(x, "dp", "model", None) is x
    with TSH.use_mesh(TM.make_production_mesh()):
        assert TSH.constrain(x, "dp", "model", None) is x
    with TSH.use_mesh(TM.make_production_mesh(multi_pod=True), "fsdp"):
        assert TSH.current_layout() == "fsdp"
        assert TSH.constrain(x, "dp", None, "model") is x
    assert TSH.current_mesh() is None and TSH.current_layout() == "2d"


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = TM.make_production_mesh(multi_pod=True)
    sh = TSH.NamedSharding(mesh, TSH.spec(("pod", "data"), None, "model"))
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    assert TSH.NamedSharding(mesh, TSH.spec()).placements() == \
        (Replicate(),) * 3
    assert TSH.spec(("data",), None) == ("data", None)
    leaf = torch.empty(32, 8, 64, dtype=torch.bfloat16, device="meta")
    assert TSH.shard_bytes(leaf, sh) == 32 * 8 * 64 * 2 // (32 * 16)

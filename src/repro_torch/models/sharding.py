"""Logical sharding rules: name-based parameter specs + activation constraints.

PyTorch counterpart of ``repro/models/sharding.py``. The rules read only a
mesh's axis names and sizes, so every function takes either a
``torch.distributed.device_mesh.DeviceMesh`` or a ``ShapeMesh``, the
shape-only mesh the dry run plans on (``launch/mesh.py``). A spec is a
tuple in ``jax.sharding.PartitionSpec``'s form — one entry per dim, each
``None``, an axis name or a tuple of names, a one-name tuple written as the
name — so the port's specs compare one to one with the reference's.
``NamedSharding`` pairs a spec with its mesh, and ``placements`` turns it
into DTensor placements (``Shard(dim)`` / ``Replicate()`` per mesh dim) on
a real ``DeviceMesh``.

The model calls ``constrain(x, *logical_axes)`` where the reference does.
The port's model is replicated on each rank and its tensors are plain, so
``constrain`` returns a plain tensor unchanged; only a ``DTensor`` is
redistributed. With no mesh in context it is a no-op, as in the reference.

The batch half of the reference's partition is explicit: ``dp_block``
says which block of a global batch's rows this rank holds over the mesh's
dp axes (the reference's ``"dp"`` entries), and the train step runs on
that block under ``use_dp_block``. The few statistics that must be global
(the masked cross-entropy's token count, the MoE's expert counts) read
the block from there and exchange them over its process groups.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

_CTX = threading.local()


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis names and sizes and no devices or process group: the
    dry run's production mesh, as the reference's 512 forced host
    devices are."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``ShapeMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, ShapeMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def current_mesh():
    return getattr(_CTX, "mesh", None)


def current_layout() -> str:
    return getattr(_CTX, "layout", "2d")


@contextlib.contextmanager
def use_mesh(mesh, layout: str = "2d"):
    prev = getattr(_CTX, "mesh", None)
    prev_layout = getattr(_CTX, "layout", "2d")
    _CTX.mesh = mesh
    _CTX.layout = layout
    try:
        yield
    finally:
        _CTX.mesh = prev
        _CTX.layout = prev_layout


def axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        return int(np.prod([axis_size(mesh, n) for n in name]))
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh, layout: str = None):
    """Batch axes. 2d: ('pod','data'); fsdp: every mesh axis (pure DP)."""
    layout = layout or current_layout()
    names = ("pod", "data", "model") if layout == "fsdp" else ("pod", "data")
    shape = mesh_shape(mesh)
    return tuple(a for a in names if a in shape)


def _fits(dim: int, mesh, axis) -> bool:
    n = axis_size(mesh, axis)
    return n > 1 and dim % n == 0


@dataclasses.dataclass(frozen=True)
class DpBlock:
    """This rank's block of a global batch: block ``index`` of ``size``
    equal blocks of rows, in row order, the dp axes' coordinates read
    major axis first (as the reference's batch sharding lays them out);
    ``groups``: the process groups of the dp axes of size > 1, major
    first."""
    index: int
    size: int
    groups: tuple

    def rows(self, n: int) -> slice:
        """This block's rows of ``n``."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def sum_(self, t):
        """``t`` summed over the blocks, in place; every rank ends with the
        same values."""
        for g in self.groups:
            dist.all_reduce(t, group=g)
        return t

    def gather(self, t):
        """(size, *t.shape): every block's ``t``, in block order."""
        out = t[None]
        for g in reversed(self.groups):                # minor axis first
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, out.contiguous(), group=g)
            out = torch.cat(parts)
        return out


def dp_block(mesh, batch: int):
    """The ``DpBlock`` this rank holds of a global batch of ``batch`` rows
    on ``mesh``, or None where every rank keeps the whole batch: no mesh,
    a ``ShapeMesh`` (one process holds every shard), or a batch that the
    dp size does not divide (``_fits``, as ``constrain``'s rule: dp size 1
    included)."""
    if mesh is None or isinstance(mesh, ShapeMesh):
        return None
    dp = dp_axes(mesh)
    if not _fits(batch, mesh, dp):
        return None
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in dp:
        index = index * axis_size(mesh, a) + coord[a]
    return DpBlock(index, axis_size(mesh, dp),
                   tuple(mesh.get_group(a) for a in dp
                         if axis_size(mesh, a) > 1))


def current_dp_block():
    """The ``DpBlock`` the running step computes, or None (the whole
    batch)."""
    return getattr(_CTX, "dp_block", None)


@contextlib.contextmanager
def use_dp_block(block):
    """Run the model on ``block`` of the global batch: its losses are this
    rank's shares of the global ones (``transformer.softmax_xent``, the
    MoE's aux), its MoE capacity and drops the global ones
    (``moe._moe_tokens``). None: the whole batch."""
    prev = getattr(_CTX, "dp_block", None)
    _CTX.dp_block = block
    try:
        yield
    finally:
        _CTX.dp_block = prev


def spec(*entries) -> tuple:
    """A spec in ``PartitionSpec``'s normal form: a one-name tuple entry
    is the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(i)`` where tensor
        dim ``i``'s entry names that mesh axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_shape(self.mesh):
            dims = [i for i, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def constrain(x, *axes):
    """axes: one entry per dim; each is None, an axis name, a tuple of axis
    names, or 'dp' (expands to the mesh's batch axes). A ``DTensor`` is
    redistributed to the spec, with each dim sharded only where its axis
    divides it; a plain tensor is returned as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    fsdp = current_layout() == "fsdp"
    entries = []
    for dim, ax in zip(x.shape, axes):
        if ax is None or (fsdp and ax == "model"):
            entries.append(None)           # fsdp layout: no tensor parallel
            continue
        ax = dp_axes(mesh) if ax == "dp" else ax
        entries.append(ax if _fits(dim, mesh, ax) else None)
    return x.redistribute(x.device_mesh,
                          NamedSharding(mesh, spec(*entries)).placements())


# --------------------------------------------------------------------- #
# parameter sharding rules
# --------------------------------------------------------------------- #
# name -> ordered (dim_from_right, axis) preferences; first divisible wins
# per axis. dims are negative indices so stacked leading layer dims are
# transparent.
_RULES = {
    "embed":    [(-2, "model"), (-1, "data")],
    "pos_embed": [(-1, "data")],
    "lm_head":  [(-1, "model"), (-2, "data")],
    "wq":       [(-2, "model"), (-1, "model"), (-3, "data")],
    "wk":       [(-2, "model"), (-1, "model"), (-3, "data")],
    "wv":       [(-2, "model"), (-1, "model"), (-3, "data")],
    "wo":       [(-3, "model"), (-1, "data"), (-2, "model")],   # attn out (H,hd,D)
    "wi":       [(-1, "model"), (-2, "data"), (-3, "model")],   # mlp/moe in
    "wg":       [(-1, "model"), (-2, "data"), (-3, "model")],
    "router":   [(-2, "data")],
    "wq_a":     [(-1, "model"), (-2, "data")],
    "wq_b":     [(-2, "model"), (-3, "data")],
    "wkv_a":    [(-2, "data")],
    "wkv_b":    [(-2, "model"), (-3, "data")],
    "wr":       [(-1, "model"), (-2, "data")],
    "w_in":     [(-1, "model"), (-2, "data")],
    "w_gate":   [(-1, "model"), (-2, "data")],
    "w_a":      [(-1, "model"), (-2, "data")],
    "w_x":      [(-1, "model"), (-2, "data")],
    "w_out":    [(-2, "model"), (-1, "data")],
}
# mlp/cmix "wo"-like (F, D) and rwkv square (D, D) output projections
_RULES_2D_OUT = [(-2, "model"), (-1, "data")]


_COL_2D = [(-1, "model"), (-2, "data")]                        # (D, F) col-parallel
# routed experts: E over 'model' (expert parallelism), D/F over 'data'
_MOE_IN = [(-3, "model"), (-2, "data")]                        # (E, D, F)
_MOE_OUT = [(-3, "model"), (-1, "data")]                       # (E, F, D)


def _spec_for(path_names, shape, mesh, fsdp: bool = True) -> tuple:
    name = path_names[-1]
    rules = _RULES.get(name)
    if "tmix" in path_names:                                   # rwkv square projs
        rules = _RULES_2D_OUT if name == "wo" else _COL_2D
    elif "cmix" in path_names:                                 # rwkv channel mix
        rules = _COL_2D if name == "wk" else _RULES_2D_OUT
    elif "moe" in path_names and "shared" not in path_names:
        if name in ("wi", "wg"):
            rules = _MOE_IN
        elif name == "wo":
            rules = _MOE_OUT
    elif name == "wo" and len(shape) - _n_stack(path_names) == 2:
        rules = _RULES_2D_OUT
    if rules is None:
        return spec()                                          # replicate
    entries = [None] * len(shape)
    used_axes = set()
    for dim, ax in rules:
        if ax == "data" and not fsdp:
            continue                   # resident weights: no FSDP sharding
        idx = len(shape) + dim
        if idx < 0 or idx >= len(shape):
            continue
        if entries[idx] is not None or ax in used_axes:
            continue
        if _fits(shape[idx], mesh, ax):
            entries[idx] = ax
            used_axes.add(ax)
    return spec(*entries)


def _n_stack(path_names) -> int:
    """Number of leading stacked dims (params inside a stacked stage)."""
    return 1 if any(p.startswith("stage") for p in path_names) else 0


def _map_with_path(fn, tree, path=()):
    """``fn(path names, leaf)`` over a tree of dicts, tuples and lists,
    named as the reference's ``_path_names`` names a pytree's keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (f"i{i}",))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def param_shardings(params, mesh, fsdp: bool = True):
    """Tree of ``NamedSharding``s matching ``params`` (tensors, meta ones
    included).

    fsdp=False keeps weights resident (no 'data'-axis sharding) — zero
    per-step weight gathers, the serving layout for small archs."""
    return _map_with_path(
        lambda names, leaf: NamedSharding(
            mesh, _spec_for(names, tuple(leaf.shape), mesh, fsdp)), params)


def cache_shardings(cache, mesh):
    """Decode caches: batch over dp axes, long (seq) dims over 'model'.

    Layout conventions (see attention.py / recurrent.py):
      k/v        (..., B, S, kv, hd) -> B@dp, S@model
      ckv/krope  (..., B, S, r)      -> B@dp, S@model
      state      (..., B, H, N, N)   -> B@dp, H@model
      h          (..., B, W)         -> B@dp, W@model
      conv       (..., B, CW-1, W)   -> B@dp, W@model
      pos        (W,)                -> replicated
      xk/xv      (..., B, Se, kv, hd) -> B@dp
    """
    dp = dp_axes(mesh)

    def assign(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nlead = len(shape)
        entries = [None] * nlead

        def set_if(idx, ax):
            if 0 <= idx < nlead and entries[idx] is None and \
                    _fits(shape[idx], mesh, ax):
                entries[idx] = ax
        if name in ("k", "v"):
            set_if(nlead - 4, dp)
            set_if(nlead - 3, "model")
        elif name in ("ckv", "krope"):
            set_if(nlead - 3, dp)
            set_if(nlead - 2, "model")
        elif name in ("xk", "xv"):
            set_if(nlead - 4, dp)
        elif name == "state":
            set_if(nlead - 4, dp)
            set_if(nlead - 3, "model")
        elif name in ("h", "x_last_t", "x_last_c"):
            set_if(nlead - 2, dp)
            set_if(nlead - 1, "model")
        elif name == "conv":
            set_if(nlead - 3, dp)
            set_if(nlead - 1, "model")
        return NamedSharding(mesh, spec(*entries))
    return _map_with_path(assign, cache)


def batch_shardings(batch, mesh):
    """Inputs: first dim over dp axes (when divisible)."""
    dp = dp_axes(mesh)

    def assign(_, leaf):
        entries = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and _fits(leaf.shape[0], mesh, dp):
            entries[0] = dp
        return NamedSharding(mesh, spec(*entries))
    return _map_with_path(assign, batch)


def shard_bytes(leaf, sharding: NamedSharding) -> int:
    """Bytes of ``leaf``'s shard on one device under ``sharding``."""
    n = 1
    for e in sharding.spec:
        if e is not None:
            n *= axis_size(sharding.mesh, e)
    return leaf.numel() * leaf.element_size() // n

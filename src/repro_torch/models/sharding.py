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

The reference's partition of a train step is explicit here. A
``TokenBlock`` says which block of a global batch this rank computes: its
rows over the mesh's dp axes (the reference's ``"dp"`` entries) and, in
the ``2d`` layout where ``model`` divides S, its sequence block over
``model`` (the residual stream's ``("dp", "model", None)``). The train step
runs on that block under ``use_dp_block``. The few statistics that must be
global (the masked cross-entropy's token count, the MoE's expert counts)
read the block from there and exchange them over its process groups; the
mixers exchange tokens over ``model`` through the block's autograd
collectives (``gather_seq``, ``scatter_seq``, ``seq_to_heads``,
``heads_to_seq``, ``halo``), so attention and the scans run on this rank's
heads or channels over the whole sequence.

Serving splits the same way (``launch/steps.py``'s prefill and decode
steps). Each rank holds only its shard of the decode caches, laid out by
``cache_shardings`` (``CacheBlock``, ``cache_block``, ``use_cache_block``):
a prefill runs on the token block and writes the cache rows, heads or
channels of this rank's shard; a decode step runs this rank's dp rows
over the whole residual stream (one token is not split over the
sequence) and reads its cache shard, attention over an S-split cache
combining the ranks' partial softmaxes over ``model``. The collectives
there run outside autograd, under ``inference_mode``.

Every rank differentiates its own share of the global loss, so the
gradient of a tensor that several ranks hold is the sum of their parts,
and the train step sums the parameters' parts over the whole block grid
once. Each collective's backward is its transpose under that rule: a
gather's is a reduce-scatter, a reduce-scatter's a gather, an all-to-all's
the inverse all-to-all.
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
class TokenBlock:
    """This rank's block of a global batch: rows block ``index`` of
    ``size`` equal blocks, the dp axes' coordinates read major axis first
    (as the reference's batch sharding lays them out), ``groups`` the
    process groups of the dp axes of size > 1, major first; and sequence
    block ``seq_index`` of ``seq_size`` over ``seq_group`` (the ``model``
    axis's group, None where the sequence stays whole). Blocks are
    numbered dp-major, sequence-minor (``flat_index``), as ``model`` is
    the mesh's last axis."""
    index: int
    size: int
    groups: tuple
    seq_index: int = 0
    seq_size: int = 1
    seq_group: object = None

    @property
    def n_blocks(self) -> int:
        return self.size * self.seq_size

    @property
    def flat_index(self) -> int:
        return self.index * self.seq_size + self.seq_index

    def _all_groups(self) -> tuple:
        return self.groups + ((self.seq_group,) if self.seq_group is not None
                              else ())

    def rows(self, n: int) -> slice:
        """This block's rows of ``n``."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def sum_(self, t):
        """``t`` summed over the blocks, in place; every rank ends with the
        same values."""
        for g in self._all_groups():
            dist.all_reduce(t, group=g)
        return t

    def gather(self, t):
        """(n_blocks, *t.shape): every block's ``t``, in block order."""
        out = t[None]
        for g in reversed(self._all_groups()):         # minor axis first
            out = _all_gather(out, g, 0)
        return out

    def share(self, n: int):
        """This rank's 1/m of ``n`` positions, heads or channels over
        ``model``, a slice, or None where m does not divide ``n`` (every
        rank then computes all of them)."""
        if n % self.seq_size:
            return None
        per = n // self.seq_size
        return slice(self.seq_index * per, (self.seq_index + 1) * per)

    def gather_seq(self, t, dim: int = 1):
        """The whole sequence of ``t`` (this block's along ``dim``), in
        block order; its backward sums the ranks' gradients and keeps this
        block's (a reduce-scatter)."""
        return _SeqGather.apply(t, self.seq_group, dim)

    def scatter_seq(self, t, dim: int = 1):
        """This block of the sum over ``model`` of ``t`` (a whole sequence
        along ``dim``, each rank's partial sum); its backward gathers."""
        return _SeqScatter.apply(t, self.seq_group, dim)

    def seq_to_heads(self, t, dim: int = 2):
        """(B, S/m, H, ...) -> (B, S, H/m, ...): the whole sequence of this
        rank's block of ``dim`` (heads or channels), by an all-to-all."""
        return _AllToAll.apply(t, self.seq_group, dim, 1)

    def heads_to_seq(self, t, dim: int = 2):
        """``seq_to_heads``'s inverse: (B, S, H/m, ...) -> (B, S/m, H,
        ...)."""
        return _AllToAll.apply(t, self.seq_group, 1, dim)

    def halo(self, t, rows: int, initial=None):
        """The ``rows`` positions of the global sequence before this block
        of ``t`` (B, S/m, ...), ``initial`` (B, rows, ...) before the first
        block (zeros if None): every block's last rows gathered, so every
        rank's graph holds the same collectives."""
        r = min(rows, t.shape[1])
        tails = self.gather_seq(t[:, -r:])
        first = (t.new_zeros((t.shape[0], rows) + t.shape[2:])
                 if initial is None else initial.to(t.dtype))
        prev = torch.cat([first, tails], dim=1)
        end = rows + self.seq_index * r
        return prev[:, end - rows:end]

    def gather_plain(self, t, dim: int = 1):
        """``gather_seq`` of a tensor that carries no gradient."""
        return _all_gather(t, self.seq_group, dim)

    def from_last(self, t):
        """The last sequence block's ``t``, on every rank of ``model``."""
        return _all_gather(t[None], self.seq_group, 0)[-1]


def _all_gather(t, group, dim):
    """``t``'s blocks from every rank of ``group``, joined along ``dim`` in
    rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def _reduce_scatter(t, group, dim):
    """This rank's block along ``dim`` of ``t`` summed over ``group``."""
    parts = [c.contiguous() for c in t.chunk(dist.get_world_size(group),
                                             dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_to_all(t, group, split: int, join: int):
    """Block j of ``t`` along ``split`` to rank j; the blocks received,
    joined along ``join`` in rank order."""
    n = dist.get_world_size(group)
    src = torch.stack(t.chunk(n, split)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), join)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split, join):
        ctx.group, ctx.split, ctx.join = group, split, join
        return _all_to_all(t, group, split, join)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.join, ctx.split), None, None,
                None)


def _coordinates(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def dp_block(mesh, batch: int):
    """The ``TokenBlock`` of rows this rank holds of a global batch of
    ``batch`` rows on ``mesh`` (its whole sequence), or None where every
    rank keeps every row: no mesh, a ``ShapeMesh`` (one process holds
    every shard), or a batch that the dp size does not divide (``_fits``,
    as ``constrain``'s rule: dp size 1 included)."""
    if mesh is None or isinstance(mesh, ShapeMesh):
        return None
    dp = dp_axes(mesh)
    if not _fits(batch, mesh, dp):
        return None
    coord = _coordinates(mesh)
    index = 0
    for a in dp:
        index = index * axis_size(mesh, a) + coord[a]
    return TokenBlock(index, axis_size(mesh, dp),
                      tuple(mesh.get_group(a) for a in dp
                            if axis_size(mesh, a) > 1))


def token_block(mesh, batch: int, seq: int):
    """The ``TokenBlock`` this rank computes of a global batch of (batch,
    seq) tokens: ``dp_block``'s rows and, in the ``2d`` layout where
    ``model`` divides ``seq`` (``_fits``), its sequence block over
    ``model``; None where every rank computes the whole batch."""
    rows = dp_block(mesh, batch)
    if rows is None and (mesh is None or isinstance(mesh, ShapeMesh)):
        return None
    if current_layout() != "2d" or not _fits(seq, mesh, "model"):
        return rows
    if mesh.mesh_dim_names[-1] != "model":
        raise ValueError(f"'model' must be the mesh's last axis: "
                         f"{mesh.mesh_dim_names}")
    rows = rows or TokenBlock(0, 1, ())
    return dataclasses.replace(rows, seq_index=_coordinates(mesh)["model"],
                               seq_size=axis_size(mesh, "model"),
                               seq_group=mesh.get_group("model"))


@dataclasses.dataclass(frozen=True)
class CacheBlock:
    """This rank's shard of the decode caches over ``model``: coordinate
    ``index`` of ``size``, ``group`` the axis's process group, for caches
    of ``max_len`` rows. ``cache_shardings`` splits a leaf's S rows, heads
    or width over ``model`` where ``size`` divides them (``share``) and
    leaves it whole where it does not; the rows over the dp axes follow
    ``dp_block``."""
    index: int
    size: int
    group: object
    max_len: int

    def share(self, n: int):
        """This rank's slice of ``n`` rows, heads or channels of a cache
        leaf, or None where ``size`` does not divide ``n`` (the leaf is
        whole on every rank)."""
        if n % self.size:
            return None
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def gather(self, t, dim: int):
        """The whole of ``t``, this rank's block along ``dim``."""
        return _all_gather(t, self.group, dim)

    def to_owners(self, t, owner):
        """Every head of the rows this rank owns, by one all-to-all: ``t``
        (B, R, h, ...) holds this rank's block of the H = h·size heads of R
        rows, ``owner`` (R,) the rank that owns each row, non-decreasing;
        -> (B, R_own, H, ...), this rank's rows in order."""
        counts = torch.bincount(owner, minlength=self.size).tolist()
        mine = counts[self.index]
        src = t.movedim(1, 0).contiguous()             # (R, B, h, ...)
        out = src.new_empty((mine * self.size,) + src.shape[1:])
        dist.all_to_all_single(out, src, [mine] * self.size, counts,
                               group=self.group)
        # (size, R_own, B, h, ...): the senders' heads, in rank order
        out = out.unflatten(0, (self.size, mine)).movedim(0, 2)
        return out.flatten(2, 3).movedim(0, 1)


def cache_block(mesh, max_len: int):
    """The ``CacheBlock`` of this rank for caches of ``max_len`` rows on
    ``mesh``, or None where every rank holds the whole caches over
    ``model``: no mesh, a ``ShapeMesh`` (the dry run holds every shard),
    or a ``model`` axis of size 1. The serving steps run the model under
    it (``use_cache_block``) and ``transformer.init_decode_caches``
    allocates only its shard of each leaf."""
    if mesh is None or isinstance(mesh, ShapeMesh) or \
            axis_size(mesh, "model") == 1:
        return None
    if current_layout() != "2d":
        raise ValueError(f"serving splits the caches over 'model' in the "
                         f"2d layout only, not {current_layout()!r}")
    if mesh.mesh_dim_names[-1] != "model":
        raise ValueError(f"'model' must be the mesh's last axis: "
                         f"{mesh.mesh_dim_names}")
    if max_len is None:
        raise ValueError("a serving step on a 'model' axis of size "
                         f"{axis_size(mesh, 'model')} needs the caches' "
                         "global max_len")
    return CacheBlock(_coordinates(mesh)["model"], axis_size(mesh, "model"),
                      mesh.get_group("model"), max_len)


def current_cache_block():
    """The ``CacheBlock`` the running serving step holds, or None (whole
    caches)."""
    return getattr(_CTX, "cache_block", None)


@contextlib.contextmanager
def use_cache_block(block):
    """Run the model on caches of which this rank holds ``block``: a
    mixer given a cache writes only the rows, heads or channels its shard
    holds, and decode attention over an S-split cache combines the ranks'
    partial softmaxes (``attention.split_k_combine``)."""
    prev = getattr(_CTX, "cache_block", None)
    _CTX.cache_block = block
    try:
        yield
    finally:
        _CTX.cache_block = prev


def local_shape(shape, sharding: "NamedSharding") -> tuple:
    """The shape of one device's shard of a leaf of ``shape``."""
    return tuple(n // axis_size(sharding.mesh, e) if e is not None else n
                 for n, e in zip(shape, sharding.spec))


def current_dp_block():
    """The ``TokenBlock`` the running step computes, or None (the whole
    batch)."""
    return getattr(_CTX, "dp_block", None)


def seq_block():
    """The running step's ``TokenBlock`` where it splits the sequence over
    ``model``, else None."""
    block = current_dp_block()
    if block is None or block.seq_group is None:
        return None
    return block


@contextlib.contextmanager
def use_dp_block(block):
    """Run the model on ``block`` of the global batch: its losses are this
    rank's shares of the global ones (``transformer.softmax_xent``, the
    MoE's aux), its MoE capacity and drops the global ones
    (``moe._moe_tokens``), and a sequence block's mixers exchange tokens
    over ``model``. None: the whole batch."""
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

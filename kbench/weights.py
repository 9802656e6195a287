"""Seeded weights, made on the device in a few large draws.

A model's reference module lists its leaves (``leaves(model)``): each a
path into the nested dict the served model reads, a shape, a dtype and how
to draw it. ``build`` draws every leaf of one dtype and distribution from
one flat buffer, on the device, with one ``torch.Generator`` seeded from
``--seed``, then scales each leaf in place. The same seed on the same
device gives the same weights, so the reference rebuilds them after the
served model is gone.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ALIGN = 128          # elements: every leaf starts 256-byte aligned


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight: ``init`` is ("normal", std), ("uniform", lo, hi) or
    ("row", values), the last a constant row repeated over the leading
    axes."""
    path: tuple
    shape: tuple
    dtype: str
    init: tuple


def seed_value(seed: int) -> int:
    """``--seed`` as the generator takes it: any whole number, folded into
    63 bits."""
    return int(seed) % (1 << 63)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def build(leaves, seed: int, device) -> dict:
    """The nested dict of every leaf, drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_value(seed))
    groups: dict = {}
    for leaf in leaves:
        if leaf.init[0] in ("normal", "uniform"):
            groups.setdefault((leaf.init[0], leaf.dtype), []).append(leaf)
        elif leaf.init[0] != "row":
            raise ValueError(f"{leaf.path}: unknown init {leaf.init[0]!r}")
    tree: dict = {}
    for (kind, dtype), members in sorted(groups.items()):
        sizes = [-(-_numel(m.shape) // ALIGN) * ALIGN for m in members]
        flat = torch.empty(sum(sizes), dtype=DTYPES[dtype], device=device)
        if kind == "normal":
            flat.normal_(generator=gen)
        else:
            flat.uniform_(generator=gen)
        start = 0
        for leaf, size in zip(members, sizes):
            t = flat[start:start + _numel(leaf.shape)].view(leaf.shape)
            if kind == "normal":
                t.mul_(leaf.init[1])
            else:
                lo, hi = leaf.init[1], leaf.init[2]
                t.mul_(hi - lo).add_(lo)
            _put(tree, leaf.path, t)
            start += size
    for leaf in leaves:
        if leaf.init[0] == "row":
            row = torch.tensor(leaf.init[1], dtype=torch.float32,
                               device=device).to(DTYPES[leaf.dtype])
            _put(tree, leaf.path, row.expand(leaf.shape).contiguous())
    return tree


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree

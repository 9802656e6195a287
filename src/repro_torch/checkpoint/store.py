"""Checkpointing: atomic snapshots of a tree of tensors.

PyTorch counterpart of ``repro/checkpoint/store.py``, in its file format, so
a checkpoint written by either package restores in the other: one
``ckpt_%08d.npz`` per snapshot, written to a temporary file and renamed,
plus ``manifest.json``, and the last ``keep`` (3) snapshots kept. Keys are
the reference's key paths: dict keys by name, tuple and list items as
``#i``, joined by ``/`` (the training loop's ``(params, opt_state)`` gives
``#0/stage0/sub0/attn/wq`` and ``#1/mu/...``). npz has no bfloat16, so
bf16 leaves are upcast to f32 on save; restore casts every array to the
template leaf's dtype and puts it on the template leaf's device.
Re-sharding on restore (``shardings=``) is ROADMAP queue 1, item 14.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch


def _items(tree, prefix=()):
    """(key path segments, leaf) in the reference's order: sorted dict
    keys, sequence items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _items(x, prefix + (f"#{i}",))
    else:
        yield prefix, tree


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()                  # npz has no bf16: upcast
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree):
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten(tree)
    fname = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = os.path.join(directory, f".tmp_{step:08d}_{os.getpid()}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, fname)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"latest_step": step, "file": os.path.basename(fname)}, f)
    _gc(directory, keep)
    return fname


def _gc(directory: str, keep: int):
    ckpts = sorted(f for f in os.listdir(directory)
                   if re.match(r"ckpt_\d+\.npz$", f))
    for f in ckpts[:-keep]:
        os.remove(os.path.join(directory, f))


def latest_step(directory: str) -> Optional[int]:
    mf = os.path.join(directory, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["latest_step"]


def _rebuild(template, data, prefix=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, data, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, data, prefix + (f"#{i}",))
                              for i, x in enumerate(template))
    arr = data["/".join(prefix)]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=template.device, dtype=template.dtype)
    if hasattr(template, "dtype") and arr.dtype != template.dtype:
        arr = arr.astype(template.dtype)
    return arr


def restore(directory: str, template, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``template``: each leaf in the
    template leaf's dtype, and a tensor on its device. Returns (tree,
    step)."""
    if shardings is not None:
        raise NotImplementedError("restore onto a mesh (shardings=): ROADMAP "
                                  "queue 1, item 14")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        return _rebuild(template, data), step

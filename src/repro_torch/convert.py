"""Weights of the reference package in the port's layout.

``params_from_jax`` takes the pytree of ``repro.models.transformer.init_params``
(nested dicts of arrays, e.g. after ``jax.tree_util.tree_map(np.asarray,
...)``) and returns the same tree of torch tensors: the port keeps the
reference's stacked layout, so conversion is a tree-map. numpy has no
bfloat16 of its own, so every leaf is upcast to float32 first, as
``repro/checkpoint/store.py`` does, and then cast to the target dtype.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def params_from_jax(tree, dtype=None, device="cpu"):
    """``dtype`` None keeps each leaf's own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    target = dtype if dtype is not None else _TORCH_DTYPES[arr.dtype.name]
    return torch.from_numpy(np.array(arr, np.float32)).to(device=device,
                                                             dtype=target)

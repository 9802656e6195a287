"""AdamW with global-norm clipping, a cosine schedule, a configurable moment
dtype (bf16 moments for the largest MoE configs), and optional int8 gradient
compression with error feedback.

PyTorch counterpart of ``repro/optim/adamw.py``, on the same nested-dict
trees and with the same arithmetic in the same order: the schedule in f32,
the bias corrections from an f32 step, the clip from the global norm, decay
only where a leaf has two or more dims, the update in f32 and cast back to
the parameter's dtype, moments kept in ``moment_dtype``. The state holds
``step`` (a 0-d int32 tensor), ``mu``, ``nu`` and, under
``compress_grads``, the bf16 residual ``err``.

Where the reference returns new trees, ``update`` writes the parameters and
moments in place (and returns them), one piece of each leaf at a time: a
stacked phi3-mini MLP leaf holds 805 M elements, and the reference's
expressions over a whole leaf would hold about eight f32 temporaries of it
(~26 GB). A piece is a run of leading-axis rows of at most ``PIECE``
elements, so the temporaries stay near 1 GB whatever the model.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PIECE = 1 << 25        # elements of one leaf the update holds in f32 at once


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"       # bfloat16 for the giant configs
    compress_grads: bool = False        # int8 + error feedback (DP traffic)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    """The leaves in the reference's order (``tree_leaves``: sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _pieces(t):
    """``t`` as runs of leading-axis rows of at most ``PIECE`` elements
    (views; the whole of ``t`` when it is small or 0-d)."""
    if t.ndim == 0 or t.numel() <= PIECE:
        return (t,)
    rows = max(1, PIECE // (t.numel() // t.shape[0]))
    return t.split(rows, 0)


def schedule(cfg: OptConfig, step):
    """Linear warm-up, then cosine decay to a tenth of ``lr``, in f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(cfg: OptConfig, params):
    mdt = _DTYPES[cfg.moment_dtype]
    some = _leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state = {"step": torch.zeros((), dtype=torch.int32, device=some.device),
             "mu": _map(zeros, params), "nu": _map(zeros, params)}
    if cfg.compress_grads:
        state["err"] = _map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)
    return state


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in f32."""
    total = 0
    for g in _leaves(tree):
        total = total + sum(torch.sum(torch.square(x.float()))
                            for x in _pieces(g))
    return torch.sqrt(total)


def compress_int8(g, err):
    """int8 quantization with error feedback: returns (deq, new_err).

    The quantized tensor is what would cross the data-parallel links (8x
    smaller); the residual is fed back into the next step's gradient."""
    gf = g.float() + err.float()
    scale = torch.clamp(torch.max(torch.abs(gf)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, (gf - deq).to(torch.bfloat16)


@torch.no_grad()
def update(cfg: OptConfig, params, grads, state):
    """One AdamW step. Returns (params, state, metrics); the parameters and
    moments are updated in place."""
    step = state["step"] + 1
    if cfg.compress_grads:
        pairs = _map(compress_int8, grads, state["err"])
        grads = _map(lambda pr: pr[0], pairs)
        state = dict(state, err=_map(lambda pr: pr[1], pairs))
        del pairs
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        decay = bool(cfg.weight_decay) and p.ndim >= 2   # no decay on norms
        for ps, gs, ms, ns in zip(_pieces(p), _pieces(g), _pieces(mu),
                                  _pieces(nu)):
            gf = gs.float() * clip
            mu_n = b1 * ms.float() + (1 - b1) * gf
            nu_n = b2 * ns.float() + (1 - b2) * gf * gf
            mhat = mu_n / bc1
            vhat = nu_n / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * ps.float()
            p_n = ps.float() - lr * delta
            ps.copy_(p_n)
            ms.copy_(mu_n)
            ns.copy_(nu_n)

    _map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"step": step, "mu": state["mu"], "nu": state["nu"]}
    if cfg.compress_grads:
        new_state["err"] = state["err"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

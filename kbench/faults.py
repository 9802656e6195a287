"""Faults planted in the port underneath the timed path, each of which a
sound check must turn into ``correct`` false. The CPU tests plant them
with pytest's ``monkeypatch.setattr``; ``calibrate.py --fault`` plants one
for a whole process on the card, to read it at a cell's own size.

Each fault is a function of ``patch(obj, name, value)``, which replaces
``obj.name`` by ``value``. ``ATTENTION`` names those that break the
attention over a decode cache (D1 on the card): they exist only where a
model keeps such a cache.
"""
from __future__ import annotations

import copy

import torch


def state_unchanged(patch):
    """Every decode step runs on a copy of the caches: the state the step
    leaves is thrown away."""
    from repro_torch.models import transformer as T
    step = T.decode_step

    def frozen(params, cfg, caches, token, t):
        return step(params, cfg, copy.deepcopy(caches), token, t)
    patch(T, "decode_step", frozen)


def half_batch(patch):
    """Only the first half of a batch is run; the rest gets its mean."""
    from repro_torch.models import transformer as T
    forward = T.forward

    def half(params, cfg, batch, **kw):
        keep = max(batch["tokens"].shape[0] // 2, 1)
        if kw.get("caches") is not None:      # (L, B, ...) leaves
            kw["caches"] = T._tree_map(lambda c: c[:, :keep], kw["caches"])
        logits, caches, aux = forward(
            params, cfg, {k: v[:keep] for k, v in batch.items()}, **kw)
        rest = logits.mean(dim=0, keepdim=True).expand(
            batch["tokens"].shape[0] - keep, *logits.shape[1:])
        return torch.cat([logits, rest]), caches, aux
    patch(T, "forward", half)


def answer_altered(patch):
    """A decode step's first row of logits comes out rotated by one."""
    from repro_torch.models import transformer as T
    step = T.decode_step

    def altered(params, cfg, caches, token, t):
        logits, caches = step(params, cfg, caches, token, t)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, caches
    patch(T, "decode_step", altered)


def token_altered(patch):
    """The last token of a prompt's first row (a decode step's one token)
    is read as the next token of the vocabulary."""
    from repro_torch.models import transformer as T
    forward = T.forward

    def altered(params, cfg, batch, **kw):
        tokens = batch["tokens"].clone()
        tokens[0, -1] = (tokens[0, -1] + 1) % cfg.vocab_size
        return forward(params, cfg, dict(batch, tokens=tokens), **kw)
    patch(T, "forward", altered)


def _decode_attention(patch, wrap):
    from repro_torch.kernels import ops
    patch(ops, "decode_attention", wrap(ops.decode_attention))


def attention_zeroed(patch):
    """The decode attention's output is zero (its max and sum kept)."""
    def wrap(attend):
        def zeroed(q, k_cache, v_cache, **kw):
            m, l_sum, o = attend(q, k_cache, v_cache, **kw)
            return m, l_sum, torch.zeros_like(o)
        return zeroed
    _decode_attention(patch, wrap)


def split_dropped(patch):
    """The decode attention leaves out the first half of the valid rows,
    as a split-K kernel that lost its first split would."""
    def wrap(attend):
        def dropped(q, k_cache, v_cache, *, lo=None, hi, **kw):
            lo = max(lo or 0, 0)
            return attend(q, k_cache, v_cache, lo=(lo + hi) // 2, hi=hi,
                          **kw)
        return dropped
    _decode_attention(patch, wrap)


def rows_past_end(patch):
    """The decode attention reads up to 64 rows past the last valid one."""
    def wrap(attend):
        def past(q, k_cache, v_cache, *, hi, offset=0, **kw):
            end = offset + k_cache.shape[1]
            return attend(q, k_cache, v_cache, hi=min(hi + 64, end),
                          offset=offset, **kw)
        return past
    _decode_attention(patch, wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "token_altered": token_altered,
          "attention_zeroed": attention_zeroed,
          "split_dropped": split_dropped, "rows_past_end": rows_past_end}
ATTENTION = ("attention_zeroed", "split_dropped", "rows_past_end")


def plant(name: str) -> None:
    """Plant the fault ``name`` for the rest of the process."""
    FAULTS[name](setattr)

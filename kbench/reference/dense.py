"""Plain float32 reference of a dense decoder block stack: RMSNorm, RoPE
on split halves, grouped-query causal attention, a SwiGLU MLP (Phi-3-mini,
arXiv:2404.14219). Also the layout of its weights, as the served model
reads them, and the FLOPs a slice of it does.

Norms scale by ``1 + scale``; attention scores are scaled by 1/sqrt(hd);
RoPE's frequency i is theta^(-2i/hd), rotating the halves (x1, x2) to
(x1 cos - x2 sin, x1 sin + x2 cos).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from kbench import weights, work
from kbench.reference.common import Precision, rmsnorm
from kbench.weights import Leaf

BLOCK = ("stage0", "sub0")       # every layer is one stacked block


def _dims(m):
    return (m["num_layers"], m["d_model"], m["num_heads"],
            m["num_kv_heads"], m["head_dim"], m["d_ff"], m["vocab_size"])


def leaves(m) -> list:
    """Every weight: embeddings and head N(0, 0.02) and fan-in scaled,
    projections N(0, 1/fan_in), the two output projections a layer scaled
    by 1/sqrt(2L) more, norm scales N(0, 0.1)."""
    n_l, d, h, kv, hd, f, v = _dims(m)
    dt = m["dtype"]
    out_scale = 1.0 / math.sqrt(2 * n_l)

    def normal(path, shape, std, dtype=dt):
        return Leaf(path, tuple(shape), dtype, ("normal", std))
    return [
        normal(("embed",), (v, d), 0.02),
        normal(BLOCK + ("norm1", "scale"), (n_l, d), 0.1, "float32"),
        normal(BLOCK + ("norm2", "scale"), (n_l, d), 0.1, "float32"),
        normal(BLOCK + ("attn", "wq"), (n_l, d, h, hd), d ** -0.5),
        normal(BLOCK + ("attn", "wk"), (n_l, d, kv, hd), d ** -0.5),
        normal(BLOCK + ("attn", "wv"), (n_l, d, kv, hd), d ** -0.5),
        normal(BLOCK + ("attn", "wo"), (n_l, h, hd, d),
               (h * hd) ** -0.5 * out_scale),
        normal(BLOCK + ("mlp", "wi"), (n_l, d, f), d ** -0.5),
        normal(BLOCK + ("mlp", "wg"), (n_l, d, f), d ** -0.5),
        normal(BLOCK + ("mlp", "wo"), (n_l, f, d), f ** -0.5 * out_scale),
        normal(("final_norm", "scale"), (d,), 0.1, "float32"),
        normal(("lm_head",), (d, v), d ** -0.5),
    ]


def slice_flops(m, phase: str, batch: int, seq: int) -> float:
    """Model FLOPs of one slice: 2 x the non-embedding parameters (the
    lm_head included) a token, plus attention's two products at the
    positions it scores (a causal prompt's pairs, or a decode token's
    t + 1 rows)."""
    n_l, d, h, kv, hd, f, v = _dims(m)
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    tokens = work.slice_tokens(phase, batch, seq)
    dense = 2.0 * (n_l * per_layer + d * v) * tokens
    if phase == "prefill":
        pairs = batch * work.causal_pairs(seq)
    else:
        pairs = batch * (work.decode_position(seq) + 1)
    return dense + n_l * 4.0 * h * hd * pairs


def prepare(tree, m, prec: Precision) -> dict:
    """The weights as the reference reads them: float32 (or the control's
    precision), each projection as a (K, N) matrix."""
    n_l, d, h, kv, hd, f, v = _dims(m)
    blk = tree[BLOCK[0]][BLOCK[1]]
    layers = []
    for i in range(n_l):
        a, mlp = blk["attn"], blk["mlp"]
        layers.append({
            "norm1": blk["norm1"]["scale"][i].float(),
            "norm2": blk["norm2"]["scale"][i].float(),
            "wq": prec.weight(a["wq"][i].reshape(d, h * hd)),
            "wk": prec.weight(a["wk"][i].reshape(d, kv * hd)),
            "wv": prec.weight(a["wv"][i].reshape(d, kv * hd)),
            "wo": prec.weight(a["wo"][i].reshape(h * hd, d)),
            "wi": prec.weight(mlp["wi"][i]),
            "wg": prec.weight(mlp["wg"][i]),
            "wo_mlp": prec.weight(mlp["wo"][i]),
        })
    return {"embed": tree["embed"].float(), "layers": layers,
            "final": tree["final_norm"]["scale"].float(),
            "lm_head": prec.weight(tree["lm_head"])}


def rope(x, positions, theta: float):
    """x (B, S, H, hd) rotated at ``positions`` (S,)."""
    hd = x.shape[-1]
    i = torch.arange(0, hd, 2, dtype=torch.float64, device=x.device)
    freqs = (1.0 / theta ** (i / hd)).float()
    ang = positions.float()[:, None] * freqs                 # (S, hd/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, q_pos, q_block: int = 512):
    """Softmax attention of q (B, Sq, H, hd) at positions ``q_pos`` over
    k, v (B, Sk, kv, hd) at positions 0..Sk-1, keys after the query
    masked; query rows in blocks of ``q_block``."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)         # (B,H,Sk,hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    k_pos = torch.arange(k.shape[2], device=q.device)
    outs = []
    for q0 in range(0, sq, q_block):
        qb = q[:, q0:q0 + q_block].transpose(1, 2)            # (B,H,sq,hd)
        s = qb @ k.transpose(-1, -2) / math.sqrt(hd)
        allowed = k_pos[None, :] <= q_pos[q0:q0 + q_block, None]
        s = s.masked_fill(~allowed, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ v).transpose(1, 2))
    return torch.cat(outs, dim=1)                             # (B,Sq,H,hd)


def _block(x, p, m, prec, positions, kv_fn):
    """One layer on x (B, S, D); ``kv_fn(k, v)`` gives the keys and values
    attended over (the prompt's own, or a cache's)."""
    _, d, h, kv, hd, _, _ = _dims(m)
    b, s, _ = x.shape
    hh = rmsnorm(x, p["norm1"])
    q = prec.mm(hh, p["wq"]).view(b, s, h, hd)
    k = prec.mm(hh, p["wk"]).view(b, s, kv, hd)
    v = prec.mm(hh, p["wv"]).view(b, s, kv, hd)
    q = rope(q, positions, m["rope_theta"])
    k = rope(k, positions, m["rope_theta"])
    keys, values = kv_fn(k, v)
    o = attend(q, keys, values, positions)
    x = x + prec.mm(o.reshape(b, s, h * hd), p["wo"])
    h2 = rmsnorm(x, p["norm2"])
    gated = F.silu(prec.mm(h2, p["wg"])) * prec.mm(h2, p["wi"])
    return x + prec.mm(gated, p["wo_mlp"]), k, v


def prefill(w, m, tokens, prec: Precision):
    """Logits (B, S, V) of a prompt ``tokens`` (B, S) from position 0."""
    x = w["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p in w["layers"]:
        x, _, _ = _block(x, p, m, prec, positions, lambda k, v: (k, v))
    return prec.mm(rmsnorm(x, w["final"]), w["lm_head"])


def _past_seed(seed: int, layer: int, key: str, region: str) -> int:
    code = 4 * layer + 2 * ("k", "v").index(key) \
        + ("before", "after").index(region)
    return (weights.seed_value(seed) + 1_000_003 * (1 + code)) % (1 << 63)


def past_rows(m, past, seed: int, layer: int, key: str, region: str,
              shape, device):
    """The rows set-up writes into layer ``layer``'s ``key`` cache (k or
    v), in the served dtype: ``region`` "before" are the rows of the
    context before t, drawn N(0, ``past[key + "_std"]``); "after" the rows
    after t, N(0, ``past["after_std"]``), which a correct step never reads.
    With no ``past`` both are zeros, as the server's caches start. Drawn
    on ``device`` from the seed, so the reference draws them again."""
    dtype = weights.DTYPES[m["dtype"]]
    if not past:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_past_seed(seed, layer, key, region))
    std = past[f"{key}_std"] if region == "before" else past["after_std"]
    rows = torch.empty(shape, dtype=dtype, device=device)
    return rows.normal_(generator=gen).mul_(std)


def _cache_leaves(caches):
    """The served model's k and v caches, (L, B, S, kv, hd) each."""
    c = caches[BLOCK[0]][BLOCK[1]]
    return {key: c[key] for key in ("k", "v")}


def fill_past(caches, m, t: int, past, seed: int) -> None:
    """Write a context into the served model's decode caches, in place
    (under inference mode, as the server made them): every row but t, as
    ``past_rows`` draws them."""
    with torch.inference_mode():
        for key, cache in _cache_leaves(caches).items():
            if cache.dtype != weights.DTYPES[m["dtype"]]:
                raise ValueError(f"the {key} cache is {cache.dtype}, the "
                                 f"model {m['dtype']}")
            for i, layer in enumerate(cache):            # (B, S, kv, hd)
                b, s, kv, hd = layer.shape
                layer[:, :t] = past_rows(m, past, seed, i, key, "before",
                                         (b, t, kv, hd), layer.device)
                layer[:, t + 1:] = past_rows(m, past, seed, i, key, "after",
                                             (b, s - t - 1, kv, hd),
                                             layer.device)


def decode(w, m, tok, t: int, steps: int, prec: Precision, past=None,
           seed: int = 0):
    """``steps`` decode steps of the tokens ``tok`` (B,) at position t over
    caches whose rows before t hold the context ``past_rows`` draws from
    ``seed`` (zeros with no ``past``): (the last step's logits (B, V), the
    state the steps leave: each layer's cache row t, k and v (L, B, kv,
    hd)).

    Every step writes row t and reads rows 0..t, and rows before t are
    never written, so each step computes the same row and logits as the
    first: one step stands for all of them."""
    if steps < 1:
        raise ValueError("no decode step ran")
    _, d, h, kv, hd, _, _ = _dims(m)
    b = tok.shape[0]
    x = w["embed"][tok][:, None]
    pos = torch.tensor([t], device=tok.device)
    rows_k, rows_v = [], []
    for i, p in enumerate(w["layers"]):
        def with_cache(k, v, i=i):
            before = [past_rows(m, past, seed, i, key, "before",
                                (b, t, kv, hd), k.device).float()
                      for key in ("k", "v")]
            return (torch.cat([before[0], k], dim=1),
                    torch.cat([before[1], v], dim=1))
        x, k, v = _block(x, p, m, prec, pos, with_cache)
        rows_k.append(k[:, 0])
        rows_v.append(v[:, 0])
    logits = prec.mm(rmsnorm(x[:, 0], w["final"]), w["lm_head"])
    return logits, {"k": torch.stack(rows_k), "v": torch.stack(rows_v)}


def program_state(caches, m, t: int, past=None, seed: int = 0):
    """The served model's decode state in ``decode``'s layout, and the
    count of cache elements outside row t that differ from what set-up
    wrote there (``fill_past``; zeros with no ``past``): 0 when no step
    wrote another row."""
    leaves = _cache_leaves(caches)
    changed = 0
    for key, cache in leaves.items():
        for i, layer in enumerate(cache):                # (B, S, kv, hd)
            b, s, kv, hd = layer.shape
            for region, rows in (("before", layer[:, :t]),
                                 ("after", layer[:, t + 1:])):
                want = past_rows(m, past, seed, i, key, region, rows.shape,
                                 layer.device)
                changed += int((rows != want).sum())
    return ({key: c[:, :, t].float() for key, c in leaves.items()},
            {"changed": changed})

"""Plain float32 reference of a DeepSeek-V2 block stack (arXiv:2405.04434)
as DeepSeek-V2-Lite states it: multi-head latent attention (MLA) with a
direct query projection and YaRN RoPE, a dense SwiGLU first layer, then
MoE layers of shared experts plus routed experts chosen by a softmax
router. Also the layout of its weights, as the served model reads them,
and the FLOPs a slice of it does.

A layer on x: h = RMSNorm(x); q = h Wq split into (nope, rope) a head; the
latent c = RMSNorm((h Wkv_a)[:r]) and one shared rope key k_r =
(h Wkv_a)[r:]; the rope parts rotated at each position. K and V are
*expanded* from the latents, [k_nope, v] = c Wkv_b a head, k = [k_nope,
k_r], and attention scores q.k by mscale^2 / sqrt(dn + dr), causally; o
Wo is added to x. Then h2 = RMSNorm(x) and x += the FFN of h2: in the
first layers a SwiGLU MLP, silu(h2 Wg) * (h2 Wi) Wo; after them the shared
experts' SwiGLU plus, for each of the top-k experts e of softmax(h2
Wrouter), p_e times expert e's SwiGLU of h2.

Departures from the published model and code, each also in the
configuration's ``assumed``:

- RoPE rotates split halves (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2
  cos). The published code first de-interleaves the rope columns, a fixed
  permutation of them that random weights do not see.
- Norms scale by ``1 + scale``, as the port's weights are laid out.
- Serving computes no auxiliary loss.

What the plain form makes explicit: K and V are expanded from the latents
(the prompt's and the decode's), never attended in the latent space as
the port's decode does; the router's weights are the raw top-k
probabilities (``norm_topk_prob`` false, ``routed_scaling_factor`` 1); and
every (token, expert) pair is computed, grouped by expert, with no
capacity and nothing dropped. YaRN: rotary pair i of the dr-wide rope
turns at theta^(-2i/dr) times (1 - ramp(i)) + ramp(i) / factor, the ramp
rising linearly from the pair low = floor(c(beta_fast)) to high =
ceil(c(beta_slow)), c(n) = dr ln(original / (2 pi n)) / (2 ln theta); cos
and sin are scaled by mscale(mscale) / mscale(mscale_all_dim), and
mscale(a) = 0.1 a ln(factor) + 1.

A decode step reads the cache's rows before t as ``fill_past`` drew them
from the seed and computes every layer in blocks of ``DECODE_BLOCK``
sequences, so that the expanded K and V of a block fit on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from kbench import weights, work
from kbench.reference.common import Precision, rmsnorm
from kbench.weights import Leaf

DECODE_BLOCK = 8           # sequences a decode step expands K and V for
KEYS = ("ckv", "krope")    # the cache's leaves: latent rows, rope keys
Q_BLOCK = 512              # prompt rows a block of scores


def _dims(m):
    a, e = m["mla"], m["moe"]
    if a["q_lora_rank"]:
        raise ValueError("the reference projects the query directly "
                         "(q_lora_rank 0)")
    return dict(n_l=m["num_layers"], d=m["d_model"], h=m["num_heads"],
                f=m["d_ff"], v=m["vocab_size"], r=a["kv_lora_rank"],
                dn=a["qk_nope_dim"], dr=a["qk_rope_dim"], dv=a["v_head_dim"],
                e=e["num_experts"], k=e["top_k"], fe=e["d_ff_expert"],
                shared=e["num_shared_experts"],
                dense=min(e["first_dense_layers"], m["num_layers"]))


def stages(m) -> list:
    """The served model's stacks, in order: (path, layers, is_moe) — the
    dense first layers, then the MoE layers."""
    n = _dims(m)
    out = []
    if n["dense"]:
        out.append(((f"stage{len(out)}", "sub0"), n["dense"], False))
    if n["n_l"] > n["dense"]:
        out.append(((f"stage{len(out)}", "sub0"), n["n_l"] - n["dense"],
                    True))
    return out


def leaves(m) -> list:
    """Every weight: embeddings N(0, 0.02), projections and the router
    N(0, 1/fan_in) (each layer's two output projections, and each
    expert's, scaled by 1/sqrt(2L) more), norm scales N(0, 0.1)."""
    n = _dims(m)
    d, h, r, dn, dr, dv = n["d"], n["h"], n["r"], n["dn"], n["dr"], n["dv"]
    dt = m["dtype"]
    out_scale = 1.0 / math.sqrt(2 * n["n_l"])

    def normal(path, shape, std, dtype=dt):
        return Leaf(path, tuple(shape), dtype, ("normal", std))
    out = [normal(("embed",), (n["v"], d), 0.02)]
    for path, n_l, moe in stages(m):
        a = path + ("attn",)
        out += [
            normal(path + ("norm1", "scale"), (n_l, d), 0.1, "float32"),
            normal(path + ("norm2", "scale"), (n_l, d), 0.1, "float32"),
            normal(a + ("wq",), (n_l, d, h, dn + dr), d ** -0.5),
            normal(a + ("wkv_a",), (n_l, d, r + dr), d ** -0.5),
            normal(a + ("kv_norm", "scale"), (n_l, r), 0.1, "float32"),
            normal(a + ("wkv_b",), (n_l, r, h, dn + dv), r ** -0.5),
            normal(a + ("wo",), (n_l, h, dv, d),
                   (h * dv) ** -0.5 * out_scale)]
        if moe:
            e, fe, fs = n["e"], n["fe"], n["fe"] * n["shared"]
            p, s = path + ("moe",), path + ("moe", "shared")
            out += [
                normal(p + ("router",), (n_l, d, e), d ** -0.5, "float32"),
                normal(p + ("wi",), (n_l, e, d, fe), d ** -0.5),
                normal(p + ("wg",), (n_l, e, d, fe), d ** -0.5),
                normal(p + ("wo",), (n_l, e, fe, d), fe ** -0.5 * out_scale),
                normal(s + ("wi",), (n_l, d, fs), d ** -0.5),
                normal(s + ("wg",), (n_l, d, fs), d ** -0.5),
                normal(s + ("wo",), (n_l, fs, d), fs ** -0.5 * out_scale)]
        else:
            p, f = path + ("mlp",), n["f"]
            out += [normal(p + ("wi",), (n_l, d, f), d ** -0.5),
                    normal(p + ("wg",), (n_l, d, f), d ** -0.5),
                    normal(p + ("wo",), (n_l, f, d), f ** -0.5 * out_scale)]
    out += [normal(("final_norm", "scale"), (d,), 0.1, "float32"),
            normal(("lm_head",), (d, n["v"]), d ** -0.5)]
    return out


def active_params(m) -> int:
    """The weights a token's forward multiplies by, the lm_head included:
    every layer's attention projections, the dense layers' MLPs, and in a
    MoE layer the router, the shared experts and k routed experts."""
    n = _dims(m)
    d, h = n["d"], n["h"]
    attn = d * h * (n["dn"] + n["dr"]) + d * (n["r"] + n["dr"]) \
        + n["r"] * h * (n["dn"] + n["dv"]) + h * n["dv"] * d
    moe = d * n["e"] + (n["k"] + n["shared"]) * 3 * d * n["fe"]
    return n["n_l"] * attn + n["dense"] * 3 * d * n["f"] \
        + (n["n_l"] - n["dense"]) * moe + d * n["v"]


def slice_flops(m, phase: str, batch: int, seq: int) -> float:
    """Model FLOPs of one slice: 2 x ``active_params`` a token, plus
    attention's two products (q.k over dn + dr, p.v over dv) at the
    positions it scores (a causal prompt's pairs, or a decode token's
    t + 1 rows), as the expanded form computes them."""
    n = _dims(m)
    tokens = work.slice_tokens(phase, batch, seq)
    if phase == "prefill":
        pairs = batch * work.causal_pairs(seq)
    else:
        pairs = batch * (work.decode_position(seq) + 1)
    return 2.0 * active_params(m) * tokens + n["n_l"] * 2.0 * n["h"] \
        * (n["dn"] + n["dr"] + n["dv"]) * pairs


class Prepared:
    """The weights as the reference reads them, a layer at a time: the
    served tree stays in its dtype and each layer is made float32 (or the
    control's precision) when it runs, so no float32 copy of the whole
    model is held."""

    def __init__(self, tree, m, prec: Precision):
        self.tree, self.m, self.prec = tree, m, prec
        self.embed = tree["embed"].float()
        self.final = tree["final_norm"]["scale"].float()
        self.lm_head = prec.weight(tree["lm_head"])

    def layers(self):
        """(the layer's weights, is_moe) for each layer in order."""
        n, wt = _dims(self.m), self.prec.weight
        d, h = n["d"], n["h"]
        for path, n_l, moe in stages(self.m):
            blk = weights.get(self.tree, path)
            for i in range(n_l):
                a = blk["attn"]
                p = {"norm1": blk["norm1"]["scale"][i].float(),
                     "norm2": blk["norm2"]["scale"][i].float(),
                     "wq": wt(a["wq"][i].reshape(d, -1)),
                     "wkv_a": wt(a["wkv_a"][i]),
                     "kv_norm": a["kv_norm"]["scale"][i].float(),
                     "wkv_b": wt(a["wkv_b"][i].reshape(n["r"], -1)),
                     "attn_wo": wt(a["wo"][i].reshape(h * n["dv"], d))}
                if moe:
                    e = blk["moe"]
                    p["router"] = wt(e["router"][i])
                    for key in ("wi", "wg", "wo"):
                        p[key] = [wt(x) for x in e[key][i]]
                        p["shared_" + key] = wt(e["shared"][key][i])
                else:
                    for key in ("wi", "wg", "wo"):
                        p[key] = wt(blk["mlp"][key][i])
                yield p, moe


def prepare(tree, m, prec: Precision) -> Prepared:
    return Prepared(tree, m, prec)


def yarn(m, dim: int):
    """(the rope's frequencies (dim/2,), the gain on cos and sin, the gain
    on the softmax scale) under the model's ``rope_scaling`` (none: plain
    RoPE, gains 1)."""
    theta = m["rope_theta"]
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    freqs = 1.0 / theta ** (i / dim)
    rs = m.get("rope_scaling")
    if not rs:
        return freqs.float(), 1.0, 1.0

    def pair(rotations):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))

    def mscale(a):
        return 0.1 * a * math.log(rs["factor"]) + 1.0 if rs["factor"] > 1 \
            else 1.0
    low = max(math.floor(pair(rs["beta_fast"])), 0)
    high = min(math.ceil(pair(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / max(high - low, 1e-3)).clamp(0.0, 1.0)
    freqs = freqs / rs["factor"] * ramp + freqs * (1.0 - ramp)
    softmax = mscale(rs["mscale_all_dim"]) ** 2 if rs["mscale_all_dim"] \
        else 1.0
    return (freqs.float(),
            mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"]), softmax)


def rope(x, positions, freqs, gain: float):
    """x (B, S, ..., dr) rotated at ``positions`` (S,), split halves."""
    ang = positions.float()[:, None] * freqs.to(x.device)     # (S, dr/2)
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (ang.shape[1],)
    cos = (torch.cos(ang) * gain).view(shape)
    sin = (torch.sin(ang) * gain).view(shape)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _swiglu(x, wi, wg, wo, prec):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def _ffn(x, p, moe: bool, m, prec):
    """The FFN of x (T, D): the dense MLP, or the shared experts plus every
    routed (token, expert) pair, each weighted by its raw probability."""
    if not moe:
        return _swiglu(x, p["wi"], p["wg"], p["wo"], prec)
    out = _swiglu(x, p["shared_wi"], p["shared_wg"], p["shared_wo"], prec)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)    # (T, E)
    top_w, top_i = torch.topk(probs, m["moe"]["top_k"], dim=-1)
    for e in range(len(p["wi"])):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(x[tok], p["wi"][e], p["wg"][e], p["wo"][e], prec)
            out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
    return out


def _project(x, p, m, prec, positions, rot):
    """The query (B, S, H, dn + dr) and the latent row (c (B, S, r), k_r
    (B, S, dr)) of x (B, S, D), the rope parts rotated."""
    n = _dims(m)
    b, s, _ = x.shape
    freqs, gain, _ = rot
    q = prec.mm(x, p["wq"]).view(b, s, n["h"], n["dn"] + n["dr"])
    q = torch.cat([q[..., :n["dn"]],
                   rope(q[..., n["dn"]:], positions, freqs, gain)], dim=-1)
    kv_a = prec.mm(x, p["wkv_a"])
    c = rmsnorm(kv_a[..., :n["r"]], p["kv_norm"])
    k_r = rope(kv_a[..., n["r"]:], positions, freqs, gain)
    return q, c, k_r


def _expand(c, k_r, p, m, prec):
    """K (B, T, H, dn + dr) and V (B, T, H, dv) from the latents c (B, T,
    r) and the shared rope keys k_r (B, T, dr)."""
    n = _dims(m)
    b, t, _ = c.shape
    kv = prec.mm(c, p["wkv_b"]).view(b, t, n["h"], n["dn"] + n["dv"])
    k = torch.cat([kv[..., :n["dn"]], k_r[:, :, None].expand(
        b, t, n["h"], n["dr"])], dim=-1)
    return k, kv[..., n["dn"]:]


def _attend(q, k, v, q_pos, scale: float):
    """Softmax attention of q (B, Sq, H, dqk) at ``q_pos`` over k (B, Sk,
    H, dqk), v (B, Sk, H, dv) at positions 0..Sk-1, later keys masked;
    query rows in blocks of ``Q_BLOCK``."""
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for q0 in range(0, q.shape[1], Q_BLOCK):
        qb = q[:, q0:q0 + Q_BLOCK]
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k) * scale
        allowed = k_pos[None, :] <= q_pos[q0:q0 + Q_BLOCK, None]
        s = s.masked_fill(~allowed, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v))
    return torch.cat(outs, dim=1)


def _out(x, o, p, m, prec, moe):
    """x plus the attention output o (B, S, H, dv) projected, then plus
    the FFN of its norm."""
    b, s = o.shape[:2]
    x = x + prec.mm(o.reshape(b, s, -1), p["attn_wo"])
    h2 = rmsnorm(x, p["norm2"]).reshape(b * s, -1)
    return x + _ffn(h2, p, moe, m, prec).view(b, s, -1)


def prefill(w: Prepared, m, tokens, prec: Precision):
    """Logits (B, S, V) of a prompt ``tokens`` (B, S) from position 0."""
    n = _dims(m)
    rot = yarn(m, n["dr"])
    scale = rot[2] / math.sqrt(n["dn"] + n["dr"])
    x = w.embed[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p, moe in w.layers():
        q, c, k_r = _project(rmsnorm(x, p["norm1"]), p, m, prec, positions,
                             rot)
        k, v = _expand(c, k_r, p, m, prec)
        x = _out(x, _attend(q, k, v, positions, scale), p, m, prec, moe)
    return prec.mm(rmsnorm(x, w.final), w.lm_head)


def _past_seed(seed: int, layer: int, key: str, region: str) -> int:
    code = 4 * layer + 2 * KEYS.index(key) + ("before", "after").index(region)
    return (weights.seed_value(seed) + 1_000_003 * (1 + code)) % (1 << 63)


def past_rows(m, past, seed: int, layer: int, key: str, region: str,
              shape, device):
    """The rows set-up writes into layer ``layer``'s ``key`` cache (ckv or
    krope), in the served dtype: ``region`` "before" are the rows of the
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


def _cache_layers(caches, m):
    """Each layer's (ckv (B, S, r), krope (B, S, dr)) of the served
    model's decode caches, in order."""
    out = []
    for path, n_l, _ in stages(m):
        c = weights.get(caches, path)
        out += [(c["ckv"][i], c["krope"][i]) for i in range(n_l)]
    return out


def fill_past(caches, m, t: int, past, seed: int) -> None:
    """Write a context into the served model's decode caches, in place
    (under inference mode, as the server made them): every row but t, as
    ``past_rows`` draws them."""
    with torch.inference_mode():
        for i, layer in enumerate(_cache_layers(caches, m)):
            for key, cache in zip(KEYS, layer):
                if cache.dtype != weights.DTYPES[m["dtype"]]:
                    raise ValueError(f"the {key} cache is {cache.dtype}, "
                                     f"the model {m['dtype']}")
                b, s, dim = cache.shape
                cache[:, :t] = past_rows(m, past, seed, i, key, "before",
                                         (b, t, dim), cache.device)
                cache[:, t + 1:] = past_rows(m, past, seed, i, key, "after",
                                             (b, s - t - 1, dim),
                                             cache.device)


def decode(w: Prepared, m, tok, t: int, steps: int, prec: Precision,
           past=None, seed: int = 0):
    """``steps`` decode steps of the tokens ``tok`` (B,) at position t over
    caches whose rows before t hold the context ``past_rows`` draws from
    ``seed`` (zeros with no ``past``): (the last step's logits (B, V), the
    state the steps leave: each layer's cache row t, ``ckv`` (L, B, r) and
    ``krope`` (L, B, dr)).

    Every step writes row t and reads rows 0..t, and rows before t are
    never written, so each step computes the same row and logits as the
    first: one step stands for all of them."""
    if steps < 1:
        raise ValueError("no decode step ran")
    n = _dims(m)
    rot = yarn(m, n["dr"])
    scale = rot[2] / math.sqrt(n["dn"] + n["dr"])
    b = tok.shape[0]
    x = w.embed[tok][:, None]
    pos = torch.tensor([t], device=tok.device)
    rows = {key: [] for key in KEYS}
    for i, (p, moe) in enumerate(w.layers()):
        q, c, k_r = _project(rmsnorm(x, p["norm1"]), p, m, prec, pos, rot)
        rows["ckv"].append(c[:, 0])
        rows["krope"].append(k_r[:, 0])
        before = [past_rows(m, past, seed, i, key, "before",
                            (b, t, dim), tok.device)
                  for key, dim in zip(KEYS, (n["r"], n["dr"]))]
        o = []
        for b0 in range(0, b, DECODE_BLOCK):
            blk = slice(b0, b0 + DECODE_BLOCK)
            k, v = _expand(torch.cat([before[0][blk].float(), c[blk]], 1),
                           torch.cat([before[1][blk].float(), k_r[blk]], 1),
                           p, m, prec)
            o.append(_attend(q[blk], k, v, pos, scale))
            del k, v
        x = _out(x, torch.cat(o), p, m, prec, moe)
    logits = prec.mm(rmsnorm(x[:, 0], w.final), w.lm_head)
    return logits, {key: torch.stack(rows[key]) for key in KEYS}


def program_state(caches, m, t: int, past=None, seed: int = 0):
    """The served model's decode state in ``decode``'s layout; no exact
    counts."""
    layers = _cache_layers(caches, m)
    return {key: torch.stack([layer[j][:, t].float() for layer in layers])
            for j, key in enumerate(KEYS)}, {}

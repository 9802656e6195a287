"""Plain float32 reference of a decoder whose attention layers are of two
kinds, sliding-window and full, over sparse experts, as Mellum2-12B-A2.5B
states it (huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct,
config.json): grouped-query attention, a window of ``local_window`` keys on
the layers ``block_pattern`` marks ``local`` and the whole causal context
on those it marks ``attn``, and on every layer a softmax router choosing
``top_k`` routed experts whose probabilities are renormalised to sum to 1.
Also the layout of its weights, as the served model reads them, and the
FLOPs a slice of it does.

A layer on x: h = RMSNorm(x); q = h Wq (H heads), k = h Wk, v = h Wv (kv
heads, each shared by H / kv query heads in order); q and k rotated at
their positions; o = softmax(q.k * gain / sqrt(hd)) v over the keys a
query sees (k <= q, and q - k < W on a window layer); x += o Wo. Then h2 =
RMSNorm(x) and x += sum over the top-k experts e of softmax(h2 Wrouter)
of w_e silu(h2 Wg_e) * (h2 Wi_e) Wo_e, w the top-k probabilities over
their sum.

RoPE rotates split halves, (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).
The window layers rotate at theta^(-2i/hd); the full layers under YaRN
(``rope_scaling``): pair i turns at theta^(-2i/hd) (1 - ramp(i)) +
ramp(i) / factor, the ramp rising linearly from the pair low =
floor(c(beta_fast)) to high = ceil(c(beta_slow)), c(n) = hd ln(original /
(2 pi n)) / (2 ln theta). The published attention_factor a = 0.1 ln
(factor) + 1 multiplies cos and sin of both q and k; over a fully rotated
head that multiplies every score by a^2, which is how it is applied here
(``gain``), so that k is held as the served cache holds it.

Departures from the published model and code, each also in the
configuration's ``assumed``: norms scale by ``1 + scale``, as the port's
weights are laid out, and serving computes no auxiliary loss.

What the plain form makes explicit: every key a query sees is scored, the
window's by its position and not through a ring's slots; and every (token,
expert) pair is computed, grouped by expert, with no capacity and nothing
dropped.

A decode step at position t reads what ``fill_past`` wrote: on a full
layer the rows before t, on a window layer the ring's slots that hold the
positions t - W + 1 .. t - 1, each drawn from the seed again here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from kbench import weights, work
from kbench.reference.common import Precision, rmsnorm
from kbench.reference.mla_moe import rope, yarn
from kbench.weights import Leaf

DECODE_BLOCK = 16          # sequences a decode step attends for at once
KEYS = ("k", "v")          # a cache's leaves
Q_BLOCK = 512              # prompt rows a block of scores
STATE = ("k", "v", "ring_k", "ring_v")   # the decode state's keys


def _dims(m):
    e = m["moe"]
    if e["num_shared_experts"] or e["first_dense_layers"]:
        raise ValueError("the reference's layers are all routed experts, "
                         "with no shared expert and no dense layer")
    pattern = tuple(m["block_pattern"])
    if set(pattern) - {"local", "attn"}:
        raise ValueError(f"block kinds {pattern}: only local and attn")
    return dict(n_l=m["num_layers"], d=m["d_model"], h=m["num_heads"],
                kv=m["num_kv_heads"], hd=m["head_dim"], v=m["vocab_size"],
                w=m["local_window"], e=e["num_experts"], k=e["top_k"],
                fe=e["d_ff_expert"], norm_topk=e["norm_topk_prob"],
                pattern=pattern)


def kinds(m) -> list:
    """Each layer's kind, ``block_pattern`` cycled over the layers."""
    p = _dims(m)["pattern"]
    return [p[i % len(p)] for i in range(m["num_layers"])]


def stages(m) -> list:
    """The served model's stacks, in order: (path, kind, layers), one a
    place of the pattern, which the layers repeat whole; and each layer's
    (path, index) in order."""
    n = _dims(m)
    p = n["pattern"]
    reps, rest = divmod(n["n_l"], len(p))
    if rest or not reps:
        raise ValueError(f"{n['n_l']} layers: the reference takes whole "
                         f"periods of the pattern {p}")
    paths = [("stage0", f"sub{c}") for c in range(len(p))]
    return ([(path, kind, reps) for path, kind in zip(paths, p)],
            [(paths[i % len(p)], i // len(p)) for i in range(n["n_l"])])


def leaves(m) -> list:
    """Every weight: embeddings N(0, 0.02), projections and the router
    N(0, 1/fan_in) (each layer's output projections, the attention's and
    each expert's, scaled by 1/sqrt(2L) more), norm scales N(0, 0.1)."""
    n = _dims(m)
    d, h, kv, hd = n["d"], n["h"], n["kv"], n["hd"]
    e, fe = n["e"], n["fe"]
    dt = m["dtype"]
    out_scale = 1.0 / math.sqrt(2 * n["n_l"])

    def normal(path, shape, std, dtype=dt):
        return Leaf(path, tuple(shape), dtype, ("normal", std))
    out = [normal(("embed",), (n["v"], d), 0.02)]
    for path, _, n_l in stages(m)[0]:
        a, p = path + ("attn",), path + ("moe",)
        out += [
            normal(path + ("norm1", "scale"), (n_l, d), 0.1, "float32"),
            normal(path + ("norm2", "scale"), (n_l, d), 0.1, "float32"),
            normal(a + ("wq",), (n_l, d, h, hd), d ** -0.5),
            normal(a + ("wk",), (n_l, d, kv, hd), d ** -0.5),
            normal(a + ("wv",), (n_l, d, kv, hd), d ** -0.5),
            normal(a + ("wo",), (n_l, h, hd, d), (h * hd) ** -0.5 * out_scale),
            normal(p + ("router",), (n_l, d, e), d ** -0.5, "float32"),
            normal(p + ("wi",), (n_l, e, d, fe), d ** -0.5),
            normal(p + ("wg",), (n_l, e, d, fe), d ** -0.5),
            normal(p + ("wo",), (n_l, e, fe, d), fe ** -0.5 * out_scale)]
    out += [normal(("final_norm", "scale"), (d,), 0.1, "float32"),
            normal(("lm_head",), (d, n["v"]), d ** -0.5)]
    return out


def active_params(m) -> int:
    """The weights a token's forward multiplies by, the lm_head included:
    every layer's attention projections, router and k routed experts."""
    n = _dims(m)
    d, h, kv, hd = n["d"], n["h"], n["kv"], n["hd"]
    layer = 2 * d * h * hd + 2 * d * kv * hd + d * n["e"] \
        + n["k"] * 3 * d * n["fe"]
    return n["n_l"] * layer + d * n["v"]


def window_pairs(s: int, w: int) -> int:
    """(query, key) pairs a causal prompt of ``s`` tokens scores under a
    window of ``w`` keys: sum over q of min(q + 1, w)."""
    if s <= w:
        return work.causal_pairs(s)
    return work.causal_pairs(w) + (s - w) * w


def slice_flops(m, phase: str, batch: int, seq: int) -> float:
    """Model FLOPs of one slice: 2 x ``active_params`` a token, plus
    attention's two products of 2 hd FLOPs a (head, query, key) pair it
    scores: a full layer's causal pairs (a decode token's t + 1 rows), a
    window layer's ``window_pairs`` (a decode token's min(t + 1, W))."""
    n = _dims(m)
    tokens = work.slice_tokens(phase, batch, seq)
    t = work.decode_position(seq)
    pairs = 0
    for kind in kinds(m):
        if phase == "prefill":
            pairs += (work.causal_pairs(seq) if kind == "attn"
                      else window_pairs(seq, n["w"]))
        else:
            pairs += t + 1 if kind == "attn" else min(t + 1, n["w"])
    return 2.0 * active_params(m) * tokens \
        + 4.0 * n["h"] * n["hd"] * batch * pairs


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
        """(the layer's weights, its kind) for each layer in order."""
        n, wt = _dims(self.m), self.prec.weight
        d = n["d"]
        for (path, i), kind in zip(stages(self.m)[1], kinds(self.m)):
            blk = weights.get(self.tree, path)
            a, e = blk["attn"], blk["moe"]
            p = {"norm1": blk["norm1"]["scale"][i].float(),
                 "norm2": blk["norm2"]["scale"][i].float(),
                 "wq": wt(a["wq"][i].reshape(d, -1)),
                 "wk": wt(a["wk"][i].reshape(d, -1)),
                 "wv": wt(a["wv"][i].reshape(d, -1)),
                 "attn_wo": wt(a["wo"][i].reshape(-1, d)),
                 "router": wt(e["router"][i])}
            for key in ("wi", "wg", "wo"):
                p[key] = [wt(x) for x in e[key][i]]
            yield p, kind


def prepare(tree, m, prec: Precision) -> Prepared:
    return Prepared(tree, m, prec)


def rotation(m, kind: str):
    """(frequencies, gain on cos and sin, gain on the softmax scale) of a
    layer of ``kind``: YaRN on the full layers, plain RoPE on the window
    layers."""
    hd = _dims(m)["hd"]
    if kind == "attn":
        return yarn(m, hd)
    return yarn(dict(m, rope_scaling=None), hd)


def _ffn(x, p, m, prec):
    """Every routed (token, expert) pair of x (T, D), weighted by the
    top-k probabilities (renormalised where ``norm_topk_prob``)."""
    n = _dims(m)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)    # (T, E)
    top_w, top_i = torch.topk(probs, n["k"], dim=-1)
    if n["norm_topk"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(n["e"]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            xe = x[tok]
            y = prec.mm(F.silu(prec.mm(xe, p["wg"][e]))
                        * prec.mm(xe, p["wi"][e]), p["wo"][e])
            out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
    return out


def _project(x, p, m, prec, positions, rot):
    """q (B, S, H, hd), k and v (B, S, kv, hd) of x (B, S, D), q and k
    rotated at ``positions`` (S,)."""
    n = _dims(m)
    b, s, _ = x.shape
    freqs, gain, _ = rot
    q = prec.mm(x, p["wq"]).view(b, s, n["h"], n["hd"])
    k = prec.mm(x, p["wk"]).view(b, s, n["kv"], n["hd"])
    v = prec.mm(x, p["wv"]).view(b, s, n["kv"], n["hd"])
    return (rope(q, positions, freqs, gain), rope(k, positions, freqs, gain),
            v)


def _attend(q, k, v, q_pos, k_pos, scale: float, window: int):
    """Softmax attention of q (B, Sq, H, hd) at ``q_pos`` (Sq,) over k, v
    (B, Sk, kv, hd) at ``k_pos`` (Sk,): the keys at or before the query
    and, with ``window`` > 0, less than ``window`` before it. Query head h
    reads kv head h // (H / kv). Query rows in blocks of ``Q_BLOCK``."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    outs = []
    for q0 in range(0, sq, Q_BLOCK):
        qp = q_pos[q0:q0 + Q_BLOCK]
        seen = k_pos <= qp.max()
        if window:
            seen &= k_pos > qp.min() - window
        kb, vb, kp = k[:, seen], v[:, seen], k_pos[seen]
        qb = q[:, q0:q0 + Q_BLOCK].reshape(b, -1, kv, h // kv, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
        allowed = kp[None, :] <= qp[:, None]
        if window:
            allowed &= qp[:, None] - kp[None, :] < window
        s = s.masked_fill(~allowed, float("-inf"))
        o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), vb)
        outs.append(o.reshape(b, -1, h, hd))
    return torch.cat(outs, dim=1)


def _out(x, o, p, m, prec):
    """x plus the attention output o (B, S, H, hd) projected, then plus the
    routed experts of its norm."""
    b, s = o.shape[:2]
    x = x + prec.mm(o.reshape(b, s, -1), p["attn_wo"])
    h2 = rmsnorm(x, p["norm2"]).reshape(b * s, -1)
    return x + _ffn(h2, p, m, prec).view(b, s, -1)


def _scale(m, rot) -> float:
    return rot[2] / math.sqrt(_dims(m)["hd"])


def prefill(w: Prepared, m, tokens, prec: Precision):
    """Logits (B, S, V) of a prompt ``tokens`` (B, S) from position 0."""
    n = _dims(m)
    x = w.embed[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p, kind in w.layers():
        rot = rotation(m, kind)
        q, k, v = _project(rmsnorm(x, p["norm1"]), p, m, prec, positions,
                           rot)
        o = _attend(q, k, v, positions, positions, _scale(m, rot),
                    n["w"] if kind == "local" else 0)
        x = _out(x, o, p, m, prec)
    return prec.mm(rmsnorm(x, w.final), w.lm_head)


def _past_seed(seed: int, layer: int, key: str, region: str) -> int:
    code = 4 * layer + 2 * KEYS.index(key) + ("before", "after").index(region)
    return (weights.seed_value(seed) + 1_000_003 * (1 + code)) % (1 << 63)


def past_rows(m, past, seed: int, layer: int, key: str, region: str,
              shape, device):
    """The rows set-up writes into layer ``layer``'s ``key`` cache (k or
    v), in the served dtype: ``region`` "before" the context, drawn N(0,
    ``past[key + "_std"]``) (a full layer's rows before t, a window layer's
    W slots in slot order); "after" what a correct step never reads, N(0,
    ``past["after_std"]``) (a full layer's rows after t, a window layer's
    slot t mod W before the step writes it). With no ``past`` both are
    zeros, as the server's caches start. Drawn on ``device`` from the
    seed, so the reference draws them again."""
    dtype = weights.DTYPES[m["dtype"]]
    if not past:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_past_seed(seed, layer, key, region))
    std = past[f"{key}_std"] if region == "before" else past["after_std"]
    rows = torch.empty(shape, dtype=dtype, device=device)
    return rows.normal_(generator=gen).mul_(std)


def ring_positions(t: int, w: int, device):
    """The position each of a ring's ``w`` slots holds before the step at
    t writes slot t mod w: slot j the one of (t - w, t) that is j mod w,
    slot t mod w the stale t - w."""
    j = torch.arange(w, device=device)
    return t - ((t - j - 1) % w) - 1


def _cache_layers(caches, m):
    """Each layer's (kind, its cache dict: k, v (B, S, kv, hd), and a
    ring's pos (W,)), in order."""
    out = []
    for (path, i), kind in zip(stages(m)[1], kinds(m)):
        c = weights.get(caches, path)
        out.append((kind, {key: val[i] for key, val in c.items()}))
    return out


def fill_past(caches, m, t: int, past, seed: int) -> None:
    """Write a context into the served model's decode caches, in place
    (under inference mode, as the server made them): a full layer's rows
    but t, a window layer's ring as it stands before the step at t (its
    slots' positions in ``pos``, ``ring_positions``), as ``past_rows``
    draws them."""
    with torch.inference_mode():
        for i, (kind, c) in enumerate(_cache_layers(caches, m)):
            for key in KEYS:
                cache = c[key]
                if cache.dtype != weights.DTYPES[m["dtype"]]:
                    raise ValueError(f"the {key} cache is {cache.dtype}, "
                                     f"the model {m['dtype']}")
                b, s = cache.shape[:2]
                rest = tuple(cache.shape[2:])
                if kind == "attn":
                    cache[:, :t] = past_rows(m, past, seed, i, key, "before",
                                             (b, t) + rest, cache.device)
                    cache[:, t + 1:] = past_rows(
                        m, past, seed, i, key, "after", (b, s - t - 1) + rest,
                        cache.device)
                    continue
                if s != _dims(m)["w"] or t < s:
                    raise ValueError(f"a ring of {s} slots at t = {t}: the "
                                     "context fills a whole window")
                cache.copy_(past_rows(m, past, seed, i, key, "before",
                                      (b, s) + rest, cache.device))
                cache[:, t % s] = past_rows(m, past, seed, i, key, "after",
                                            (b,) + rest, cache.device)
            if kind == "local":
                c["pos"].copy_(ring_positions(t, c["pos"].shape[0],
                                              c["pos"].device))


def decode(w: Prepared, m, tok, t: int, steps: int, prec: Precision,
           past=None, seed: int = 0):
    """``steps`` decode steps of the tokens ``tok`` (B,) at position t over
    the context ``past_rows`` draws from ``seed`` (zeros with no
    ``past``): (the last step's logits (B, V), the state the steps leave:
    each full layer's row t, ``k`` and ``v`` (L_full, B, kv, hd), and each
    window layer's slot t mod W, ``ring_k`` and ``ring_v`` (L_window, B,
    kv, hd)).

    Every step writes row t (slot t mod W) and reads positions up to t, and
    nothing before t is written, so each step computes the same rows and
    logits as the first: one step stands for all of them."""
    if steps < 1:
        raise ValueError("no decode step ran")
    n = _dims(m)
    b, ww = tok.shape[0], n["w"]
    x = w.embed[tok][:, None]
    pos = torch.tensor([t], device=tok.device)
    state = {key: [] for key in STATE}
    for i, (p, kind) in enumerate(w.layers()):
        rot = rotation(m, kind)
        q, k, v = _project(rmsnorm(x, p["norm1"]), p, m, prec, pos, rot)
        ring = "ring_" if kind == "local" else ""
        state[ring + "k"].append(k[:, 0])
        state[ring + "v"].append(v[:, 0])
        rest = (n["kv"], n["hd"])
        if kind == "attn":
            before = [past_rows(m, past, seed, i, key, "before",
                                (b, t) + rest, tok.device) for key in KEYS]
            k_pos = torch.arange(t + 1, device=tok.device)
        else:
            slots = ring_positions(t, ww, tok.device)
            live = slots > t - ww                 # all but slot t mod W
            before = [past_rows(m, past, seed, i, key, "before",
                                (b, ww) + rest, tok.device)[:, live]
                      for key in KEYS]
            k_pos = torch.cat([slots[live], pos])
        o = []
        for b0 in range(0, b, DECODE_BLOCK):
            blk = slice(b0, b0 + DECODE_BLOCK)
            kb = torch.cat([before[0][blk].float(), k[blk]], 1)
            vb = torch.cat([before[1][blk].float(), v[blk]], 1)
            o.append(_attend(q[blk], kb, vb, pos, k_pos, _scale(m, rot),
                             ww if kind == "local" else 0))
            del kb, vb
        x = _out(x, torch.cat(o), p, m, prec)
    logits = prec.mm(rmsnorm(x[:, 0], w.final), w.lm_head)
    return logits, {key: torch.stack(rows) for key, rows in state.items()
                    if rows}


def program_state(caches, m, t: int, past=None, seed: int = 0):
    """The served model's decode state in ``decode``'s layout: each full
    layer's cache row t and each window layer's ring slot t mod W; no
    exact counts."""
    state = {key: [] for key in STATE}
    for kind, c in _cache_layers(caches, m):
        row = t if kind == "attn" else t % c["k"].shape[1]
        ring = "ring_" if kind == "local" else ""
        for key in KEYS:
            state[ring + key].append(c[key][:, row].float())
    return {key: torch.stack(rows) for key, rows in state.items()
            if rows}, {}

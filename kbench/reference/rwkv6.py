"""Plain float32 reference of an RWKV-6 "Finch" block stack (arXiv:
2404.05892): the time mix (token shift with data-dependent interpolation,
data-dependent decay, the WKV recurrence with its bonus u, a LayerNorm over
the heads' output, a SiLU gate) and the squared-ReLU channel mix. Also the
layout of its weights, as the served model reads them, and the FLOPs a
slice of it does.

The WKV recurrence a head, with S (N, N) indexed [key, value]:
out_t = r_t (S + diag(u) k_t v_t^T), then S = diag(exp(w_t)) S + k_t v_t^T.
A prompt runs it in chunks (``wkv_chunked``), exactly; decode one token at
a time (``wkv_step``). Norms scale by ``1 + scale``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from kbench import work
from kbench.reference.common import Precision, layernorm
from kbench.weights import Leaf

BLOCK = ("stage0", "sub0")       # every layer is one stacked block
LORA = 32                        # token-shift mixes' low rank
DECAY_LORA = 64                  # the decay's low rank
CHUNK = 32


def _dims(m):
    n = m["rwkv_head_dim"]
    return (m["num_layers"], m["d_model"], m["d_model"] // n, n, m["d_ff"],
            m["vocab_size"])


def leaves(m) -> list:
    """Every weight: embeddings N(0, 0.02), projections N(0, 1/fan_in)
    (the two output projections a layer scaled by 1/sqrt(2L) more), the
    low-rank mixes' second factors N(0, 0.1), the interpolation
    coefficients U(0, 1), the bonus u N(0, 0.25), norm scales and biases
    N(0, 0.1), and the decay's base -6 + 5 (i / (N - 1))^0.9 over each
    head's channels."""
    n_l, d, h, n, f, v = _dims(m)
    dt = m["dtype"]
    out_scale = 1.0 / math.sqrt(2 * n_l)
    base = [-6.0 + 5.0 * (i / max(n - 1, 1)) ** 0.9 for i in range(n)] * h

    def normal(path, shape, std, dtype=dt):
        return Leaf(path, tuple(shape), dtype, ("normal", std))

    def unit(path, shape):
        return Leaf(path, tuple(shape), "float32", ("uniform", 0.0, 1.0))
    t, c = BLOCK + ("tmix",), BLOCK + ("cmix",)
    out = [normal(("embed",), (v, d), 0.02)]
    for norm in ("norm1", "norm2"):
        for key in ("scale", "bias"):
            out.append(normal(BLOCK + (norm, key), (n_l, d), 0.1, "float32"))
    out += [
        unit(t + ("mu",), (n_l, 5, d)),
        unit(t + ("mu_x",), (n_l, d)),
        normal(t + ("lora_a",), (n_l, 5, d, LORA), d ** -0.5, "float32"),
        normal(t + ("lora_b",), (n_l, 5, LORA, d), 0.1, "float32"),
        Leaf(t + ("w_base",), (n_l, d), "float32", ("row", base)),
        normal(t + ("w_lora_a",), (n_l, d, DECAY_LORA), d ** -0.5,
               "float32"),
        normal(t + ("w_lora_b",), (n_l, DECAY_LORA, d), 0.1, "float32"),
        normal(t + ("wr",), (n_l, d, d), d ** -0.5),
        normal(t + ("wk",), (n_l, d, d), d ** -0.5),
        normal(t + ("wv",), (n_l, d, d), d ** -0.5),
        normal(t + ("wg",), (n_l, d, d), d ** -0.5),
        normal(t + ("wo",), (n_l, d, d), d ** -0.5 * out_scale),
        normal(t + ("u",), (n_l, h, n), 0.5, "float32"),
        normal(t + ("ln_out", "scale"), (n_l, d), 0.1, "float32"),
        normal(t + ("ln_out", "bias"), (n_l, d), 0.1, "float32"),
        unit(c + ("mu_k",), (n_l, d)),
        normal(c + ("wk",), (n_l, d, f), d ** -0.5),
        normal(c + ("wv",), (n_l, f, d), f ** -0.5 * out_scale),
        normal(("final_norm", "scale"), (d,), 0.1, "float32"),
        normal(("final_norm", "bias"), (d,), 0.1, "float32"),
        normal(("lm_head",), (d, v), d ** -0.5),
    ]
    return out


def slice_flops(m, phase: str, batch: int, seq: int) -> float:
    """Model FLOPs of one slice: 2 x the non-embedding parameters (the
    lm_head included) a token, plus the WKV recurrence's products: the
    chunked scan's (``work.wkv6_work``) for a prompt, 4 N^2 a head a
    token (r S and the k v^T update) for decode."""
    n_l, d, h, n, f, v = _dims(m)
    per_layer = 5 * d * d + 5 * 2 * LORA * d + 2 * DECAY_LORA * d \
        + 2 * d * f
    tokens = work.slice_tokens(phase, batch, seq)
    dense = 2.0 * (n_l * per_layer + d * v) * tokens
    if phase == "prefill":
        products, _, _ = work.wkv6_work(batch, seq, h, n, 2)
        return dense + n_l * products
    return dense + n_l * 4.0 * h * n * n * batch


def prepare(tree, m, prec: Precision) -> dict:
    """The weights as the reference reads them: float32 (or the control's
    precision for the products' weights), a dict a layer."""
    n_l = m["num_layers"]
    blk = tree[BLOCK[0]][BLOCK[1]]
    tm, cm = blk["tmix"], blk["cmix"]
    layers = []
    for i in range(n_l):
        layers.append({
            "n1s": blk["norm1"]["scale"][i].float(),
            "n1b": blk["norm1"]["bias"][i].float(),
            "n2s": blk["norm2"]["scale"][i].float(),
            "n2b": blk["norm2"]["bias"][i].float(),
            "mu": tm["mu"][i].float(), "mu_x": tm["mu_x"][i].float(),
            "lora_a": [prec.weight(a) for a in tm["lora_a"][i]],
            "lora_b": [prec.weight(b) for b in tm["lora_b"][i]],
            "w_base": tm["w_base"][i].float(),
            "w_lora_a": prec.weight(tm["w_lora_a"][i]),
            "w_lora_b": prec.weight(tm["w_lora_b"][i]),
            **{k: prec.weight(tm[k][i]) for k in ("wr", "wk", "wv", "wg",
                                                   "wo")},
            "u": tm["u"][i].float(),
            "lns": tm["ln_out"]["scale"][i].float(),
            "lnb": tm["ln_out"]["bias"][i].float(),
            "mu_k": cm["mu_k"][i].float(),
            "cwk": prec.weight(cm["wk"][i]),
            "cwv": prec.weight(cm["wv"][i]),
        })
    return {"embed": tree["embed"].float(), "layers": layers,
            "fs": tree["final_norm"]["scale"].float(),
            "fb": tree["final_norm"]["bias"].float(),
            "lm_head": prec.weight(tree["lm_head"])}


def wkv_step(r, k, v, w_log, u, state):
    """One token a head: r, k, v, w_log (B, H, N), u (H, N), state (B, H,
    N, N). Returns (out (B, H, N), the new state)."""
    kv = k[..., :, None] * v[..., None, :]
    out = (r[..., :, None] * (state + u[..., None] * kv)).sum(dim=-2)
    return out, torch.exp(w_log)[..., None] * state + kv


def wkv_chunked(r, k, v, w_log, u, state, chunk: int = CHUNK):
    """The recurrence over a prompt, r, k, v, w_log (B, S, H, N), in
    chunks: within a chunk, position i sees the state entering the chunk
    decayed by the w_log summed before it, and each earlier position j of
    the chunk decayed by the w_log summed over (j, i); the state leaving
    it is the entering one decayed over the whole chunk plus each k_j v_j^T
    decayed over (j, end]. Every exponent is <= 0. Returns (out (B, S, H,
    N), the final state)."""
    b, s, h, n = r.shape
    idx = torch.arange(chunk, device=r.device)
    before = (idx[None, :] < idx[:, None])                 # [i, j]: j < i
    outs = []
    for c0 in range(0, s, chunk):
        rr, kk, vv, ww = (a[:, c0:c0 + chunk] for a in (r, k, v, w_log))
        cl = rr.shape[1]
        incl = torch.cumsum(ww, dim=1)                     # through i
        excl = incl - ww                                   # before i
        out = torch.einsum("bihn,bhnm->bihm", rr * torch.exp(excl), state)
        expo = excl[:, :, None] - incl[:, None, :]         # (B, i, j, H, N)
        mask = before[:cl, :cl, None, None]
        decay = torch.exp(torch.where(mask, expo, torch.zeros_like(expo)))
        att = (rr[:, :, None] * kk[:, None] * decay).sum(-1)  # (B,i,j,H)
        att = torch.where(mask[..., 0], att, torch.zeros_like(att))
        out = out + torch.einsum("bijh,bjhm->bihm", att, vv)
        bonus = (rr * u * kk).sum(-1, keepdim=True)
        outs.append(out + bonus * vv)
        end = incl[:, -1:]                                 # (B, 1, H, N)
        state = torch.exp(end[:, 0])[..., None] * state + torch.einsum(
            "bjhn,bjhm->bhnm", kk * torch.exp(end - incl), vv)
    return torch.cat(outs, dim=1), state


def _time_mix(x, prev, p, m, prec):
    """The time mix's projections at x (B, S, D), ``prev`` each position's
    previous input: (r, k, v, g, w_log), each (B, S, D)."""
    dx = prev - x
    xx = x + dx * p["mu_x"]
    mix = torch.stack([prec.mm(torch.tanh(prec.mm(xx, a)), bb)
                       for a, bb in zip(p["lora_a"], p["lora_b"])], dim=2)
    mix = mix + p["mu"]                                    # (B, S, 5, D)
    xw, xk, xv, xr, xg = (x + dx * mix[:, :, i] for i in range(5))
    w_raw = p["w_base"] + prec.mm(torch.tanh(prec.mm(xw, p["w_lora_a"])),
                                  p["w_lora_b"])
    return (prec.mm(xr, p["wr"]), prec.mm(xk, p["wk"]), prec.mm(xv, p["wv"]),
            F.silu(prec.mm(xg, p["wg"])), -torch.exp(w_raw))


def _layer(x, p, m, prec, carry, scan):
    """One layer on x (B, S, D) from ``carry`` (state, the time mix's and
    the channel mix's previous input, each None to start from zeros);
    ``scan`` runs the recurrence. Returns (x, the new carry)."""
    _, d, h, n, _, _ = _dims(m)
    b, s, _ = x.shape
    state, last_t, last_c = carry
    hh = layernorm(x, p["n1s"], p["n1b"])
    first = torch.zeros(b, 1, d, device=x.device) if last_t is None \
        else last_t[:, None]
    r, k, v, g, w_log = _time_mix(
        hh, torch.cat([first, hh[:, :-1]], dim=1), p, m, prec)
    if state is None:
        state = torch.zeros(b, h, n, n, device=x.device)
    heads = [a.view(b, s, h, n) for a in (r, k, v, w_log)]
    out, state = scan(*heads, p["u"], state)
    o2 = layernorm(out.reshape(b, s, d), p["lns"], p["lnb"])
    x = x + prec.mm(o2 * g, p["wo"])
    h2 = layernorm(x, p["n2s"], p["n2b"])
    first = torch.zeros(b, 1, d, device=x.device) if last_c is None \
        else last_c[:, None]
    prev = torch.cat([first, h2[:, :-1]], dim=1)
    xk = h2 + (prev - h2) * p["mu_k"]
    x = x + prec.mm(torch.square(F.relu(prec.mm(xk, p["cwk"]))), p["cwv"])
    return x, (state, hh[:, -1], h2[:, -1])


def _one_token(r, k, v, w_log, u, state):
    out, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], w_log[:, 0], u, state)
    return out[:, None], state


def prefill(w, m, tokens, prec: Precision):
    """Logits (B, S, V) of a prompt ``tokens`` (B, S) from a zero state."""
    x = w["embed"][tokens]
    for p in w["layers"]:
        x, _ = _layer(x, p, m, prec, (None, None, None), wkv_chunked)
    return prec.mm(layernorm(x, w["fs"], w["fb"]), w["lm_head"])


def decode(w, m, tok, t: int, steps: int, prec: Precision, past=None,
           seed: int = 0):
    """``steps`` decode steps of the tokens ``tok`` (B,) from zero states
    (no position enters): (the last step's logits (B, V), the state the
    steps leave: ``state`` (L, B, H, N, N), ``x_last_t`` and ``x_last_c``
    (L, B, D)). No context is written into the state (``past``)."""
    if steps < 1:
        raise ValueError("no decode step ran")
    if past:
        raise ValueError("an RWKV6 decode tenant takes no past context")
    carries = [(None, None, None)] * m["num_layers"]
    for _ in range(steps):
        x = w["embed"][tok][:, None]
        for i, p in enumerate(w["layers"]):
            x, carries[i] = _layer(x, p, m, prec, carries[i], _one_token)
    logits = prec.mm(layernorm(x[:, 0], w["fs"], w["fb"]), w["lm_head"])
    return logits, {key: torch.stack([c[j] for c in carries])
                    for j, key in enumerate(("state", "x_last_t",
                                             "x_last_c"))}


def fill_past(caches, m, t: int, past, seed: int) -> None:
    """No context is written: the state starts from zeros, as the server
    makes it."""
    if past:
        raise ValueError("an RWKV6 decode tenant takes no past context")


def program_state(caches, m, t: int, past=None, seed: int = 0):
    """The served model's decode state in ``decode``'s layout; no exact
    counts."""
    c = caches[BLOCK[0]][BLOCK[1]]
    return {key: c[key].float() for key in ("state", "x_last_t",
                                            "x_last_c")}, {}

"""Frozen work counts: the card's peaks, the least time of an operation at
its shapes, and the model FLOPs of a drain.

The counts are taken from the shapes alone, never from the kernel that does
the work, so a later change to a kernel cannot change its own yardstick.
Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates without sparsity.
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str):
    """Least time the card could take: (ms, 'operations' | 'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def k3_work(shape, causal: bool, elt: int = 2):
    """Causal or full attention's (FLOPs, bytes) at (B, H, S, D): two
    products of 2D FLOPs per (query, key) pair it must score (S(S+1)/2
    pairs causal, S^2 full), and q, k, v read and the output written
    once."""
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * d * pairs * b * h, 4 * b * h * s * d * elt


def decode_work(b: int, h: int, kv: int, rows: int, d: int, elt: int,
                q_elt: int = 2):
    """One query token's attention over ``rows`` valid cache rows, as
    (FLOPs, bytes): two products of 2D FLOPs a (query head, row); each
    valid K and V row read once, q read once, the f32 partials (m, l, o)
    written once."""
    return (4.0 * b * h * rows * d,
            2 * b * rows * kv * d * elt + b * h * d * q_elt
            + b * h * (d + 2) * 4)


def wkv6_work(b: int, s: int, h: int, n: int, rkv_bytes: int,
              c: int = 32):
    """The chunked WKV6 scan at (b, s, h, n) with r/k/v of ``rkv_bytes``
    each: (product FLOPs, other FLOPs, bytes). A chunk of c tokens does
    4cn^2 in the inter-chunk product and state update and c^2 n in
    att @ v (products), 2.5 c^2 n in the scores' decays and sums and 10 cn
    in the cumsum, decays and bonus; bytes read r, k, v, w_log, u and the
    state once and write the output and the state once."""
    chunks = math.ceil(s / c) * b * h
    products = (4 * c * n * n + c * c * n) * chunks
    other = (2.5 * c * c * n + 10 * c * n) * chunks
    nbytes = (3 * rkv_bytes + 2 * 4) * b * s * h * n + 4 * h * n \
        + 2 * 4 * b * h * n * n
    return products, other, nbytes


def wkv6_bound_ms(products: float, other: float, nbytes: float):
    """The WKV6 scan's least time: the products on the tensor cores, each
    f32 product as three bf16 products (high and low parts), the rest on
    the CUDA cores in f32, against the bytes. (ms, 'operations' |
    'bytes')."""
    t_ops = 3 * products / PEAK_FLOPS["bfloat16"] + \
        other / PEAK_FLOPS["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal prompt of ``s`` tokens scores."""
    return s * (s + 1) // 2


def slice_tokens(phase: str, batch: int, seq: int) -> int:
    """Tokens one slice serves: a prompt's every position, or one new
    token a sequence."""
    return batch * seq if phase == "prefill" else batch


def decode_position(seq: int) -> int:
    """The position a decode slice writes and attends up to: the server
    decodes at half its cache's length."""
    return seq // 2

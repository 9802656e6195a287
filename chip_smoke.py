#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds the hand-written kernels, holds each against its plain PyTorch
version, drives the port's main paths, and prints what it measured.

  python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each asserting (a failure exits non-zero and prints no result):
  1. device check, ``nvidia-smi`` name, power limit and maximum SM clock,
     the card's SM count beside the H100 model's, parallel nvcc build of
     all eight kernels (the five TPU kernels' ports, D1, decode attention,
     D2, MLA's latent decode attention, and G1, the dropless route's
     grouped expert products) with each instance's registers
     and spills (K3's instances must spill nothing);
  2. each kernel against its plain version on the card, on the CPU tests'
     small grids and at the main paths' shapes, with kernel, plain and
     library times (CUDA events) and the bound from the card's peak rates
     (2a: K3 at D = 96, at StableLM's D = 80 and 160 and at MLA's q.k dim
     192 (DeepSeek's prefill shape, 128 heads) in bf16 and f32, causal and
     full, each timed beside its bound and SDPA, with the profiler naming
     their instances, and the reduced MLA dim 48 on the small grids; then
     bf16 at phase 3e's prefill shapes, D = 128 causal (Qwen2-VL), D = 64
     full at S = 1500 (Whisper's encoder) and causal at 448 (its decoder
     prompt), and D = 48 causal at 128 heads, each against the plain
     version and timed beside its bound and SDPA; 2b: K1 at slice sizes 4
     and 132 and as one launch, each beside its bound at that slice size;
     2c: K2's occupancy, fused, matmul-alone and stream-alone times at the
     C2050 model's run ratio and at the one the H100 model picks for the
     same two kernels, and from one traced launch the share of stream time
     spent beside a matmul CTA on the same SM; 2d: K4 rwkv6_scan, from zero
     and from a given state overwritten in place, at a ragged S, at an extreme
     decay, with bf16 w_log and u and at a padded N, with each pass's
     device time; 2e: K5 rg_lru, f32 and bf16, from zero and from h0, on
     ragged shapes and over several windows, two calls chained through h0
     against one, its clusters' occupancy, and the bytes it moves beside
     its bound; 2h: D1 at the decode shapes; 2i: D2 at dsv2lite-mixed's
     decode shape, the reduced widths, 128 heads, a row block at an offset
     and an empty one, timed at the first beside its bound; 2j: G1 at
     dsv2lite-mixed's prompt, even and skewed counts, timed beside its
     bound and the bucketed route it replaces; 2k: K3's causal window,
     every head dim and the edges, then mellum2-mixed's window layer
     (1, 32, 16384, 128) at W 1024, timed beside its bound and the plain
     route it replaces);
  3. the dense path, with the launch counters set to 0 just before it and
     read just after: the scheduler-to-kernel handoff
     (``balanced_slice_sizes`` drives ``ops.coschedule``),
     ``ops.sliced_matmul`` at its default slice size, and
     ``SharedPodServer(use_reduced=False)`` on the H100 model serving two
     full-width phi3-mini-3.8b tenants (a prefill job and a decode job),
     D1 launched once a layer per decode run, the decode step profiled
     alone (``decode_report``: device time, idle share, D1's share, top
     kernels, peak memory; so in 3b-3e); then the decisions of the H100 and v5e models side by side, the
     spread of drain/serial over alternating passes in this call (serial,
     the drain under each model's decisions), and one drain through the
     port's own ``ServingDaemon``;
  3b. the recurrent path, counted the same way: a second server serving
     full-width rwkv6-1.6b and recurrentgemma-9b tenants (a prefill and a
     decode job each, the two jobs of an arch sharing one set of weights),
     whose prefill steps run K4 and K5 and RecurrentGemma's decode D1 on
     its ring (12 local layers), with the same report;
  3c. StableLM, counted the same way: full-width stablelm-3b (D = 80; a
     prefill and a decode tenant) and stablelm-12b (D = 160; a prefill
     tenant) served on the H100 model, one arch's weights at a time, K3
     launched once a layer per prefill run and D1 once a layer per decode
     run;
  3d. DeepSeek (MLA + MoE), counted the same way: deepseek-v2-236b at full
     width cut to 4 layers (a prefill and a decode tenant),
     deepseek-v3-671b at full width cut to 4 layers (a prefill tenant) and
     deepseek-v2-lite at full width cut to 4 layers (a 1 x 4096 prefill
     tenant), served on the H100 model, one arch's weights at a time, with
     the v5e model's decisions beside the H100 one's; K3 launched once a
     layer per prefill run at D = 192, D1 never and D2 once a layer per
     decode run (the absorbed MLA decode attends in its latent space), G1
     twice a MoE layer per prefill run of the dropless route (V2-Lite's)
     and never on a capacity route;
  3e. Qwen2-VL and Whisper, counted the same way: full-width, uncut
     qwen2-vl-7b (M-RoPE, 256 patch embeddings replacing the prompt's
     prefix; a prefill and a decode tenant) and whisper-small (encoder over
     1500 audio frames, learned positions, cross-attention; a prefill and a
     decode tenant) served by one server on the H100 model, the v5e
     model's decisions beside its; K3 launched 28 times a Qwen2-VL prefill
     run (<128>) and 24 times a Whisper prefill run (<64>, 12 full in the
     encoder and 12 causal in the decoder), never at decode, where D1 runs
     28 times a Qwen2-VL and 24 a Whisper decode run (12 self, 12 over the
     cross cache); each step profiled alone with its peak memory; ``train_loss`` once on each
     arch's prefill batch, finite;
  3f. Mellum2, counted the same way: mellum2-12b-a2.5b at full width cut to
     one period of its pattern (3 window layers and 1 full), a 1 x 16384
     prefill and an 8 x 4096 decode tenant; a prefill step's window layers
     on ``flash_fwd_window_kernel<128>`` (3) and its full layer on
     ``flash_fwd_wgmma_kernel<128>`` (1), by symbol, G1 twice a layer a
     prefill run, D1 once a layer a decode run over the rings and the full
     cache;
  2f. (run after 2e) K3, K4 and K5 through their autograd Functions at the
     training path's shapes (phi3-mini's attention at 4096 tokens,
     rwkv6-1.6b's time mix and recurrentgemma-9b's RG-LRU at 2048): the
     forward is the kernel's output bit for bit in one launch, the backward
     launches no kernel of the port, and every input's gradient is finite
     and equals autograd through an f32 plain version; forward and backward
     timed;
  2g. (run after 2f) the same at a (1, 4) rank's shard shapes of the split
     train step, from strided slices of full-width tensors; then, with no
     Function (serving runs under ``inference_mode``), K3 <96> and K4 at a
     rank's prefill shard shapes, (1, 8, 2048, 96) and (4, 2048, 8, 64),
     against the plain versions, beside their bounds and SDPA's time;
  2h. (run after 2g) D1, decode attention, against its plain version at
     the serving paths' decode shapes (``DECODE_SHAPES``: phi3-mini,
     Qwen2-VL, StableLM-3B/-12B, Whisper's self and cross caches,
     RecurrentGemma's ring after a wrap, a window, a rank's row block,
     one with no valid row, empty splits), bf16 and f32 caches, with
     kernel, plain and SDPA times beside the bound; at phi3's shape its
     memory (no copy of the cache), a strided view read in place, and
     the split and combine kernels' times;
  5. (run after 3e) training, counted the same way: ``make_train_step``
     with the reference's ``OptConfig`` (f32 moments) for 3 steps on one
     repeated batch at full width, under a (1, 1) ``DeviceMesh`` over a
     one-rank NCCL group (the data-parallel path at world size 1), after
     the same steps with no mesh, whose losses and params it equals bit
     for bit (asserted): phi3-mini-3.8b uncut (1 x 4096, K3 64
     launches a step: 32 layers, forward and remat), rwkv6-1.6b uncut
     (1 x 2048, K4 48) and recurrentgemma-9b cut to 3 layers (1 x 2048, K5
     4), one arch's weights at a time; each step's loss finite, every
     gradient leaf present, finite and nonzero, the third loss below the
     first (for rwkv6-1.6b, whose loss rises from its seeded init under the
     reference's arithmetic too, the same steps run again with the plain
     form in place of K4 and the first losses agree); step times, AdamW's time beside its bound, training MFU, peak
     memory and one profiled step's top kernels; then the reduced
     ``train()`` through a failure at step 6 and a restore from the
     checkpoint of step 5 (the first batch's loss falls over training);
  6. (run after 5) the mesh and the expert-parallel MoE, counted the same
     way, on a (1, 1) ``DeviceMesh`` over a one-rank NCCL group made for
     the phase and destroyed after it (the card is one H100, so EP runs at
     world size 1; multi-rank EP is held to the reference on the CPU):
     ``input_specs`` for deepseek-v2-236b cut to 4 layers at prefill_32k
     and decode_32k, with its spec counts and per-device argument bytes;
     its full-width forward over 1 x 16384 tokens under ``use_mesh`` with
     ``moe_group=8192`` and with 0 (drops counted), and over 1 x 4096 with
     ``moe_group=2048`` and with 0 at a capacity factor that drops no pair
     (asserted; the first MoE layer within bf16's 2e-2), the ungrouped one
     run twice to equal logits (``torch.equal``: the MoE combine has no
     atomics), K3 <192> once a layer in each; ``moe_ffn_ep`` and
     ``moe_ffn_ep_sharded`` (NCCL all-to-all, bf16 and int8) at
     DeepSeek-V2's MoE on 2048 tokens against ``moe_ffn``, timed; the
     gradients of x and every weight through ``moe_ffn_ep`` against
     autograd through ``moe_ffn``, each leaf within bf16's 2e-2, int8
     under autograd refused, forward plus backward timed; the params saved
     and restored with ``param_shardings``, bit for bit; three
     ``make_train_step`` steps of reduced DeepSeek-V2 under the mesh and
     with none, their losses, params and moments equal bit for bit;
  7. (run after 6) the three examples of ``repro_torch.examples``
     (quickstart, multi_tenant_serving, fault_tolerant_training) on the
     card in this process, counted the same way, each under the profiler
     with its lines logged and its K1, K3, K4 and D1 launches asserted
     exactly;
  8. (run after 7) serving under the mesh, counted the same way:
     ``make_prefill_step`` and ``make_serve_step`` under a (1, 1)
     ``DeviceMesh`` over a one-rank NCCL group (made for the phase and
     destroyed after it) and with no mesh, at full width: phi3-mini-3.8b,
     rwkv6-1.6b, recurrentgemma-9b uncut and deepseek-v2-236b cut to 4
     layers, each a prefill of 1 x 2048 into a 1 x 4096 cache and 8
     decode steps of 8 rows over an 8 x 4096 cache holding that prompt;
     every logit and cache leaf ``torch.equal`` across the two, K3, K4 or
     K5 once a layer of its kind a prefill and never at decode, D1 exactly
     once an attn or local layer a decode step (none for DeepSeek-V2's
     absorbed decode, which runs D2 once a layer) and no other kernel
     there, the step
     times side by side, and the per-rank cache bytes of a (1, 4)
     ``ShapeMesh`` (``shard_bytes`` of ``cache_shardings``) beside the
     whole cache's;
  4. one JSON line of the kernels, the card line, and the final JSON line.

Predicted CP and makespan are the scheduler's model predictions, labelled
with the model (H100 or v5e); every time printed here is the card's own.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet; dense rates) for the bounds
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16_TOL = dict(atol=2e-2, rtol=2e-2)     # tests/test_kernels.py:17-19
F32_TOL = dict(atol=2e-4, rtol=2e-4)
K4_TOL = {"float32": dict(atol=1e-3, rtol=1e-3),    # tests/test_kernels.py:75-76
          "bfloat16": dict(atol=5e-2, rtol=5e-2)}
K5_TOL = dict(atol=1e-4, rtol=1e-4)                  # tests/test_kernels.py:88-89
# K3 at the main shape, beside the allclose: the error's norm relative to
# the plain version's, over the whole output and over each query row. A late
# row's |out| is small, so a row norm sees a wrong key tile that the
# absolute tolerance would not.
K3_REL_TOL = 1e-2
# K4 at the main shape: kernel and plain version both compute in f32 from
# the same bf16 inputs and differ only in summation order.
K4_REL_TOL = 1e-3
# the __global__ functions of csrc/*.cu, to find them in a profile: the
# tensor-core paths of K1, K2 and K3 (bf16) and their FMA paths (f32), K4's
# two passes, K5's cluster kernel and D1's split and combine kernels
KERNEL_SYMBOLS = ("sliced_matmul_wgmma_kernel", "sliced_matmul_kernel",
                  "coschedule_wgmma_kernel", "coschedule_kernel",
                  "flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                  "wkv6_states_kernel", "wkv6_out_kernel",
                  "rg_lru_cluster_kernel", "decode_attention_kernel",
                  "decode_combine_kernel")
K4_KERNELS = ("wkv6_states_kernel", "wkv6_out_kernel")
K5_KERNEL = "rg_lru_cluster_kernel"
K5_OLD_KERNEL = "rg_lru_kernel"        # the per-segment kernel it replaced
SMS = 132                                 # H100 SXM streaming multiprocessors
# K3's instances beside Phi-3's 96, each at its model's prefill shape:
# StableLM-3B's and -12B's head dims, and MLA's q.k dim (DeepSeek-V2/V3,
# 128 heads, v padded to 192)
K3_NEW_SHAPES = {80: (1, 32, 2048, 80), 160: (1, 32, 2048, 160),
                 192: (1, 128, 2048, 192)}
# K3 at the shapes of phase 3e's prefill steps and at D = 48 (the reduced
# MLA q.k dim) at 128 heads: (row key prefix, (B, H, S, D), causal).
# Qwen2-VL's prefill; Whisper's encoder (full, a ragged S = 1500: 11 x 128 +
# 92 query rows, 28 keys in the last 64-key tile) and decoder prompt (448)
K3_MODEL_SHAPES = (("d128_", (1, 28, 2048, 128), True),
                   ("d64_full_", (8, 12, 1500, 64), False),
                   ("d64_causal_", (8, 12, 448, 64), True),
                   ("d48_", (1, 128, 2048, 48), True))
# the depth DeepSeek's full-width configs are cut to (phase 3d): the
# 236B/671B models do not fit one card
DS_DEPTH = 4
PASSES = 10       # alternating serial/drain passes a serving phase
# the kernels' times before their redesign, at the same shapes, printed
# beside this run's (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W): K2
# on its FMA tile, K4 as one CTA per (b, h), K5 as one CTA per 32 channels
# reading x and a_log twice
EARLIER_MS = {"coschedule": dict(fused=42.174, matmul=40.887, stream=1.062),
              "rwkv6_scan": 1.7817, "rg_lru": 0.1572}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_entries(log_text: str) -> list:
    """From ``nvcc -Xptxas -v`` output, one (instance, registers line,
    stack and spill line) per compiled kernel, the instance shortened from
    its mangled name (``flash_fwd_wgmma_kernelILi80E``,
    ``decode_attention_kernelI13__nv_bfloat16Li16ELi1E``)."""
    def instance(line):
        # a mangled name is <length><name>: try each length that ends
        # where a name starts, and keep the one that names a kernel
        for m in re.finditer(r"\d+(?=[A-Za-z_])", line):
            for i in range(len(m.group())):
                name = line[m.end():m.end() + int(m.group()[i:])]
                if name.endswith("_kernel"):
                    args = re.match(r"I[^E]*E(?:Li\d+E)*",
                                    line[m.end() + len(name):])
                    return name + (args.group() if args else "")
        return line.strip()

    out, entry, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = instance(line)
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry is not None:
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
    return out


def median_range(xs):
    """(median, least, most) of a list of numbers."""
    s = sorted(xs)
    n = len(s)
    med = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    return med, s[0], s[-1]


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls that the host queued
    behind a spin kernel, for a kernel whose host work a call is of its own
    order: the card reaches the first call only once the last is queued, so
    no host gap between calls enters the time. The spin is lengthened until
    the start event is still pending when the last call has been queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError(f"the host did not queue {reps} calls within a spin "
                         f"of {cycles // 4} cycles")


def bound(flops: float, nbytes: float, dtype: str):
    """Least time the card could take: (ms, 'operations' | 'bytes')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def sliced_bound_ms(tiles: int, slice_size: int, tile_flops: float,
                    nbytes: float, dtype: str = "bfloat16") -> float:
    """Least time of a matmul cut into launches of ``slice_size`` tiles, one
    CTA a tile (paper Fig. 3): ceil(tiles / s) launches of ceil(s / 132)
    waves each, a wave no shorter than one tile on one SM at its 1/132
    share of the peak. One launch of every tile is held to the whole
    card's bound."""
    if slice_size >= tiles:
        return bound(tiles * tile_flops, nbytes, dtype)[0]
    launches = math.ceil(tiles / slice_size)
    waves = math.ceil(slice_size / SMS)
    return launches * waves * 1e3 * tile_flops / (PEAK_FLOPS[dtype] / SMS)


def wkv6_work(b: int, s: int, h: int, n: int, rkv_bytes: int,
              c: int = 32):
    """K4's work at (b, s, h, n) with r/k/v of ``rkv_bytes`` each: (product
    FLOPs, other FLOPs, bytes). A chunk of c tokens does 4cn^2 in the
    inter-chunk product and state update and c^2 n in att @ v (products),
    2.5 c^2 n in the scores' decays and sums and 10 cn in the cumsum,
    decays and bonus; bytes read r, k, v, w_log, u and the state once and
    write out and the state once."""
    chunks = math.ceil(s / c) * b * h
    products = (4 * c * n * n + c * c * n) * chunks
    other = (2.5 * c * c * n + 10 * c * n) * chunks
    nbytes = (3 * rkv_bytes + 2 * 4) * b * s * h * n + 4 * h * n \
        + 2 * 4 * b * h * n * n
    return products, other, nbytes


def wkv6_bound_ms(products: float, other: float, nbytes: float):
    """K4's least time: the products on the tensor cores, each f32 product
    as three bf16 products (high and low parts), the rest on the CUDA cores
    in f32, against the bytes. (ms, 'operations' | 'bytes')."""
    t_ops = 3 * products / PEAK_FLOPS["bfloat16"] + \
        other / PEAK_FLOPS["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def wkv6_pass_bytes(b: int, s: int, h: int, n: int, rkv_bytes: int,
                    c: int = 32):
    """What K4's two passes move through device memory: (total, scratch).
    Pass 1 reads k, v, w_log and the state and writes the state entering
    every chunk (the scratch) and the final state; pass 2 reads r, k, v,
    w_log, u and the scratch and writes out."""
    tokens = b * s * h * n
    scratch = 4 * b * h * math.ceil(s / c) * n * n
    state = 4 * b * h * n * n
    pass1 = (2 * rkv_bytes + 4) * tokens + 2 * state + scratch
    pass2 = (3 * rkv_bytes + 4 + 4) * tokens + 4 * h * n + scratch
    return pass1 + pass2, 2 * scratch


def lru_bytes(b: int, s: int, w: int, in_bytes: int, reads: int = 1) -> int:
    """Bytes K5 moves at (b, s, w) from a given h0: x and a_log (``in_bytes``
    an element) read ``reads`` times, h0 read and h (f32) written once."""
    n = b * s * w
    return reads * 2 * in_bytes * n + 4 * n + 4 * b * w


def sp_exchange_bytes(kind: str, b: int, s: int, m: int, width: int,
                      d: int = 0, elt: int = 2) -> int:
    """Bytes one rank of ``m`` sends over ``model`` in one layer's forward
    of the split train step at (b, s) tokens, from the shapes (the
    backward sends as much again: each collective's transpose). "attn":
    the gather of attention's (b, s/m, ``width``) input (MLA's latents
    where ``width`` != ``d``) and the reduce-scatter of its (b, s, ``d``)
    partial sums. "rwkv6": the all-to-alls of r, k, v (``elt`` bytes) and
    w_log and back of the WKV output (f32), ``width`` = D, and the time
    and channel mixes' one-row halos. "rglru": the all-to-alls of x and
    a_log and back of h (f32), ``width`` = W, and the conv's 3-row halo.
    A gather or reduce-scatter sends m - 1 blocks of b s/m rows, an
    all-to-all (m - 1)/m of the rank's tensor, a halo's gather m - 1
    copies of its rows."""
    rows = b * s // m
    if kind == "attn":
        return (m - 1) * rows * (width + (d or width)) * elt
    if kind == "rwkv6":
        return (m - 1) * rows * width * (3 * elt + 4 + 4) // m \
            + 2 * (m - 1) * b * width * elt
    if kind == "rglru":
        return (m - 1) * rows * width * 3 * 4 // m \
            + (m - 1) * b * 3 * width * elt
    raise ValueError(kind)

def trace_report(trace) -> dict:
    """From K2's trace rows (SM, start ns, end ns, op): the share of stream
    CTAs' time during which a matmul CTA ran on the same SM (``share``), the
    share of stream CTAs that met one at all (``met``), the SMs that ran a
    stream CTA (``stream_sms``), when the last stream CTA ended after the
    launch's first start (``stream_end_us``), the mean stream CTA's time
    (``stream_us``) and matmul CTA's time before and after that
    (``mm_us_during``, ``mm_us_after``), the most stream CTAs resident at
    once (``peak_stream``), the matmul CTAs resident on average while
    stream CTAs ran (``mm_resident_during``), and the matmul and stream
    CTAs resident at a quarter, half and three quarters of the launch
    (``resident``, (matmul, stream) each)."""
    t_first = min(int(row[1]) for row in trace)
    rows = [(int(sm), int(t0) - t_first, int(t1) - t_first, int(op))
            for sm, t0, t1, op in trace]
    by_sm: dict = {}
    for sm, t0, t1, op in rows:
        by_sm.setdefault(sm, ([], []))[op].append((t0, t1))
    stream_ns = overlap_ns = met = n_stream = 0
    for mm, st in by_sm.values():
        merged = []
        for t0, t1 in sorted(mm):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        for t0, t1 in st:
            seen = sum(max(0, min(t1, m1) - max(t0, m0)) for m0, m1 in merged)
            stream_ns += t1 - t0
            overlap_ns += seen
            met += seen > 0
            n_stream += 1
    end = max(t1 for _, _, t1, _ in rows)
    st_end = max((t1 for _, _, t1, op in rows if op == 1), default=0)

    def mean_us(durs):
        return sum(durs) / len(durs) / 1e3 if durs else 0.0

    live = peak = 0
    for _, step in sorted((t, step) for _, t0, t1, op in rows if op == 1
                          for t, step in ((t0, 1), (t1, -1))):
        live += step
        peak = max(peak, live)
    mm_ns_during = sum(max(0, min(t1, st_end) - t0)
                       for _, t0, t1, op in rows if op == 0)
    resident = []
    for frac in (0.25, 0.5, 0.75):
        t = frac * end
        live = [op for _, t0, t1, op in rows if t0 <= t < t1]
        resident.append((live.count(0), live.count(1)))
    return dict(
        share=overlap_ns / stream_ns if stream_ns else 0.0,
        met=met / n_stream if n_stream else 0.0,
        stream_sms=sum(1 for _, st in by_sm.values() if st),
        stream_end_us=st_end / 1e3,
        stream_us=mean_us([t1 - t0 for _, t0, t1, op in rows if op == 1]),
        peak_stream=peak,
        mm_resident_during=mm_ns_during / st_end if st_end else 0.0,
        mm_us_during=mean_us([t1 - t0 for _, t0, t1, op in rows
                              if op == 0 and t0 < st_end]),
        mm_us_after=mean_us([t1 - t0 for _, t0, t1, op in rows
                             if op == 0 and t0 >= st_end]),
        resident=resident)


def kernel_events(torch, fn, want=None, tries: int = 5) -> list:
    """The device kernels of one run of ``fn`` under ``torch.profiler``
    (key averages, one a kernel name). A profile that recorded no kernel,
    or fails ``want`` (a test of the events: the kernels the caller then
    asserts), is taken again, up to ``tries`` times: on the card the
    profiler has come back empty, and once without one of two kernels that
    had both run and been checked. The caller's asserts still decide."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs and (want is None or want(evs)):
            break
        log("[profile] the profiler missed a kernel that ran; profiling "
            "again")
    return evs


def n_launches(evs, sym: str) -> int:
    """How many of the profiled kernels ``evs`` have ``sym`` in their name."""
    return sum(e.count for e in evs if sym in e.key)


def names_all(*syms):
    """A ``kernel_events`` test: every one of ``syms`` names a kernel."""
    return lambda evs: all(n_launches(evs, s) for s in syms)


def max_err(torch, got, want, tol) -> float:
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), **tol)
    assert ok, f"kernel disagrees with its plain version: max err {err}"
    return err


def k3_work(shape, causal: bool, elt: int = 2):
    """K3's (FLOPs, bytes) at (B, H, S, D): two products of 2D FLOPs per
    (query, key) pair it must score (S(S+1)/2 pairs causal, S^2 full), and
    q, k, v read and out written once."""
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * d * pairs * b * h, 4 * b * h * s * d * elt


def decode_work(b: int, h: int, kv: int, rows: int, d: int, elt: int,
                q_elt: int = 2):
    """D1's (FLOPs, bytes) over ``rows`` valid cache rows: two products of
    2D FLOPs a (query head, row); each valid K and V row read once, q read
    once, the f32 (m, l, o) written once."""
    return (4.0 * b * h * rows * d,
            2 * b * rows * kv * d * elt + b * h * d * q_elt
            + b * h * (d + 2) * 4)


def decode_attn_layers(cfg) -> int:
    """D1 launches a decode step of ``cfg``: one an attn layer (none where
    MLA's absorbed decode attends in its latent space), one a local layer
    (the ring), and one more a decoder layer with cross-attention."""
    kinds = cfg.layer_kinds()
    n = kinds.count("local")
    if cfg.mla is None or cfg.mla_decode != "absorbed":
        n += kinds.count("attn")
    if cfg.is_encoder_decoder:
        n += kinds.count("attn")
    return n


def mla_decode_layers(cfg) -> int:
    """D2 launches a decode step of ``cfg``: one an MLA layer whose decode
    attends in the latent space."""
    if cfg.mla is None or cfg.mla_decode != "absorbed":
        return 0
    return cfg.layer_kinds().count("attn")


def rel_errs(got, want):
    """(||got - want|| / ||want|| over the whole tensor, the same ratio at
    its worst last-axis row)."""
    g, w = got.float(), want.float()
    diff = g - w
    whole = float(diff.norm() / w.norm())
    rows = float((diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
    return whole, rows


def prefill_runs(rounds, name) -> int:
    """Runs of a job's step in a drain, its warm-up in submit included."""
    return 1 + sum(n1 * (k1 == name) + n2 * (k2 == name)
                   for k1, k2, n1, n2, _ in rounds)


def twin_server(srv, spec, profile_fn):
    """A server over ``srv``'s jobs and steps (the same weights, caches and
    executables) that plans on another hardware model. Build it before
    ``srv`` drains: it copies the pending slices."""
    import dataclasses

    from repro_torch.launch.serve import SharedPodServer, job_profile
    twin = SharedPodServer(gpu_spec=spec, profile_fn=profile_fn,
                           device=srv.device)
    for name, job in srv.jobs.items():
        twin.jobs[name] = dataclasses.replace(job)
        twin.profiles[name] = job_profile(job, spec, profile_fn)
        twin._exec[name] = srv._exec[name]
    return twin


def model_decisions(srv, spec, profile_fn):
    """The rounds a server over ``srv``'s pending jobs would run when it
    planned on another hardware model, found by draining a twin whose
    steps do nothing. Call it before ``srv`` drains."""
    twin = twin_server(srv, spec, profile_fn)
    twin._exec = {name: (lambda: None) for name in twin.jobs}
    return twin.drain(plan_first=False)["rounds"]


def decisions(rounds) -> list:
    """A drain's decisions: (pair, slices) a round, without the CP."""
    return [(k1, k2, n1, n2) for k1, k2, n1, n2, _ in rounds]


def drain_report(torch, srv, twin, res, res_twin, slices, label: str,
                 passes: int = PASSES, want=None) -> dict:
    """Print a drain's rounds on the H100 model beside the v5e model's
    (``twin``) for the same jobs, each job's step timed alone, and the
    spread of drain/serial over ``passes`` alternating passes in this call:
    every job's ``slices`` run one after the other on one stream (serial),
    the drain under the v5e decisions and the drain under the H100 ones
    (one drain a pass where the two decide alike). Then each step's top
    device kernels (a job's profile retaken while it fails its test in
    ``want``). Returns each job's device kernel names from its profile."""
    rounds = res["rounds"]
    for tag, r in (("H100", res), ("v5e", res_twin)):
        for k1, k2, n1, n2, cp in r["rounds"]:
            log(f"[{label}] {tag} model: round {k1} x {k2}: slices "
                f"{n1}:{n2}, predicted CP {cp:+.4f}")
        log(f"[{label}] {tag} model: predicted gain "
            f"{r['predicted_gain']:+.4f}, predicted makespan "
            f"{r['plan']['predicted_makespan_cycles']:.0f} cycles")
    same = decisions(rounds) == decisions(res_twin["rounds"])
    log(f"[{label}] decisions side by side (pair, slices), H100 | v5e: "
        f"{decisions(rounds)} | {decisions(res_twin['rounds'])}"
        + ("; the two models decide alike" if same else ""))
    solo = {name: time_ms(torch, srv._exec[name], 3) for name in srv.jobs}
    ran = {name: sum(n1 * (k1 == name) + n2 * (k2 == name)
                     for k1, k2, n1, n2, _ in rounds) for name in srv.jobs}
    assert ran == slices, (ran, slices)
    serial_s = sum(ran[name] * solo[name] for name in srv.jobs) / 1e3
    log(f"[{label}] step alone: " + ", ".join(
        f"{name} {solo[name]:.3f} ms x {ran[name]} slices" for name in
        srv.jobs) + f"; their sum {serial_s:.4f} s; the counted drain's "
        f"wall_s {res['wall_s']:.4f} (first on its streams), the v5e "
        f"drain's {res_twin['wall_s']:.4f}")

    def serial():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for name, n in slices.items():
            for _ in range(n):
                srv._exec[name]()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def drain(server, want):
        for name, n in slices.items():
            server.jobs[name].num_slices = n
        r = server.drain(plan_first=False)
        assert decisions(r["rounds"]) == want
        return r["wall_s"]

    runs = {"serial": [], "v5e": [], "H100": []}
    kinds = ["serial", "H100"] if same else ["serial", "v5e", "H100"]
    for i in range(passes):
        for kind in (kinds if i % 2 == 0 else kinds[::-1]):
            runs[kind].append(
                serial() if kind == "serial" else
                drain(srv, decisions(rounds)) if kind == "H100" else
                drain(twin, decisions(res_twin["rounds"])))
    for kind in kinds[1:]:
        ratios = [d / t for d, t in zip(runs[kind], runs["serial"])]
        med, lo, hi = median_range(ratios)
        log(f"[{label}] drain/serial under the {kind} decisions over "
            f"{passes} alternating passes: median {med:.4f}, range "
            f"{lo:.4f}-{hi:.4f}; passes {[round(x, 4) for x in ratios]}")
    med, lo, hi = median_range(runs["serial"])
    log(f"[{label}] serial wall over the same passes: median {med:.4f} s, "
        f"range {lo:.4f}-{hi:.4f} s")
    seen = {}
    for name in srv.jobs:
        evs = kernel_events(torch, srv._exec[name], (want or {}).get(name))
        seen[name] = [e.key for e in evs]
        total = sum(e.self_device_time_total for e in evs)
        assert total > 0, f"{name}: the profiler saw no device time"
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
        ours = [e for e in evs if any(k in e.key for k in KERNEL_SYMBOLS)]
        log(f"[profile {name}] device time {total / 1e3:.3f} ms in "
            f"{sum(e.count for e in evs)} kernels; top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                f"x{e.count}" for e in top) + "; the port's kernels: " + (
                "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms x{e.count} "
                          f"({e.self_device_time_total / total:.1%})"
                          for e in ours) or "none"))
    return seen


# phase 2f: each kernel's autograd Function at the training path's shapes,
# (B, S, ...) as the model hands them over: phi3-mini's attention at
# TRAIN_4K's length, rwkv6-1.6b's time mix and recurrentgemma-9b's RG-LRU
# at 2048 tokens, with the model's dtypes (K5's x and a_log are f32 there)
K3_TRAIN = (1, 4096, 32, 96)
K4_TRAIN = (1, 2048, 32, 64)
K5_TRAIN = (1, 2048, 4096)
# phase 2g: the shapes one rank of a (1, 4) mesh hands K3, K4 and K5 on the
# split train step (``sharding.seq_block``: the whole sequence of its
# quarter of the heads or channels), at full width: (row key prefix, (B, S,
# heads or channels of the whole tensor, D), dtypes). phi3-mini's 32 heads
# at TRAIN_4K's length, DeepSeek-V2's MLA 128 heads at q.k dim 192 (v
# padded from 128) at 2048, rwkv6-1.6b's 32 heads of 64 at 2048,
# recurrentgemma-9b's 4096 channels at 2048. Each input is rank 1's quarter
# sliced out of a full-width tensor, a view with the whole tensor's strides
SHARD_M, SHARD_RANK = 4, 1
SHARD_K3 = (("shard_d96_", (1, 4096, 32, 96), 96),
            ("shard_d192_", (1, 2048, 128, 192), 128))
SHARD_K4 = (1, 2048, 32, 64)
SHARD_K5 = (1, 2048, 4096)
# and the prefill shard shapes of serving under the mesh that the training
# rows lack, (B, S, heads of the whole tensor, D): phi3-mini's prefill
# 1 x 2048 (K3 <96> at 8 heads) and rwkv6-1.6b's 4 x 2048 (K4 at 8 heads)
SERVE_K3 = (1, 2048, 32, 96)
SERVE_K4 = (4, 2048, 32, 64)
# what a rank of the (1, 4) mesh sends over 'model' a layer at those
# shapes, bf16 activations: (label, kind, (B, S), gathered width, D)
SHARD_EXCHANGES = (
    ("phi3-mini-3.8b attn", "attn", (1, 4096), 3072, 3072),
    ("deepseek-v2-236b MLA attn (latents 1536 + 512 + 64)", "attn",
     (1, 2048), 2112, 5120),
    ("rwkv6-1.6b time + channel mix", "rwkv6", (1, 2048), 2048, 0),
    ("recurrentgemma-9b RG-LRU", "rglru", (1, 2048), 4096, 0),
    ("recurrentgemma-9b local MQA", "attn", (1, 2048), 4096, 4096))
# phase 2h: D1 at the decode shapes of the serving paths: (label, (B, H,
# kv, S, D), key range [lo, hi), the global position of row 0, whether
# the rows are a ring's slots, splits (None: the kernel's split_count),
# cache dtypes). phi3-mini's decode at t = 2048 (hi 2049: the server
# decodes at job.seq // 2) over its 8 x 4096 cache, with a window of 512,
# and rank 1's and rank 3's row blocks of a (1, 4) mesh (rank 3 holds no
# valid row); Qwen2-VL (7 query heads a kv head, D 128), StableLM-3B (D
# 80) and -12B (4 a kv head, D 160) at the same t; Whisper's self cache at
# t = 224 and its cross cache (1500 frames); RecurrentGemma's ring after it
# wrapped (2048 slots holding positions 1..2048, 16 query heads over its 1
# kv head, D 256); the reduced configs' D 32 (phase 7); and 8 splits of
# 3 valid rows, 5 of them empty
DECODE_SHAPES = (
    ("phi3", (8, 32, 32, 4096, 96), (0, 2049), 0, False, None,
     ("bf16", "f32")),
    ("phi3_window", (8, 32, 32, 4096, 96), (2049 - 512, 2049), 0, False,
     None, ("bf16",)),
    ("phi3_rank1", (8, 32, 32, 1024, 96), (0, 2049), 1024, False, None,
     ("bf16",)),
    ("phi3_rank3", (8, 32, 32, 1024, 96), (0, 2049), 3072, False, None,
     ("bf16",)),
    ("qwen2vl", (8, 28, 4, 4096, 128), (0, 2049), 0, False, None,
     ("bf16", "f32")),
    ("slm3b", (2, 32, 32, 4096, 80), (0, 2049), 0, False, None, ("bf16",)),
    ("slm12b", (2, 32, 8, 4096, 160), (0, 2049), 0, False, None,
     ("bf16", "f32")),
    ("whisper_self", (32, 12, 12, 448, 64), (0, 225), 0, False, None,
     ("bf16",)),
    ("whisper_cross", (32, 12, 12, 1500, 64), (0, 1500), 0, False, None,
     ("bf16", "f32")),
    ("rgemma_ring", (8, 16, 1, 2048, 256), (1, 2049), 0, True, None,
     ("bf16", "f32")),
    ("reduced_d32", (2, 4, 4, 64, 32), (0, 33), 0, False, None,
     ("bf16", "f32")),
    ("empty_splits", (8, 32, 32, 4096, 96), (0, 3), 0, False, 8,
     ("bf16",)))
# the shapes whose time phase 2h also takes at other split counts
DECODE_SWEEP = ("phi3", "qwen2vl", "slm12b", "rgemma_ring")
# D1's output o / l (and m) against the plain version's: an f32 cache within
# 5e-4 absolute (ROADMAP item 19); a bf16 one within BF16_TOL. Both compute
# in f32 from the same values, so they differ in summation order and exp
DECODE_F32_TOL = dict(atol=5e-4, rtol=0.0)
D1_KERNEL = "decode_attention_kernel"
D1_COMBINE = "decode_combine_kernel"
# the decode steps' device time before D1, when eager f32 copies of the
# caches fed the einsums (PERF.md section 5; NVIDIA H100 80GB HBM3,
# 700.00 W): phi3-mini 8 x 4096 and whisper-small 32 x 448
EARLIER_DECODE_MS = {"phi3-mini-3.8b": 74.4, "whisper-small": 14.229}
# D2 (mla_decode_attention) at (label, (B, H, S, R, DR), hi, offset): rows
# whose position offset + row lies below hi are read; the rows after them
# hold N(0, 64^2), so a read past hi shows. The first is dsv2lite-mixed's
# decode (48 x 8193 rows of a 16,384-row latent cache), then the reduced
# widths (and R 32 / DR 8, whose (R + DR) / 8 chunks are odd), 128 heads
# (DeepSeek-V2-236B, V3: 8 head tiles), a row block at an offset, and a
# block with no row in it
MLA_DECODE_SHAPES = (
    ("dsv2lite", (48, 16, 16384, 512, 64), 8193, 0),
    ("reduced", (2, 4, 64, 32, 16), 40, 0),
    ("r32_dr8", (2, 4, 64, 32, 8), 40, 0),
    ("h128", (2, 128, 1024, 512, 64), 700, 0),
    ("offset", (4, 16, 2048, 512, 64), 3000, 1536),
    ("empty", (2, 16, 256, 512, 64), 100, 256))
D2_KERNEL = "mla_decode_kernel"
D2_COMBINE = "mla_combine_kernel"
# G1 at dsv2lite-mixed's prompt: (tokens, top-k, experts, D, F)
G1_SHAPE = (4096, 6, 64, 2048, 1408)
# mellum2-mixed's prompt at a sliding-window layer: (B, H, S, D), kv heads
# and the window
K3W_SHAPE, K3W_KV, K3W_WINDOW = (1, 32, 16384, 128), 4, 1024
G1_KERNELS = ("grouped_gate_up_kernel", "grouped_down_kernel")
# the absorbed decode of one dsv2lite-mixed layer before D2: the f32 copy of
# the latents and two f32 einsums, ~1.87 ms (PERF.md section 5; NVIDIA H100
# 80GB HBM3, 700.00 W)
EARLIER_MLA_DECODE_MS = 1.87
# a bf16 gradient against autograd through an independent f32 plain
# version (the full S x S attention, the sequential recurrences): 5e-2 of
# max(1, the gradient's largest entry), i.e. 5e-2 abs on unit-scale
# gradients, and the error's norm within 1e-2 of the gradient's
GRAD_TOL = 5e-2
GRAD_REL_TOL = 1e-2
# phase 5: (arch, depth cut (None: uncut), batch, seq, kernel op, its
# profiler symbol, its launches a step: each layer of its kind once in the
# forward and once in the remat recompute, whether the loss must fall over
# the steps). rwkv6-1.6b from its seeded init has a gradient norm of ~5e9
# (its u and the layernorm of a time-mix row that is exactly zero at t = 0)
# and its loss rises under the reference's arithmetic too (the plain forms
# in place of K4, run beside it), so there only the twin run is compared
TRAIN_CELLS = (("phi3-mini-3.8b", None, 1, 4096, "flash_attention",
                "flash_fwd_wgmma_kernel<96>", 64, True),
               ("rwkv6-1.6b", None, 1, 2048, "rwkv6_scan",
                "wkv6_out_kernel", 48, False),
               ("recurrentgemma-9b", 3, 1, 2048, "rg_lru", K5_KERNEL, 4,
                True))
# the kernel path's first loss (before any update) against the plain
# forms': the forward through K4 differs only in summation order, which 24
# layers from this init amplify to ~0.1%
TWIN_LOSS_REL = 1e-2
TRAIN_STEPS = 3


# phase 8: the serving steps under the (1, 1) DeviceMesh at full width,
# against the same calls with no mesh: (arch, depth cut (None: uncut), the
# kernel its prefill launches once a layer of its kind). Each prefills
# 1 x SERVE_PROMPT into a 1 x SERVE_LEN cache, then decodes SERVE_STEPS
# tokens of SERVE_BATCH rows over a SERVE_BATCH x SERVE_LEN cache whose
# rows are that prompt's; SERVE_SPLIT is the ShapeMesh whose per-rank cache
# bytes it prints
SERVE_MESH = (("phi3-mini-3.8b", None, "flash_attention", "attn"),
              ("rwkv6-1.6b", None, "rwkv6_scan", "rwkv6"),
              ("recurrentgemma-9b", None, "rg_lru", "rglru"),
              ("deepseek-v2-236b", DS_DEPTH, "flash_attention", "attn"))
SERVE_PROMPT, SERVE_LEN, SERVE_BATCH, SERVE_STEPS = 2048, 4096, 8, 8
SERVE_SPLIT = (1, 4)
# the order of the timed calls, after the first ones
SERVE_ORDER = ("no mesh", "(1, 1) mesh", "(1, 1) mesh", "no mesh") * 3


def grad_errs(got, want):
    """(max abs error over max(1, max |want|), error norm over want's)."""
    g, w = got.float(), want.float()
    d = g - w
    return (float(d.abs().max()) / max(1.0, float(w.abs().max())),
            float(d.norm() / w.norm().clamp_min(1e-30)))


def named_leaves(tree, prefix=""):
    """(key path, leaf) of nested dicts."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def adamw_bytes(params, state) -> int:
    """The bytes one AdamW step must move: each parameter read and written,
    its gradient (in the parameter's dtype) read, mu and nu read and
    written."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in named_leaves(tree))
    return 3 * nbytes(params) + 2 * nbytes(state["mu"]) \
        + 2 * nbytes(state["nu"])


def check_function(torch, ops, randn, case):
    """One kernel through its autograd Function on ``case["args"]``: the
    forward is the kernel's output bit for bit and launches it once, the
    backward launches none of the port's kernels, and each input's
    gradient is finite and equals autograd through the f32 plain version
    (``GRAD_TOL``, ``GRAD_REL_TOL``). Returns ([(abs, norm-relative) error
    an input], forward ms, backward ms), the times from CUDA events over 3
    calls."""
    name, args = case["name"], case["args"]
    leaves = [t.detach().requires_grad_() for t in args]
    cot = [randn(o.shape, torch.float32).to(o.dtype)
           for o in case["kernel"](*args)]
    ops.reset_launches()
    outs = case["fn"](*leaves)
    fwd_launches = dict(ops.LAUNCHES)
    grads = torch.autograd.grad(outs, leaves, cot)
    torch.cuda.synchronize()
    assert fwd_launches[name] == 1 and sum(fwd_launches.values()) == 1, \
        (name, fwd_launches)
    assert ops.LAUNCHES == fwd_launches, \
        f"{name}: the backward launched a kernel: {ops.LAUNCHES}"
    with torch.no_grad():
        direct = case["kernel"](*args)
    for o, want in zip(outs, direct):
        assert torch.equal(o.detach(), want), \
            f"{name}: the Function's forward is not the kernel's output"
    f32 = [t.detach().float().requires_grad_() for t in args]
    want = torch.autograd.grad(case["plain"](*f32), f32,
                               [c.float() for c in cot])
    errs = []
    for i, (g, wg) in enumerate(zip(grads, want)):
        assert bool(torch.isfinite(g).all()), (name, i)
        e_abs, e_rel = grad_errs(g, wg)
        assert e_abs <= GRAD_TOL and e_rel <= GRAD_REL_TOL, \
            (name, i, e_abs, e_rel)
        errs.append((e_abs, e_rel))
    del outs, grads, want, f32, direct
    fwd_ms = time_ms(torch, lambda: case["fn"](*leaves), 3)
    both_ms = time_ms(torch, lambda: torch.autograd.grad(
        case["fn"](*leaves), leaves, cot), 3)
    return errs, fwd_ms, both_ms - fwd_ms


def autograd_phase(torch, ops, ref, A, R, randn, rows) -> None:
    """Phase 2f: K3, K4 and K5 through their autograd Functions at the
    training shapes. The forward is the kernel's output bit for bit and
    launches it once; the backward launches none of the port's kernels;
    each input's gradient is finite and equals autograd through an f32
    plain version (``GRAD_TOL``, ``GRAD_REL_TOL``). Times the forward and
    the backward (CUDA events)."""
    b, s, h, d = K3_TRAIN
    q, k, v = (randn((b, s, h, d), torch.bfloat16) for _ in range(3))

    def bhsd(t):
        return t.transpose(1, 2)

    k3 = dict(
        name="flash_attention", args=(q, k, v), dtype="bf16 q/k/v",
        fn=lambda q, k, v: (A.FlashAttention.apply(q, k, v, True),),
        kernel=lambda q, k, v: (A._flash_fwd(q, k, v, causal=True),),
        plain=lambda q, k, v: (bhsd(ref.flash_attention(
            bhsd(q), bhsd(k), bhsd(v), causal=True)),),
        plain_name="the full S x S f32 attention")
    b, s, h, n = K4_TRAIN
    r4, k4, v4 = (randn((b, s, h, n), torch.bfloat16) for _ in range(3))
    w4 = -torch.exp(randn((b, s, h, n), torch.float32) - 1.0)
    u4 = randn((h, n), torch.float32) * 0.1
    s4 = torch.zeros(b, h, n, n, device=q.device)

    def k4_kernel(r, k, v, w_log, u, state):
        final = state.clone()
        return ops.rwkv6_scan(r, k, v, w_log, u, state=final), final

    k4_case = dict(
        name="rwkv6_scan", args=(r4, k4, v4, w4, u4, s4),
        dtype="bf16 r/k/v, f32 w_log/u/state",
        fn=lambda *xs: R.WKV6.apply(*xs, 32), kernel=k4_kernel,
        plain=ref.rwkv6, plain_name="the sequential f32 recurrence")
    b, s, w = K5_TRAIN
    x5 = randn((b, s, w), torch.float32)
    a5 = -torch.exp(randn((b, s, w), torch.float32) - 4.0)
    h5 = torch.zeros(b, w, device=q.device)
    k5 = dict(
        name="rg_lru", args=(x5, a5, h5), dtype="f32 x/a_log/h0",
        fn=lambda x, a, h0: (R.RGLRU.apply(x, a, h0),),
        kernel=lambda x, a, h0: (ops.rg_lru(x, a, chunk=s, bw=w, h0=h0),),
        plain=lambda x, a, h0: (ref.rg_lru(x, a, h0),),
        plain_name="the sequential f32 recurrence")
    for case in (k3, k4_case, k5):
        name, args = case["name"], case["args"]
        errs, fwd_ms, bwd_ms = check_function(torch, ops, randn, case)
        rows[name].update(train_fwd_ms=fwd_ms, train_bwd_ms=bwd_ms,
                          train_grad_err=max(e for e, _ in errs))
        log(f"[2f {name}] {tuple(args[0].shape)} {case['dtype']} through "
            f"its autograd Function: forward = the kernel's output bit for "
            f"bit, 1 launch; backward 0 launches; gradients of "
            f"{len(errs)} inputs finite, against autograd through "
            f"{case['plain_name']}: max abs err / max(1, max|grad|) "
            + ", ".join(f"{e:.3e}" for e, _ in errs) + " (tol "
            f"{GRAD_TOL:g}), norm-relative " + ", ".join(
                f"{r:.3e}" for _, r in errs) + f" (tol {GRAD_REL_TOL:g}); "
            f"forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
            f"(CUDA events, mean of 3)")
        del args, case
    del q, k, v, r4, k4, v4, w4, u4, s4, x5, a5, h5
    torch.cuda.empty_cache()


def shard_phase(torch, ops, ref, A, R, randn, rows) -> None:
    """Phase 2g: K3, K4 and K5 through their autograd Functions at a (1, 4)
    rank's shard shapes (``SHARD_K3``, ``SHARD_K4``, ``SHARD_K5``), each
    input a strided quarter of a full-width tensor: the forward against the
    plain version at the kernel's tolerance, and ``check_function``'s
    launches and gradients. Times the kernel alone (CUDA events; K5 queued
    behind a spin, as phase 2e), the Function's forward and backward, and
    the kernel's bound at the shard's shape; then the serving rows
    (``serve_shards``)."""
    def quarter(t, dim):
        n = t.shape[dim] // SHARD_M
        return t.narrow(dim, SHARD_RANK * n, n)

    def bhsd(t):
        return t.transpose(1, 2)

    cases = []
    for key, (b, s, h, d), dv in SHARD_K3:
        q, k = (quarter(randn((b, s, h, d), torch.bfloat16), 2)
                for _ in range(2))
        v = A._pad_v(quarter(randn((b, s, h, dv), torch.bfloat16), 2), d)
        shape = (b, h // SHARD_M, s, d)
        flops, nbytes = k3_work(shape, True)
        cases.append(dict(
            key=key, name="flash_attention", args=(q, k, v), shape=shape,
            dtype="bf16 q/k/v", tol=BF16_TOL, ms_fn=time_ms,
            bound=bound(flops, nbytes, "bfloat16"),
            fn=lambda q, k, v: (A.FlashAttention.apply(q, k, v, True),),
            kernel=lambda q, k, v: (A._flash_fwd(q, k, v, causal=True),),
            plain=lambda q, k, v: (bhsd(ref.flash_attention(
                bhsd(q), bhsd(k), bhsd(v), causal=True)),),
            plain_name="the full S x S f32 attention",
            dense=lambda *ts: [bhsd(t).contiguous() for t in ts],
            op=lambda q, k, v: ops.flash_attention(q, k, v, causal=True)))
    b, s, h, n = SHARD_K4
    r4, k4, v4 = (quarter(randn((b, s, h, n), torch.bfloat16), 2)
                  for _ in range(3))
    w4 = quarter(-torch.exp(randn((b, s, h, n), torch.float32) - 1.0), 2)
    u4 = quarter(randn((h, n), torch.float32) * 0.1, 0)
    s4 = torch.zeros(b, h // SHARD_M, n, n, device=u4.device)

    def k4_kernel(r, k, v, w_log, u, state):
        final = state.clone()
        return ops.rwkv6_scan(r, k, v, w_log, u, state=final), final
    products, other, nbytes = wkv6_work(b, s, h // SHARD_M, n, 2)
    cases.append(dict(
        key="shard_", name="rwkv6_scan", args=(r4, k4, v4, w4, u4, s4),
        shape=tuple(r4.shape), dtype="bf16 r/k/v, f32 w_log/u/state",
        tol=K4_TOL["bfloat16"], ms_fn=time_ms,
        bound=wkv6_bound_ms(products, other, nbytes),
        fn=lambda *xs: R.WKV6.apply(*xs, 32), kernel=k4_kernel,
        plain=ref.rwkv6, plain_name="the sequential f32 recurrence"))
    b, s, w = SHARD_K5
    for dt, key in ((torch.bfloat16, "shard_bf16_"),
                    (torch.float32, "shard_f32_")):
        x5 = quarter(randn((b, s, w), torch.float32).to(dt), 2)
        a5 = quarter((-torch.exp(randn((b, s, w), torch.float32) - 4.0))
                     .to(dt), 2)
        h5 = torch.zeros(b, w // SHARD_M, device=x5.device)
        elt = x5.element_size()
        cases.append(dict(
            key=key, name="rg_lru", args=(x5, a5, h5), shape=tuple(x5.shape),
            dtype=f"{str(dt)[6:]} x/a_log, f32 h0", tol=K5_TOL,
            ms_fn=queued_ms,
            bound=bound(9.0 * x5.numel(), lru_bytes(b, s, w // SHARD_M, elt),
                        "float32"),
            fn=lambda x, a, h0: (R.RGLRU.apply(x, a, h0),),
            kernel=lambda x, a, h0: (ops.rg_lru(
                x, a, chunk=x.shape[1], bw=x.shape[2], h0=h0),),
            plain=lambda x, a, h0: (ref.rg_lru(x, a, h0),),
            plain_name="the sequential f32 recurrence"))
    for case in cases:
        name, args = case["name"], case["args"]
        assert not all(t.is_contiguous() for t in args[:3]), name
        dense = case.get("dense", lambda *ts: [t.contiguous() for t in ts])(
            *args)
        op = case.get("op", case["kernel"])
        with torch.no_grad():
            got = case["kernel"](*args)[0]
            want = case["plain"](*(t.float() for t in args))[0]
        err = max_err(torch, got, want, case["tol"])
        del got, want
        errs, fwd_ms, bwd_ms = check_function(torch, ops, randn, case)
        ms = case["ms_fn"](torch, lambda: op(*dense), 10)
        b_ms, b_by = case["bound"]
        rows[name].update({f"{case['key']}ms": ms,
                           f"{case['key']}bound_ms": b_ms,
                           f"{case['key']}err": err,
                           f"{case['key']}fwd_ms": fwd_ms,
                           f"{case['key']}bwd_ms": bwd_ms})
        log(f"[2g {name}] rank {SHARD_RANK} of {SHARD_M}: {case['shape']} "
            f"{case['dtype']}, strided slices of the full-width tensors: "
            f"kernel {ms:.4f} ms on them copied whole (CUDA events, mean of "
            f"10{', queued' if case['ms_fn'] is queued_ms else ''}), bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; against "
            f"{case['plain_name']} max err {err:.3e}; through its autograd "
            f"Function 1 launch forward, 0 backward, gradients of "
            f"{len(errs)} inputs max abs err / max(1, max|grad|) "
            + ", ".join(f"{e:.3e}" for e, _ in errs) + ", norm-relative "
            + ", ".join(f"{r:.3e}" for _, r in errs) + f"; forward "
            f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms")
        del args, case, dense, op
    del cases, r4, k4, v4, w4, u4, s4, x5, a5, h5
    torch.cuda.empty_cache()
    serve_shards(torch, ops, ref, A, randn, rows, quarter, bhsd, k4_kernel)
    for label, kind, (b, s), width, d in SHARD_EXCHANGES:
        log(f"[2g exchange] {label} at {b} x {s}, m = {SHARD_M}: "
            f"{sp_exchange_bytes(kind, b, s, SHARD_M, width, d) / 1e6:.2f} MB "
            f"sent by a rank over 'model' a layer's forward, counted from "
            f"the shapes (as much again in the backward)")


def serve_shards(torch, ops, ref, A, randn, rows, quarter, bhsd,
                 k4_kernel) -> None:
    """Phase 2g's serving rows: K3 <96> and K4 at a (1, 4) rank's prefill
    shard shapes (``SERVE_K3``, ``SERVE_K4``), each input a strided
    quarter of a full-width tensor, against its plain version; kernel
    (on the slices copied whole), plain and library times (CUDA events)
    beside the bound. The serving steps run under ``inference_mode``, so
    the kernel alone, with no autograd Function."""
    import torch.nn.functional as F
    card = nvidia_smi("name,power.limit")
    b, s, h, d = SERVE_K3
    q, k, v = (quarter(randn((b, s, h, d), torch.bfloat16), 2)
               for _ in range(3))
    dense = [bhsd(t).contiguous() for t in (q, k, v)]
    shape = tuple(dense[0].shape)
    with torch.no_grad():
        got = A._flash_fwd(q, k, v, causal=True)
        want = bhsd(ref.flash_attention(*(t.float() for t in dense),
                                        causal=True))
    err = max_err(torch, got, want, BF16_TOL)
    del got, want
    ms = time_ms(torch, lambda: ops.flash_attention(*dense, causal=True), 10)
    plain = time_ms(torch, lambda: ref.flash_attention(*dense, causal=True),
                    3)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        *dense, is_causal=True), 10)
    b_ms, b_by = bound(*k3_work(shape, True), "bfloat16")
    rows["flash_attention"].update({
        "shard_serve_d96_ms": ms, "shard_serve_d96_bound_ms": b_ms,
        "shard_serve_d96_err": err, "shard_serve_d96_plain_ms": plain,
        "shard_serve_d96_library_ms": lib})
    log(f"[2g serve flash_attention] rank {SHARD_RANK} of {SHARD_M}'s "
        f"prefill shard {shape} causal bf16, strided slices: kernel "
        f"{ms:.4f} ms on them copied whole, plain {plain:.4f} ms, SDPA "
        f"{lib:.4f} ms (CUDA events), bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms:.1%} of it; max err {err:.3e} against the full S x S "
        f"f32 attention; {card}")
    del q, k, v, dense
    b, s, h, n = SERVE_K4
    r4, k4, v4 = (quarter(randn((b, s, h, n), torch.bfloat16), 2)
                  for _ in range(3))
    w4 = quarter(-torch.exp(randn((b, s, h, n), torch.float32) - 1.0), 2)
    u4 = quarter(randn((h, n), torch.float32) * 0.1, 0)
    s4 = torch.zeros(b, h // SHARD_M, n, n, device=u4.device)
    args = (r4, k4, v4, w4, u4, s4)
    with torch.no_grad():
        got = k4_kernel(*args)[0]
        want = ref.rwkv6(*(t.float() for t in args))[0]
    err = max_err(torch, got, want, K4_TOL["bfloat16"])
    del got, want
    dense = [t.contiguous() for t in args]
    ms = time_ms(torch, lambda: k4_kernel(*dense), 10)
    plain = time_ms(torch, lambda: ref.rwkv6(*(t.float() for t in args)), 1)
    b_ms, b_by = wkv6_bound_ms(*wkv6_work(b, s, h // SHARD_M, n, 2))
    rows["rwkv6_scan"].update({
        "shard_serve_ms": ms, "shard_serve_bound_ms": b_ms,
        "shard_serve_err": err, "shard_serve_plain_ms": plain})
    log(f"[2g serve rwkv6_scan] rank {SHARD_RANK} of {SHARD_M}'s prefill "
        f"shard {tuple(r4.shape)} bf16 r/k/v, f32 w_log/u/state, strided "
        f"slices: kernel {ms:.4f} ms on them copied whole, the sequential "
        f"f32 recurrence {plain:.4f} ms (CUDA events), bound {b_ms:.4f} ms "
        f"({b_by}), {b_ms / ms:.1%} of it; max err {err:.3e}; no library "
        f"call; {card}")
    del args, dense, r4, k4, v4, w4, u4, s4
    torch.cuda.empty_cache()


def decode_phase(torch, ops, ref, randn, rows) -> None:
    """Phase 2h: D1 against its plain version at each ``DECODE_SHAPES``
    shape and cache dtype, the same split count for both: o / l and m
    within ``DECODE_F32_TOL`` (f32 caches) or ``BF16_TOL`` (bf16), l within
    5e-4 relative, and a call with no valid row exactly (NEG_INF, 0, 0).
    For the bf16 cache, the kernel's time (CUDA events over 20 calls queued
    behind a spin: a call's host work is of the small shapes' order), the
    plain version's, SDPA's over the valid rows (``enable_gqa``; for the
    table only, never on the path) and the bound of ``decode_work`` at
    3.35 TB/s. At phi3's shape also: the kernel's memory above what the
    cache holds (less than one cache tensor: no copy) beside the plain
    version's, a view of 8 of the cache's 32 kv heads read in place, and
    the profiler's times of the split and combine kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    card = nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def normalised(m, l_sum, o):
        return o / l_sum[..., None]

    row = rows["decode_attention"] = dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/models/attention.py:183")
    for label, (b, h, kv, s, d), (lo, hi), offset, ring, splits, dts in \
            DECODE_SHAPES:
        pos = None
        if ring:    # positions hi - s .. hi - 1, each at slot p % s
            p = torch.arange(hi - s, hi, device=dev, dtype=torch.int32)
            pos = torch.empty(s, device=dev, dtype=torch.int32)
            pos[p % s] = p
        r0, r1 = ref.decode_rows(lo, hi, offset, s, ring)
        valid = (int(((pos >= lo) & (pos < hi)).sum()) if ring else r1 - r0)
        ns = splits or DA.split_count(b * kv, r1 - r0, sms)
        kw = dict(lo=lo, hi=hi, offset=offset, pos=pos, n_splits=ns)
        errs = []
        for name in dts:
            dt = dtypes[name]
            q = randn((b, h, d), dt)
            k, v = randn((b, s, kv, d), dt), randn((b, s, kv, d), dt)
            got = ops.decode_attention(q, k, v, **kw)
            want = ref.decode_attention(q, k, v, **kw)
            if name == dts[0]:      # timed below
                q0, k0, v0 = q, k, v
            del q, k, v
            if not valid:
                for x, w0 in zip(got, (ref.NEG_INF, 0.0, 0.0)):
                    assert bool((x == w0).all()), (label, name)
                for x, y in zip(got, want):
                    assert torch.equal(x, y), (label, name)
                errs.append((name, 0.0, 0.0, 0.0))
                continue
            tol = DECODE_F32_TOL if dt == torch.float32 else BF16_TOL
            err = max_err(torch, normalised(*got), normalised(*want), tol)
            m_err = max_err(torch, got[0], want[0], DECODE_F32_TOL)
            l_err = max_err(torch, got[1] / want[1],
                            torch.ones_like(want[1]), DECODE_F32_TOL)
            errs.append((name, err, m_err, l_err))
            del got, want
        q, k, v = q0, k0, v0
        elt = k.element_size()
        flops, nbytes = decode_work(b, h, kv, valid, d, elt)
        b_ms, b_by = bound(flops, nbytes, "bfloat16")
        ms = queued_ms(torch, lambda: ops.decode_attention(q, k, v, **kw), 20)
        plain = time_ms(torch, lambda: ref.decode_attention(q, k, v, **kw), 3)
        lib = None
        if valid:
            if ring:
                sel = torch.nonzero((pos >= lo) & (pos < hi))[:, 0]
                kk, vv = k[:, sel], v[:, sel]
            else:
                kk, vv = k[:, r0:r1], v[:, r0:r1]
            kk, vv = (x.transpose(1, 2).contiguous() for x in (kk, vv))
            q4 = q.view(b, h, 1, d)
            lib = queued_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kk, vv, enable_gqa=True), 20)
            del kk, vv
        if label in DECODE_SWEEP:   # the split count's waves, side by side
            sweep = []
            for waves in (1, 2, 4, 8):
                n_w = DA.split_count(b * kv, r1 - r0, sms, waves)
                sweep.append((waves, n_w, queued_ms(
                    torch, lambda: ops.decode_attention(
                        q, k, v, **dict(kw, n_splits=n_w)), 20)))
            log(f"[2h splits {label}] CTAs an SM the split count aims for "
                f"(split_count's waves; {DA.SPLIT_WAVES} on the path): "
                + ", ".join(f"{w}: {n} splits {t:.4f} ms" for w, n, t in
                            sweep) + f" (queued); {card}")
        key = "" if label == "phi3" else f"dec_{label}_"
        row.update({f"{key}max_abs_err": max(e[1] for e in errs),
                    f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bound_ms": b_ms, f"{key}library_ms": lib,
                    f"{key}splits": ns})
        if not key:
            row["bound_by"] = b_by
        log(f"[2h decode_attention {label}] q ({b}, {h}, {d}) over a "
            f"({b}, {s}, {kv}, {d}) cache, keys [{lo}, {hi}) of rows at "
            f"{'the ring pos' if ring else f'offset {offset}'}: {valid} "
            f"valid rows, {ns} splits; "
            + "; ".join(f"{n} cache: o / l err {e:.3e}, m {me:.3e}, l "
                        f"relative {le:.3e}" for n, e, me, le in errs)
            + f" (tol f32 5e-4 abs, bf16 2e-2); bf16 kernel {ms:.4f} ms "
            f"(queued), plain {plain:.4f} ms, SDPA "
            + (f"{lib:.4f} ms" if lib is not None else "none (no valid row)")
            + f", bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB), "
            f"{b_ms / ms:.1%} of it; {card}")
        if label == "phi3":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            extra = {}
            for tag, fn in (("kernel", ops.decode_attention),
                            ("plain", ref.decode_attention)):
                torch.cuda.reset_peak_memory_stats()
                fn(q, k, v, **kw)
                torch.cuda.synchronize()
                extra[tag] = torch.cuda.max_memory_allocated() - base
            assert extra["kernel"] < k.numel() * elt, extra
            view_k, view_v = k[:, :, 8:16], v[:, :, 8:16]
            assert not view_k.is_contiguous()
            qv = q[:, 8:16].contiguous()
            torch.cuda.reset_peak_memory_stats()
            got = ops.decode_attention(qv, view_k, view_v, lo=lo, hi=hi)
            torch.cuda.synchronize()
            view_extra = torch.cuda.max_memory_allocated() - base
            assert view_extra < view_k.numel() * elt, view_extra
            want = ref.decode_attention(qv, view_k, view_v, lo=lo, hi=hi)
            view_err = max_err(torch, normalised(*got), normalised(*want),
                               BF16_TOL)
            del got, want
            # five calls a profile: on the card the profiler has missed the
            # first of a one-call profile's two kernels five times running
            evs = kernel_events(torch, lambda: [ops.decode_attention(
                q, k, v, **kw) for _ in range(5)], names_all(D1_KERNEL,
                                                             D1_COMBINE))
            by = {}
            for sym in (D1_KERNEL, D1_COMBINE):
                mine = [e for e in evs if sym in e.key]
                assert mine, (sym, [e.key for e in evs])
                by[sym] = (sum(e.self_device_time_total for e in mine) / 1e3
                           / sum(e.count for e in mine))
            row.update(kernel_only_ms=by[D1_KERNEL],
                       combine_ms=by[D1_COMBINE], view_err=view_err,
                       extra_mib=extra["kernel"] / 2**20,
                       plain_extra_mib=extra["plain"] / 2**20)
            log(f"[2h decode_attention phi3 memory] above the {base / 2**30:.3f}"
                f" GiB held: kernel {extra['kernel'] / 2**20:.2f} MiB, plain "
                f"{extra['plain'] / 2**20:.2f} MiB (one bf16 cache tensor "
                f"{k.numel() * elt / 2**20:.2f} MiB); kv heads 8..15 as a "
                f"view (strides {view_k.stride()}) read in place, "
                f"{view_extra / 2**20:.2f} MiB above, err {view_err:.3e}; "
                f"profiler, a launch: {D1_KERNEL} {by[D1_KERNEL]:.4f} ms + "
                f"{D1_COMBINE} {by[D1_COMBINE]:.4f} ms")
        del q, k, v, q0, k0, v0
    torch.cuda.empty_cache()


def mla_decode_work(b: int, h: int, rows: int, r: int, dr: int,
                    elt: int = 2):
    """D2's (FLOPs, bytes) over ``rows`` valid latent rows: the scores'
    2 (R + DR) and the output's 2 R FLOPs a (head, row); each ckv and krope
    row read once (q and the f32 partials, under 1% at the cell's shape,
    left out)."""
    return 2.0 * b * h * rows * (2 * r + dr), b * rows * (r + dr) * elt


def grouped_experts_work(t: int, k: int, d: int, f: int, e: int,
                         elt: int = 2):
    """G1's (FLOPs, bytes) a call for ``t`` tokens routed top-``k`` over
    ``e`` experts of width (D, F): the gate, up and down products' 2 x 3 x
    D x F FLOPs a pair; every expert's three matrices read once, each
    pair's row read and its output row written once."""
    return 6.0 * t * k * d * f, 3 * e * d * f * elt + 2 * t * k * d * elt


def g1_case(torch, dev, skewed: bool, seed: int = 0):
    """G1's inputs at dsv2lite-mixed's prompt (``G1_SHAPE``), bf16 experts
    of unit-variance products. Even: the same count every expert. Skewed:
    one expert 3506 pairs (of 4096 tokens, as the cell's seeded router
    sends), three experts none, the rest uneven."""
    t, k, e, d, f = G1_SHAPE
    n = t * k
    g = torch.Generator().manual_seed(seed)
    if skewed:
        share = torch.rand(e, generator=g) ** 4
        share[[5, 7, 20, 41]] = 0
        counts = (share / share.sum() * (n - 3506)).floor().long()
        counts[5] = 3506
        counts[0] += n - int(counts.sum())
    else:
        counts = torch.full((e,), n // e)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                ).bfloat16()

    return dict(xs=randn(n, d), counts=counts.to(dev),
                weights=torch.rand(n, generator=gen, device=dev),
                sort_idx=torch.randperm(n, generator=gen, device=dev),
                wi=randn(e, d, f, scale=d ** -0.5),
                wg=randn(e, d, f, scale=d ** -0.5),
                wo=randn(e, f, d, scale=f ** -0.5))


def grouped_experts_phase(torch, ops, rows) -> None:
    """Phase 2j: G1 against its plain version at dsv2lite-mixed's prompt
    (``G1_SHAPE``: 4096 tokens, top-6 of 64 experts, D 2048, F 1408), with
    even counts and skewed ones (``g1_case``): within ``BF16_TOL``, two
    launches a call, the same bits on a second call. Each timed (CUDA
    events over 20 calls queued behind a spin kernel) beside the
    operations' bound, the plain version's time and the route it replaces
    (the buckets of a depth chosen from the counts read back, the hot
    experts' rest one by one, the weighting and the scatter to the pairs'
    slots), with the profiler's time of each of G1's two kernels. No one
    PyTorch call computes a grouped product: no library time."""
    from repro_torch.kernels import grouped_experts as GE
    from repro_torch.models import moe as M
    card = nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    t, k, e, d, f = G1_SHAPE
    flops, nbytes = grouped_experts_work(t, k, d, f, e)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    row = rows["grouped_experts"] = dict(
        source="src/repro_torch/csrc/grouped_experts.cu",
        replaces="none: models/moe.py _dropless_expert_compute (the "
                 "reference's XLA einsums, src/repro/models/moe.py moe_ffn)",
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    for label in ("even", "skewed"):
        case = g1_case(torch, dev, label == "skewed")
        ops.reset_launches()
        got = ops.grouped_experts(**case)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["grouped_experts"] == 2, ops.LAUNCHES
        want = GE.plain(**case)
        err = max_err(torch, got, want, BF16_TOL)
        rel = float((got.float() - want.float()).norm()
                    / want.float().norm())
        assert torch.equal(got, ops.grouped_experts(**case)), label
        del got, want
        ms = queued_ms(torch, lambda: ops.grouped_experts(**case), 20)
        plain = time_ms(torch, lambda: GE.plain(**case), 2)
        sizes = case["counts"].tolist()
        seg = torch.repeat_interleave(torch.arange(e, device=dev),
                                      case["counts"])
        pos = torch.arange(t * k, device=dev) - (
            torch.cumsum(case["counts"], 0) - case["counts"])[seg]

        def buckets():
            ys = M._dropless_expert_compute(
                case["xs"], seg, pos, case["counts"].tolist(), case["wi"],
                case["wg"], case["wo"], "swiglu")
            w = case["weights"].to(ys.dtype)[:, None]
            return M._combine(ys * w, case["sort_idx"], k)

        before = time_ms(torch, buckets, 3)
        evs = kernel_events(torch, lambda: [ops.grouped_experts(**case)
                                            for _ in range(5)],
                            names_all(*G1_KERNELS))
        by = {}
        for sym in G1_KERNELS:
            mine = [x for x in evs if sym in x.key]
            assert mine, (sym, [x.key for x in evs])
            by[sym] = (sum(x.self_device_time_total for x in mine) / 1e3
                       / sum(x.count for x in mine))
        log(f"[2j grouped_experts {label}] pairs an expert {min(sizes)} to "
            f"{max(sizes)} ({sizes.count(0)} empty) of {t} x {k}: max abs "
            f"err {err:.3e}, relative {rel:.3e} (tol bf16 2e-2); kernel "
            f"{ms:.4f} ms (queued; profiler {G1_KERNELS[0]} "
            f"{by[G1_KERNELS[0]]:.4f} ms + {G1_KERNELS[1]} "
            f"{by[G1_KERNELS[1]]:.4f} ms), bound {b_ms:.4f} ms ({b_by}: "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB), "
            f"{b_ms / ms:.1%} of it; plain {plain:.4f} ms; the buckets it "
            f"replaces (counts on the host) {before:.4f} ms; {card}")
        key = "" if label == "even" else "g1_skewed_"
        row.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}max_abs_err": err, f"{key}rel_err": rel,
                    f"g1_{label}_buckets_ms": before,
                    f"g1_{label}_gate_up_ms": by[G1_KERNELS[0]],
                    f"g1_{label}_down_ms": by[G1_KERNELS[1]]})
        del case, seg, pos
    torch.cuda.empty_cache()


def k3_window_work(shape, window: int, kv: int, elt: int = 2):
    """K3's (FLOPs, bytes) over keys q - k < ``window`` at (B, H, S, D):
    two products of 2D FLOPs a pair, sum over q of min(q + 1, window)
    pairs a row; q and out at H heads, k and v at ``kv``, each once."""
    b, h, s, d = shape
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    return 4.0 * d * pairs * b * h, 2 * b * (h + kv) * s * d * elt


def window_phase(torch, ops, ref, A, randn, rows) -> None:
    """Phase 2k: K3's causal window (``flash_fwd_window_kernel<D>``)
    against the plain windowed attention: every head dim in bf16 at (1, 2,
    200, D) under a window of 70 (f32 refused); at D 128 a prompt not a whole
    number of tiles, a window not a whole number of tiles, a window of 1
    and one past the prompt, which gives the causal kernel's bits; then at
    ``K3W_SHAPE`` with the model's kv heads as ``_local_attention_block``
    calls it (``attention._flash_fwd``, kv heads repeated), against the
    plain route it replaces (``attention.chunked_attention`` in float32).
    Timed (CUDA events): the kernel alone, the model's call, the plain
    route in bf16, and the causal kernel at the same shape, beside the
    window's bound (``k3_window_work``)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    card = nvidia_smi("name,power.limit")
    for d in HEAD_DIMS:
        q, k, v = (randn((1, 2, 200, d), torch.bfloat16) for _ in range(3))
        max_err(torch, ops.flash_attention(q, k, v, bq=200, bk=200,
                                           window=70),
                ref.flash_attention(q, k, v, window=70), BF16_TOL)
    q = randn((1, 2, 200, 64), torch.float32)
    try:
        ops.flash_attention(q, q, q, bq=200, bk=200, window=70)
    except ValueError:
        pass
    else:
        raise AssertionError("K3 took a window in f32")
    log(f"[2k K3 window grid] D in {HEAD_DIMS}, bf16, (1, 2, 200, D), "
        "window 70: within tol; f32 refused")
    for s, w in ((1000, 100), (1000, 64), (200, 1), (4096, 1024),
                 (100, 300), (2048, 4096)):
        q, k, v = (randn((1, 4, s, 128), torch.bfloat16) for _ in range(3))
        got = ops.flash_attention(q, k, v, bq=s, bk=s, window=w)
        err = max_err(torch, got, ref.flash_attention(q, k, v, window=w),
                      BF16_TOL)
        same = torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                    bq=s, bk=s))
        assert same == (w >= s), (s, w, same)
        log(f"[2k K3 window edge] S {s}, W {w}: err {err:.3e}"
            + ("; the causal kernel's bits" if same else ""))
    b, h, s, d = K3W_SHAPE
    q = randn((b, s, h, d), torch.bfloat16)
    k, v = (randn((b, s, K3W_KV, d), torch.bfloat16) for _ in range(2))
    blk = 1024                            # attention._pick_block(s, s)

    def plain(q=q, k=k, v=v):
        return A.chunked_attention(q, k, v, causal=True, window=K3W_WINDOW,
                                   q_block=blk, kv_block=blk)

    got = A._flash_fwd(q, k, v, causal=True, window=K3W_WINDOW)
    want = A.chunked_attention(q.float(), k.float(), v.float(), causal=True,
                               window=K3W_WINDOW, q_block=blk, kv_block=blk)
    err = max_err(torch, got, want, BF16_TOL)
    rw, rr = rel_errs(got, want)
    assert rw < K3_REL_TOL and rr < K3_REL_TOL, (rw, rr)
    del got, want
    g = h // K3W_KV
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    ms = time_ms(torch, lambda: ops.flash_attention(
        qh, kh, vh, window=K3W_WINDOW), 20)
    call = time_ms(torch, lambda: A._flash_fwd(q, k, v, causal=True,
                                               window=K3W_WINDOW), 10)
    plain_ms = time_ms(torch, plain, 3)
    causal_ms = time_ms(torch, lambda: ops.flash_attention(qh, kh, vh), 10)
    evs = kernel_events(torch, lambda: ops.flash_attention(
        qh, kh, vh, window=K3W_WINDOW), names_all("flash_fwd_window_kernel"))
    assert n_launches(evs, f"flash_fwd_window_kernel<{d}>") == 1
    assert n_launches(evs, "flash_fwd_wgmma_kernel") == 0
    flops, nbytes = k3_window_work(K3W_SHAPE, K3W_WINDOW, K3W_KV)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    rows["flash_attention"].update({
        "window_ms": ms, "window_call_ms": call, "window_plain_ms": plain_ms,
        "window_causal_ms": causal_ms, "window_bound_ms": b_ms,
        "window_max_abs_err": err, "window_rel_err": rw})
    log(f"[2k K3 window] {K3W_SHAPE} bf16, {K3W_KV} kv heads, W "
        f"{K3W_WINDOW}: err {err:.3e}, relative {rw:.3e} whole, {rr:.3e} "
        f"worst row (tol {K3_REL_TOL:g}, against f32 chunked); kernel "
        f"{ms:.4f} ms, {b_ms / ms:.1%} of its bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); the model's call "
        f"(kv heads repeated) {call:.4f} ms; the plain route it replaces "
        f"{plain_ms:.4f} ms; the causal kernel at this shape "
        f"{causal_ms:.4f} ms; {card}")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()


def mellum2_phase(torch, dev, spec) -> dict:
    """Phase 3f: mellum2-12b-a2.5b at full width cut to one period of its
    pattern (3 window layers, then 1 full), a 1 x 16384 prefill and an 8 x
    4096 decode tenant (t = 2048: the rings have wrapped) served on the H100
    model, with the launch counters set to 0 just before it. Asserted: K3
    once a layer a prefill run, a prefill step's window layers under
    ``flash_fwd_window_kernel<128>`` (3) and its full layer under
    ``flash_fwd_wgmma_kernel<128>`` (1) by symbol, G1 twice a layer a
    prefill run, D1 once a layer a decode run (3 rings and 1 full cache).
    Returns the phase's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import Job, SharedPodServer
    from repro_torch.core.profiles import h100_profile_from_costs
    from repro_torch.models import transformer as T
    full = get_config("mellum2-12b-a2.5b")
    cfg = dataclasses.replace(full, num_layers=len(full.block_pattern))
    kinds = cfg.layer_kinds()
    assert kinds == ("local", "local", "local", "attn"), kinds
    jobs = [Job("tenantM-mellum2-prefill", "mellum2-12b-a2.5b", "prefill", 2,
                1, 16384),
            Job("tenantM-mellum2-decode", "mellum2-12b-a2.5b", "decode", 2, 8,
                4096)]
    wts = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    srv = SharedPodServer(gpu_spec=spec, profile_fn=h100_profile_from_costs,
                          use_reduced=False, device="cuda")
    for job in jobs:
        srv.submit(job, params=wts, cfg=cfg)
    res = srv.drain()
    launches = dict(ops.LAUNCHES)
    assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
    pre = prefill_runs(res["rounds"], jobs[0].name)
    dec = prefill_runs(res["rounds"], jobs[1].name)
    assert launches["flash_attention"] == cfg.num_layers * pre, \
        (launches, pre)
    assert launches["grouped_experts"] == 2 * cfg.num_layers * pre, \
        (launches, pre)
    assert decode_attn_layers(cfg) == cfg.num_layers
    assert launches["decode_attention"] == cfg.num_layers * dec, \
        (launches, dec)
    step = srv._exec[jobs[0].name]
    win, causal = "flash_fwd_window_kernel<128>", "flash_fwd_wgmma_kernel<128>"
    evs = kernel_events(torch, step, lambda evs: (
        n_launches(evs, win), n_launches(evs, causal)) == (3, 1))
    counts = (n_launches(evs, win), n_launches(evs, causal))
    assert counts == (3, 1), (counts, [e.key for e in evs])
    total = sum(e.self_device_time_total for e in evs) / 1e3
    win_ms = sum(e.self_device_time_total for e in evs if win in e.key) / 1e3
    alone = time_ms(torch, step, 3)
    log(f"[serve-mellum2] one period of {full.num_layers} layers at full "
        f"width (d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, window {cfg.local_window}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}), bf16, seeded "
        f"random weights ({T.count_params(wts) / 1e9:.3f} B params): rounds "
        f"{decisions(res['rounds'])}; launches flash_attention "
        f"{launches['flash_attention']} = {cfg.num_layers} x {pre} prefill "
        f"runs, grouped_experts {launches['grouped_experts']}, "
        f"decode_attention {launches['decode_attention']} = "
        f"{cfg.num_layers} x {dec} decode runs (warm-ups included); a "
        f"prefill step: {win} x{counts[0]} ({win_ms:.3f} ms), {causal} "
        f"x{counts[1]}, device {total:.3f} ms, alone {alone:.3f} ms; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    decode_report(torch, "serve-mellum2", jobs[1].name, srv._exec[jobs[1].name],
                  decode_attn_layers(cfg))
    del srv, wts, res, step
    torch.cuda.empty_cache()
    return {name: launches.get(name, 0) for name in _build.NAMES}


def mla_decode_phase(torch, ops, ref, randn, rows) -> None:
    """Phase 2i: D2 against its plain version at each ``MLA_DECODE_SHAPES``
    shape, the latents bf16 ~ N(0, 1.5^2) below hi and N(0, 64^2) after:
    o / l within ``BF16_TOL``, m within ``DECODE_F32_TOL``, l within 5e-4
    relative, and a block with no row exactly (NEG_INF, 0, 0). At the
    dsv2lite-mixed shape: the kernel's time (CUDA events over 20 calls
    queued behind a spin) beside the bytes' bound at 3.35 TB/s and the
    plain version's time, the split counts side by side, the memory above
    what the cache holds (less than one f32 copy of it) and the profiler's
    times of the split and merge kernels. No one PyTorch call computes the
    latent form: no library time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as MLA
    card = nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    ds = get_config("deepseek-v2-lite")
    scale = ds.rope_scaling.softmax_gain / math.sqrt(
        ds.mla.qk_nope_dim + ds.mla.qk_rope_dim)

    def latents(b, s, width, valid):
        x = randn((b, s, width), torch.float32) * 1.5
        x[:, valid:] *= 64.0 / 1.5
        return x.bfloat16()

    row = rows["mla_decode"] = dict(
        source="src/repro_torch/csrc/mla_decode.cu",
        replaces="src/repro/models/attention.py:332", library_ms=None)
    for label, (b, h, s, r, dr), hi, offset in MLA_DECODE_SHAPES:
        r0, r1 = ref.decode_rows(0, hi, offset, s, False)
        q_lat = randn((b, h, r), torch.bfloat16)
        q_rope = randn((b, h, dr), torch.bfloat16)
        ckv, krope = latents(b, s, r, r1), latents(b, s, dr, r1)
        kw = dict(hi=hi, offset=offset, scale=scale)
        got = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, **kw)
        want = MLA.plain(q_lat, q_rope, ckv, krope, lo=0, **kw)
        torch.cuda.synchronize()
        if r1 == r0:
            for x, w0 in zip(got, (ref.NEG_INF, 0.0, 0.0)):
                assert bool((x == w0).all()), label
            errs = (0.0, 0.0, 0.0)
        else:
            errs = (max_err(torch, got[2] / got[1][..., None],
                            want[2] / want[1][..., None], BF16_TOL),
                    max_err(torch, got[0], want[0], DECODE_F32_TOL),
                    max_err(torch, got[1] / want[1],
                            torch.ones_like(want[1]), DECODE_F32_TOL))
        del got, want
        tiles = -(-(r1 - r0) // MLA.TILE_ROWS)
        ns = MLA.split_count(b * -(-h // MLA.HEAD_TILE), tiles,
                             MLA._slots(0, r, dr))
        log(f"[2i mla_decode {label}] q ({b}, {h}, {r} + {dr}) over ({b}, "
            f"{s}) latent rows, positions below {hi} from offset {offset}: "
            f"{r1 - r0} valid rows, {ns} splits; o / l err {errs[0]:.3e}, m "
            f"{errs[1]:.3e}, l relative {errs[2]:.3e} (tol bf16 2e-2, m and "
            f"l 5e-4); {card}")
        if label != "dsv2lite":
            row[f"mla_{label}_max_abs_err"] = errs[0]
            del q_lat, q_rope, ckv, krope
            continue
        flops, nbytes = mla_decode_work(b, h, r1 - r0, r, dr)
        b_ms, b_by = bound(flops, nbytes, "bfloat16")
        ms = queued_ms(torch, lambda: ops.mla_decode_attention(
            q_lat, q_rope, ckv, krope, **kw), 20)
        plain = time_ms(torch, lambda: MLA.plain(q_lat, q_rope, ckv, krope,
                                                 lo=0, **kw), 3)
        sweep = []
        for n in sorted({ns, 6, 11, 22, 44, 66}):
            sweep.append((n, queued_ms(torch, lambda: ops.mla_decode_attention(
                q_lat, q_rope, ckv, krope, n_splits=n, **kw), 20)))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        extra = {}
        for tag, fn in (("kernel", ops.mla_decode_attention),
                        ("plain", functools.partial(MLA.plain, lo=0))):
            torch.cuda.reset_peak_memory_stats()
            fn(q_lat, q_rope, ckv, krope, **kw)
            torch.cuda.synchronize()
            extra[tag] = torch.cuda.max_memory_allocated() - base
        assert extra["kernel"] < ckv.numel() * 4, extra     # no f32 copy
        evs = kernel_events(torch, lambda: [ops.mla_decode_attention(
            q_lat, q_rope, ckv, krope, **kw) for _ in range(5)],
            names_all(D2_KERNEL, D2_COMBINE))
        by = {}
        for sym in (D2_KERNEL, D2_COMBINE):
            mine = [e for e in evs if sym in e.key]
            assert mine, (sym, [e.key for e in evs])
            by[sym] = (sum(e.self_device_time_total for e in mine) / 1e3
                       / sum(e.count for e in mine))
        row.update(max_abs_err=errs[0], ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, splits=ns, kernel_only_ms=by[D2_KERNEL],
                   combine_ms=by[D2_COMBINE],
                   extra_mib=extra["kernel"] / 2**20,
                   plain_extra_mib=extra["plain"] / 2**20)
        log(f"[2i mla_decode {label} time] kernel {ms:.4f} ms (queued; "
            f"profiler {D2_KERNEL} {by[D2_KERNEL]:.4f} ms + {D2_COMBINE} "
            f"{by[D2_COMBINE]:.4f} ms), bound {b_ms:.4f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB), {b_ms / ms:.1%} of it; plain "
            f"{plain:.4f} ms (the path before D2 ~{EARLIER_MLA_DECODE_MS} ms "
            f"a layer); splits " + ", ".join(f"{n}: {t:.4f} ms" for n, t in
                                            sweep)
            + f" (queued); above the {base / 2**30:.3f} GiB held: kernel "
            f"{extra['kernel'] / 2**20:.2f} MiB, plain "
            f"{extra['plain'] / 2**20:.2f} MiB; {card}")
        del q_lat, q_rope, ckv, krope
    torch.cuda.empty_cache()


def decode_report(torch, label: str, name: str, fn, per_step: int,
                  earlier=None) -> None:
    """One decode step ``fn`` alone: its time (CUDA events over 3 calls),
    its device time and idle share and top kernels from the profiler, D1's
    launches (``per_step``; no other kernel of the port, asserted) and
    times, and its peak memory above what was held before it;
    ``earlier``: the step's device time before D1 (``EARLIER_DECODE_MS``)."""
    alone = time_ms(torch, fn, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    evs = kernel_events(torch, fn, lambda evs: n_launches(evs, D1_KERNEL)
                        == per_step)
    total = sum(e.self_device_time_total for e in evs) / 1e3
    assert total > 0, f"{name}: the profiler saw no device time"
    assert n_launches(evs, D1_KERNEL) == per_step, \
        (name, per_step, [e.key for e in evs])
    others = [e.key for e in evs if any(k in e.key for k in KERNEL_SYMBOLS)
              and D1_KERNEL not in e.key and D1_COMBINE not in e.key]
    assert not others, (name, others)
    d1 = {sym: sum(e.self_device_time_total for e in evs if sym in e.key)
          / 1e3 for sym in (D1_KERNEL, D1_COMBINE)}
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[{label} decode {name}] step alone {alone:.3f} ms; device time "
        f"{total:.3f} ms in {sum(e.count for e in evs)} kernels (idle "
        f"{1 - total / alone:.1%})"
        + (f", {earlier} ms before D1 (PERF.md section 5)" if earlier else "")
        + f"; D1 {D1_KERNEL} {d1[D1_KERNEL]:.3f} ms x{per_step}, "
        f"{D1_COMBINE} {d1[D1_COMBINE]:.3f} ms "
        f"x{n_launches(evs, D1_COMBINE)} ("
        f"{(d1[D1_KERNEL] + d1[D1_COMBINE]) / total:.1%}); peak memory "
        f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**20:.1f} MiB above the "
        f"{base / 2**30:.2f} GiB held; top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
            for e in top))


def training_phase(torch, dev, card) -> dict:
    """Phase 5: ``make_train_step`` at full width with the reference's
    ``OptConfig`` (f32 moments), ``TRAIN_STEPS`` steps of each
    ``TRAIN_CELLS`` arch on one fixed ``SyntheticLoader(seed=0)`` batch, one
    arch's weights at a time, with no mesh and then under the (1, 1) mesh
    of a one-rank NCCL group (made here, destroyed before ``train()``),
    bit for bit the same; then the reduced ``train()`` through a failure
    and a restore. Returns the kernel launches of the steps and of
    ``train()``."""
    import torch.distributed as dist

    import repro_torch.optim.adamw as adamw
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import recurrent as R
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T

    total = dict.fromkeys(_build.NAMES, 0)
    real_update = adamw.update
    seen = {}

    def checked_update(cfg, params, grads, state):
        """adamw.update, after a check of every gradient leaf (present,
        finite, nonzero) and timed alone."""
        named = named_leaves(grads)
        seen["grads_ok"] = torch.stack([torch.isfinite(g).all()
                                        & (g != 0).any() for _, g in named])
        seen["names"] = [n for n, _ in named]
        seen["norms"] = torch.stack([torch.linalg.vector_norm(g).float()
                                     for _, g in named])
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = real_update(cfg, params, grads, state)
        e1.record()
        seen["opt_events"] = (e0, e1)
        return out

    def run(arch, cfg, b, s, mesh=None):
        """``TRAIN_STEPS`` steps from the seeded init under ``mesh``:
        (params, state, step, batch, losses, step seconds, AdamW ms,
        launches a step, (grad norm, largest leaf, its norm) a step)."""
        params = T.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        opt_cfg = adamw.OptConfig()
        state = adamw.init(opt_cfg, params)
        step = make_train_step(cfg, opt_cfg)
        raw = SyntheticLoader(cfg, b, s, seed=0).load(0)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        losses, step_s, opt_ms, launched, norms = [], [], [], [], []
        for i in range(TRAIN_STEPS):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SH.use_mesh(mesh):
                params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            e0, e1 = seen["opt_events"]
            opt_ms.append(e0.elapsed_time(e1))
            launched.append(dict(ops.LAUNCHES))
            ok = seen["grads_ok"].tolist()
            bad = [n for n, good in zip(seen["names"], ok) if not good]
            assert not bad, f"{arch} step {i}: gradients absent, " \
                f"non-finite or zero: {bad}"
            losses.append(float(m["loss"]))
            assert math.isfinite(losses[-1]), (arch, losses)
            top = int(seen["norms"].argmax())
            norms.append((float(m["grad_norm"]), seen["names"][top],
                          float(seen["norms"][top])))
        return (params, state, step, batch, losses, step_s, opt_ms, launched,
                norms)

    def counted(launched, op, per_step, arch):
        for got in launched:
            for name in _build.NAMES:
                total[name] += got[name]
            assert got[op] == per_step and \
                sum(got.values()) == per_step, (arch, got)

    assert not dist.is_initialized(), "an earlier phase left a process group"
    mesh = make_host_mesh(1)     # a one-rank NCCL group: the (1, 1) mesh
    adamw.update = checked_update
    try:
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        for arch, depth, b, s, op, sym, per_step, falls in TRAIN_CELLS:
            full = get_config(arch)
            cfg = (dataclasses.replace(full, num_layers=depth) if depth
                   else full)
            kind = {"flash_attention": "attn", "rwkv6_scan": "rwkv6",
                    "rg_lru": "rglru"}[op]
            n_kind = cfg.layer_kinds().count(kind)
            assert cfg.remat and 2 * n_kind == per_step, (arch, n_kind)
            # the steps with no mesh first, their params kept on the host;
            # then the same steps under the (1, 1) mesh, which must split
            # and exchange nothing: the same losses and params, bit for bit
            nomesh = run(arch, cfg, b, s)
            counted(nomesh[7], op, per_step, arch)
            nomesh_losses, nomesh_s = nomesh[4], nomesh[5]
            nomesh_params = [t.cpu() for _, t in named_leaves(nomesh[0])]
            del nomesh
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, state, step, batch, losses, step_s, opt_ms, launched, \
                norms = run(arch, cfg, b, s, mesh)
            peak = torch.cuda.max_memory_allocated() / 2**30
            n_params = T.count_params(params)
            counted(launched, op, per_step, arch)
            assert losses == nomesh_losses, (arch, losses, nomesh_losses)
            leaves = named_leaves(params)
            differ = [n for (n, t), u in zip(leaves, nomesh_params)
                      if not torch.equal(t.cpu(), u)]
            assert len(leaves) == len(nomesh_params) and not differ, \
                (arch, differ)
            del nomesh_params
            log(f"[train {arch} mesh] the (1, 1) mesh over a one-rank NCCL "
                f"group against no mesh, {TRAIN_STEPS} steps each from the "
                f"same init: losses and all {len(leaves)} parameter leaves "
                f"equal bit for bit (torch.equal, asserted); step times "
                f"under the mesh {', '.join(f'{x * 1e3:.1f}' for x in step_s)}"
                f" ms, with no mesh "
                f"{', '.join(f'{x * 1e3:.1f}' for x in nomesh_s)} ms; {card}")
            if falls:
                assert losses[-1] < losses[0], (arch, losses)
            opt_bytes = adamw_bytes(params, state)

            def mesh_step():
                with SH.use_mesh(mesh):
                    return step(params, state, batch)
            evs = kernel_events(torch, mesh_step,
                                lambda evs: n_launches(evs, sym) == per_step)
            dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
            assert dev_ms > 0, f"{arch}: the profiler saw no device time"
            n_sym = n_launches(evs, sym)
            assert n_sym == per_step, (arch, sym, n_sym)
            sym_ms = sum(e.self_device_time_total for e in evs
                         if sym in e.key) / 1e3
            top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
            step_ms = median_range(step_s[1:])[0] * 1e3
            mfu = 6 * n_params * b * s / (step_ms / 1e3) / PEAK_FLOPS[
                "bfloat16"]
            opt_bound = opt_bytes / HBM_BYTES_PER_S * 1e3
            cut = (f"cut num_layers {full.num_layers} -> {depth}" if depth
                   else "uncut")
            log(f"[train {arch}] {cut}, full width, bf16 params, f32 AdamW "
                f"moments (OptConfig defaults), remat on, the (1, 1) mesh, "
                f"batch {b} x seq "
                f"{s}: {n_params / 1e9:.3f} B params; losses "
                f"{', '.join(f'{x:.4f}' for x in losses)} on one repeated "
                f"batch{' (falling, asserted)' if falls else ''}; grad norms "
                + ", ".join(f"{g:.4g} (largest {n} {x:.4g})"
                            for g, n, x in norms) + "; "
                f"{len(seen['names'])} gradient leaves present, finite and "
                f"nonzero each step; {op} launches {per_step} a step "
                f"({n_kind} layers x 2, forward and remat); step times "
                f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, median "
                f"of the later {step_ms:.1f} ms; AdamW "
                f"{', '.join(f'{x:.2f}' for x in opt_ms)} ms (CUDA events) "
                f"against its bound {opt_bound:.2f} ms ({opt_bytes / 1e9:.2f} "
                f"GB at 3.35 TB/s); training MFU 6NT/(step x 989 TFLOP/s) "
                f"{mfu:.2%}; peak memory {peak:.2f} GiB; {card}")
            log(f"[profile train {arch}] one more step profiled: device "
                f"time {dev_ms:.1f} ms in {sum(e.count for e in evs)} "
                f"kernels (idle {1 - dev_ms / step_ms:.1%} of the median "
                f"step); {sym} {sym_ms:.3f} ms x{n_sym}; top: " + "; ".join(
                    f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
            del params, state, step, batch, evs
            torch.cuda.empty_cache()
            if falls:
                continue
            # the same steps with the plain form the reference trains
            # through in place of the kernel, forward included
            real_apply = R.WKV6.apply
            R.WKV6.apply = lambda r, k, v, w, u, s0, c: R.rwkv6_chunked(
                r, k, v, w, u, s0, chunk=c)
            try:
                twin = run(arch, cfg, b, s)
            finally:
                R.WKV6.apply = real_apply
            plain = twin[4]
            assert all(sum(got.values()) == 0 for got in twin[7]), twin[7]
            assert abs(losses[0] - plain[0]) <= TWIN_LOSS_REL * plain[0], \
                (arch, losses, plain)
            log(f"[train {arch} plain] the same {TRAIN_STEPS} steps with "
                f"rwkv6_chunked in place of K4 (no kernel launched): losses "
                f"{', '.join(f'{x:.4f}' for x in plain)} (K4's "
                f"{', '.join(f'{x:.4f}' for x in losses)}; first within "
                f"{TWIN_LOSS_REL:g}); step times "
                f"{', '.join(f'{x * 1e3:.1f}' for x in twin[5])} ms")
            del twin
            torch.cuda.empty_cache()
    finally:
        adamw.update = real_update
        dist.destroy_process_group()
    # the reference's test_train_loop_end_to_end on the card, with a
    # restore that loads a checkpoint: ckpt_every is max(8 // 4, 5) = 5,
    # so step 5 is saved before the failure at 6 and run once more after.
    # Each step's batch is another draw of uniform tokens, and the losses of
    # two batches differ by ~0.1 (the first and last run's fall or rise with
    # the seed, on the CPU too), so the fall is asserted on one batch, the
    # first, before and after training
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res = train("stablelm-3b", use_reduced=True, steps=8, batch=4,
                    seq=32, ckpt_dir=ckpt_dir, fail_at={6: 1}, device=dev)
        files = sorted(p.name for p in Path(ckpt_dir).iterdir())
    for name in _build.NAMES:
        total[name] += ops.LAUNCHES[name]
    losses = res["losses"]
    assert res["steps"] == 8 and len(losses) == 9, (res["steps"], losses)
    assert losses[5] == losses[6], ("step 5 after the restore", losses)
    assert files == ["ckpt_00000005.npz", "ckpt_00000008.npz",
                     "manifest.json"], files
    n_k3 = ops.LAUNCHES["flash_attention"]
    assert n_k3 == 9 * res["cfg"].num_layers, n_k3
    cfg = res["cfg"]
    first = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticLoader(cfg, 4, 32, seed=0).load(0).items()}
    init = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    with torch.no_grad():
        before = float(T.train_loss(init, cfg, first)[0])
        after = float(T.train_loss(res["params"], cfg, first)[0])
    assert abs(before - losses[0]) <= 1e-4 * before and after < before, \
        (before, after, losses)
    log(f"[train loop] train('stablelm-3b', use_reduced=True, steps=8, "
        f"batch=4, seq=32, fail_at={{6: 1}}) on the card: {res['steps']} "
        f"steps, 9 runs (step 5 restored from its checkpoint and run again, "
        f"its loss the same, {losses[6]:.4f}), losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; the first batch's loss "
        f"{before:.4f} -> {after:.4f} after training (asserted to fall); "
        f"checkpoints {files}, flash_attention launches {n_k3} (9 runs x "
        f"{cfg.num_layers} layers, no remat in the reduced config), "
        f"{res['seconds']:.2f} s")
    return total


# phase 6: DeepSeek-V2 at full width cut to DS_DEPTH layers. Its seeded
# weights route most of a prompt's tokens to a few experts (on the card a
# group of 8192 sent 7871 of them to one expert: the hidden states share a
# direction, cosine 0.6-0.96 to their mean), so no pair is dropped only
# when an expert's capacity is the whole group (capacity factor E / k),
# and then the ungrouped (E, C, D) buckets of 16384 tokens would need ~100
# GB. So the grouped MoE runs at 1 x MESH_PROMPT with moe_group MESH_GROUP
# (``specs.moe_group_size``'s cap: two groups) and 0 at EP_CF, its drops
# counted, and is held to the ungrouped one at 1 x EQUAL_PROMPT with
# moe_group EQUAL_GROUP (two groups) at capacity factor E / k, where none
# drops (asserted by counting each group's loads against its capacity).
# EP runs on EP_TOKENS random rows, whose routing is near even, at EP_CF.
MESH_PROMPT = 16384
MESH_GROUP = 8192
EQUAL_PROMPT = 4096
EQUAL_GROUP = 2048
EP_TOKENS = 2048
EP_CF = 4.0
# grouped against ungrouped MoE, in bf16 with no pair dropped: the products
# differ only in bf16 rounding (the buckets' shapes differ, so the GEMMs'
# do), and a token's k = 6 expert outputs, tens in size, can cancel to a
# small sum, so an element's own relative error is no measure; held as
# bf16's 2e-2 of the output's largest value and of its norm
GROUPED_TOL = 2e-2
# the sharded restore's depth: the 4-layer params' npz (f32, 53 GB) is more
# than the 45 GiB a run may write to the chip machine's disk; 1 dense + 1
# MoE layer, every kind of leaf at full width, is 21 GB
RESTORE_DEPTH = 2
# int8 EP against moe_ffn, in quantization steps (1 / 127 of a row's
# largest value) of the routed part's largest value, over the bf16 bound
# (GROUPED_TOL): each of the two trips rounds an element by at most half a
# step of its row; the return trip's error reaches the output as it is
# (the k pairs' weights sum to 1), the dispatch's through the expert, whose
# two projections (wi, wg) both see it. Two steps a trip (a CPU rehearsal
# at the reduced width came to 1.96 steps), and as much of the norm
INT8_STEPS = 4
# moe_ffn at EP_TOKENS with the index_add_ combine that the fixed-order one
# replaced (phase 6 on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6)
EARLIER_MOE_FFN_MS = 7.123
# phase 6's train steps of reduced DeepSeek-V2 on the (1, 1) mesh
DP_BATCH, DP_SEQ = 4, 64


def _drop_counter(torch, M, seen):
    """``moe.moe_ffn``'s per-group routine, counting each group's pairs
    past its capacity into ``seen`` before it runs the group, and keeping
    the first call's input and weights (the first MoE layer's)."""
    real = M._moe_tokens

    def counted(x2d, p, cfg, *block, **kw):
        seen.setdefault("first", (x2d, p))
        m = cfg.moe
        _, top_i, _ = M._route(x2d, p["router"], m)
        load = torch.bincount(top_i.reshape(-1), minlength=m.num_experts)
        cap = max(int(math.ceil(x2d.shape[0] * m.top_k / m.num_experts
                                * m.capacity_factor)), 4)
        seen["dropped"] = seen["dropped"] + (load - cap).clamp(min=0).sum()
        seen["max_load"] = torch.maximum(seen["max_load"], load.max())
        seen["groups"].append((int(x2d.shape[0]), cap))
        return real(x2d, p, cfg, *block, **kw)
    return real, counted


def ep_backward(torch, M, T, x, p, cfg, group, card) -> None:
    """Phase 6's EP backward at world size 1: the gradients of x, the
    router, the experts and the shared expert through ``moe_ffn_ep`` (the
    NCCL all-to-all's autograd Function) against autograd through
    ``moe_ffn``, on the same rows and weights, each leaf held to
    GROUPED_TOL of its largest value and of its norm and freed after, and
    ``moe_ffn_ep``'s run again repeats bit for bit; the int8 exchange
    under autograd raises (fault 14). Forward plus backward timed for
    both routes, with the peak memory."""
    import dataclasses
    m = cfg.moe
    ct = torch.randn(x.shape, generator=torch.Generator(
        device=x.device).manual_seed(7), device=x.device).to(x.dtype)
    routes = {"moe_ffn": lambda xx, pp: M.moe_ffn(xx, pp, cfg),
              "moe_ffn_ep": lambda xx, pp: M.moe_ffn_ep(xx, pp, cfg,
                                                        group=group)}

    def grads(route):
        xx = x.detach().requires_grad_()
        pp = T._tree_map(lambda w: w.detach().requires_grad_(), p)
        out, aux = routes[route](xx, pp)
        loss = (out.float() * ct.float()).sum() + 3.0 * aux
        named = [("x", xx)] + [(k[1:], v) for k, v in named_leaves(pp)]
        return dict(zip([k for k, _ in named], torch.autograd.grad(
            loss, [v for _, v in named])))

    timed, peak = {}, {}
    for route in routes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed[route] = time_ms(torch, lambda r=route: grads(r), 3)
        peak[route] = torch.cuda.max_memory_allocated() / 2**30
    want, got = grads("moe_ffn"), grads("moe_ffn_ep")
    assert set(got) == set(want) == {
        "x", "router", "wi", "wg", "wo", "shared/wi", "shared/wg",
        "shared/wo"}, sorted(got)
    # ranks that train together stay in step only if a backward repeats
    again = grads("moe_ffn_ep")
    for name in list(again):
        assert torch.equal(again.pop(name), got[name]), name
    errs = {}
    for name in list(want):
        w, g = want.pop(name).float(), got.pop(name).float()
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        rel = float((g - w).norm() / w.norm())
        assert scale > 0 and err <= GROUPED_TOL * scale, (name, err, scale)
        assert rel <= GROUPED_TOL, (name, rel)
        errs[name] = (err / scale, rel)
        del w, g
    int8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, a2a_dtype="int8"))
    try:
        M.moe_ffn_ep(x.detach().requires_grad_(), p, int8, group=group)
        raise AssertionError("int8 EP under autograd did not raise")
    except NotImplementedError as e:
        assert "fault 14" in str(e), e
    log(f"[mesh ep backward] moe_ffn_ep under autograd at world size 1 "
        f"(NCCL all_to_all_single both ways), E {m.num_experts} top-"
        f"{m.top_k} D {cfg.d_model} F {m.d_ff_expert} "
        f"{m.num_shared_experts} shared, {x.shape[1]} tokens, capacity "
        f"factor {m.capacity_factor}, loss sum(out * ct) + 3 aux: against "
        f"autograd through moe_ffn, per leaf (max abs err / max |grad|, "
        f"error norm / norm; bound {GROUPED_TOL} each) "
        + ", ".join(f"{k} {a:.2e}/{r:.2e}" for k, (a, r) in errs.items())
        + f"; run again, every leaf torch.equal (asserted); int8 under "
        f"autograd raises (fault 14); forward + backward "
        f"{timed['moe_ffn_ep']:.3f} ms (moe_ffn {timed['moe_ffn']:.3f} ms), "
        f"peak memory {peak['moe_ffn_ep']:.2f} GiB (moe_ffn "
        f"{peak['moe_ffn']:.2f} GiB), the phase's weights included; CUDA "
        f"events ({card})")


def mesh_phase(torch, dev, card) -> dict:
    """Phase 6: the mesh layer and the expert-parallel MoE on a (1, 1)
    ``DeviceMesh`` over a one-rank NCCL group, made here and destroyed at
    the end. ``input_specs`` for DeepSeek-V2 (``DS_DEPTH`` layers) at
    prefill_32k and decode_32k; the full-width grouped MoE over a
    ``MESH_PROMPT``-token prompt under ``use_mesh``, with and without
    ``moe_group``, K3 <192> once a layer in each, and held to the
    ungrouped one where no pair drops; ``moe_ffn_ep`` and
    ``moe_ffn_ep_sharded`` (NCCL's all-to-all at world size 1, bf16 and
    int8) against ``moe_ffn`` on ``EP_TOKENS`` tokens; the params saved
    and restored with ``param_shardings``, bit for bit; reduced
    DeepSeek-V2's train step under the mesh against the step with none,
    bit for bit. Returns the kernel launches of the forwards and the
    steps."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.data.synthetic import SyntheticLoader
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import specs as SP
    from repro_torch.launch.dryrun import _leaves, argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    assert not dist.is_initialized(), "an earlier phase left a process group"
    mesh = make_host_mesh(1)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        assert tuple(mesh.shape) == (1, 1), mesh
        full = get_config("deepseek-v2-236b")
        cfg = dataclasses.replace(full, num_layers=DS_DEPTH)

        # shardings on the card
        for name in ("prefill_32k", "decode_32k"):
            args, shardings = SP.input_specs(cfg, SHAPES[name], mesh)
            specs = [sh.spec for sh in _leaves(shardings)]
            whole = sum(a.numel() * a.element_size() for a in _leaves(args))
            per_device = argument_bytes(args, shardings)
            assert not any(e is not None for sp in specs for e in sp), name
            assert per_device == whole, (name, per_device, whole)
            log(f"[mesh] input_specs {cfg.name} ({DS_DEPTH} layers) {name} "
                f"on the (1, 1) DeviceMesh over NCCL: {len(specs)} specs, "
                f"none sharded; argument bytes a device "
                f"{per_device / 2**30:.3f} GiB (= the whole)")

        # the grouped MoE at full width
        params = T.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        gen = torch.Generator(device=dev).manual_seed(6)
        m = cfg.moe
        launches = dict.fromkeys(_build.NAMES, 0)
        logits = {}
        no_drop = m.num_experts / m.top_k     # capacity = a group's tokens
        for n_tok, group, cf in ((MESH_PROMPT, MESH_GROUP, EP_CF),
                                 (MESH_PROMPT, 0, EP_CF),
                                 (EQUAL_PROMPT, EQUAL_GROUP, no_drop),
                                 (EQUAL_PROMPT, 0, no_drop),
                                 (EQUAL_PROMPT, -1, no_drop)):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                m, capacity_factor=cf))
            tokens = torch.randint(0, cfg.vocab_size, (1, n_tok),
                                   generator=torch.Generator(
                                       device=dev).manual_seed(6),
                                   device=dev)
            seen = {"dropped": torch.zeros((), dtype=torch.long, device=dev),
                    "max_load": torch.zeros((), dtype=torch.long,
                                            device=dev), "groups": []}
            real, counted = _drop_counter(torch, M, seen)
            M._moe_tokens = counted
            try:
                with SH.use_mesh(mesh):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    ops.reset_launches()
                    t0 = time.time()
                    lg, _, aux = T.forward(params, c, {"tokens": tokens},
                                           moe_group=max(group, 0))
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                    for name in _build.NAMES:
                        launches[name] += ops.LAUNCHES[name]
                    flash = ops.LAUNCHES["flash_attention"]
            finally:
                M._moe_tokens = real
            peak = torch.cuda.max_memory_allocated() / 2**30
            dropped = int(seen["dropped"])
            assert flash == cfg.num_layers, (n_tok, group, flash)
            assert tuple(lg.shape) == (1, n_tok, cfg.vocab_size)
            assert bool(torch.isfinite(lg.float()).all()), (n_tok, group)
            if n_tok == EQUAL_PROMPT:
                assert dropped == 0, (group, dropped)
                logits[group] = lg
                moe_in = seen["first"]
            caps = sorted(set(seen["groups"]))
            log(f"[mesh grouped] {cfg.name} full width, {DS_DEPTH} layers, "
                f"1 x {n_tok} tokens, moe_group={max(group, 0)}"
                f"{' (again)' if group < 0 else ''}, capacity factor "
                f"{cf:.4f}: groups (tokens, capacity) {caps} x "
                f"{len(seen['groups']) // len(caps)}, largest expert load "
                f"{int(seen['max_load'])}, {dropped} pairs dropped; aux "
                f"{float(aux):.6f}; flash_attention launches {flash}; "
                f"forward {wall * 1e3:.1f} ms (host clock, first call); "
                f"peak memory {peak:.2f} GiB")
            del lg
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=EP_CF))
        tokens = torch.randint(0, cfg.vocab_size, (1, MESH_PROMPT),
                               generator=gen, device=dev)
        with SH.use_mesh(mesh):
            evs = kernel_events(torch, lambda: T.forward(
                params, c, {"tokens": tokens}, moe_group=MESH_GROUP),
                lambda evs: n_launches(evs, "flash_fwd_wgmma_kernel<192>")
                == cfg.num_layers)
        n_k3 = n_launches(evs, "flash_fwd_wgmma_kernel<192>")
        assert n_k3 == cfg.num_layers, (n_k3, [e.key for e in evs])
        k3_ms = sum(e.self_device_time_total for e in evs
                    if "flash_fwd_wgmma_kernel<192>" in e.key) / 1e3
        total = sum(e.self_device_time_total for e in evs) / 1e3
        # the first MoE layer, grouped against ungrouped, on the input the
        # ungrouped forward gave it: the same products up to bf16 rounding
        x_moe, p_moe = moe_in
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=no_drop))
        with torch.inference_mode():
            got = M.moe_ffn(x_moe[None], p_moe, c, group_size=EQUAL_GROUP)[0]
            want = M.moe_ffn(x_moe[None], p_moe, c)[0]
        scale = float(want.float().abs().max())
        moe_diff = float((got.float() - want.float()).abs().max())
        moe_rel = float((got.float() - want.float()).norm()
                        / want.float().norm())
        assert moe_diff <= GROUPED_TOL * scale, (moe_diff, scale)
        assert moe_rel <= GROUPED_TOL, moe_rel
        rel = {k: float((logits[k].float() - logits[0].float()).norm()
                        / logits[0].float().norm())
               for k in (EQUAL_GROUP, -1)}
        # the combine sums each token's k rows in a fixed order (fault 13)
        assert torch.equal(logits[-1], logits[0]), rel[-1]
        log(f"[mesh grouped] moe_group={EQUAL_GROUP} against 0 at 1 x "
            f"{EQUAL_PROMPT}, no pair dropped: the first MoE layer's output "
            f"on its input in the forward, max abs diff {moe_diff:.4f} of "
            f"max |out| {scale:.2f} (bound {GROUPED_TOL} of it), error norm "
            f"{moe_rel:.2e} of its norm (bound {GROUPED_TOL}); the logits' "
            f"error norm {rel[EQUAL_GROUP]:.4f} of theirs (the buckets' "
            f"bf16 GEMM shapes differ: not asserted), and the same "
            f"ungrouped forward run twice {rel[-1]:.4f}: torch.equal "
            f"(asserted; the combine has no atomics); profiled at 1 x "
            f"{MESH_PROMPT}, "
            f"moe_group={MESH_GROUP}: device time {total:.3f} ms, "
            f"flash_fwd_wgmma_kernel<192> x{n_k3} {k3_ms:.3f} ms ({card})")
        del logits, moe_in, x_moe, got, want

        # EP at full width on one rank
        p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
             for k, v in params["stage1"]["sub0"]["moe"].items()}
        cfg_ep = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=EP_CF))
        x = torch.randn(1, EP_TOKENS, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        top_i = M._route(x.reshape(-1, cfg.d_model), p["router"], m)[1]
        load = int(torch.bincount(top_i.reshape(-1),
                                  minlength=m.num_experts).max())
        cap_e = int(math.ceil(EP_TOKENS * m.top_k / m.num_experts * EP_CF))
        assert load <= cap_e, (load, cap_e)
        group_model = mesh.get_group("model")
        timed = {}
        with torch.inference_mode():
            want, want_aux = M.moe_ffn(x, p, cfg_ep)
            routed = float((want.float() - L.mlp(x, p["shared"], cfg.act)
                            .float()).abs().max())
            scale = float(want.float().abs().max())
            timed["moe_ffn"] = time_ms(torch, lambda: M.moe_ffn(x, p, cfg_ep),
                                       5)
            for a2a in ("bf16", "int8"):
                c = dataclasses.replace(cfg_ep, moe=dataclasses.replace(
                    cfg_ep.moe, a2a_dtype=a2a))
                # bf16 as the grouped MoE is held; int8 adds its rounding
                steps = 0 if a2a == "bf16" else INT8_STEPS
                bound = GROUPED_TOL * scale + steps * routed / 127
                bound_rel = GROUPED_TOL + steps / 127
                for route, fn in (
                        ("moe_ffn_ep", lambda c=c: M.moe_ffn_ep(
                            x, p, c, group=group_model)),
                        ("moe_ffn_ep_sharded", lambda c=c:
                         M.moe_ffn_ep_sharded(x, p, c, mesh))):
                    out, aux = fn()
                    err = float((out.float() - want.float()).abs().max())
                    rel = float((out.float() - want.float()).norm()
                                / want.float().norm())
                    assert err <= bound and rel <= bound_rel, \
                        (route, a2a, err, bound, rel, bound_rel)
                    assert abs(float(aux) - float(want_aux)) <= \
                        1e-3 * abs(float(want_aux)), (route, a2a)
                    ms = time_ms(torch, fn, 5)
                    timed[f"{route}_{a2a}"] = ms
                    log(f"[mesh ep] {route} a2a {a2a} at world size 1 "
                        f"(NCCL all_to_all_single), E {m.num_experts} top-"
                        f"{m.top_k} D {cfg.d_model} F {m.d_ff_expert} "
                        f"{m.num_shared_experts} shared, {EP_TOKENS} tokens, "
                        f"capacity factor {EP_CF} (largest expert load "
                        f"{load} <= {cap_e}): against moe_ffn max abs err "
                        f"{err:.4f} of max |out| {scale:.2f} (bound "
                        f"{bound:.4f}; {err / (routed / 127):.2f} steps of "
                        f"the routed part's max {routed:.4f}), error norm "
                        f"{rel:.2e} of its norm (bound {bound_rel:.4f}); "
                        f"send buffers "
                        f"{M.ep_send_bytes(c, EP_TOKENS, 1, 2) / 2**20:.2f}"
                        f" MiB a layer; {ms:.3f} ms against moe_ffn "
                        f"{timed['moe_ffn']:.3f} ms (CUDA events; {card})")

        log(f"[mesh moe_ffn] {cfg.name}'s MoE layer on {EP_TOKENS} tokens "
            f"at capacity factor {EP_CF}: {timed['moe_ffn']:.3f} ms with the "
            f"fixed-order combine, against {EARLIER_MOE_FFN_MS} ms with the "
            f"index_add_ combine it replaced (NVIDIA H100 80GB HBM3, 700.00 "
            f"W); CUDA events ({card}); no gain is claimed")
        ep_backward(torch, M, T, x, p, cfg_ep, group_model, card)
        del x, p, want, out

        # sharded restore, of the params cut to RESTORE_DEPTH layers (views)
        n_moe = RESTORE_DEPTH - m.first_dense_layers
        cut = dict(params, stage1=T._tree_map(lambda a: a[:n_moe],
                                              params["stage1"]))
        sh = SH.param_shardings(cut, mesh)
        nbytes = sum(a.numel() * 4 for a in _leaves(cut))
        with tempfile.TemporaryDirectory() as tmp:
            free = shutil.disk_usage(tmp).free
            assert free > 1.2 * nbytes, (free, nbytes)
            t0 = time.time()
            store.save(tmp, 1, cut)
            t_save = time.time() - t0
            t0 = time.time()
            got, step = store.restore(tmp, cut, shardings=sh)
            torch.cuda.synchronize()
            t_restore = time.time() - t0
        pairs = list(zip(_leaves(cut), _leaves(got)))
        assert step == 1 and len(pairs) == len(_leaves(sh))
        for a, b in pairs:
            assert type(b) is torch.Tensor and b.device == a.device
            assert b.dtype == a.dtype and torch.equal(a, b)
        log(f"[mesh restore] {len(pairs)} leaves of {cfg.name} "
            f"({RESTORE_DEPTH} layers, {nbytes / 4 / 2**30 * 2:.2f} GiB bf16, "
            f"{nbytes / 2**30:.2f} GiB as the npz's f32) saved in "
            f"{t_save:.1f} s and restored with param_shardings on the (1, 1) "
            f"mesh in {t_restore:.1f} s: every leaf a plain tensor on the "
            f"card, bit for bit")
        del params, cut, got, pairs
        torch.cuda.empty_cache()

        # the train step on the mesh: at world size 1 the dp block is the
        # whole batch and nothing is exchanged, so it is the step with no
        # mesh, bit for bit
        red = reduced(full)
        opt = adamw.OptConfig(warmup_steps=1)
        loader = SyntheticLoader(red, DP_BATCH, DP_SEQ, seed=0)
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in loader.load(i).items()}
                   for i in range(TRAIN_STEPS)]
        runs = {}
        for key, on in (("none", None), ("mesh", mesh)):
            pp = T.init_params(red, torch.Generator(
                device=dev).manual_seed(0), device=dev)
            st = adamw.init(opt, pp)
            step = make_train_step(red, opt)
            losses = []
            ops.reset_launches()
            with SH.use_mesh(on):
                for b in batches:
                    pp, st, met = step(pp, st, b)
                    losses.append(float(met["loss"]))
            for name in _build.NAMES:
                launches[name] += ops.LAUNCHES[name]
            flash = ops.LAUNCHES["flash_attention"]
            runs[key] = (losses, [t for _, t in named_leaves(
                {"p": pp, "mu": st["mu"], "nu": st["nu"]})])
        assert flash == TRAIN_STEPS * red.num_layers, flash
        assert runs["mesh"][0] == runs["none"][0], runs
        assert all(torch.equal(a, b) for a, b in zip(runs["mesh"][1],
                                                     runs["none"][1]))
        log(f"[mesh train] reduced {full.name} (bf16, {red.num_layers} "
            f"layers, MLA + MoE), make_train_step for {TRAIN_STEPS} steps "
            f"of {DP_BATCH} x {DP_SEQ} under the (1, 1) mesh and with no "
            f"mesh: losses {', '.join(f'{x:.4f}' for x in runs['mesh'][0])}"
            f" and all {len(runs['mesh'][1])} param and moment leaves equal "
            f"bit for bit (asserted); flash_attention {flash} launches in "
            f"each run")
        return launches
    finally:
        dist.destroy_process_group()


def _fill_batch(torch, T, big, small) -> None:
    """Every row of the caches ``big`` set to ``small``'s one row (the
    batch dim, after each leaf's stacked layer dim; a ring's ``pos`` is
    copied as it is)."""
    with torch.inference_mode():
        T._zip_map(lambda b, s, _: b.copy_(s.expand_as(b)), big, small)


def serving_mesh_phase(torch, dev, card) -> dict:
    """Phase 8: ``make_prefill_step`` and ``make_serve_step`` under a
    (1, 1) ``DeviceMesh`` over a one-rank NCCL group, made here and
    destroyed at the end, against the same calls with no mesh, at full
    width (``SERVE_MESH``): a prefill of 1 x ``SERVE_PROMPT`` into a
    1 x ``SERVE_LEN`` cache, then ``SERVE_STEPS`` decode steps of
    ``SERVE_BATCH`` rows over a ``SERVE_BATCH`` x ``SERVE_LEN`` cache
    whose rows are that prompt's. Under the mesh every logit and every
    cache leaf is ``torch.equal`` to no mesh's (m = d = 1 cuts nothing, and
    the caches ``init_decode_caches`` allocates there are whole), the
    logits finite and of their shapes, each prefill launches its kernel
    once a layer of its kind and nothing else, and each decode step D1
    (``decode_attention``) once an attn or local layer (none for
    DeepSeek-V2's absorbed MLA decode) and nothing else. Then times a
    prefill
    and a decode step of each, in turns (``SERVE_ORDER``; host clock
    around synchronised calls), and prints the medians side by side, and
    the per-rank cache bytes
    ``shard_bytes`` counts on a ``SERVE_SPLIT`` ``ShapeMesh`` beside the
    whole cache's. Returns the kernel launches of both runs."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T

    total = dict.fromkeys(_build.NAMES, 0)
    assert not dist.is_initialized(), "an earlier phase left a process group"
    mesh = make_host_mesh(1)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        assert tuple(mesh.shape) == (1, 1), mesh
        split = SH.ShapeMesh(("data", "model"), SERVE_SPLIT)
        for arch, depth, op, kind in SERVE_MESH:
            full = get_config(arch)
            cfg = full if depth is None else dataclasses.replace(
                full, num_layers=depth)
            n_kernel = cfg.layer_kinds().count(kind)
            n_dec = decode_attn_layers(cfg)
            n_mla = mla_decode_layers(cfg)
            params = T.init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), device=dev)
            gen = torch.Generator(device=dev).manual_seed(8)
            prompt = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT),
                                   generator=gen, device=dev)
            toks = torch.randint(0, cfg.vocab_size,
                                 (SERVE_STEPS, SERVE_BATCH), generator=gen,
                                 device=dev)
            meta = T.init_decode_caches(cfg, SERVE_BATCH, SERVE_LEN,
                                        device="meta")
            leaves = named_leaves(meta)
            specs = dict(named_leaves(SH.cache_shardings(meta, split)))
            whole = sum(t.numel() * t.element_size() for _, t in leaves)
            per_rank = sum(SH.shard_bytes(t, specs[n]) for n, t in leaves)
            log(f"[serve mesh bytes] {arch}"
                f"{'' if depth is None else f' ({depth} layers)'} decode "
                f"caches {SERVE_BATCH} x {SERVE_LEN}: whole "
                f"{whole / 1e9:.4f} GB; a rank of a {SERVE_SPLIT} ShapeMesh "
                f"{per_rank / 1e9:.4f} GB (shard_bytes of cache_shardings, "
                f"{per_rank / whole:.4f} of the whole); {card}")
            prefill = make_prefill_step(cfg, max_len=SERVE_LEN)
            serve = make_serve_step(cfg, max_len=SERVE_LEN)
            runs = {}
            for label, m in (("no mesh", None), ("(1, 1) mesh", mesh)):
                with SH.use_mesh(m):
                    one = T.init_decode_caches(cfg, 1, SERVE_LEN,
                                               device=dev)
                    many = T.init_decode_caches(cfg, SERVE_BATCH, SERVE_LEN,
                                                device=dev)
                    ops.reset_launches()
                    lg, one = prefill(params, one, {"tokens": prompt})
                    pre_launches = dict(ops.LAUNCHES)
                    _fill_batch(torch, T, many, one)
                    logits = [lg]
                    for i in range(SERVE_STEPS):
                        lg, many = serve(params, many, toks[i],
                                         SERVE_PROMPT + i)
                        logits.append(lg)
                    torch.cuda.synchronize()
                    dec_launches = {k: ops.LAUNCHES[k] - pre_launches[k]
                                    for k in _build.NAMES}
                assert pre_launches[op] == n_kernel and sum(
                    pre_launches.values()) == n_kernel, (arch, pre_launches)
                assert dec_launches == {**dict.fromkeys(_build.NAMES, 0),
                                        "decode_attention":
                                        n_dec * SERVE_STEPS,
                                        "mla_decode":
                                        n_mla * SERVE_STEPS}, \
                    (arch, dec_launches)
                for name in _build.NAMES:
                    total[name] += pre_launches[name] + dec_launches[name]
                assert tuple(logits[0].shape) == (1, SERVE_PROMPT,
                                                  cfg.vocab_size)
                for lg in logits:
                    assert bool(torch.isfinite(lg.float()).all()), arch
                assert all(tuple(lg.shape) == (SERVE_BATCH, cfg.vocab_size)
                           for lg in logits[1:])
                runs[label] = (m, logits, one, many)
            (_, want, one0, many0), (_, got, one1, many1) = (
                runs["no mesh"], runs["(1, 1) mesh"])
            assert all(torch.equal(g, w) for g, w in zip(got, want)), arch
            got_c = named_leaves(one1) + named_leaves(many1)
            want_c = named_leaves(one0) + named_leaves(many0)
            assert [n for n, _ in got_c] == [n for n, _ in want_c]
            for (name, g), (_, w) in zip(got_c, want_c):
                assert torch.equal(g, w), (arch, name)
            # the times, after those first calls, in turns: the prefill
            # again into its cache, and one more decode step (t = the next
            # row, rewritten each time)
            times = {label: ([], []) for label in runs}
            for label in SERVE_ORDER:
                m, _, one, many = runs[label]
                with SH.use_mesh(m):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prefill(params, one, {"tokens": prompt})
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    serve(params, many, toks[-1], SERVE_PROMPT + SERVE_STEPS)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                times[label][0].append(1e3 * (t1 - t0))
                times[label][1].append(1e3 * (t2 - t1))
            (p0, d0), (p1, d1) = ([median_range(x) for x in times[label]]
                                  for label in runs)
            log(f"[serve mesh] {arch}"
                f"{'' if depth is None else f' ({depth} layers)'} full "
                f"width, bf16: prefill 1 x {SERVE_PROMPT} median no mesh "
                f"{p0[0]:.3f} ms ({p0[1]:.3f}-{p0[2]:.3f}) | (1, 1) mesh "
                f"{p1[0]:.3f} ms ({p1[1]:.3f}-{p1[2]:.3f}); decode step "
                f"{SERVE_BATCH} x {SERVE_LEN} median no mesh {d0[0]:.3f} ms "
                f"({d0[1]:.3f}-{d0[2]:.3f}) | (1, 1) mesh {d1[0]:.3f} ms "
                f"({d1[1]:.3f}-{d1[2]:.3f}); {len(times['no mesh'][0])} "
                f"calls each, in turns {SERVE_ORDER[:4]} (host clock, "
                f"synchronised); {op} {n_kernel} launches a prefill, "
                f"decode_attention {n_dec} a decode step and no other "
                f"kernel; {len(got)} logits (prefill, {SERVE_STEPS} "
                f"decode steps at t = {SERVE_PROMPT}.."
                f"{SERVE_PROMPT + SERVE_STEPS - 1}) and {len(got_c)} cache "
                f"leaves torch.equal to no mesh; {card}")
            del params, runs, want, want_c, got, got_c, meta, leaves, \
                one0, one1, many0, many1, one, many
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


def examples_phase(torch, card) -> dict:
    """Phase 7: the port's three examples (``repro_torch.examples``) on the
    card, in this process, in a fresh working directory (their checkpoints
    and stores land there), each under the profiler with its printed lines
    logged, and its kernels counted exactly from the code: quickstart's
    256 x 256 f32 sliced matmul at slice size 2 is 4 tiles in 2 launches
    of K1's f32 kernel, and its 10 training steps of reduced phi3-mini run
    K3 once an attn layer a step (remat off; the backward is plain);
    multi_tenant_serving's demo runs K3 once an attn layer per prefill run
    of its phi3-mini tenant, K4's two passes once an rwkv6 layer per
    prefill run of its rwkv6 tenant, and D1 once an attn layer per decode
    run of its starcoder2 tenant (DeepSeek-V2's absorbed decode runs
    none); fault_tolerant_training runs K3 once an attn layer per step it
    runs, its reruns after each restart included, and neither example
    that trains runs D1. Quickstart's own measured
    error of K1 against ``ref.matmul`` is held to F32_TOL's atol (phase
    2b holds K1 at its shape too, and phase 2a K3 at D = 32). Returns the
    launches."""
    import contextlib
    import io
    import os

    from repro_torch.configs import get_config, reduced
    from repro_torch.examples import fault_tolerant_training as FT
    from repro_torch.examples import multi_tenant_serving as MTS
    from repro_torch.examples import quickstart as QS
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import DEMO_JOBS

    def attn(arch):
        cfg = reduced(get_config(arch))
        assert not cfg.remat, arch
        return (cfg.layer_kinds().count("attn"),
                f"flash_fwd_wgmma_kernel<{cfg.head_dim}>")
    n_phi3, k3_phi3 = attn("phi3-mini-3.8b")
    n_slm, k3_slm = attn("stablelm-3b")
    n_wkv = reduced(get_config("rwkv6-1.6b")).layer_kinds().count("rwkv6")
    k1_f32 = "sliced_matmul_kernel"
    tenant = {arch: name for name, arch, _, _ in DEMO_JOBS}
    decoders = [arch for _, arch, phase, _ in DEMO_JOBS if phase == "decode"]
    n_dec = {arch: decode_attn_layers(reduced(get_config(arch)))
             for arch in decoders}
    assert n_dec["deepseek-v2-236b"] == 0 < n_dec["starcoder2-15b"], n_dec

    def want_quickstart(res):
        return {k1_f32: 2, "sliced_matmul_wgmma_kernel": 0,
                k3_phi3: res["steps"] * n_phi3, D1_KERNEL: 0}

    def want_serving(res):
        runs = {arch: prefill_runs(res["rounds"], tenant[arch])
                for arch in tenant}
        return {k3_phi3: n_phi3 * runs["phi3-mini-3.8b"],
                "flash_fwd": n_phi3 * runs["phi3-mini-3.8b"],
                **{k: n_wkv * runs["rwkv6-1.6b"] for k in K4_KERNELS},
                D1_KERNEL: sum(n_dec[arch] * runs[arch] for arch in decoders)}

    def want_ft(res):
        assert res["res"]["steps"] == 16
        return {k3_slm: len(res["res"]["losses"]) * n_slm, D1_KERNEL: 0}

    launches = dict.fromkeys(_build.NAMES, 0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name, fn, want in (
                    ("quickstart", lambda: QS.main([]), want_quickstart),
                    ("multi_tenant_serving", lambda: MTS.main([]),
                     want_serving),
                    ("fault_tolerant_training", lambda: FT.main([]),
                     want_ft)):
                run = {}

                def go(fn=fn, run=run):
                    buf = io.StringIO()
                    ops.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    with contextlib.redirect_stdout(buf):
                        run["res"] = fn()
                    torch.cuda.synchronize()
                    run["wall"] = time.time() - t0
                    run["lines"] = buf.getvalue().splitlines()
                    run["launches"] = dict(ops.LAUNCHES)

                evs = kernel_events(torch, go, lambda evs, want=want, run=run:
                                    all(n_launches(evs, k) == v for k, v in
                                        want(run["res"]).items()))
                for line in run["lines"]:
                    log(f"[examples {name}] {line}")
                counts = want(run["res"])
                seen = {k: n_launches(evs, k) for k in counts}
                assert seen == counts, (name, seen, counts,
                                        [e.key for e in evs])
                if name == "quickstart":    # K1 against ref.matmul
                    assert run["res"]["err"] <= F32_TOL["atol"], run["res"]
                for k in _build.NAMES:
                    launches[k] += run["launches"][k]
                log(f"[examples] python -m repro_torch.examples.{name} in "
                    f"this process: {run['wall']:.2f} s on the host clock "
                    f"under the profiler; kernels {seen} (asserted from "
                    f"the code); ops launches "
                    f"{ {k: v for k, v in run['launches'].items() if v} } "
                    f"({card})")
        finally:
            os.chdir(cwd)
    assert launches["sliced_matmul"] == 2, launches
    return launches


def main() -> int:
    if not __debug__:
        sys.exit("chip_smoke: its checks are asserts; run it without -O")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import VLM_PATCHES, make_batch
    from repro_torch.core.calibrate import calibrated_benchmarks
    from repro_torch.core.markov import MarkovModel, balanced_slice_sizes
    from repro_torch.core.engine import WorkloadEngine
    from repro_torch.core.profiles import (C2050, H100, TPU_V5E,
                                           h100_profile_from_costs,
                                           tpu_profile_from_costs)
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import coschedule as CS
    from repro_torch.kernels import rg_lru as LRU
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.kernels import sliced_matmul as SM
    from repro_torch.launch.serve import Job, SharedPodServer, card_spec
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.runtime.daemon import ServingDaemon

    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # ---- phase 1: device and build -------------------------------------
    card = nvidia_smi("name,power.limit")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(card)
    spec = card_spec(dev)
    log(f"[device] H100 model: {spec.n_sm} SMs on this card "
        f"(multi_processor_count; the module's constant {H100.n_sm}), "
        f"maximum SM clock {nvidia_smi('clocks.max.sm')} (the module's "
        f"{H100.freq_mhz:.0f} MHz), bw_per_sm {spec.bw_per_sm:.4f}")
    t0 = time.time()
    _build.build()
    log(f"[build] {len(_build.NAMES)} kernels, nvcc in parallel, "
        f"{time.time() - t0:.1f} s")
    for name in _build.NAMES:
        text = (_build.BUILD_DIR / f"{name}.log").read_text()
        for entry, regs, spill in ptxas_entries(text):
            log(f"[ptxas {name}] {entry}: {regs}; {spill}")
            if name == "flash_attention":
                assert "0 bytes spill stores" in spill, (entry, spill)
        if name == "flash_attention":
            entries = " ".join(e for e, _, _ in ptxas_entries(text))
            for d in (48, 192):
                for sym in (f"flash_fwd_wgmma_kernelILi{d}E",
                            f"flash_fwd_kernelIfLi{d}E",
                            f"flash_fwd_window_kernelILi{d}E"):
                    assert sym in entries, (sym, entries)

    rows = {}

    # ---- phase 2a: K3 flash_attention -----------------------------------
    for (b, h, s, d, causal) in [(1, 2, 256, 64, True), (2, 1, 128, 128, True),
                                 (1, 2, 256, 64, False), (1, 2, 100, 96, True),
                                 (1, 2, 100, 80, True),
                                 (2, 1, 256, 160, False),
                                 (1, 2, 100, 48, True), (2, 1, 256, 48, False),
                                 (1, 2, 100, 192, True),
                                 (2, 1, 256, 192, False),
                                 (4, 4, 64, 32, True)]:    # phase 7's training
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v = (randn((b, h, s, d), dt) for _ in range(3))
            err = max_err(torch, ops.flash_attention(q, k, v, causal=causal),
                          ref.flash_attention(q, k, v, causal=causal), tol)
            log(f"[K3 grid] {(b, h, s, d)} causal={causal} {dt} err {err:.3e}")
    qs = [randn((1, 2, 256, 48), dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
    syms = ("flash_fwd_wgmma_kernel<48>", "flash_fwd_kernel<float, 48>")
    names = " ".join(e.key for e in kernel_events(
        torch, lambda: [ops.flash_attention(q, q, q) for q in qs],
        names_all(*syms)))
    for sym in syms:
        assert sym in names, (sym, names)
    log("[K3 D=48] the profiler names flash_fwd_wgmma_kernel<48> and "
        "flash_fwd_kernel<float, 48> (reduced MLA's q.k dim)")
    shape = (1, 32, 2048, 96)
    q, k, v = (randn(shape, torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    err = max_err(torch, got, want, BF16_TOL)
    rel_whole, rel_row = rel_errs(got, want)
    assert rel_whole < K3_REL_TOL and rel_row < K3_REL_TOL, \
        f"K3 relative error {rel_whole:.3e} whole, {rel_row:.3e} worst row"
    del got, want
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True), 20)
    plain = time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True), 5)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    b_ms, b_by = bound(*k3_work(shape, True), "bfloat16")
    rows["flash_attention"] = dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:56", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        rel_err=rel_whole, row_rel_err=rel_row)
    log(f"[K3] {shape} bf16 causal: err {err:.3e} (tol atol=rtol=2e-2), "
        f"relative {rel_whole:.3e} whole and {rel_row:.3e} worst row (tol "
        f"{K3_REL_TOL:g}); "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del q, k, v
    # StableLM's head dims and MLA's q.k dim at their prefill shapes: both
    # paths, both masks; the tensor-core path timed beside its bound and SDPA
    for d, shape in K3_NEW_SHAPES.items():
        flops = k3_work(shape, True)[0]
        errs = []
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q, k, v = (randn(shape, dt) for _ in range(3))
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                e = max_err(torch, got, want, tol)
                rw, rr = rel_errs(got, want)
                assert rw < K3_REL_TOL and rr < K3_REL_TOL, \
                    f"K3 D={d} {dt} relative error {rw:.3e}, row {rr:.3e}"
                errs.append((str(dt).split(".")[-1], causal, e, rw, rr))
                del got, want
        q, k, v = (randn(shape, torch.bfloat16) for _ in range(3))
        ms_d = time_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                          causal=True), 20)
        plain_d = time_ms(torch, lambda: ref.flash_attention(
            q, k, v, causal=True), 5)
        lib_d = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        b_d, by_d = bound(*k3_work(shape, True), "bfloat16")
        syms = (f"flash_fwd_wgmma_kernel<{d}>", f"flash_fwd_kernel<float, {d}>")
        names = " ".join(e.key for e in kernel_events(torch, lambda: (
            ops.flash_attention(q, k, v, causal=True),
            ops.flash_attention(q[:, :2, :256].float(),
                                k[:, :2, :256].float(),
                                v[:, :2, :256].float())), names_all(*syms)))
        for sym in syms:
            assert sym in names, (sym, names)
        rows["flash_attention"].update({
            f"d{d}_max_abs_err": max(e[2] for e in errs), f"d{d}_ms": ms_d,
            f"d{d}_plain_ms": plain_d, f"d{d}_bound_ms": b_d,
            f"d{d}_library_ms": lib_d})
        log(f"[K3 D={d}] {shape}: " + "; ".join(
            f"{dt} {'causal' if c else 'full'} err {e:.3e}, relative "
            f"{rw:.3e} whole, {rr:.3e} worst row" for dt, c, e, rw, rr in errs)
            + f" (tol bf16 2e-2, f32 2e-4, relative {K3_REL_TOL:g}); bf16 "
            f"causal kernel {ms_d:.4f} ms, plain {plain_d:.4f} ms, sdpa "
            f"{lib_d:.4f} ms, bound {b_d:.4f} ms ({by_d}: "
            f"{flops / 1e9:.1f} GFLOP); the profiler "
            f"names flash_fwd_wgmma_kernel<{d}> and "
            f"flash_fwd_kernel<float, {d}>")
        del q, k, v

    # Qwen2-VL's and Whisper's prefill shapes (phase 3e) and D = 48 at 128
    # heads, bf16, each against the plain version, timed beside its bound
    # and SDPA with the same mask; blocks as ``attention._flash`` picks them
    for key, shape, causal in K3_MODEL_SHAPES:
        s = shape[2]
        blk = max(x for x in range(1, 129) if s % x == 0)
        q, k, v = (randn(shape, torch.bfloat16) for _ in range(3))

        def k3(q=q, k=k, v=v, causal=causal, blk=blk):
            return ops.flash_attention(q, k, v, causal=causal, bq=blk, bk=blk)

        got, want = k3(), ref.flash_attention(q, k, v, causal=causal)
        e = max_err(torch, got, want, BF16_TOL)
        rw, rr = rel_errs(got, want)
        assert rw < K3_REL_TOL and rr < K3_REL_TOL, \
            f"K3 {shape} causal={causal}: relative {rw:.3e}, row {rr:.3e}"
        del got, want
        ms_m = time_ms(torch, k3, 20)
        plain_m = time_ms(torch, lambda: ref.flash_attention(
            q, k, v, causal=causal), 5)
        lib_m = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20)
        flops, nbytes = k3_work(shape, causal)
        b_m, by_m = bound(flops, nbytes, "bfloat16")
        rows["flash_attention"].update({
            f"{key}max_abs_err": e, f"{key}ms": ms_m,
            f"{key}plain_ms": plain_m, f"{key}bound_ms": b_m,
            f"{key}library_ms": lib_m})
        log(f"[K3 {key[:-1]}] {shape} bf16 {'causal' if causal else 'full'}: "
            f"err {e:.3e} (tol atol=rtol=2e-2), relative {rw:.3e} whole, "
            f"{rr:.3e} worst row (tol {K3_REL_TOL:g}); kernel {ms_m:.4f} ms, "
            f"plain {plain_m:.4f} ms, sdpa {lib_m:.4f} ms "
            f"(is_causal={causal}), bound {b_m:.4f} ms ({by_m}: "
            f"{flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB); K3/sdpa {ms_m / lib_m:.2f}")
        del q, k, v

    # ---- phase 2b: K1 sliced_matmul -------------------------------------
    for (m, kk, n, ss) in [(256, 128, 256, 1), (128, 256, 384, 3),
                           (384, 128, 128, 4),
                           (256, 256, 256, 2)]:     # phase 7's quickstart
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a, bm = randn((m, kk), dt), randn((kk, n), dt)
            err = max_err(torch, ops.sliced_matmul(a, bm, slice_size=ss),
                          ref.matmul(a, bm), tol)
            log(f"[K1 grid] {(m, kk, n)} slice {ss} {dt} err {err:.3e}")

    def one_launch(a, bm):
        out = torch.empty(a.shape[0], bm.shape[1], dtype=a.dtype, device=dev)
        SM.matmul_slice(a, bm, out, offset=0,
                        slice_size=(a.shape[0] // 128) * (bm.shape[1] // 128))
        return out

    a, bm = (randn((2048, 2048), torch.bfloat16) for _ in range(2))
    whole = one_launch(a, bm)
    for ss in (1, 3, 4, SMS):     # 256 tiles: a ragged last slice of 132
        assert torch.equal(ops.sliced_matmul(a, bm, slice_size=ss), whole), \
            f"slice size {ss} is not bitwise equal to one launch"
    log(f"[K1 bitwise] 2048^3 bf16: slice sizes 1, 3, 4, {SMS} == one "
        f"launch, bitwise")
    n = 8192
    a, bm = randn((n, n), torch.bfloat16), randn((n, n), torch.bfloat16)
    mm_want = ref.matmul(a, bm)
    err = max_err(torch, ops.sliced_matmul(a, bm), mm_want, BF16_TOL)
    err = max(err, max_err(torch, ops.sliced_matmul(a, bm, slice_size=SMS),
                           mm_want, BF16_TOL))
    ms = time_ms(torch, lambda: ops.sliced_matmul(a, bm), 2)
    ms_132 = time_ms(torch, lambda: ops.sliced_matmul(a, bm, slice_size=SMS),
                     5)
    ms_one = time_ms(torch, lambda: one_launch(a, bm), 5)
    plain = time_ms(torch, lambda: ref.matmul(a, bm), 3)
    lib = time_ms(torch, lambda: torch.matmul(a, bm), 10)
    nbytes = 3 * n * n * 2
    b_ms, b_by = bound(2.0 * n ** 3, nbytes, "bfloat16")
    tiles, tile_flops = (n // 128) ** 2, 2.0 * 128 * 128 * n
    b4 = sliced_bound_ms(tiles, 4, tile_flops, nbytes)
    b132 = sliced_bound_ms(tiles, SMS, tile_flops, nbytes)
    rows["sliced_matmul"] = dict(
        source="src/repro_torch/csrc/sliced_matmul.cu",
        replaces="src/repro/kernels/sliced_matmul.py:44", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        one_launch_ms=ms_one, slice132_ms=ms_132, sliced_bound_ms=b4,
        slice132_bound_ms=b132)
    log(f"[K1] 8192^3 bf16 ({tiles} tiles): err {err:.3e} (tol "
        f"atol=rtol=2e-2, slice sizes 4 and {SMS}); kernel at slice_size=4 "
        f"{ms:.3f} ms (bound {b4:.4f} ms: {tiles // 4} launches x 1 wave), "
        f"at slice_size={SMS} {ms_132:.3f} ms (bound {b132:.4f} ms: "
        f"{math.ceil(tiles / SMS)} launches x 1 wave), one launch "
        f"{ms_one:.3f} ms (bound {b_ms:.4f} ms, {b_by}); slicing overhead "
        f"T_s/T_one - 1: {ms / ms_one - 1:.4f} at 4, {ms_132 / ms_one - 1:.4f}"
        f" at {SMS}; plain {plain:.3f} ms, torch.matmul {lib:.3f} ms")

    # ---- phase 2c: K2 coschedule ----------------------------------------
    occ = CS.occupancy()
    assert occ >= 2, f"bf16 K2 holds {occ} CTA an SM; a stream CTA cannot " \
        "sit beside a matmul CTA"
    log(f"[K2 occupancy] coschedule_wgmma_kernel: {occ} CTAs an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, 288 threads, "
        f"3-stage ring)")
    for run_a, run_b in [(1, 1), (2, 1), (1, 3)]:
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a2, b2 = randn((256, 128), dt), randn((128, 256), dt)
            x2 = randn((1024, 256), dt)
            mm, st = ops.coschedule(a2, b2, x2, run_a=run_a, run_b=run_b)
            mref, sref = ref.coschedule(a2, b2, x2, 2.0)
            e = max(max_err(torch, mm, mref, tol),
                    max_err(torch, st, sref, tol))
            log(f"[K2 grid] runs {run_a}:{run_b} {dt} err {e:.3e}")
    profs = calibrated_benchmarks(C2050)
    model = MarkovModel(C2050.virtual())
    pc, tea = profs["PC"], profs["TEA"]
    c1, c2 = model.pair_ipc(pc, 2, tea, 2)
    s1, s2 = balanced_slice_sizes(pc, c1, tea, c2, 14, 14, 14)
    run_a = min(max(1, round(s1 / 14)), 8)
    run_b = min(max(1, round(s2 / 14)), 8)
    x = randn((65536, 8192), torch.bfloat16)
    st_want = ref.streaming_scale(x, 2.0)
    mm, st = ops.coschedule(a, bm, x, run_a=run_a, run_b=run_b)
    err = max(max_err(torch, mm, mm_want, BF16_TOL),
              max_err(torch, st, st_want, BF16_TOL))
    del mm, st
    n_a, n_b = (n // 128) ** 2, 65536 // 256
    # the H100 model's ratio for the same two kernels: each profiled from
    # its FLOPs and bytes at the card's peaks, one block a CTA
    k2_profs = {"matmul": h100_profile_from_costs(
                    "matmul", 2.0 * n ** 3, 3 * n * n * 2, n_a),
                "stream": h100_profile_from_costs(
                    "stream", float(x.numel()), 2 * x.numel() * 2, n_b)}
    cs = WorkloadEngine().scheduler_for(
        spec, k2_profs, alpha_p=0.2, alpha_m=0.2,
        cp_margin=0.0).find_coschedule(list(k2_profs))
    assert cs.k2 is not None, f"the H100 model pairs nothing: {cs}"
    runs_h = {cs.k1: round(cs.s1 / spec.n_sm), cs.k2: round(cs.s2 / spec.n_sm)}
    h_a, h_b = max(1, runs_h["matmul"]), max(1, runs_h["stream"])
    mm, st = ops.coschedule(a, bm, x, run_a=h_a, run_b=h_b)
    err_h = max(max_err(torch, mm, mm_want, BF16_TOL),
                max_err(torch, st, st_want, BF16_TOL))
    err = max(err, err_h)
    del mm, st
    # the schedules on the card once, so that the times are the kernel's
    # alone (ops.coschedule builds its schedule on the host every call)
    scheds = {"fused": CS.make_schedule(n_a, n_b, run_a, run_b),
              "fused_h100": CS.make_schedule(n_a, n_b, h_a, h_b),
              "matmul": CS.make_schedule(n_a, 0),
              "stream": CS.make_schedule(0, n_b)}
    sched_dev = {k: CS.schedule_tensor(v, dev) for k, v in scheds.items()}
    k2_ms = {k: [] for k in scheds}
    for order in (("fused", "fused_h100", "matmul", "stream"),
                  ("stream", "matmul", "fused_h100", "fused")):
        for k in order:
            k2_ms[k].append(time_ms(torch, lambda: CS.launch(
                a, bm, x, sched_dev[k], scale=2.0, bx=256), 5))
    ms, ms_h, mm_only, st_only = (sum(k2_ms[k]) / 2 for k in
                                  ("fused", "fused_h100", "matmul", "stream"))
    call_ms = time_ms(torch, lambda: ops.coschedule(a, bm, x, run_a=run_a,
                                                    run_b=run_b), 3)
    traced = {}
    for k in ("fused", "matmul"):
        trace = torch.zeros(len(scheds[k][0]), 4, dtype=torch.int64,
                            device=dev)
        CS.launch(a, bm, x, sched_dev[k], scale=2.0, bx=256, trace=trace)
        torch.cuda.synchronize()
        traced[k] = trace_report(trace.cpu().tolist())
    ov = traced["fused"]
    plain = time_ms(torch, lambda: ref.coschedule(a, bm, x, 2.0), 3)
    st_bytes = 2 * x.numel() * x.element_size()
    b_ms, b_by = bound(2.0 * n ** 3 + x.numel(), 3 * n * n * 2 + st_bytes,
                       "bfloat16")
    serial_bound = (bound(2.0 * n ** 3, 3 * n * n * 2, "bfloat16")[0]
                    + 1e3 * st_bytes / HBM_BYTES_PER_S)
    serial = mm_only + st_only
    rows["coschedule"] = dict(
        source="src/repro_torch/csrc/coschedule.cu",
        replaces="src/repro/kernels/coschedule.py:73", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        serial_ms=serial, matmul_ms=mm_only, stream_ms=st_only,
        fused_over_serial=ms / serial, overlap_share=ov["share"],
        occupancy=occ, h100_runs=[h_a, h_b], h100_fused_ms=ms_h,
        h100_fused_over_serial=ms_h / serial)
    rows["coschedule"].update(
        stream_end_us=ov["stream_end_us"], stream_us=ov["stream_us"],
        peak_stream=ov["peak_stream"],
        mm_resident_during=ov["mm_resident_during"],
        mm_us_during=ov["mm_us_during"],
        mm_us_after=ov["mm_us_after"],
        mm_us_alone=traced["matmul"]["mm_us_after"])
    before = EARLIER_MS["coschedule"]
    log(f"[K2] 8192^3 + 65536x8192 bf16, runs {run_a}:{run_b} from "
        f"balanced_slice_sizes (s1={s1}, s2={s2}): err {err:.3e} "
        f"(tol atol=rtol=2e-2); fused {ms:.4f} ms (on the FMA tile: "
        f"{before['fused']}), matmul alone {mm_only:.4f} ms (FMA: "
        f"{before['matmul']}), stream alone {st_only:.4f} ms (FMA kernel: "
        f"{before['stream']}), serial {serial:.4f} ms, fused/serial "
        f"{ms / serial:.4f}; each the mean of two turns "
        f"(fused/matmul/stream: {k2_ms['fused']}, {k2_ms['matmul']}, "
        f"{k2_ms['stream']}); ops.coschedule per call, schedule built on "
        f"the host, {call_ms:.4f} ms; plain {plain:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}; serial bound {serial_bound:.4f} ms, the "
        f"stream's {1e3 * st_bytes / HBM_BYTES_PER_S:.4f} ms)")
    log(f"[K2 H100 model] find_coschedule on the H100 model (profiles "
        f"from FLOPs and bytes at 989 TFLOP/s and 3.35 TB/s, one block a "
        f"CTA: matmul PUR {k2_profs['matmul'].pur:.4f} MUR "
        f"{k2_profs['matmul'].mur:.4f}, stream PUR "
        f"{k2_profs['stream'].pur:.4f} MUR {k2_profs['stream'].mur:.4f}) "
        f"picks {cs.k1} x {cs.k2} at s1={cs.s1}, s2={cs.s2} (w {cs.w1}:"
        f"{cs.w2}, predicted CP {cs.cp:+.4f}): runs {h_a}:{h_b} (matmul:"
        f"stream) against the C2050 model's {run_a}:{run_b}; err "
        f"{err_h:.3e}; fused {ms_h:.4f} ms (turns {k2_ms['fused_h100']}) "
        f"against {ms:.4f} ms at {run_a}:{run_b}; fused/serial "
        f"{ms_h / serial:.4f} against {ms / serial:.4f}")
    log(f"[K2 trace] one traced fused launch: stream CTAs spent "
        f"{ov['share']:.4f} of their time beside a matmul CTA on the same "
        f"SM; {ov['met']:.4f} of them met one at all; stream CTAs ran on "
        f"{ov['stream_sms']} SMs, {ov['stream_us']:.1f} us each on average, "
        f"at most {ov['peak_stream']} at once, and the last ended at "
        f"{ov['stream_end_us']:.1f} us, while {ov['mm_resident_during']:.1f} "
        f"matmul CTAs were resident on average (of {SMS} SMs x {occ}); "
        f"resident (matmul, stream) CTAs at 1/4, 1/2, 3/4 of the launch: "
        f"{ov['resident']}; a matmul CTA took "
        f"{ov['mm_us_during']:.1f} us while stream CTAs ran and "
        f"{ov['mm_us_after']:.1f} us after, against "
        f"{traced['matmul']['mm_us_after']:.1f} us in a traced matmul-alone "
        f"launch")

    # ---- phase 2d: K4 rwkv6_scan -----------------------------------------
    def wkv_inputs(b, s, h, n, dt):
        r, k, v = (randn((b, s, h, n), dt) for _ in range(3))
        w_log = -torch.exp(randn((b, s, h, n), torch.float32) - 1.0)
        return r, k, v, w_log, randn((h, n), torch.float32) * 0.1

    # S = 80 and 37 leave a ragged last chunk of the kernels' own 32
    for (b, s, h, n, chunk) in [(2, 64, 2, 32, 16), (1, 128, 4, 64, 32),
                                (2, 80, 2, 64, 16), (1, 37, 3, 32, 37)]:
        for dt in (torch.float32, torch.bfloat16):
            tol = K4_TOL[str(dt).split(".")[-1]]
            r, k, v, w_log, u = wkv_inputs(b, s, h, n, dt)
            err = max_err(torch, ops.rwkv6_scan(r, k, v, w_log, u,
                                                chunk=chunk),
                          ref.rwkv6(r, k, v, w_log, u)[0], tol)
            s0 = randn((b, h, n, n), torch.float32)
            state = s0.clone()
            got = ops.rwkv6_scan(r, k, v, w_log, u, chunk=chunk, state=state)
            want, want_s = ref.rwkv6(r, k, v, w_log, u, s0)
            err_s = max(max_err(torch, got, want, tol),
                        max_err(torch, state, want_s, tol))
            log(f"[K4 grid] {(b, s, h, n)} chunk {chunk} {dt} err {err:.3e}; "
                f"from a given state, overwritten in place: out and final "
                f"state err {err_s:.3e}")
    # a log decay of -4 a step (tests/test_torch_recurrent.py's seed-24
    # case): the exponent above the diagonal would reach 4 * 31
    for n in WKV.HEAD_DIMS:
        r, k, v, _, u = wkv_inputs(1, 64, 2, n, torch.float32)
        w_log = torch.full_like(r, -4.0)
        s0 = randn((1, 2, n, n), torch.float32)
        state = s0.clone()
        got = ops.rwkv6_scan(r, k, v, w_log, u, state=state)
        want, want_s = ref.rwkv6(r, k, v, w_log, u, s0)
        assert bool(torch.isfinite(got).all()), "K4 went non-finite"
        err = max(max_err(torch, got, want, K4_TOL["float32"]),
                  max_err(torch, state, want_s, K4_TOL["float32"]))
        log(f"[K4 decay] (1, 64, 2, {n}) f32, w_log = -4 a step, from a "
            f"given state: finite, out and final state err {err:.3e}")
    # what the reference's kernel takes and the card's wrapper now widens:
    # bf16 w_log and u, r/k/v of two dtypes, a bf16 state; and N = 16 and
    # 48, padded to the 32 and 64 instances
    for (b, s, h, n) in [(2, 64, 2, 32), (2, 80, 3, 16), (1, 64, 2, 48)]:
        for dt in (torch.float32, torch.bfloat16):
            tol = K4_TOL[str(dt).split(".")[-1]]
            r, k, v, w_log, u = wkv_inputs(b, s, h, n, dt)
            w_log, u = w_log.bfloat16(), u.bfloat16()
            s0 = randn((b, h, n, n), torch.float32).bfloat16()
            state = s0.clone()
            got = ops.rwkv6_scan(r, k.float(), v, w_log, u, chunk=16,
                                 state=state)
            want, want_s = ref.rwkv6(r, k.float(), v, w_log, u, s0)
            err = max_err(torch, got, want, tol)
            err_s = max_err(torch, state, want_s, K4_TOL["bfloat16"])
            pad = (f" (N padded to {WKV.padded_n(n)})"
                   if n not in WKV.HEAD_DIMS else "")
            log(f"[K4 widen] {(b, s, h, n)}{pad} r/v {dt}, k f32, bf16 "
                f"w_log, u and state: out err {err:.3e} (tol "
                f"{tol['atol']:g}), final bf16 state err {err_s:.3e} (tol "
                f"5e-2)")
    shape = (4, 2048, 32, 64)
    b, s, h, n = shape
    r, k, v, w_log, u = wkv_inputs(b, s, h, n, torch.bfloat16)
    s0 = randn((b, h, n, n), torch.float32)
    zeros = torch.zeros(b, h, n, n, device=dev)
    k4_errs, k4_rel = [], []
    for init in (zeros, s0):      # the main path's zero state, then a given one
        state = init.clone()
        got = ops.rwkv6_scan(r, k, v, w_log, u, state=state)
        want, want_s = R.rwkv6_chunked(r, k, v, w_log, u, init)
        assert bool(torch.isfinite(want).all()), "plain K4 went non-finite"
        seq, seq_s = ref.rwkv6(r, k, v, w_log, u, init)
        k4_errs.append(max(max_err(torch, got, want, K4_TOL["float32"]),
                           max_err(torch, state, want_s, K4_TOL["float32"]),
                           max_err(torch, got, seq, K4_TOL["float32"]),
                           max_err(torch, state, seq_s, K4_TOL["float32"])))
        for pair in ((got, want), (state, want_s)):
            rel_whole, rel_row = rel_errs(*pair)
            assert rel_whole < K4_REL_TOL and rel_row < K4_REL_TOL, \
                f"K4 relative error {rel_whole:.3e} whole, {rel_row:.3e} row"
            k4_rel.append((rel_whole, rel_row))
    del got, want, want_s, seq, seq_s
    rel_whole = max(x[0] for x in k4_rel)
    rel_row = max(x[1] for x in k4_rel)
    state = zeros.clone()
    ms = time_ms(torch, lambda: ops.rwkv6_scan(r, k, v, w_log, u,
                                               state=state), 20)
    evs = kernel_events(torch, lambda: [
        ops.rwkv6_scan(r, k, v, w_log, u, state=state) for _ in range(5)],
        names_all(*K4_KERNELS))
    pass_ms = {name: sum(e.self_device_time_total for e in evs
                         if name in e.key) / 5e3 for name in K4_KERNELS}
    assert all(t > 0 for t in pass_ms.values()), pass_ms
    plain = time_ms(torch, lambda: R.rwkv6_chunked(r, k, v, w_log, u, zeros),
                    3)
    products, other, nbytes = wkv6_work(b, s, h, n, r.element_size())
    b_ms, b_by = wkv6_bound_ms(products, other, nbytes)
    f32_ms = bound(products + other, nbytes, "float32")[0]
    moved, scratch = wkv6_pass_bytes(b, s, h, n, r.element_size())
    rows["rwkv6_scan"] = dict(
        source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:58",
        max_abs_err=max(k4_errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, rel_err=rel_whole,
        row_rel_err=rel_row, states_ms=pass_ms[K4_KERNELS[0]],
        out_ms=pass_ms[K4_KERNELS[1]])
    log(f"[K4] {shape} bf16 r/k/v, f32 w/u/state, chunk 32: err "
        f"{max(k4_errs):.3e} (tol atol=rtol=1e-3, against the plain chunked "
        f"version and the sequential oracle, out and final state, from zero "
        f"and from a given state), relative {rel_whole:.3e} whole and "
        f"{rel_row:.3e} worst row (tol {K4_REL_TOL:g}); kernel {ms:.4f} ms "
        f"(one CTA per head: {EARLIER_MS['rwkv6_scan']}), of which pass 1 "
        f"{pass_ms[K4_KERNELS[0]]:.4f} ms and pass 2 "
        f"{pass_ms[K4_KERNELS[1]]:.4f} ms (profiler, mean of 5); plain "
        f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s; {(products + other) / 1e9:.2f} GFLOP, "
        f"{f32_ms:.4f} ms were it all f32 on the CUDA cores); the two "
        f"passes move {moved / 1e6:.1f} MB, a floor of "
        f"{1e3 * moved / HBM_BYTES_PER_S:.4f} ms, the scratch "
        f"{scratch / 1e6:.1f} MB of it ({scratch / moved:.1%}); no one "
        f"PyTorch call computes it")
    del r, k, v, w_log, u, s0, zeros, state

    # ---- phase 2e: K5 rg_lru ---------------------------------------------
    def lru_inputs(b, s, w, dtype=torch.float32):
        return (randn((b, s, w), torch.float32).to(dtype),
                (-torch.exp(randn((b, s, w), torch.float32))).to(dtype))

    def lru(x, a_log, h0=None):       # one block over the call, as the model
        return ops.rg_lru(x, a_log, chunk=x.shape[1], bw=x.shape[2], h0=h0)

    # the CPU tests' grids; then ragged in the 32-channel block with
    # W * 4 % 16 != 0 (the threads load the tiles), and three windows of 2048
    for (b, s, w) in [(2, 256, 512), (1, 128, 1024), (3, 37, 100),
                      (2, 300, 42), (1, 4100, 64)]:
        for dt in (torch.float32, torch.bfloat16):
            xs, als = lru_inputs(b, s, w, dt)
            xf, af = xs.float(), als.float()
            h0 = randn((b, w), torch.float32)
            err = max_err(torch, lru(xs, als), ref.rg_lru(xf, af), K5_TOL)
            got = lru(xs, als, h0)
            err_h = max(max_err(torch, got, ref.rg_lru(xf, af, h0), K5_TOL),
                        max_err(torch, got, R.rglru_scan(xf, af, h0)[0],
                                K5_TOL))
            log(f"[K5 grid] {(b, s, w)} {dt} err {err:.3e}; from h0 err "
                f"{err_h:.3e}")
    xs, als = lru_inputs(1, 4100, 96)
    h0 = randn((1, 96), torch.float32)
    cut = LRU.RANKS * LRU.STEPS
    first = lru(xs[:, :cut].contiguous(), als[:, :cut].contiguous(), h0)
    second = lru(xs[:, cut:].contiguous(), als[:, cut:].contiguous(),
                 first[:, -1].contiguous())
    assert torch.equal(torch.cat([first, second], 1), lru(xs, als, h0)), \
        "K5: two calls chained through h0 differ from one"
    log(f"[K5 chain] (1, 4100, 96) f32: {cut} and {4100 - cut} steps chained "
        f"through h0 == one call, bitwise")
    shape = (1, 2048, 4096)
    occ = {dt: LRU.occupancy(dt) for dt in (torch.float32, torch.bfloat16)}
    for dt, (clusters, per_sm) in occ.items():
        assert clusters >= 1 and per_sm >= 1, (dt, clusters, per_sm)
    log(f"[K5 occupancy] clusters of {LRU.RANKS} CTAs resident at once "
        f"(cudaOccupancyMaxActiveClusters) and CTAs an SM: f32 "
        f"{occ[torch.float32][0]} clusters, {occ[torch.float32][1]} an SM; "
        f"bf16 {occ[torch.bfloat16][0]}, {occ[torch.bfloat16][1]}; the grid "
        f"at {shape} is {shape[0] * math.ceil(shape[2] / 32)} clusters")
    xs, als = lru_inputs(*shape)
    zeros = torch.zeros(shape[0], shape[2], device=dev)
    k5_errs = []
    for init in (zeros, randn((shape[0], shape[2]), torch.float32)):
        got = ops.rg_lru(xs, als, h0=init)
        k5_errs.append(max(
            max_err(torch, got, R.rglru_scan(xs, als, init)[0], K5_TOL),
            max_err(torch, got, ref.rg_lru(xs, als, init), K5_TOL)))
    xb, ab = xs.bfloat16(), als.bfloat16()
    got = ops.rg_lru(xb, ab, h0=init)
    bf16_err = max_err(torch, got, ref.rg_lru(xb.float(), ab.float(), init),
                       K5_TOL)
    del got

    # a call's host work (checks, two tensor maps) is of the kernel's order,
    # so back-to-back events would time the host: time calls queued ahead
    ms = queued_ms(torch, lambda: ops.rg_lru(xs, als, h0=zeros), 20)
    ms_bf16 = queued_ms(torch, lambda: ops.rg_lru(xb, ab, h0=zeros), 20)
    event_ms = time_ms(torch, lambda: ops.rg_lru(xs, als, h0=zeros), 20)
    plain = time_ms(torch, lambda: R.rglru_scan(xs, als, zeros), 3)
    nbytes = lru_bytes(*shape, 4)
    b_ms, b_by = bound(9.0 * xs.numel(), nbytes, "float32")
    rows["rg_lru"] = dict(
        source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru.py:41", max_abs_err=max(k5_errs),
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        event_ms=event_ms, bf16_ms=ms_bf16, bf16_err=bf16_err,
        clusters=occ[torch.float32][0], ctas_per_sm=occ[torch.float32][1])
    log(f"[K5] {shape} f32: err {max(k5_errs):.3e} (tol atol=rtol=1e-4, "
        f"against the plain scan and the oracle, from zero and from h0); "
        f"bf16 x/a_log err {bf16_err:.3e} against the oracle on the same "
        f"values in f32; kernel {ms:.4f} ms device time (CUDA events, mean "
        f"of 20 calls queued behind a spin kernel; before this design "
        f"{EARLIER_MS['rg_lru']}), {event_ms:.4f} ms "
        f"a call back to back (CUDA events, the host's work included); moves "
        f"{nbytes / 1e6:.1f} MB (the kernel it replaced "
        f"{lru_bytes(*shape, 4, reads=2) / 1e6:.1f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of its bound; bf16 "
        f"{ms_bf16:.4f} ms ({lru_bytes(*shape, 2) / 1e6:.1f} MB, "
        f"{lru_bytes(*shape, 2) / ms_bf16 / 1e6:.1f} GB/s); plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); no one PyTorch call computes it")
    del xs, als, xb, ab, h0, zeros, init, first, second

    # ---- phase 2f: K3, K4 and K5 through their autograd Functions ---------
    autograd_phase(torch, ops, ref, A, R, randn, rows)

    # ---- phase 2g: K3, K4 and K5 at a (1, 4) rank's shard shapes ---------
    shard_phase(torch, ops, ref, A, R, randn, rows)

    # ---- phase 2h: D1 decode_attention at the decode shapes ---------------
    decode_phase(torch, ops, ref, randn, rows)

    # ---- phase 2i: D2 mla_decode_attention at the latent decode shapes ----
    mla_decode_phase(torch, ops, ref, randn, rows)

    # ---- phase 2j: G1 grouped_experts at the dropless prompt's shape -----
    grouped_experts_phase(torch, ops, rows)

    # ---- phase 2k: K3's causal window at Mellum2's prompt ----------------
    window_phase(torch, ops, ref, A, randn, rows)

    # ---- phase 3: the dense path, counted --------------------------------
    ops.reset_launches()
    mm, st = ops.coschedule(a, bm, x, run_a=run_a, run_b=run_b)
    max_err(torch, mm, mm_want, BF16_TOL)
    max_err(torch, st, st_want, BF16_TOL)
    max_err(torch, ops.sliced_matmul(a, bm), mm_want, BF16_TOL)
    del mm, st, x, st_want, a, bm, mm_want, whole
    torch.cuda.empty_cache()
    log(f"[handoff] scheduler runs {run_a}:{run_b} -> coschedule, and "
        "sliced_matmul at slice_size=4: both agree with their plain versions")

    def h100_server():
        return SharedPodServer(gpu_spec=spec,
                               profile_fn=h100_profile_from_costs,
                               use_reduced=False, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    srv = h100_server()
    prefill = Job("tenantA-phi3-prefill", "phi3-mini-3.8b", "prefill", 4, 1,
                  2048)
    decode = Job("tenantB-phi3-decode", "phi3-mini-3.8b", "decode", 8, 8,
                 4096)
    srv.submit(prefill)
    srv.submit(decode)
    t_submit = time.time() - t0
    log(f"[serve] {srv.capture_report()}")
    slices = {name: job.num_slices for name, job in srv.jobs.items()}
    twin = twin_server(srv, TPU_V5E, tpu_profile_from_costs)
    res = srv.drain()
    launches = dict(ops.LAUNCHES)
    rounds = res["rounds"]
    assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
    assert any(k2 is not None for _, k2, _, _, _ in rounds), \
        "no co-scheduled round"
    n_layers = get_config("phi3-mini-3.8b").num_layers
    runs = prefill_runs(rounds, prefill.name)
    assert launches["flash_attention"] == n_layers * runs, (launches, runs)
    n_dec = decode_attn_layers(get_config("phi3-mini-3.8b"))
    dec_runs = prefill_runs(rounds, decode.name)
    assert launches["decode_attention"] == n_dec * dec_runs, \
        (launches, dec_runs)
    logits = {name: srv._exec[name]() for name in srv.jobs}
    torch.cuda.synchronize()
    assert logits[prefill.name].shape == (1, 2048, 32064)
    assert logits[decode.name].shape == (8, 32064)
    for name, lg in logits.items():
        assert bool(torch.isfinite(lg.float()).all()), f"{name}: non-finite"
    log(f"[serve] phi3-mini-3.8b full width (32 layers, d_model 3072), bf16, "
        f"seeded random weights, on the H100 model; {len(srv.jobs)} tenants "
        f"submitted in {t_submit:.2f} s (warm-up included); drain wall_s "
        f"{res['wall_s']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_attention launches {launches['flash_attention']} = "
        f"{n_layers} x {runs} prefill slices, decode_attention launches "
        f"{launches['decode_attention']} = {n_dec} x {dec_runs} decode "
        f"slices (warm-up included)")
    log(f"[main path] dense launches {launches}")
    res_twin = twin.drain()
    drain_report(torch, srv, twin, res, res_twin, slices, "serve")
    decode_report(torch, "serve", decode.name, srv._exec[decode.name], n_dec,
                  EARLIER_DECODE_MS["phi3-mini-3.8b"])
    with tempfile.TemporaryDirectory() as store_dir:
        dmn = ServingDaemon(str(Path(store_dir) / "serve.sqlite"),
                            pod_id="chip-smoke")
        for name, n in slices.items():
            srv.jobs[name].num_slices = n
        res_d = srv.drain(daemon=dmn, plan_first=False)
        final = dmn.store.state(res_d["job_id"])
        dmn.close()
    assert res_d["state"] == final == "finished", (res_d["state"], final)
    assert decisions(res_d["rounds"]) == decisions(rounds)
    log(f"[serve daemon] one drain under the port's ServingDaemon (job "
        f"store in a temporary directory): job {res_d['job_id']!r} ends "
        f"{final!r} after {len(res_d['rounds'])} rounds, wall_s "
        f"{res_d['wall_s']:.4f}")
    del srv, twin, logits, res, res_twin
    torch.cuda.empty_cache()

    # ---- phase 3b: the recurrent path, counted -----------------------------
    archs = ("rwkv6-1.6b", "recurrentgemma-9b")
    t0 = time.time()
    weights = {}
    for arch in archs:        # each arch's weights once, for both its tenants
        wgen = torch.Generator(device=dev).manual_seed(0)
        weights[arch] = T.init_params(get_config(arch), wgen, device=dev)
    n_params = {arch: T.count_params(weights[arch]) for arch in archs}
    t_init = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    jobs = [Job("tenantC-rwkv6-prefill", "rwkv6-1.6b", "prefill", 4, 4, 2048),
            Job("tenantD-rwkv6-decode", "rwkv6-1.6b", "decode", 8, 32, 4096),
            Job("tenantE-rgemma-prefill", "recurrentgemma-9b", "prefill", 4,
                1, 2048),
            Job("tenantF-rgemma-decode", "recurrentgemma-9b", "decode", 8, 8,
                4096)]
    ops.reset_launches()
    t0 = time.time()
    srv = h100_server()
    for job in jobs:
        srv.submit(job, params=weights[job.arch])
    t_submit = time.time() - t0
    log(f"[serve-rec] {srv.capture_report()}")
    slices = {name: job.num_slices for name, job in srv.jobs.items()}
    twin = twin_server(srv, TPU_V5E, tpu_profile_from_costs)
    res = srv.drain()
    rec_launches = dict(ops.LAUNCHES)
    rounds = res["rounds"]
    assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
    assert any(k2 is not None for _, k2, _, _, _ in rounds), \
        "no co-scheduled round"
    kinds = {arch: get_config(arch).layer_kinds() for arch in archs}
    n_wkv, n_lru = kinds["rwkv6-1.6b"].count("rwkv6"), \
        kinds["recurrentgemma-9b"].count("rglru")
    runs_c = prefill_runs(rounds, jobs[0].name)
    runs_e = prefill_runs(rounds, jobs[2].name)
    assert (n_wkv, n_lru) == (24, 26), (n_wkv, n_lru)
    assert rec_launches["rwkv6_scan"] == n_wkv * runs_c, (rec_launches, runs_c)
    assert rec_launches["rg_lru"] == n_lru * runs_e, (rec_launches, runs_e)
    n_dec = {job.name: decode_attn_layers(get_config(job.arch))
             for job in jobs}
    assert (n_dec[jobs[1].name], n_dec[jobs[3].name]) == (0, 12), n_dec
    runs_f = prefill_runs(rounds, jobs[3].name)
    assert rec_launches["decode_attention"] == 12 * runs_f, \
        (rec_launches, runs_f)
    logits = {name: srv._exec[name]() for name in srv.jobs}
    torch.cuda.synchronize()
    want_shapes = {jobs[0].name: (4, 2048, 65536), jobs[1].name: (32, 65536),
                   jobs[2].name: (1, 2048, 256000), jobs[3].name: (8, 256000)}
    for name, lg in logits.items():
        assert tuple(lg.shape) == want_shapes[name], (name, lg.shape)
        assert bool(torch.isfinite(lg.float()).all()), f"{name}: non-finite"
    del logits
    log(f"[serve-rec] rwkv6-1.6b (24 rwkv6 layers, d_model 2048, "
        f"{n_params['rwkv6-1.6b'] / 1e9:.3f} B params) and recurrentgemma-9b "
        f"(26 rglru + 12 local layers, d_model 4096, "
        f"{n_params['recurrentgemma-9b'] / 1e9:.3f} B params) at full width, "
        f"bf16, seeded random weights built in {t_init:.2f} s, each shared by "
        f"its arch's two tenants, on the H100 model; {len(srv.jobs)} tenants "
        f"submitted in {t_submit:.2f} s (warm-up included); drain wall_s "
        f"{res['wall_s']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; rwkv6_scan "
        f"launches {rec_launches['rwkv6_scan']} = {n_wkv} x {runs_c} prefill "
        f"slices, rg_lru launches {rec_launches['rg_lru']} = {n_lru} x "
        f"{runs_e} prefill slices, decode_attention launches "
        f"{rec_launches['decode_attention']} = 12 local layers x {runs_f} "
        f"RecurrentGemma decode slices (warm-up included)")
    log(f"[main path] recurrent launches {rec_launches}")
    res_twin = twin.drain()
    seen = drain_report(torch, srv, twin, res, res_twin, slices, "serve-rec",
                        want={jobs[0].name: names_all(*K4_KERNELS),
                              jobs[2].name: names_all(K5_KERNEL)})
    names = " ".join(seen[jobs[0].name])
    assert all(k in names for k in K4_KERNELS) and "wkv6_kernel" not in names, \
        f"the RWKV6 prefill step did not run K4's two passes: {names}"
    names = " ".join(seen[jobs[2].name])
    assert K5_KERNEL in names and K5_OLD_KERNEL not in names, \
        f"the RecurrentGemma prefill step did not run K5's kernel: {names}"
    for job in (jobs[1], jobs[3]):
        decode_report(torch, "serve-rec", job.name, srv._exec[job.name],
                      n_dec[job.name])
    del srv, twin, weights, res, res_twin
    torch.cuda.empty_cache()

    # ---- phase 3c: StableLM, counted -------------------------------------
    slm_launches = dict.fromkeys(_build.NAMES, 0)
    slm = {"stablelm-3b": [
               Job("tenantG-slm3b-prefill", "stablelm-3b", "prefill", 2, 1,
                   2048),
               Job("tenantH-slm3b-decode", "stablelm-3b", "decode", 2, 8,
                   4096)],
           "stablelm-12b": [
               Job("tenantI-slm12b-prefill", "stablelm-12b", "prefill", 2, 1,
                   2048)]}
    for arch, arch_jobs in slm.items():
        cfg = get_config(arch)
        t0 = time.time()
        wts = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        torch.cuda.synchronize()
        t_init = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        srv = h100_server()
        for job in arch_jobs:
            srv.submit(job, params=wts)
        log(f"[serve-slm] {srv.capture_report()}")
        res = srv.drain()
        for name in _build.NAMES:
            slm_launches[name] += ops.LAUNCHES[name]
        assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
        runs = prefill_runs(res["rounds"], arch_jobs[0].name)
        flash = ops.LAUNCHES["flash_attention"]
        assert flash == cfg.num_layers * runs, (arch, flash, runs)
        dec_jobs = [job for job in arch_jobs if job.phase == "decode"]
        dec = sum(decode_attn_layers(cfg) * prefill_runs(res["rounds"],
                                                         job.name)
                  for job in dec_jobs)
        assert ops.LAUNCHES["decode_attention"] == dec, \
            (arch, ops.LAUNCHES, dec)
        logits = {name: srv._exec[name]() for name in srv.jobs}
        torch.cuda.synchronize()
        for job in arch_jobs:
            want = ((job.batch_per_slice, job.seq, cfg.vocab_size)
                    if job.phase == "prefill" else
                    (job.batch_per_slice, cfg.vocab_size))
            lg = logits[job.name]
            assert tuple(lg.shape) == want, (job.name, lg.shape)
            assert bool(torch.isfinite(lg.float()).all()), \
                f"{job.name}: non-finite"
        log(f"[serve-slm] {arch} full width ({cfg.num_layers} layers, "
            f"d_model {cfg.d_model}, head dim {cfg.head_dim}, "
            f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv), bf16, seeded "
            f"random weights ({T.count_params(wts) / 1e9:.3f} B params, built "
            f"in {t_init:.2f} s), on the H100 model: rounds "
            f"{decisions(res['rounds'])}, drain wall_s {res['wall_s']:.4f}; "
            f"flash_attention launches {flash} = {cfg.num_layers} x {runs} "
            f"prefill runs, decode_attention launches {dec} (one an attn "
            f"layer a decode run; warm-up included); logits "
            + ", ".join(f"{n} {tuple(lg.shape)}" for n, lg in logits.items())
            + f" finite; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        step = arch_jobs[0].name
        alone = time_ms(torch, srv._exec[step], 3)
        sym = f"flash_fwd_wgmma_kernel<{cfg.head_dim}>"
        evs = kernel_events(torch, srv._exec[step], lambda evs: n_launches(
            evs, sym) == cfg.num_layers)
        total = sum(e.self_device_time_total for e in evs)
        k3 = [e for e in evs if sym in e.key]
        assert sum(e.count for e in k3) == cfg.num_layers, \
            [e.key for e in evs]
        k3_ms = sum(e.self_device_time_total for e in k3) / 1e3
        log(f"[profile {step}] step alone {alone:.3f} ms; device time "
            f"{total / 1e3:.3f} ms in {sum(e.count for e in evs)} kernels "
            f"(idle {1 - total / 1e3 / alone:.1%}); K3 "
            f"flash_fwd_wgmma_kernel<{cfg.head_dim}> {k3_ms:.3f} ms x"
            f"{cfg.num_layers} ({k3_ms / (total / 1e3):.1%})")
        for job in dec_jobs:
            decode_report(torch, "serve-slm", job.name, srv._exec[job.name],
                          decode_attn_layers(cfg))
        del srv, wts, logits, res
        torch.cuda.empty_cache()
    log(f"[main path] stablelm launches {slm_launches}")

    # ---- phase 3d: DeepSeek (MLA + MoE), counted ---------------------------
    ds_launches = dict.fromkeys(_build.NAMES, 0)
    ds = {"deepseek-v2-236b": [
              Job("tenantB-dsv2-prefill", "deepseek-v2-236b", "prefill", 2,
                  1, 2048),
              Job("tenantB-dsv2-decode", "deepseek-v2-236b", "decode", 4, 8,
                  4096)],
          "deepseek-v3-671b": [
              Job("tenantK-dsv3-prefill", "deepseek-v3-671b", "prefill", 2,
                  1, 2048)],
          "deepseek-v2-lite": [
              Job("tenantL-dsv2lite-prefill", "deepseek-v2-lite", "prefill",
                  2, 1, 4096)]}
    for arch, arch_jobs in ds.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=DS_DEPTH)
        kinds = [T._layer_sig(cfg, i) for i in range(cfg.num_layers)]
        n_moe = sum(is_moe for _, is_moe in kinds)
        t0 = time.time()
        wts = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        torch.cuda.synchronize()
        t_init = time.time() - t0
        n_params = T.count_params(wts)
        # the leaves' sizes, not the leaves: a list of the tensors would
        # keep the weights alive past ``del wts``, into later phases' peaks
        sizes = []
        T._tree_map(lambda a: sizes.append(a.numel() * a.element_size()),
                    wts)
        gib = sum(sizes) / 2**30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        srv = h100_server()
        for job in arch_jobs:
            srv.submit(job, params=wts, cfg=cfg)
        log(f"[serve-ds] {srv.capture_report()}")
        v5e_rounds = model_decisions(srv, TPU_V5E, tpu_profile_from_costs)
        res = srv.drain()
        for name in _build.NAMES:
            ds_launches[name] += ops.LAUNCHES[name]
        assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
        runs = prefill_runs(res["rounds"], arch_jobs[0].name)
        flash = ops.LAUNCHES["flash_attention"]
        assert flash == cfg.num_layers * runs, (arch, flash, runs)
        # MLA's absorbed decode attends in its latent space: D2 once a
        # layer a decode run, D1 never
        assert decode_attn_layers(cfg) == 0, arch
        assert ops.LAUNCHES["decode_attention"] == 0, (arch, ops.LAUNCHES)
        d2 = sum(mla_decode_layers(cfg) * prefill_runs(res["rounds"], j.name)
                 for j in arch_jobs if j.phase == "decode")
        assert ops.LAUNCHES["mla_decode"] == d2, (arch, ops.LAUNCHES, d2)
        # a dropless route's prompt runs its routed experts on G1, two
        # launches a MoE layer a prefill run; a capacity route never
        g1 = 2 * n_moe * sum(prefill_runs(res["rounds"], j.name)
                             for j in arch_jobs if j.phase == "prefill") \
            if cfg.moe.capacity_factor <= 0 else 0
        assert ops.LAUNCHES["grouped_experts"] == g1, (arch, ops.LAUNCHES, g1)
        logits = {name: srv._exec[name]() for name in srv.jobs}
        torch.cuda.synchronize()
        for job in arch_jobs:
            want = ((job.batch_per_slice, job.seq, cfg.vocab_size)
                    if job.phase == "prefill" else
                    (job.batch_per_slice, cfg.vocab_size))
            lg = logits[job.name]
            assert tuple(lg.shape) == want, (job.name, lg.shape)
            assert bool(torch.isfinite(lg.float()).all()), \
                f"{job.name}: non-finite"
        m, moe = cfg.mla, cfg.moe
        log(f"[serve-ds] {arch} full width (d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads, MLA kv_lora {m.kv_lora_rank} / q_lora "
            f"{m.q_lora_rank} / qk {m.qk_nope_dim}+{m.qk_rope_dim} / v "
            f"{m.v_head_dim}, {moe.num_experts} experts top-{moe.top_k} of "
            f"d_ff {moe.d_ff_expert} ({moe.router_act} router), "
            f"{moe.num_shared_experts} shared, vocab {cfg.vocab_size}), depth "
            f"cut num_layers {full.num_layers} -> {cfg.num_layers} "
            f"({cfg.num_layers - n_moe} dense + {n_moe} MoE), bf16, seeded "
            f"random weights ({n_params / 1e9:.3f} B params, {gib:.2f} GiB, "
            f"built in {t_init:.2f} s), on the H100 model: drain wall_s "
            f"{res['wall_s']:.4f}; flash_attention launches {flash} = "
            f"{cfg.num_layers} x {runs} prefill runs (warm-up included); "
            f"logits " + ", ".join(f"{n} {tuple(lg.shape)}"
                                   for n, lg in logits.items())
            + f" finite; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k1, k2, n1, n2, cp in res["rounds"]:
            log(f"[serve-ds] H100 model: round {k1} x {k2}: slices {n1}:{n2}, "
                f"predicted CP {cp:+.4f}")
        log(f"[serve-ds] decisions side by side (pair, slices), H100 | v5e: "
            f"{decisions(res['rounds'])} | {decisions(v5e_rounds)}")
        for job in arch_jobs:
            if job.phase == "decode":   # asserts no kernel of the port ran
                decode_report(torch, "serve-ds", job.name,
                              srv._exec[job.name], 0)
                continue
            alone = time_ms(torch, srv._exec[job.name], 3)
            n_want = cfg.num_layers
            evs = kernel_events(torch, srv._exec[job.name], lambda evs: (
                n_launches(evs, "flash_fwd_wgmma_kernel<192>") == n_want))
            total = sum(e.self_device_time_total for e in evs)
            assert total > 0, f"{job.name}: the profiler saw no device time"
            k3 = [e for e in evs if "flash_fwd_wgmma_kernel<192>" in e.key]
            n_k3 = sum(e.count for e in k3)
            assert n_k3 == n_want, \
                (job.name, n_k3, [e.key for e in evs])
            k3_ms = sum(e.self_device_time_total for e in k3) / 1e3
            top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
            log(f"[profile {job.name}] step alone {alone:.3f} ms; device "
                f"time {total / 1e3:.3f} ms in {sum(e.count for e in evs)} "
                f"kernels (idle {1 - total / 1e3 / alone:.1%}); K3 "
                f"flash_fwd_wgmma_kernel<192> {k3_ms:.3f} ms x{n_k3} "
                f"({k3_ms / (total / 1e3):.1%}); top: " + "; ".join(
                    f"{e.key[:56]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
        del srv, wts, logits, res
        torch.cuda.empty_cache()
    log(f"[main path] deepseek launches {ds_launches}")

    # ---- phase 3e: Qwen2-VL and Whisper (serve-multimodal), counted --------
    mm_archs = ("qwen2-vl-7b", "whisper-small")
    mm_cfg = {arch: get_config(arch) for arch in mm_archs}
    t0 = time.time()
    weights = {arch: T.init_params(mm_cfg[arch], torch.Generator(
        device=dev).manual_seed(0), device=dev) for arch in mm_archs}
    torch.cuda.synchronize()
    t_init = time.time() - t0
    n_params = {arch: T.count_params(weights[arch]) for arch in mm_archs}
    qcfg, wcfg = mm_cfg["qwen2-vl-7b"], mm_cfg["whisper-small"]
    mm_jobs = [Job("tenantL-qwen2vl-prefill", "qwen2-vl-7b", "prefill", 4, 1,
                   2048),
               Job("tenantL-qwen2vl-decode", "qwen2-vl-7b", "decode", 8, 8,
                   4096),
               Job("tenantM-whisper-prefill", "whisper-small", "prefill", 4,
                   8, 448),
               Job("tenantM-whisper-decode", "whisper-small", "decode", 8, 32,
                   448)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    srv = h100_server()
    for job in mm_jobs:
        srv.submit(job, params=weights[job.arch])
    t_submit = time.time() - t0
    log(f"[serve-mm] {srv.capture_report()}")
    v5e_rounds = model_decisions(srv, TPU_V5E, tpu_profile_from_costs)
    res = srv.drain()
    mm_launches = dict(ops.LAUNCHES)
    assert all(j.num_slices == 0 for j in srv.jobs.values()), "not drained"
    runs_l = prefill_runs(res["rounds"], mm_jobs[0].name)
    runs_m = prefill_runs(res["rounds"], mm_jobs[2].name)
    k3_l, k3_m = qcfg.num_layers, wcfg.num_layers + wcfg.encoder_layers
    assert (k3_l, k3_m) == (28, 24), (k3_l, k3_m)
    assert mm_launches["flash_attention"] == k3_l * runs_l + k3_m * runs_m, \
        (mm_launches, runs_l, runs_m)
    d1_l, d1_m = decode_attn_layers(qcfg), decode_attn_layers(wcfg)
    assert (d1_l, d1_m) == (28, 24), (d1_l, d1_m)
    dec_l = prefill_runs(res["rounds"], mm_jobs[1].name)
    dec_m = prefill_runs(res["rounds"], mm_jobs[3].name)
    assert mm_launches["decode_attention"] == d1_l * dec_l + d1_m * dec_m, \
        (mm_launches, dec_l, dec_m)
    logits = {name: srv._exec[name]() for name in srv.jobs}
    torch.cuda.synchronize()
    want_shapes = {mm_jobs[0].name: (1, 2048, qcfg.vocab_size),
                   mm_jobs[1].name: (8, qcfg.vocab_size),
                   mm_jobs[2].name: (8, 448, wcfg.vocab_size),
                   mm_jobs[3].name: (32, wcfg.vocab_size)}
    for name, lg in logits.items():
        assert tuple(lg.shape) == want_shapes[name], (name, lg.shape)
        assert bool(torch.isfinite(lg.float()).all()), f"{name}: non-finite"
    del logits
    # bf16 K and V a layer: the decode KV cache over the job's seq, and the
    # cross cache over the encoder's frames
    cache_gb = {job.name: 2 * 2 * cfg.num_layers * job.batch_per_slice * rows
                * cfg.num_kv_heads * cfg.head_dim / 1e9
                for job, cfg, rows in ((mm_jobs[1], qcfg, mm_jobs[1].seq),
                                       (mm_jobs[3], wcfg, wcfg.encoder_seq))}
    log(f"[serve-mm] qwen2-vl-7b ({qcfg.num_layers} layers, d_model "
        f"{qcfg.d_model}, {qcfg.num_heads} heads over {qcfg.num_kv_heads} "
        f"kv, "
        f"head dim {qcfg.head_dim}, M-RoPE sections "
        f"{L.mrope_sections(qcfg.head_dim)}, vocab {qcfg.vocab_size}; "
        f"{n_params['qwen2-vl-7b'] / 1e9:.3f} B params) and whisper-small "
        f"({wcfg.encoder_layers} encoder + {wcfg.num_layers} decoder layers, "
        f"d_model {wcfg.d_model}, {wcfg.num_heads} heads, head dim "
        f"{wcfg.head_dim}, {wcfg.encoder_seq} frames, vocab "
        f"{wcfg.vocab_size}; {n_params['whisper-small'] / 1e9:.3f} B params) "
        f"at full width, uncut, bf16, seeded random weights built in "
        f"{t_init:.2f} s, each shared by its arch's two tenants, on the H100 "
        f"model; {len(srv.jobs)} tenants submitted in {t_submit:.2f} s "
        f"(warm-up included); Qwen2-VL decode KV cache "
        f"{cache_gb[mm_jobs[1].name]:.3f} GB, Whisper decode cross cache "
        f"{cache_gb[mm_jobs[3].name]:.3f} GB; drain wall_s "
        f"{res['wall_s']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_attention launches {mm_launches['flash_attention']} = "
        f"{k3_l} x {runs_l} "
        f"Qwen2-VL + {k3_m} x {runs_m} Whisper prefill runs, "
        f"decode_attention launches {mm_launches['decode_attention']} = "
        f"{d1_l} x {dec_l} Qwen2-VL + {d1_m} x {dec_m} Whisper decode runs "
        f"(12 self + 12 cross; warm-up included); logits " + ", ".join(
            f"{n} {s}" for n, s in want_shapes.items()) + " finite")
    for k1, k2, n1, n2, cp in res["rounds"]:
        log(f"[serve-mm] H100 model: round {k1} x {k2}: slices {n1}:{n2}, "
            f"predicted CP {cp:+.4f}")
    log(f"[serve-mm] decisions side by side (pair, slices), H100 | v5e: "
        f"{decisions(res['rounds'])} | {decisions(v5e_rounds)}")
    log(f"[main path] multimodal launches {mm_launches}")
    k3_want = {mm_jobs[0].name: ("flash_fwd_wgmma_kernel<128>", k3_l),
               mm_jobs[2].name: ("flash_fwd_wgmma_kernel<64>", k3_m)}
    for job in (mm_jobs[0], mm_jobs[2]):
        alone = time_ms(torch, srv._exec[job.name], 3)
        torch.cuda.reset_peak_memory_stats()
        srv._exec[job.name]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        sym, n_want = k3_want[job.name]
        evs = kernel_events(torch, srv._exec[job.name], lambda evs: (
            n_launches(evs, sym) == n_want))
        total = sum(e.self_device_time_total for e in evs)
        assert total > 0, f"{job.name}: the profiler saw no device time"
        k3 = [e for e in evs if sym in e.key]
        n_k3 = sum(e.count for e in k3)
        assert n_k3 == n_want, (job.name, n_k3, [e.key for e in evs])
        k3_ms = sum(e.self_device_time_total for e in k3) / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
        log(f"[profile {job.name}] step alone {alone:.3f} ms; device time "
            f"{total / 1e3:.3f} ms in {sum(e.count for e in evs)} kernels "
            f"(idle {1 - total / 1e3 / alone:.1%}); K3 {sym} {k3_ms:.3f} ms "
            f"x{n_k3} ({k3_ms / (total / 1e3):.1%}); peak memory {peak:.2f} "
            f"GiB; top: " + "; ".join(
                f"{e.key[:56]} {e.self_device_time_total / 1e3:.3f} ms "
                f"x{e.count}" for e in top))
    for job, n, arch in ((mm_jobs[1], d1_l, "qwen2-vl-7b"),
                         (mm_jobs[3], d1_m, "whisper-small")):
        decode_report(torch, "serve-mm", job.name, srv._exec[job.name], n,
                      EARLIER_DECODE_MS.get(arch))
    del srv, res
    torch.cuda.empty_cache()
    # the losses, once each on a prefill batch: Qwen2-VL's labels are -1
    # over the 256 patch rows and the last position
    for arch, b, s in (("qwen2-vl-7b", 1, 2048), ("whisper-small", 8, 448)):
        cfg = mm_cfg[arch]
        raw = make_batch(cfg, b, s)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        masked = int((raw["labels"] < 0).sum())
        assert masked == b * (1 + VLM_PATCHES * (arch == "qwen2-vl-7b")), \
            masked
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, metrics = T.train_loss(weights[arch], cfg, batch)
        loss = float(loss)
        t_loss = time.perf_counter() - t0
        assert math.isfinite(loss) and all(math.isfinite(float(v)) for v in
                                           metrics.values()), (arch, metrics)
        log(f"[loss {arch}] train_loss on ({b}, {s}) "
            f"({'patches' if arch == 'qwen2-vl-7b' else 'audio'}, {masked} "
            f"labels masked): {loss:.4f} (ce {float(metrics['ce']):.4f}, aux "
            f"{float(metrics['aux']):.4f}; ln V = "
            f"{math.log(cfg.vocab_size):.4f}), {t_loss * 1e3:.1f} ms, "
            f"peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del weights, batch
    torch.cuda.empty_cache()

    # ---- phase 3f: Mellum2 (window and full layers), counted ---------------
    m2_launches = mellum2_phase(torch, dev, spec)
    log(f"[main path] mellum2 launches {m2_launches}")

    # ---- phase 5: training, counted ----------------------------------------
    train_launches = training_phase(torch, dev, card)
    log(f"[main path] training launches {train_launches}")

    # ---- phase 6: mesh and EP, counted -------------------------------------
    mesh_launches = mesh_phase(torch, dev, card)
    log(f"[main path] mesh launches {mesh_launches}")

    # ---- phase 7: the examples, counted ------------------------------------
    ex_launches = examples_phase(torch, card)
    log(f"[main path] examples launches {ex_launches}")

    # ---- phase 8: serving under the (1, 1) mesh, counted -------------------
    serve_launches = serving_mesh_phase(torch, dev, card)
    log(f"[main path] serving mesh launches {serve_launches}")

    launches = {name: launches[name] + rec_launches[name] + slm_launches[name]
                + ds_launches[name] + mm_launches[name] + m2_launches[name]
                + train_launches[name]
                + mesh_launches[name] + ex_launches[name]
                + serve_launches[name] for name in _build.NAMES}
    for name in _build.NAMES:
        assert launches[name] > 0, f"{name} never launched on the main paths"

    # ---- phase 4: results ------------------------------------------------
    kernels = []
    for name in _build.NAMES:
        row = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": row["source"], "replaces": row["replaces"],
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        **{k: row[k] for k in ("one_launch_ms", "slice132_ms",
                                               "sliced_bound_ms",
                                               "slice132_bound_ms",
                                               "serial_ms", "matmul_ms",
                                               "stream_ms",
                                               "fused_over_serial",
                                               "overlap_share", "occupancy",
                                               "stream_end_us", "stream_us",
                                               "peak_stream",
                                               "mm_resident_during",
                                               "mm_us_during",
                                               "mm_us_after", "mm_us_alone",
                                               "states_ms", "out_ms",
                                               "event_ms", "bf16_ms",
                                               "bf16_err", "clusters",
                                               "ctas_per_sm",
                                               "rel_err", "row_rel_err",
                                               "h100_runs", "h100_fused_ms",
                                               "h100_fused_over_serial",
                                               "splits", "kernel_only_ms",
                                               "combine_ms", "view_err",
                                               "extra_mib",
                                               "plain_extra_mib")
                           if k in row},
                        **{k: v for k, v in row.items()
                           if k.startswith(("d80_", "d160_", "d192_", "d128_",
                                            "d64_", "d48_", "train_",
                                            "shard_", "dec_", "mla_",
                                            "g1_"))}})
    for row in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(row[key]), (row["name"], key)
    log(f"[total] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

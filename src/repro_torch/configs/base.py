"""Config system: model architectures, input shapes, and run settings.

Every assigned architecture is a ``ModelConfig`` (frozen dataclass). Shapes
(train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeSpec``s. A
``(ModelConfig, ShapeSpec)`` pair fully determines the jitted step that the
dry-run lowers and the Kernelet scheduler treats as a schedulable kernel.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25   # 0: dropless, every pair is kept
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    router_act: str = "softmax"      # softmax | sigmoid (DeepSeek-V3)
    a2a_dtype: str = "bf16"          # bf16 | int8 (quantized EP dispatch
                                     # with per-row scales; halves ICI bytes)
    norm_topk_prob: bool = True      # False: weight each pair by its raw
                                     # router probability (DeepSeek-V2)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention. ``q_lora_rank`` 0 means
    a direct query projection ``wq`` (DeepSeek-V2-Lite), else the query
    goes through a latent of that rank (``wq_a``, ``q_norm``, ``wq_b``)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN RoPE scaling (arXiv:2309.00071), under the keys of a published
    ``config.json``'s ``rope_scaling``. Rotary pairs that turn fewer than
    ``beta_slow`` times over the original context are slowed by
    ``factor``, those that turn more than ``beta_fast`` times are kept, and
    the pairs between follow a linear ramp, and an attention's softmax
    scale is multiplied by mscale(``mscale_all_dim``) squared. YaRN also
    scales cos and sin by mscale(``mscale``) / mscale(``mscale_all_dim``),
    which is 1 in every published DeepSeek config; another ratio is
    refused."""
    type: str = "yarn"
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope_scaling type {self.type!r}: only 'yarn'")
        if self._mscale(self.mscale) != self._mscale(self.mscale_all_dim):
            raise ValueError("YaRN with mscale != mscale_all_dim scales cos "
                             "and sin, which the port does not")

    def _mscale(self, m: float) -> float:
        return 1.0 if self.factor <= 1 else 0.1 * m * math.log(self.factor) \
            + 1.0

    def correction_range(self, dim: int, theta: float) -> tuple:
        """(low, high): the rotary pairs of a ``dim``-wide rope between
        which the ramp runs."""
        def pair(rotations):
            return dim * math.log(self.original_max_position_embeddings
                                  / (rotations * 2 * math.pi)) \
                / (2 * math.log(theta))
        return (max(math.floor(pair(self.beta_fast)), 0),
                min(math.ceil(pair(self.beta_slow)), dim - 1))

    @property
    def softmax_gain(self) -> float:
        """What an attention's 1/sqrt(d) softmax scale is multiplied by."""
        if not self.mscale_all_dim:
            return 1.0
        return self._mscale(self.mscale_all_dim) ** 2


_NESTED = {"moe": MoEConfig, "mla": MLAConfig, "rope_scaling": RopeScaling}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    attention_kind: str = "full"     # full | local | none
    local_window: int = 2048
    pos_kind: str = "rope"           # rope | mrope | learned | none
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    mla: Optional[MLAConfig] = None

    # --- ffn ---
    act: str = "swiglu"              # swiglu | gelu | geglu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None

    # --- layer mixing (hybrid / attention-free) ---
    # cycled across layers; entries: "attn" | "local" | "rwkv6" | "rglru"
    block_pattern: tuple = ("attn",)

    # --- recurrent dims ---
    rwkv_head_dim: int = 64
    lru_width: int = 0               # 0 -> d_model

    # --- encoder-decoder ---
    encoder_layers: int = 0          # >0 -> enc-dec (whisper)
    encoder_seq: int = 1500          # whisper audio frames after conv stub

    # --- modality frontend (STUB: input_specs provides embeddings) ---
    frontend: str = "none"           # none | audio_stub | vision_stub

    # --- extras ---
    mtp: bool = False                # DeepSeek-V3 multi-token prediction head
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # attention impl: "chunked" (pure-XLA online-softmax; dry-run safe)
    #                 "pallas"  (TPU kernel; validated in interpret mode)
    attention_impl: str = "chunked"

    # --- performance levers (hillclimbed; defaults = paper-faithful
    # baseline, see EXPERIMENTS.md §Perf for before/after) ---
    mla_decode: str = "absorbed"     # absorbed | expand (baseline)
    moe_impl: str = "ep"             # ep (shard_map all-to-all) | dense
    xent_impl: str = "gather"        # gather | onehot (vocab-sharded safe)
    causal_skip: bool = False        # skip fully-masked attention KV blocks
    layout: str = "2d"               # 2d (TP over 'model') | fsdp (pure DP:
                                     # batch over every axis, params fully
                                     # sharded — right call for small archs
                                     # where TP collectives dominate)
    param_fsdp: bool = True          # shard params over 'data' (ZeRO/FSDP).
                                     # False = weights resident (replicated
                                     # over 'data'): the right call for
                                     # serving small archs — no per-step
                                     # weight gathers

    def __post_init__(self):
        # nested sizes given as mappings (a JSON file's) become dataclasses
        for key, kind in _NESTED.items():
            value = getattr(self, key)
            if isinstance(value, Mapping):
                object.__setattr__(self, key, kind(**value))
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------ #
    def layer_kinds(self) -> tuple:
        """Per-layer block kind, cycling block_pattern over num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv6", "rglru") for k in self.layer_kinds())

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer attends over the full (unbounded) context."""
        return all(k != "attn" for k in self.layer_kinds())

    # ---- parameter counting (used for MODEL_FLOPS = 6·N·D) ------------- #
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            n += 2 * d                                # 2 norms (scale only approx)
            if kind in ("attn", "local"):
                if self.mla is not None:
                    m = self.mla
                    qk = self.num_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    if m.q_lora_rank:
                        n += d * m.q_lora_rank + m.q_lora_rank * qk
                    else:                             # direct wq
                        n += d * qk
                    n += d * (m.kv_lora_rank + m.qk_rope_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * d
                else:
                    n += d * self.num_heads * hd      # q
                    n += 2 * d * self.num_kv_heads * hd  # k,v
                    n += self.num_heads * hd * d      # o
            elif kind == "rwkv6":
                nh = d // self.rwkv_head_dim
                n += 5 * d * d                        # wr,wk,wv,wg,wo
                n += nh * self.rwkv_head_dim          # u (bonus)
                n += 5 * (2 * 32 * d) + 6 * d         # token-shift loras + mus
                n += 2 * 64 * d                       # decay lora
            elif kind == "rglru":
                w = self.lru_width
                n += 2 * d * w + w * d                # w_in, w_gate, w_out
                n += 2 * w * w + w                    # w_a, w_x, Λ
                n += 4 * w                            # depthwise conv
            # ffn
            moe_here = self.moe is not None and i >= self.moe.first_dense_layers
            if moe_here:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                e_params = mult * d * self.moe.d_ff_expert
                n += self.moe.num_experts * e_params
                n += self.moe.num_shared_experts * e_params
                n += d * self.moe.num_experts        # router
                if active_only:
                    n -= (self.moe.num_experts - self.moe.top_k) * e_params
            else:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += 2 * d
                n += 4 * d * self.num_heads * hd
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            # cross-attention in decoder layers
            n += self.num_layers * 4 * d * self.num_heads * hd
        if self.mtp:
            n += 2 * d * d                            # MTP projection + norm-ish
        return int(n)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    phase: str          # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig) -> list:
    """Shapes valid for an arch. long_500k needs sub-quadratic attention."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        lru_width=0,
        rwkv_head_dim=32,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16,
        remat=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_ff_expert=64,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=32,
                                   q_lora_rank=64 if cfg.mla.q_lora_rank
                                   else 0,
                                   qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    return dataclasses.replace(cfg, **changes)


SMOKE_SHAPE = ShapeSpec("smoke", 32, 2, "train")
SMOKE_DECODE = ShapeSpec("smoke_decode", 64, 2, "decode")

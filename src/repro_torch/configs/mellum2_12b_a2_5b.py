"""Mellum2-12B-A2.5B — GQA with sliding-window and full layers side by
side, per-type RoPE (YaRN on the full layers only), MoE 64 experts top-8,
no shared expert, every layer sparse.

[huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct config.json]
28L d_model=2304 32H kv=4 head_dim=128, ``layer_types`` sliding (window
1024) on three layers of every four and full on layers 3, 7, ..., 27;
64 routed experts of 896, top-8, ``norm_topk_prob`` true, no shared
expert; vocab=98304 untied; RMSNorm eps 1e-6; context 131072; 12.15 B
parameters. What the config leaves to convention, as taken here:

- The router is a softmax over the 64 experts, top-8, the eight
  probabilities renormalised: the config names no ``scoring_func``, and
  softmax is the default for its set of keys.
- Serving keeps every (token, expert) pair (``capacity_factor`` 0).
- No per-head q/k norm and no MTP module: the config names neither.
- The window is q - k < 1024, as the published sliding mask and the
  port's ``attention._mask`` draw it.
- The full layers' ``rope_parameters`` (YaRN, factor 16 over 8192
  positions, theta 500000, beta 32 / 1, ``attention_factor`` 1.2773) are
  ``RopeScaling(factor=16, original_max_position_embeddings=8192,
  beta_fast=32, beta_slow=1, mscale=1, mscale_all_dim=1)``: its softmax
  gain (0.1 ln 16 + 1)^2 = 1.2773^2 is the published attention_factor on
  cos and sin of a fully rotated head. The sliding layers rotate by plain
  RoPE at theta 500000 (``models/transformer.py`` ``local`` blocks).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, RopeScaling

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=7168,                       # intermediate_size; no layer is dense
    vocab_size=98304,
    local_window=1024,
    pos_kind="rope",
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=16.0,
                             original_max_position_embeddings=8192,
                             beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                             mscale_all_dim=1.0),
    act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=896,
                  capacity_factor=0.0, norm_topk_prob=True),
    block_pattern=("local", "local", "local", "attn"),
)

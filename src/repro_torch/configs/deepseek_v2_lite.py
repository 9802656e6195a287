"""DeepSeek-V2-Lite 15.7B — MLA with a direct query projection, YaRN RoPE,
MoE 64 experts top-6 with 2 shared, dropless and unnormalised routing.

[arXiv:2405.04434; huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json]
27L d_model=2048 16H kv_lora=512 q_lora none, qk 128 + 64, v 128,
d_ff_expert=1408 vocab=102400 untied, first layer dense (d_ff=10944);
``norm_topk_prob`` false, ``routed_scaling_factor`` 1, greedy top-k in one
group; YaRN factor 40 over 4096 positions, mscale = mscale_all_dim = 0.707.
Tokens are dropped only in training, so serving keeps every pair
(``capacity_factor`` 0).
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      RopeScaling)

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                      # the dense first layer
    vocab_size=102400,
    pos_kind="rope",
    rope_theta=10000.0,
    rope_scaling=RopeScaling(factor=40.0,
                             original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                             mscale_all_dim=0.707),
    act="swiglu",
    norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, first_dense_layers=1,
                  capacity_factor=0.0, norm_topk_prob=False),
)

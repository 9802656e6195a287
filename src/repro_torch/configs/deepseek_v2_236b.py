"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 160 experts top-6, 2 shared.

[arXiv:2405.04434] 60L d_model=5120 128H d_ff_expert=1536 vocab=102400,
first layer dense (d_ff=12288).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,                      # dense layers
    vocab_size=102400,
    pos_kind="rope",
    act="swiglu",
    norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, first_dense_layers=1),
)

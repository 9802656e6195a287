"""DeepSeek-V3 671B — MLA + MoE 256 experts top-8, 1 shared, MTP head.

[arXiv:2412.19437] 61L d_model=7168 128H d_ff_expert=2048 vocab=129280,
first 3 layers dense (d_ff=18432).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # dense layers
    vocab_size=129280,
    pos_kind="rope",
    act="swiglu",
    norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_dense_layers=3,
                  router_act="sigmoid"),
    mtp=True,
)

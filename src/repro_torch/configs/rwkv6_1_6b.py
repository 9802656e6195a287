"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # 2048 / 64 head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attention_kind="none",
    pos_kind="none",
    act="relu2",             # RWKV channel-mix uses squared relu
    norm="layernorm",
    block_pattern=("rwkv6",),
    rwkv_head_dim=64,
)

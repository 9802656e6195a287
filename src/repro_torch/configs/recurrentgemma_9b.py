"""RecurrentGemma 9B (Griffin) — RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427] 38L d_model=4096 16H MQA kv=1 d_ff=12288 vocab=256000.
Pattern: (rglru, rglru, local) cycled — local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention_kind="local",
    local_window=2048,
    pos_kind="rope",
    act="geglu",
    norm="rmsnorm",
    block_pattern=("rglru", "rglru", "local"),
    lru_width=4096,
)

"""Qwen2-VL 7B — dense decoder with M-RoPE; vision frontend (STUB).

[arXiv:2409.12191] 28L d_model=3584 28H kv=4 d_ff=18944 vocab=152064.
Vision patches are precomputed embeddings from input_specs() (stub).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pos_kind="mrope",
    act="swiglu",
    norm="rmsnorm",
    frontend="vision_stub",
)

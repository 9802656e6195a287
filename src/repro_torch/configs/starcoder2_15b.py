"""StarCoder2 15B — dense decoder, GQA kv=4, RoPE.

[arXiv:2402.19173] 40L d_model=6144 48H kv=4 d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pos_kind="rope",
    act="gelu",              # StarCoder2 uses a non-gated GELU MLP
    norm="layernorm",
)

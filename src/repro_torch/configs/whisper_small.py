"""Whisper-small — encoder-decoder, conv audio frontend (STUB).

[arXiv:2212.04356] 12L enc + 12L dec, d_model=768 12H kv=12 d_ff=3072
vocab=51865. The conv frontend is a stub: input_specs() provides
precomputed frame embeddings of shape (batch, encoder_seq, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pos_kind="learned",
    act="gelu",
    norm="layernorm",
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_stub",
)

"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE, sliding-window 4096 attention. [arXiv:2402.19173]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    layer_plan=((("attn",), 40),),
    window=4096,  # the model's own sliding window => sub-quadratic long path
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    rope_theta=100000.0,
    fl_m=16,
    supports_long=True,
)

"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE, SwiGLU, GQA. [arXiv:2404.14219]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    layer_plan=((("attn",), 40),),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    fl_m=16,
    supports_long=False,  # full attention
)

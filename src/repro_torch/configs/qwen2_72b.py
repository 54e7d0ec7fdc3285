"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA with QKV bias. [arXiv:2407.10671]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    layer_plan=((("attn",), 80),),
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    fl_m=1,  # 72B: FSDP within pod; EF-HC across pods
    supports_long=False,  # full attention
)

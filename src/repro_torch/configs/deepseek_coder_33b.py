"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama architecture. [arXiv:2401.14196]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    source="arXiv:2401.14196",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    layer_plan=((("attn",), 62),),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=100000.0,
    fl_m=16,
    supports_long=False,  # full attention
)

"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; pool line: "MoE 40e top-8 — 32
experts top-8" — we follow the explicit expert count 32, top-8.]
"""
from repro_torch.models.common import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,  # FFN is fully MoE
    vocab=49155,
    layer_plan=((("moe",), 32),),
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, n_shared=0, impl="scatter"),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    fl_m=16,
    supports_long=False,  # full attention (DESIGN.md §4)
)

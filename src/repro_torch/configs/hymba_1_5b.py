"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per block;
sliding-window attention except global layers [0, 15, 31]. [arXiv:2411.13676]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    # global full-attention at 0 / 15 / 31, SWA elsewhere (model card)
    layer_plan=(
        (("hybrid_g",), 1),
        (("hybrid",), 14),
        (("hybrid_g",), 1),
        (("hybrid",), 15),
        (("hybrid_g",), 1),
    ),
    window=1024,
    ssm_state=16,
    ssm_expand=2,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    fl_m=16,
    supports_long=True,  # mamba state + windowed attention
)

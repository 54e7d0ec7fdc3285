"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (cycle of two mLSTM then one sLSTM, 4 repeats). [arXiv:2405.04517]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # xLSTM blocks carry their own up/down projections
    vocab=50304,
    layer_plan=((("mlstm", "mlstm", "slstm"), 4),),
    ssm_expand=2,
    mlstm_chunk=256,
    act="gelu",
    norm="layernorm",
    fl_m=16,
    supports_long=True,  # recurrent state, O(1)/token decode
)

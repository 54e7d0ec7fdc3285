"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP vision frontend (stubbed: input_specs supplies 256
patch embeddings of dim 1152) + gemma decoder, prefix-LM masking.
[arXiv:2407.07726]
"""
from repro_torch.models.common import ArchConfig, FrontendStub

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    layer_plan=((("attn",), 18),),
    act="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,  # gemma ties input/output embeddings
    frontend=FrontendStub(kind="vision", tokens=256, dim=1152),
    fl_m=16,
    supports_long=False,  # full attention
)

"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only transformer (wav2vec2 architecture); conv/mel frontend stubbed
(input_specs supplies frame embeddings); masked-prediction objective over a
504-codeword codebook.  No autoregressive decode (DESIGN.md §4).
[arXiv:2106.07447]
"""
from repro_torch.models.common import ArchConfig, FrontendStub

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    layer_plan=((("attn",), 48),),
    causal=False,  # bidirectional encoder
    act="gelu",
    norm="layernorm",
    frontend=FrontendStub(kind="audio", tokens=0, dim=512),
    fl_m=16,
    supports_decode=False,  # encoder-only: decode shapes skipped
    supports_long=False,
)

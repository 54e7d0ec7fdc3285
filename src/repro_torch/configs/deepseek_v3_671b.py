"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (routed expert
dim) vocab=129280 — MLA, 1 shared + 256 routed experts top-8, MTP head;
first 3 layers dense FFN (d_ff 18432 per the paper). [arXiv:2412.19437]
"""
from repro_torch.models.common import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # MLA: effectively MHA over the shared latent
    d_head=128,
    d_ff=18432,  # dense-FFN layers (first 3); experts use moe.d_expert
    vocab=129280,
    layer_plan=(
        (("mla",), 3),
        (("mla_moe",), 58),
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1, impl="scatter"),
    mtp=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    fl_m=1,  # 671B: one FL device per pod; EF-HC runs across pods
    supports_long=False,  # full (latent) attention
)

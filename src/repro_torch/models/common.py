"""Architecture configuration schema (the port's copy of
``repro/models/common.py``; the port imports nothing of ``repro``).

One ``ArchConfig`` per architecture (``repro_torch/configs/<id>.py``).  The
model is assembled from a ``layer_plan``: a sequence of stages, each a
(block-cycle, repeat) pair.  A stage's parameters are stacked along a
leading ``repeat`` axis and run as a Python loop over it.

Block types:
  attn        - attention + (dense MLP or nothing if d_ff == 0)
  attn_g      - the same with global attention (ignores ``window``)
  moe         - attention + MoE FFN
  mla         - MLA attention + dense MLP (deepseek-v3 first layers)
  mla_moe     - MLA attention + (shared + routed) MoE FFN
  hybrid      - parallel attention & mamba heads + dense MLP (hymba)
  mamba       - pure mamba block
  mlstm       - xLSTM matrix-memory block (no separate FFN)
  slstm       - xLSTM scalar-memory block (no separate FFN)

The port runs every block type (``models/blocks.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BlockCycle = Tuple[str, ...]
LayerPlan = Tuple[Tuple[BlockCycle, int], ...]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0  # shared (always-on) experts, deepseek style
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    impl: str = "dispatch"  # dispatch (GShard einsum, expert-parallel) | dense


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: precomputed embeddings of shape (batch,
    tokens, dim); the model owns only the projector."""
    kind: str  # "vision" | "audio"
    tokens: int  # e.g. 256 SigLIP patches; audio: frames = seq_len
    dim: int  # embedding dim delivered by the stub (1152 SigLIP, 512 conv)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str  # citation of the published configuration
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    layer_plan: LayerPlan
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size (None = full)
    global_layers: Tuple[int, ...] = ()  # layers that ignore `window`
    causal: bool = True  # False = encoder-only (hubert)
    attn_impl: str = "auto"  # auto | xla | chunked | banded | pallas_swa
    attn_chunk: int = 1024  # kv-chunk for the online-softmax path
    logit_softcap: float = 0.0

    # non-attention blocks
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mlstm_chunk: int = 256

    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    mtp: bool = False  # multi-token-prediction extra head (deepseek-v3)
    mtp_weight: float = 0.3

    frontend: Optional[FrontendStub] = None

    # distribution
    fl_m: int = 16  # FL devices along the `data` axis for train (1 => FSDP)
    remat: bool = True
    dtype: str = "bfloat16"

    # which input shapes are supported
    supports_decode: bool = True
    supports_long: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        total = sum(len(cycle) * rep for cycle, rep in self.layer_plan)
        assert total == self.n_layers, (
            f"{self.name}: layer_plan covers {total} layers, config says {self.n_layers}")

    @property
    def n_params(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    @property
    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def supported_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        out.append("decode_32k")
        if cfg.supports_long:
            out.append("long_500k")
    return out

"""Serving steps on one card (port of ``repro/launch/steps.py:213-228``).

The reference builds them over a device mesh with activation sharding; the
port runs the whole model on one GPU, so there is no mesh.  Both steps run
under ``torch.no_grad``.  Training steps are ROADMAP Queue 1 item 18.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.common import ArchConfig


def make_serve_step(cfg: ArchConfig):
    """(params, caches, tokens (B,), t) -> (logits (B, V), caches); the
    caches are updated in place."""
    @torch.no_grad()
    def serve_step(params, caches, tokens, t):
        return M.decode_step(cfg, params, caches, tokens, t)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> logits (B, S, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch)
        return logits

    return prefill_step

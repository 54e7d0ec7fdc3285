"""Plain PyTorch version of the sLSTM recurrence kernel: the reference's
``_slstm_cell`` (``repro/models/ssm.py:316-330``), one step at a time.

A step takes the input projection ``pre_x_t`` (B, 4, H, dh) in the model's
dtype (fp32 or bf16), the recurrent weights ``r`` (4, H, dh, dh) and the
bias ``b`` (4, H, dh) in that dtype, and the fp32 state (c, n, h, m), each
(B, H, dh).  As the reference rounds: ``h`` is rounded to the model's dtype
before the recurrent product, the product's result is in that dtype, and
``pre_x + rec + b`` adds in that dtype, rounding after each add, before the
cast to fp32; the gates are fp32 with ``log_f = -softplus(-f)`` and
``sigmoid(o) = 1 / (1 + exp(-o))`` op by op.
"""
from __future__ import annotations

import torch


def _softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, op by op in x's dtype."""
    return torch.where(torch.isnan(x), x, torch.clamp_min(x, 0)
                       + torch.log1p(torch.exp(-x.abs())))


def slstm_step(pre_x_t, r, b, c, n, h, m):
    """One step -> the new (c, n, h, m), fp32 (B, H, dh) each."""
    rec = torch.einsum("bhk,ghkj->bghj", h.to(pre_x_t.dtype), r)
    pre = (pre_x_t + rec + b).float()
    i_p, f_p, z_p, o_p = pre.unbind(1)
    log_f = -_softplus(-f_p)  # log sigmoid
    m_new = torch.maximum(log_f + m, i_p)
    i_s = torch.exp(i_p - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_p)
    n_new = f_s * n + i_s
    h_new = (1 / (1 + torch.exp(-o_p))) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, h_new, m_new


def slstm_scan_ref(pre_x, r, b, state):
    """pre_x (B, S, 4, H, dh), r (4, H, dh, dh), b (4, H, dh), state (c, n,
    h, m) fp32 (B, H, dh) each -> (hs (B, S, H, dh) fp32, the final state):
    ``slstm_step`` over time."""
    c, n, h, m = state
    hs = []
    for t in range(pre_x.shape[1]):
        c, n, h, m = slstm_step(pre_x[:, t], r, b, c, n, h, m)
        hs.append(h)
    if not hs:
        bsz, _, _, heads, dh = pre_x.shape
        return (torch.zeros((bsz, 0, heads, dh), dtype=torch.float32, device=pre_x.device),
                (c, n, h, m))
    return torch.stack(hs, 1), (c, n, h, m)

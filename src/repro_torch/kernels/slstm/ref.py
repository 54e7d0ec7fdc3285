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

The gradient (``slstm_scan_bwd_ref``) is a hand-derived reverse loop over
time from the rows a saving forward keeps (``slstm_scan_save_ref``: each
step's fp32 gate pre-activations and the state before it, the rows the
backward kernel reads).  It takes the derivative the reference takes
(``jax.grad``) at each op of ``_slstm_cell``: a tie of ``max`` splits its
gradient in halves (the stabilizer's ``max(log_f + m, i)`` and ``max(n',
1e-6)``, where autograd of ``clamp_min`` would give it all to n'),
``d log_f / d f = exp(log_f - f)`` (jax's ``logaddexp`` rule, 1 at f =
-inf: autograd of ``_softplus``'s op-by-op form gives 1 at f = 0, jax 0.5),
``tanh' = (1 + z)(1 - z)`` and ``sigmoid' = o (1 - o)``; m is carried.  It
rounds where autograd of the plain loop rounds: d pre to the model's dtype
(the backward of ``.float()``), ``dh_{t-1} = d pre_t . R^T`` a product in
that dtype, widened and added to ``d hs_{t-1}``, d pre_x_t d pre_t's bits;
d R and d b are sums over (b, t) taken in fp32 and rounded once.
"""
from __future__ import annotations

import torch


def _softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, op by op in x's dtype."""
    return torch.where(torch.isnan(x), x, torch.clamp_min(x, 0)
                       + torch.log1p(torch.exp(-x.abs())))


def _pre(pre_x_t, r, b, h):
    """A step's gate pre-activations (B, 4, H, dh): fp32, or fp64 unrounded
    where pre_x_t is fp64 (the fp64 mode)."""
    rec = torch.einsum("bhk,ghkj->bghj", h.to(pre_x_t.dtype), r)
    wide = pre_x_t.dtype == torch.float64
    return (pre_x_t + rec + b).to(torch.float64 if wide else torch.float32)


def slstm_step(pre_x_t, r, b, c, n, h, m):
    """One step -> the new (c, n, h, m), fp32 (B, H, dh) each."""
    return _cell(_pre(pre_x_t, r, b, h), c, n, m)


def _cell(pre, c, n, m):
    """The gates of ``pre`` (B, 4, H, dh) on the state (c, n, m) -> the new
    (c, n, h, m)."""
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


SAVE_ROWS = 7  # a step's saved rows: the pre-activations of i, f, z, o, then c, n, m before it


def slstm_scan_save_ref(pre_x, r, b, state, acc: torch.dtype | None = None):
    """``slstm_scan_ref`` that also keeps, for each step t, the rows the
    backward reads: save (B, S, SAVE_ROWS, H, dh), the four gates' fp32
    pre-activations and the state (c, n, m) before the step.  -> (hs, the
    final state, save).  With ``acc=torch.float64`` the whole recurrence
    runs in fp64 on the inputs' values, h and the sums unrounded."""
    bsz, s, _, heads, dh = pre_x.shape
    wide = acc == torch.float64
    c, n, h, m = (t.double() for t in state) if wide else state
    rw, bw = (r.double(), b.double()) if wide else (r, b)
    save = torch.empty((bsz, s, SAVE_ROWS, heads, dh), dtype=acc or torch.float32,
                       device=pre_x.device)
    hs = torch.empty((bsz, s, heads, dh), dtype=save.dtype, device=pre_x.device)
    for t in range(s):
        pre = _pre(pre_x[:, t].to(save.dtype) if wide else pre_x[:, t], rw, bw, h)
        save[:, t, :4] = pre
        save[:, t, 4], save[:, t, 5], save[:, t, 6] = c, n, m
        c, n, h, m = _cell(pre, c, n, m)
        hs[:, t] = h
    return hs, (c, n, h, m), save


def _share(x, z, y):
    """max's gradient share for x at z = max(x, y), as ``jax.grad`` takes it:
    1 where x is the max alone, 1/2 at a tie, 0 else (and where z is NaN)."""
    return torch.where(x == z, torch.where(y == z, 0.5, 1.0), 0.0).to(z.dtype)


def _cell_bwd(pre, c, n, m, gh, gc, gn, gm):
    """The reverse of ``_cell`` at one step: from the step's pre (B, 4, H,
    dh), the state before it and the gradients of its outputs (h, and the
    carried c, n, m) -> (d pre (B, 4, H, dh), and the gradients of the state
    before it: dc, dn, dm), in pre's dtype."""
    i_p, f_p, z_p, o_p = pre.unbind(1)
    log_f = -_softplus(-f_p)
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_p)
    i_s = torch.exp(i_p - m_new)
    f_s = torch.exp(lfm - m_new)
    z = torch.tanh(z_p)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    o = 1 / (1 + torch.exp(-o_p))
    nn = torch.clamp_min(n_new, 1e-6)
    gq = gh / nn
    h = (o * c_new) / nn
    g_n = gn + -(gq * h) * _share(n_new, nn, torch.full_like(nn, 1e-6))
    g_c = gc + gq * o
    d_o = (gq * c_new) * (o * (1 - o))
    g_fs = g_c * c + g_n * n
    g_is = g_c * z + g_n
    d_z = (g_c * i_s) * ((1 + z) * (1 - z))
    e_i, e_f = g_is * i_s, g_fs * f_s
    g_mn = (gm - e_i) - e_f  # m' feeds both exps
    g_a = e_f + g_mn * _share(lfm, m_new, i_p)
    d_i = e_i + g_mn * _share(i_p, m_new, lfm)
    dlogf = torch.where(f_p == -torch.inf, 1.0, torch.exp(log_f - f_p)).to(pre.dtype)
    d_f = g_a * dlogf
    return torch.stack((d_i, d_f, d_z, d_o), 1), g_c * f_s, g_n * f_s, g_a


def slstm_bwd_walk_ref(r, h0, save, hs, dhs, dfinal=None, dtype=None):
    """The reverse walk over time of the sLSTM gradient from the saving
    forward's rows ``save`` and its hs (B, S, H, dh), given dhs (B, S, H, dh)
    and the final state's gradients ``dfinal`` (dc, dn, dh, dm) (zeros if
    None) -> (d pre_x (B, S, 4, H, dh) in the model's dtype, dR, db, (dc0,
    dn0, dh0, dm0) fp32).  ``dtype`` is the model's (r's when None); an fp64
    ``save`` (the fp64 mode) keeps everything in fp64, unrounded."""
    dtype = dtype or r.dtype
    acc = save.dtype
    wide = acc == torch.float64
    bsz, s, _, heads, dh = save.shape
    zeros = torch.zeros((bsz, heads, dh), dtype=acc, device=save.device)
    gc, gn, dh_rec, gm = (zeros.clone() for _ in range(4)) if dfinal is None else (
        t.to(acc) for t in dfinal)
    rr = r.to(acc) if wide else r
    dpx = torch.empty((bsz, s, 4, heads, dh), dtype=acc if wide else dtype, device=save.device)
    for t in reversed(range(s)):
        row = save[:, t]
        gh = dhs[:, t].to(acc) + dh_rec
        dpre, gc, gn, gm = _cell_bwd(row[:, :4], row[:, 4], row[:, 5], row[:, 6], gh, gc, gn,
                                     gm)
        dpre = dpre if wide else dpre.to(dtype)
        dpx[:, t] = dpre
        dh_rec = torch.einsum("bghj,ghkj->bhk", dpre, rr).to(acc)
    dr, db = weight_grads(h0, hs, dpx, acc if wide else dtype)
    return dpx, dr, db, (gc, gn, dh_rec, gm)


def weight_grads(h0, hs, dpx, dtype):
    """dR and db from a walk's d pre_x rows (B, S, 4, H, dh): sums over (b, t)
    of ``round(h_{t-1}) d pre_t`` and of ``d pre_t`` (h_{-1} = h0), in fp32
    (fp64 for an fp64 ``dtype``) and rounded once to ``dtype``."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    hprev = torch.cat((h0[:, None].to(hs.dtype), hs[:, :-1]), 1)[:, :hs.shape[1]]
    hprev = hprev.to(dtype).to(acc)
    dpf = dpx.to(acc)
    dr = torch.einsum("bshk,bsghj->ghkj", hprev, dpf)
    return dr.to(dtype), dpf.sum((0, 1)).to(dtype)


def slstm_scan_bwd_ref(pre_x, r, b, state, dhs, dfinal=None, acc: torch.dtype = torch.float32):
    """The gradient of ``slstm_scan_ref`` given dhs (B, S, H, dh) and the
    final state's gradients (dc, dn, dh, dm) or None: (d pre_x, dR, db,
    (dc0, dn0, dh0, dm0)), the first three in the inputs' dtype, the state's
    fp32.  ``slstm_scan_save_ref`` then ``slstm_bwd_walk_ref``; with
    ``acc=torch.float64`` both in fp64, unrounded, the gradients returned in
    fp64: the exact reference the kernel's tests hold it against."""
    wide = acc == torch.float64
    hs, _, save = slstm_scan_save_ref(pre_x, r, b, state, acc=acc if wide else None)
    return slstm_bwd_walk_ref(r, state[2], save, hs, dhs, dfinal, dtype=pre_x.dtype)

"""Plain PyTorch versions of the selective-scan kernels: a sequential loop
over time on a (B, di, n) fp32 state, with the kernel's arithmetic (the
reference's ``repro/models/ssm.py:77-88`` computes the same recurrence as an
associative scan, in another order), and its gradient as an explicit
reverse recurrence.  Time runs in blocks of TIME_BLOCK steps: a block's
decays and inputs are computed at once, the loop over its steps is two ops
a step, and its outputs are one product and sum, which gives the same
values as computing each step alone with a bounded (B, TIME_BLOCK, di, n)
working set."""
from __future__ import annotations

import torch

TIME_BLOCK = 256


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a_log: torch.Tensor) -> torch.Tensor:
    """x, dt (B, S, di), b, c (B, S, n), a_log (di, n), one dtype -> y (B, S,
    di) fp32: ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t``, ``y_t = h_t .
    c_t`` with ``a = -exp(a_log)`` and h_0 = 0; ``dt_t x_t`` is rounded to
    the inputs' dtype, everything else is fp32."""
    a = -torch.exp(a_log.float())
    dtx = (dt * x).float()
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t0 in range(0, x.shape[1], TIME_BLOCK):
        sl = slice(t0, t0 + TIME_BLOCK)
        decay = torch.exp(dt[:, sl, :, None].float() * a)
        inp = dtx[:, sl, :, None] * b[:, sl, None, :].float()
        hs = []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inp[:, t]
            hs.append(h)
        ys.append((torch.stack(hs, 1) * c[:, sl, None, :].float()).sum(-1))
    if not ys:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return torch.cat(ys, 1)


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, a_log: torch.Tensor, dy: torch.Tensor,
                           acc: torch.dtype = torch.float32) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan_ref`` given dy (B, S, di): (dx, ddt,
    db, dc, da_log), each in its input's dtype.  The states at each time
    block's start come from a forward pass; then the blocks run backwards,
    each recomputing its states and decays and walking its steps back with
    ``g_t = dy_t c_t + decay_{t+1} g_{t+1}`` (two ops a step), its sums
    taken over the block at once: ``dc_t = sum_d dy_t h_t``, ``db_t =
    sum_d g_t u_t``, ``du_t = sum_j g_t b_t``, the decay's part of ddt
    ``sum_j g_t h_{t-1} decay_t a`` and ``da += sum g h_{t-1} decay dt``.
    u = dt x is rounded to the inputs' dtype, and its gradient passes the
    rounding as autograd passes a cast: du rounded, ``dx = du dt`` and
    ``du x`` rounded, the decay's part rounded before it is added;
    ``da_log = da a``.  With ``acc=torch.float64`` everything after the
    rounding of u is fp64 and the gradients are returned unrounded, in
    fp64: the exact reference the kernel's tests hold it against."""
    a = -torch.exp(a_log.to(acc))
    dtx = (dt * x).to(acc)
    dtf, bf, cf, dyf = dt.to(acc), b.to(acc), c.to(acc), dy.to(acc)
    bsz, s, di = x.shape
    blocks = list(range(0, s, TIME_BLOCK))
    h = torch.zeros((bsz, di, a.shape[1]), dtype=acc, device=x.device)
    starts = []
    for t0 in blocks:
        starts.append(h)
        sl = slice(t0, t0 + TIME_BLOCK)
        decay = torch.exp(dtf[:, sl, :, None] * a)
        inp = dtx[:, sl, :, None] * bf[:, sl, None, :]
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + inp[:, t]
    du = torch.empty((bsz, s, di), dtype=acc, device=x.device)
    ddt_decay = torch.empty_like(du)
    db = torch.empty((bsz, s, a.shape[1]), dtype=acc, device=x.device)
    dc = torch.empty_like(db)
    da = torch.zeros_like(a)
    carry = torch.zeros_like(h)  # decay_{t+1} g_{t+1}
    for t0, h0 in zip(reversed(blocks), reversed(starts)):
        sl = slice(t0, t0 + TIME_BLOCK)
        decay = torch.exp(dtf[:, sl, :, None] * a)
        inp = dtx[:, sl, :, None] * bf[:, sl, None, :]
        hs = [h0]
        for t in range(decay.shape[1]):
            hs.append(decay[:, t] * hs[-1] + inp[:, t])
        hs = torch.stack(hs, 1)  # h_{t0 - 1} .. h_{t0 + L - 1}
        dyc = dyf[:, sl, :, None] * cf[:, sl, None, :]
        gs = [None] * decay.shape[1]
        for t in reversed(range(decay.shape[1])):
            gs[t] = dyc[:, t] + carry
            carry = decay[:, t] * gs[t]
        g = torch.stack(gs, 1)
        dc[:, sl] = (dyf[:, sl, :, None] * hs[:, 1:]).sum(2)
        db[:, sl] = (g * dtx[:, sl, :, None]).sum(2)
        du[:, sl] = (g * bf[:, sl, None, :]).sum(-1)
        q = g * hs[:, :-1] * decay  # g h_{t-1} decay
        ddt_decay[:, sl] = (q * a).sum(-1)
        da += (q * dtf[:, sl, :, None]).sum((0, 1))
    if acc != torch.float32:
        return du * dtf, du * x.to(acc) + ddt_decay, db, dc, da * a
    du = du.to(x.dtype)
    dx = du * dt
    ddt = du * x + ddt_decay.to(x.dtype)
    return (dx, ddt, db.to(b.dtype), dc.to(c.dtype), (da * a).to(a_log.dtype))

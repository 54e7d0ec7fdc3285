"""jax's threefry2x32 PRNG in torch integer ops (non-partitionable mode).

Every trajectory channel of the simulator depends on ``jax.random``: the
bandwidth draw and initial keys, the per-step key split, the edge-dropout
stream, randomized gossip and model init.  This module reproduces those
streams bit for bit, so the port realizes the same graph, trigger and init
sequences as the JAX reference from the same seed.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 words of
a legacy jax key.  All uint32 arithmetic runs in int64 masked to 32 bits,
so the same code runs on the CPU and on CUDA.  Leading key axes broadcast:
a ``(N, 2)`` key array draws N independent streams in one pass, which is
how the per-edge ``fold_in``/``uniform`` draws stay vectorized.

The functions follow jax 0.9.0's ``jax/_src/prng.py`` (``threefry_seed``,
``threefry_2x32``, ``_threefry_split_original``, ``threefry_fold_in``,
``_threefry_random_bits_original``) and ``jax/_src/random.py``
(``_uniform``, ``_normal_real``) with ``jax_threefry_partitionable=False``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    y = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK
            y = x0 ^ _rotl(y, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y = (y + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, y


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Hash a flat uint32 counter array under ``key`` (..., 2).

    As in jax, the counters are cut into a first and a second *half* (an
    odd length is padded with one zero word), the halves are hashed as
    word pairs, and the two outputs are concatenated back.  Returns
    ``key.shape[:-1] + (n,)``."""
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    half = count.shape[0] // 2
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    y0, y1 = threefry2x32(k1, k2, count[:half], count[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (x64 disabled):
    the key words are ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    counts = torch.arange(num * 2, dtype=torch.int64, device=key.device)
    bits = threefry_2x32(key, counts)
    return bits.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` with ``data`` taken as uint32 (a negative
    int32 wraps, as ``jnp.asarray(data, 'uint32')`` does).  ``data`` may be
    a tensor: the result is one key per element, broadcast against the
    leading axes of ``key``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k1, k2 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words, ``key.shape[:-1] + shape`` int64 in [0, 2**32)."""
    size = math.prod(shape)
    if size >= MASK:
        raise NotImplementedError("random_bits beyond 2**32 - 1 words")
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    bits = threefry_2x32(key, counts)
    return bits.reshape(key.shape[:-1] + tuple(shape))


def _f64(x):
    # tensors widen to float64; Python numbers round to float32 first, so
    # constants carry their float32 value (and stay kernel scalars, never
    # a host-to-device copy)
    return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding, as XLA's CPU backend
    contracts it into a fused multiply-add.  The float64 product of two
    float32 values is exact, so only the final sum rounds (twice, through
    float64: a tie-breaking difference at odds of about 2**-29)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA computes it.  Taken
    through float64 (exact for float32 inputs after the one rounding back):
    torch's vectorized float32 ``sqrt`` on some CPUs is off by an ulp in
    about one value in six."""
    return x.double().sqrt().float()


def uniform(key: torch.Tensor, shape: tuple[int, ...] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the mantissa bits of a float in
    [1, 2), minus 1, then ``* (maxval - minval) + minval`` and a floor at
    ``minval``, in that order and all in fp32."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(fma_f32(floats, span, lo), min=lo)


# Giles' single-precision erfinv polynomial, the expansion XLA lowers
# ``chlo.erf_inv`` to for float32
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# XLA's log1p for |x| < sqrt(2) - 1: the Cephes rational approximation,
# polynomials evaluated by Horner's rule with fused multiply-adds
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


# XLA's CPU log: Cephes' float32 log, range-reduced to a mantissa in
# [sqrt(1/2), sqrt(2)) and a polynomial with fused multiply-adds
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log`` as XLA's CPU backend computes it in float32 (finite
    positive inputs; zero, inf and NaN are not handled)."""
    c = _LOG_P
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    mant = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = mant < 0.707106781186547524
    e = e - low.float()
    z = (mant - 1.0) + torch.where(low, mant, 0.0)
    z2 = z * z
    z3 = z2 * z
    y = fma_f32(fma_f32(z, c[0], c[1]), z, c[2])
    y1 = fma_f32(fma_f32(z, c[3], c[4]), z, c[5])
    y2 = fma_f32(fma_f32(z, c[6], c[7]), z, c[8])
    y = fma_f32(fma_f32(fma_f32(y, z3, y1), z3, y2), z3, _LOG_Q1 * e)
    return ((z - 0.5 * z2) + y) + _LOG_Q2 * e


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` as XLA's elemental emitter computes it in float32: the
    Cephes rational form for small |x|, ``log(1 + x)`` above."""
    def horner(cs):
        r = torch.zeros_like(x)
        for c in cs:
            r = fma_f32(r, x, c)
        return r

    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + fma_f32(-0.5, x2, small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -log1p_f32(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with u
    uniform on [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv_f32(u)

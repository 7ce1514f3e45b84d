"""The port's own copy of JAX's default pseudo-random generator
(threefry-2x32 with ``jax_threefry_partitionable``, the default), so that a
seed draws the reference's weights: ``key``, ``split``, ``random_bits``,
``uniform`` and ``normal`` give ``jax.random``'s numbers for float32, and
``log_f32`` / ``expm1_f32`` give ``jnp.log`` / ``jnp.expm1``'s (the SSM
initialisers), all bit for bit.

Everything is torch tensor arithmetic on the device it is asked for: the
32-bit words live in int64 tensors masked to 32 bits, so the same code runs
on the CPU and on CUDA. A draw of n values computes the generator at
counters 0..n-1 (a 64-bit iota split into hi/lo words), ``_CHUNK`` at a
time, so a leaf of billions of elements never holds more than one chunk of
temporaries. Where JAX's float32 arithmetic rounds a multiply-add once
(XLA fuses it), the copy computes it in float64 and rounds once to float32.
XLA's float32 log, log1p, exp and tanh are its polynomials, copied here in
plain arithmetic, and the one square root is refined to double precision
before it is rounded, so no result rests on a torch math function's
last bit.

A key is a pair of Python ints (the two 32-bit words of a raw JAX key).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 24

# XLA's single-precision erf_inv (Giles): w < 5 and w >= 5 coefficients
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s raw words: the seed's high and low 32
    bits."""
    seed = int(seed)
    return ((seed >> 32) & _M32, seed & _M32)


def threefry2x32(k: Key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) (int64
    tensors holding 32-bit values) under key k. Returns two new tensors."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(_M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _blocks(k: Key, start: int, n: int, device):
    """The generator's two output words at counters start..start+n-1."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return threefry2x32(k, idx >> 32, idx & _M32)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` (the partitionable form)."""
    b1, b2 = _blocks(k, 0, num, "cpu")
    return list(zip(b1.tolist(), b2.tolist()))


def random_bits(k: Key, n: int, start: int = 0, device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 values below 2**32) for flat
    elements start..start+n-1 of a draw: ``jax.random.bits``'s words."""
    b1, b2 = _blocks(k, start, n, device)
    return b1.bitwise_xor_(b2)


def _f32(x) -> float:
    return float(np.float32(x))


def _uniform_flat(k: Key, start: int, n: int, lo: float, hi: float, device) -> torch.Tensor:
    """Flat elements start..start+n-1 of ``uniform(k, shape, lo, hi)``."""
    bits = random_bits(k, n, start, device)
    one = (bits >> 9) | 0x3F800000                          # [1, 2) as float32 bits
    floats = one.to(torch.int32).view(torch.float32) - 1.0  # exact
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(hi32 - lo32)                               # float32 arithmetic
    v = (floats.double() * span + float(lo32)).float()      # one rounding, as XLA's fma
    return torch.clamp_min(v, float(lo32))


# XLA's float32 log1p: a Cephes rational for |x| < sqrt(2) - 1, else
# log(1 + x) with the Cephes logf polynomial (both as XLA's CPU backend
# emits them, multiply-adds fused)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
           1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
           3.3333331174E-1)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (through float64)."""
    a, b, c = (t.double() if isinstance(t, torch.Tensor) else _f32(t) for t in (a, b, c))
    return (a * b + c).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of positive normal float32 v as XLA's CPU backend
    computes it, in plain arithmetic (the same bits on every device, unlike
    ``torch.log``): Cephes logf. frexp, shift the mantissa to
    [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial, add e log(2)."""
    bits = v.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 126).float()
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    low = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c) for c in _LOGF_P]
    y = _fma(p[0], x, p[1])
    y1 = _fma(p[3], x, p[4])
    y2 = _fma(p[6], x, p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    x = x - x2 * 0.5
    x = x + y
    return x + e * _f32(0.693359375)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p of x in (-1, 0]."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = _fma(-0.5, x2, (x * x2) * r)
    small = x + small
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, log_f32(x + 1.0))


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of x >= 0, from plain
    float64 arithmetic: two Newton steps refine float64 ``sqrt`` to double
    precision before one rounding. A float32 ``torch.sqrt`` of a large CPU
    tensor now and then returns other bits for one intra-op thread's share
    of it, run to run."""
    x64 = x.double()
    y = torch.sqrt(x64)
    for _ in range(2):
        y = torch.where(y > 0, 0.5 * (y + x64 / y), y)
    return y.float()


# XLA's float32 tanh (Eigen's rational: odd numerator, even denominator in
# x^2) and exp (Cephes: x = m ln2 + r, a degree-5 polynomial in r)
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
             5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
             4.89352518554385e-03)
_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
          1.6666665459E-1, 5.0000001201E-1)


def _tanh_f32(x: torch.Tensor) -> torch.Tensor:
    c = _f32(7.99881172180175781)
    xc = torch.clamp(x, -c, c)
    x2 = xc * xc
    num = xc * _horner(x2, _TANH_NUM)
    return torch.where(x.abs() < _f32(0.0004), x, num / _horner(x2, _TANH_DEN))


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    m = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    r = _fma(m, _f32(-0.693359375), x)
    r = _fma(m, _f32(2.12194440e-4), r)
    y = _fma(_horner(r, _EXP_P), r * r, r) + 1.0
    return y * ((m.to(torch.int32) + 127) << 23).view(torch.float32)   # y 2^m, exact


def expm1_f32(v: torch.Tensor) -> torch.Tensor:
    """``jnp.expm1`` of float32 v as XLA's CPU backend computes it:
    tanh(v/2) (exp(v) + 1) for |v| <= 1/2, else exp(v) - 1, with XLA's
    float32 tanh and exp, in plain arithmetic (the same bits on every
    device), for |v| < 87."""
    e = _exp_f32(v)
    out = torch.where(v.abs() > 0.5, e - 1.0, _tanh_f32(v * 0.5) * (e + 1.0))
    return torch.where(v * 0.5 == 0, v, out)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erf_inv: w = -log1p(-x^2); a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3; +-inf at |x| = 1. Each
    Horner step is one float32-rounded multiply-add."""
    xx = x * x
    w = -_log1p_f32(-xx)
    small = w < 5.0
    t = torch.where(small, w - 2.5, _sqrt_f32(w) - 3.0).double()
    sel = small.double()
    lt, ge = _ERFINV_LT5, _ERFINV_GE5
    p = (sel * _f32(lt[0]) + (1 - sel) * _f32(ge[0])).float()
    for a, b in zip(lt[1:], ge[1:]):
        c = sel * _f32(a) + (1 - sel) * _f32(b)            # the float32 coefficient, exactly
        p = (c + p.double() * t).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def _flat_draw(n: int, device, fn, dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, _CHUNK):
        m = min(_CHUNK, n - start)
        out[start:start + m] = fn(start, m)
    return out


def uniform(k: Key, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, lo, hi)``."""
    n = math.prod(shape)
    return _flat_draw(n, device, lambda s, m: _uniform_flat(k, s, m, lo, hi, device)
                      ).view(tuple(shape))


def normal(k: Key, shape: Sequence[int], device="cpu", scale: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """``(jax.random.normal(key, shape, jnp.float32) * scale).astype(dtype)``:
    sqrt(2) erf_inv(u), u uniform in [nextafter(-1, 0), 1), times ``scale``
    in float32, then cast. Drawn a chunk at a time into the output."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2, scale = _f32(math.sqrt(2.0)), _f32(scale)

    def draw(start, m):
        return _erf_inv_f32(_uniform_flat(k, start, m, lo, 1.0, device)) * sqrt2 * scale

    return _flat_draw(math.prod(shape), device, draw, dtype).view(tuple(shape))

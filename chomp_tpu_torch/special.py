"""Special functions: the NFW profile's Si/Ci auxiliary functions, erfc
and the Bessel functions J0, J1, J2.

PyTorch counterpart of the JAX package's ``special.py`` (the NFW y(k, M),
the Zheng HOD and the covariance stack's bin-averaged Bessel factors).  Same Chebyshev tables
(``_special_coeffs``, copied verbatim), same branch structure, and the
same float32 trimming: :func:`_trim` drops tail coefficients below 3e-9,
the Si/Ci power series keeps 10 terms and the asymptotic g series 4
terms in float32.  Every branch is evaluated on clamped arguments and
selected with ``torch.where`` — the plain version of the halo_contract
kernel runs on these.
"""

from __future__ import annotations

import math

import torch

from chomp_tpu_torch import _special_coeffs as _cf

_EULER_GAMMA = 0.5772156649015329
_HALF_PI = 0.5 * math.pi


def _trim(coeffs, x, tol32: float = 3e-9):
    """Drop Chebyshev tail terms below float32's needs (float32 only)."""
    if x.dtype != torch.float32:
        return coeffs
    out = list(coeffs)
    while len(out) > 2 and abs(out[-1]) < tol32:
        out.pop()
    return out


def n_series(dtype) -> int:
    """Si/Ci power-series terms: 16 in float64, 10 in float32."""
    return 10 if dtype == torch.float32 else 16


def n_g_asym(dtype) -> int:
    """Asymptotic g(x) terms: 7 in float64, 4 in float32."""
    return 4 if dtype == torch.float32 else 7


def _clenshaw(coeffs, x):
    """Chebyshev series at x in [-1, 1]; ``coeffs`` is a static list."""
    coeffs = _trim(coeffs, x)
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for ck in reversed(coeffs[1:]):
        b1, b2 = 2.0 * x * b1 - b2 + ck, b1
    return x * b1 - b2 + coeffs[0]


def _cheb_on(coeffs, lo, hi, t):
    return _clenshaw(coeffs, (2.0 * t - (hi + lo)) / (hi - lo))


def _sici_series(x):
    """Si, Ci power series for x <= 4."""
    t = x * x
    si = torch.zeros_like(x)
    ci = torch.zeros_like(x)
    for k in range(n_series(x.dtype) - 1, -1, -1):
        csi = (-1.0) ** k / ((2 * k + 1) * math.factorial(2 * k + 1))
        si = si * t + csi
        if k >= 1:
            cci = (-1.0) ** k / ((2 * k) * math.factorial(2 * k))
            ci = ci * t + cci
    si = si * x
    ci = ci * t + _EULER_GAMMA + torch.log(x)
    return si, ci


def _f_small(xs):
    """f(x) for x <= 4 from the series (no cancellation there)."""
    si_s, ci_s = _sici_series(xs)
    return (_HALF_PI - si_s) * torch.cos(xs) + ci_s * torch.sin(xs)


def aux_g(x):
    """g(x), full range (Si = pi/2 - f cos - g sin, Ci = f sin - g cos)."""
    xs = torch.clamp(x, 1e-300, 4.0)
    si_s, ci_s = _sici_series(xs)
    g_small = (_HALF_PI - si_s) * torch.sin(xs) - ci_s * torch.cos(xs)
    u = 1.0 / torch.clamp_min(x, 4.0)
    ua = torch.clamp(u, _cf.sici_a_range[0], _cf.sici_a_range[1])
    ga = _cheb_on(_cf.sici_a_g, *_cf.sici_a_range, ua) * ua * ua
    ub = torch.clamp(u, _cf.sici_b_range[0], _cf.sici_b_range[1])
    gb = _cheb_on(_cf.sici_b_g, *_cf.sici_b_range, ub) * ub * ub
    xc = torch.clamp_min(x, 64.0)
    w = 1.0 / (xc * xc)
    gc = torch.zeros_like(x)
    for k in range(n_g_asym(x.dtype) - 1, -1, -1):
        gc = gc * w + (-1.0) ** k * math.factorial(2 * k + 1)
    gc = gc * w
    out = torch.where(x <= 16.0, ga, torch.where(x <= 64.0, gb, gc))
    return torch.where(x <= 4.0, g_small, out)


def aux_fm(x):
    """f(x) - 1/x, cancellation-free at large x."""
    xs = torch.clamp(x, 1e-300, 4.0)
    f_small = _f_small(xs) - 1.0 / xs
    u = 1.0 / torch.clamp_min(x, 4.0)
    ua = torch.clamp(u, _cf.sici_a_range[0], _cf.sici_a_range[1])
    fm_a = _cheb_on(_cf.sici_a_fm, *_cf.sici_a_range, ua) * ua
    ub = torch.clamp(u, _cf.sici_b_range[0], _cf.sici_b_range[1])
    fm_b = _cheb_on(_cf.sici_b_fm, *_cf.sici_b_range, ub) * ub
    xc = torch.clamp_min(x, 64.0)
    w = 1.0 / (xc * xc)
    fm_c = torch.zeros_like(x)
    for k in range(6, 0, -1):
        fm_c = fm_c * w + (-1.0) ** k * math.factorial(2 * k)
    fm_c = fm_c * w / xc
    out = torch.where(x <= 16.0, fm_a, torch.where(x <= 64.0, fm_b, fm_c))
    return torch.where(x <= 4.0, f_small, out)


def nfw_n(x, c):
    """mu(c) y: g(x) + sin(cx) fm((1+c)x) - cos(cx) g((1+c)x)
    (the cancellation-free NFW transform, profiles.y_nfw)."""
    b = (1.0 + c) * x
    cx = c * x
    return aux_g(x) + torch.sin(cx) * aux_fm(b) - torch.cos(cx) * aux_g(b)


_SQRT_2_PI = math.sqrt(2.0 / math.pi)


def _pq(p_coeffs, q_coeffs, x):
    """The asymptotic P, Q of the Hankel expansion at x >= 8."""
    u = torch.clamp((8.0 / x) ** 2, 0.0, 1.0)
    return (_cheb_on(p_coeffs, 0.0, 1.0, u),
            _cheb_on(q_coeffs, 0.0, 1.0, u) * torch.sqrt(u))


def j0(x):
    """Bessel J0: a Chebyshev table in x^2 below 8, the Hankel expansion
    above."""
    x = torch.abs(x)
    t = torch.clamp(x * x, 0.0, 64.0)
    small = _cheb_on(_cf.j0_small, 0.0, 64.0, t)
    xl = torch.clamp_min(x, 8.0)
    p, q = _pq(_cf.bessel_p0, _cf.bessel_q0, xl)
    chi = xl - 0.25 * math.pi
    large = _SQRT_2_PI / torch.sqrt(xl) * (p * torch.cos(chi)
                                           - q * torch.sin(chi))
    return torch.where(x <= 8.0, small, large)


def j1(x):
    """Bessel J1 (odd)."""
    sign = torch.sign(x)
    x = torch.abs(x)
    t = torch.clamp(x * x, 0.0, 64.0)
    small = _cheb_on(_cf.j1_small, 0.0, 64.0, t) * x
    xl = torch.clamp_min(x, 8.0)
    p, q = _pq(_cf.bessel_p1, _cf.bessel_q1, xl)
    chi = xl - 0.75 * math.pi
    large = _SQRT_2_PI / torch.sqrt(xl) * (p * torch.cos(chi)
                                           - q * torch.sin(chi))
    return sign * torch.where(x <= 8.0, small, large)


def j2(x):
    """Bessel J2: a J2/x^2 table below 8 (no 2 J1/x - J0 cancellation),
    the recurrence above."""
    x = torch.abs(x)
    t = torch.clamp(x * x, 0.0, 64.0)
    small = _cheb_on(_cf.j2_small, 0.0, 64.0, t) * t
    xl = torch.clamp_min(x, 8.0)
    large = 2.0 * j1(xl) / xl - j0(xl)
    return torch.where(x <= 8.0, small, large)


def erfc(x):
    """Complementary error function (float32-safe occupation tails)."""
    return torch.special.erfc(x)

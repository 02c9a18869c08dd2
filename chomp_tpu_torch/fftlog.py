"""FFTLog Hankel operator (float64 numpy, built once per grid).

Copy of the numpy half of the JAX package's ``fftlog.py`` (the JAX
module imports jax): Hamilton 2000's log-convolution Hankel transform
collapsed into one dense real operator by pushing the identity through
the FFT pipeline.
The port applies it through ``correlation.wtheta_operator`` and the
composed operators built on it (``correlation.wtheta_bins_operator``,
``limber_fft.wtheta_lattice_operator``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _mellin_jmu(mu: float, s):
    """M_mu(s) = 2^(s-1) Gamma((mu+s)/2) / Gamma((mu+2-s)/2), complex."""
    from scipy.special import loggamma

    s = np.asarray(s, dtype=np.complex128)
    ln = ((s - 1.0) * np.log(2.0) + loggamma((mu + s) / 2.0)
          - loggamma((mu + 2.0 - s) / 2.0))
    # Gamma poles in the DENOMINATOR (e.g. q=2, mu=0 at eta=0) mean
    # M -> 0; complex-inf arithmetic would give nan, so patch explicitly.
    finite = np.isfinite(ln)
    return np.where(finite, np.exp(np.where(finite, ln, 0.0)), 0.0)


def _lowring_y0(mu: float, q: float, dln: float, x0: float, y0_target: float):
    """Hamilton's low-ringing choice: pick y0 near y0_target such that
    the Nyquist Mellin factor u_{N/2} is real (kills sawtooth ringing)."""
    eta_nyq = np.pi / dln
    m = _mellin_jmu(mu, q + 1j * eta_nyq)
    # phase(u_nyq) = arg(m) - eta_nyq * ln(x0 y0)  ==  0  (mod pi)
    ln_xy = (np.angle(m)) / eta_nyq
    target = np.log(x0 * y0_target)
    k = np.round((target - ln_xy) / (np.pi / eta_nyq))
    ln_xy = ln_xy + k * (np.pi / eta_nyq)
    return float(np.exp(ln_xy) / x0)


@lru_cache(maxsize=None)
def hankel_operator(n: int, ln_x0: float, dln: float, mu: float,
                    q: float = 1.0, taper_lo: float = 0.0,
                    taper_hi: float = 0.0):
    """Dense real operator H and output grid y for
        G(y_j) = sum_m H[j, m] a(x_m),   x_m = exp(ln_x0 + m dln),
    on the reciprocal grid centred against x with Hamilton's low-ringing
    y0 (the JAX function's defaults for ``y0_target`` and ``lowring``).

    ``taper_lo``/``taper_hi`` are fractions of the log-range cosine^2-
    tapered at each end (applied inside H) to suppress periodic-
    wraparound ringing from non-decayed endpoints.

    Returns (y_grid (n,), H (n, n)) as float64 numpy arrays (cached; cast
    to the runtime dtype at use site).
    """
    x0 = float(np.exp(ln_x0))
    x = np.exp(ln_x0 + dln * np.arange(n))
    y0 = _lowring_y0(mu, q, dln, x0, 1.0 / (x0 * np.exp(dln * (n - 1))))
    y = y0 * np.exp(dln * np.arange(n))

    eta = 2.0 * np.pi * np.fft.fftfreq(n) / dln
    u = _mellin_jmu(mu, q + 1j * eta) * (x0 * y0) ** (-1j * eta)

    # Cosine^2 end tapers.
    taper = np.ones(n)
    n_lo = int(round(taper_lo * n))
    n_hi = int(round(taper_hi * n))
    if n_lo > 0:
        s = np.sin(0.5 * np.pi * np.arange(n_lo) / n_lo)
        taper[:n_lo] = s * s
    if n_hi > 0:
        s = np.sin(0.5 * np.pi * np.arange(n_hi) / n_hi)
        taper[n - n_hi:] = (s * s)[::-1]

    # Push the (tapered, biased) identity through the FFT pipeline:
    # G_j = y_j^{-q} (1/n) FFT( FFT(b) * u )_j,  b_m = a_m (x_m/x_0)^{-q}.
    # (The bias is taken against x/x_0 so all x_0 powers cancel into the
    # (x_0 y_0)^{-i eta} phase above.)
    b = np.diag(taper * (x / x0) ** -q)            # (n, n): columns = basis
    bt = np.fft.fft(b, axis=0)
    g = np.fft.fft(bt * u[:, None], axis=0) / n
    h = ((x0 * y) ** -q)[:, None] * g.real
    return y, np.ascontiguousarray(h)

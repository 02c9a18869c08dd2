"""chomp_tpu_torch against the golden oracle values of tests/goldens.py
(float64 CPU, DEFAULT_GRID), at the tolerances of the JAX package's
tests that read them: comoving distance and growth (1e-6,
tests/test_background.py), the linear power, sigma(M) and nu(M) (1e-6,
tests/test_linear.py), the NFW y(k, M) (3e-5, tests/test_profiles.py)
and w(theta) on the linear power (1e-4, tests/test_correlation.py)."""

import numpy as np
import pytest
import torch

from chomp_tpu_torch import (background, correlation, default_cosmo,
                             default_halo, linear, mass, profiles,
                             projection)
from chomp_tpu_torch.grids import Statics
from chomp_tpu_torch.params import DEFAULT_GRID
from tests import goldens
from torch_threads import capped_threads  # noqa: F401 (autouse)

KW = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def st():
    return Statics(DEFAULT_GRID, **KW)


@pytest.fixture(scope="module")
def cosmo():
    return default_cosmo(**KW).batched()


def t64(x):
    return torch.tensor(x, **KW)


def test_distance_and_growth(st, cosmo):
    chi = background.comoving_distance(cosmo, t64([[0.5, 1.0]]), st)
    np.testing.assert_allclose(chi.numpy()[0], [goldens.chi_05,
                                                goldens.chi_10], rtol=1e-6)
    d = background.growth_factor(cosmo, t64([1.0]), st)
    np.testing.assert_allclose(d.numpy()[0], goldens.growth_1, rtol=1e-6)


def test_linear_power_sigma_nu(st, cosmo):
    z0 = t64([0.0])
    p = linear.linear_power(cosmo, t64([goldens.p_lin_k]), z0, st)
    np.testing.assert_allclose(p.numpy()[0], goldens.p_lin, rtol=1e-6)
    r = linear.radius_of_mass(cosmo, t64([goldens.sigma_m_masses]))
    sigma = torch.sqrt(linear.power_norm(cosmo, st)[:, None]
                       * linear.sigma2_unnorm_r(cosmo, r, st, z0))
    np.testing.assert_allclose(sigma.numpy()[0], goldens.sigma, rtol=1e-6)
    nu = (background.delta_c(cosmo, z0)[:, None] / sigma) ** 2
    np.testing.assert_allclose(nu.numpy()[0], goldens.nu, rtol=1e-6)


def test_y_nfw(st, cosmo):
    hp = default_halo(**KW)
    z0 = t64([0.0])
    m_star = mass.m_star(mass.build_mass_tables(cosmo, hp, z0, st))
    k, m = (t64([[v[i] for v in goldens.y_nfw_km]]) for i in (0, 1))
    y = profiles.y_nfw(cosmo, hp, k, m, m_star, z0)
    np.testing.assert_allclose(y.numpy()[0], goldens.y_nfw, rtol=3e-5)


def test_wtheta_on_the_linear_power(st, cosmo):
    dist = projection.DNdzGaussian(*(t64(v) for v in (0.0, 2.0, 1.0, 0.2)))
    win = projection.WindowGalaxy(dist)
    w = correlation.wtheta(cosmo, win, win,
                           projection.power_table_linear(cosmo, st), st,
                           theta_deg=goldens.w_theta_deg)
    np.testing.assert_allclose(w.numpy()[0], goldens.w_theta, rtol=1e-4)

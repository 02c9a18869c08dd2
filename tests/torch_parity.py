"""Shared inputs and JAX reference values of the chomp_tpu_torch parity
tests (tests/test_torch_*.py).

One tiny grid (``__graft_entry__._tiny_grid`` with a 0.04 lattice) and
three cosmologies from numpy; the third switches on every knob the port
folds into its kernels' inputs (baryon c_scale / k_scale, massive
neutrinos, a_mod).  :func:`jax_reference` compiles ONE JAX program that
evaluates the halo model, its spectra on the k lattice and the w(theta)
+ gamma_t pipeline (bench.py configuration A on the tiny grid), so the
parity tests pay the XLA compile once per process.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as graft
from chomp_tpu import default_cosmo, default_halo, projection
from chomp_tpu import halo as jhalo
from chomp_tpu import limber_fft as jlimber
from chomp_tpu.hod import default_hod
from chomp_tpu.parallel.sweep import broadcast_cosmo, make_pipeline

GRID = graft._tiny_grid().replace(lattice_dln=0.04)
Z_PIVOT = 1.0
COSMO = dict(omega_m0=[0.25, 0.278, 0.31], sigma_8=[0.76, 0.811, 0.86],
             bary_c=[1.0, 1.0, 0.8], bary_eta=[0.0, 0.0, 0.3],
             m_nu=[0.0, 0.0, 0.1], a_mod=[1.0, 1.0, 1.1])

MASS_FIELDS = ("ln_m", "w_lnm", "m", "sigma", "nu", "dnu_dlnm", "f_nu",
               "bias", "dndlnm", "f_norm", "bias_norm", "ln_m_star",
               "delta_c", "growth")
GAL_FIELDS = ("ln_m", "w_lnm", "m", "dndlnm", "bias", "n_first",
              "n_second", "nu")
MODEL_FIELDS = ("n_g", "m_star", "n_first", "n_second", "ln_m_sw1",
                "ln_m_sw2")
POWERS = ("linear_power", "power_mm", "power_gm", "power_gg")
INTEGRALS = ("h_m", "h_g", "pp_mm", "pp_gg", "pp_gm")
PIPELINE = ("n_g", "w_theta", "gamma_t")


def jax_dist():
    return projection.DNdzGaussian(
        z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
        z0=jnp.asarray(1.0), sigma_z=jnp.asarray(0.2))


def jax_batch():
    arrays = {k: jnp.asarray(v) for k, v in COSMO.items()}
    arrays["omega_l0"] = jnp.asarray(1.0 - np.asarray(COSMO["omega_m0"]))
    return broadcast_cosmo(default_cosmo(), **arrays)


def flatten(model, powers, integrals):
    """Halo-model fields, the five mass integrals (``two_halo_integrals``
    + ``one_halo_integrals``) and the spectra under flat names."""
    out = {f"mass.{f}": getattr(model.mass, f) for f in MASS_FIELDS}
    out.update({f"integrals.{f}": v for f, v in zip(INTEGRALS, integrals)})
    out.update({f"gal.{f}": getattr(model.gal, f) for f in GAL_FIELDS})
    out.update({f: getattr(model, f) for f in MODEL_FIELDS})
    out.update({f"powers.{k}": powers[k] for k in POWERS})
    return out


@lru_cache(maxsize=None)
def jax_reference():
    """name -> float64 numpy array for the 3 cosmologies: the halo model
    (``flatten``) at z = Z_PIVOT and ``pipe.<key>`` pipeline outputs."""
    k = jnp.asarray(np.exp(jlimber.k_lattice(GRID)))
    pipe = make_pipeline(default_halo(), default_hod(), jax_dist(),
                         power_spec="power_gg", grid=GRID,
                         include_lensing=True, z_pivot=Z_PIVOT)

    def one(c):
        model = jhalo.build_halo_model(c, default_halo(), default_hod(),
                                       Z_PIVOT, False, GRID)
        integrals = (jhalo.two_halo_integrals(c, default_halo(), model, k)
                     + jhalo.one_halo_integrals(c, default_halo(), model, k,
                                                False, GRID))
        out = flatten(model, jhalo.powers(c, default_halo(), model, k,
                                          False, GRID), integrals)
        res = pipe(c)
        out.update({f"pipe.{key}": res[key] for key in PIPELINE})
        return out

    out = jax.jit(jax.vmap(one))(jax_batch())
    return {name: np.asarray(v) for name, v in out.items()}

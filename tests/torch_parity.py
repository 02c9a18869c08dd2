"""Shared inputs and JAX reference values of the chomp_tpu_torch parity
tests (tests/test_torch_*.py).

One tiny grid (``__graft_entry__._tiny_grid`` with a 0.04 lattice) and
three cosmologies from numpy; the third switches on every knob the port
folds into its kernels' inputs (baryon c_scale / k_scale, massive
neutrinos, a_mod).  :func:`jax_reference` compiles ONE JAX program that
evaluates the halo model, its spectra on the k lattice and the w(theta)
+ gamma_t pipeline (bench.py configuration A on the tiny grid), so the
parity tests pay the XLA compile once per process.  The same program
evaluates the ``method="table"`` route and its pieces (windows, power
tables, Limber C_ell, the correlation functions) at ``Z_QUERY``.
"""

from functools import lru_cache
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as graft
from chomp_tpu import correlation, default_cosmo, default_halo, projection
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
#: Redshifts of the window checks.
Z_QUERY = np.linspace(0.05, 1.95, 7)


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


def table_pieces(c, model, p_gg_table):
    """The table route's pieces for one cosmology: the windows at
    Z_QUERY, the mean redshifts, the P_gg and linear ln P tables, and
    Limber C_ell of gg and kappa-g on P_gg and of kappa-kappa on the
    linear table (the correlation functions are these C_ell through
    ``correlation.wtheta_from_cl``, checked on the host).  The P_gg table
    is ``power_table_halo``'s body (projection.py:283-288) on
    ``p_gg_table``, P_gg at the table's k from the one ``halo.powers``
    evaluation of :func:`jax_reference`."""
    win_g = projection.WindowGalaxy(dist=jax_dist())
    win_k = projection.WindowConvergence(dist=jax_dist())
    ells = jnp.asarray(correlation.ell_grid(GRID)[0])
    ln_k, dln = projection._k_table(GRID)
    pt_gg = projection.PowerTable(
        ln_k0=ln_k[0], dln=jnp.asarray(dln),
        ln_p=jnp.log(jnp.maximum(p_gg_table, 1e-300)),
        growth_pivot=model.mass.growth)
    pt_lin = projection.power_table_linear(c, False, GRID)
    z = jnp.asarray(Z_QUERY)
    return {"window.galaxy": win_g.window_z(c, z, GRID),
            "window.kappa": win_k.window_z(c, z, GRID),
            "z_bar.gg": projection.z_bar(c, win_g, win_g, GRID),
            "z_bar.kg": projection.z_bar(c, win_k, win_g, GRID),
            "ln_p.power_gg": pt_gg.ln_p, "ln_p.linear": pt_lin.ln_p,
            "cl.gg": projection.limber_cl(c, win_g, win_g, ells, pt_gg, GRID),
            "cl.kg": projection.limber_cl(c, win_k, win_g, ells, pt_gg, GRID),
            "cl.kk": projection.limber_cl(c, win_k, win_k, ells, pt_lin,
                                          GRID)}


@lru_cache(maxsize=None)
def jax_reference():
    """name -> float64 numpy array for the 3 cosmologies: the halo model
    (``flatten``) at z = Z_PIVOT, ``pipe.<key>`` and ``table.<key>``
    outputs of the lattice and table routes, and :func:`table_pieces`."""
    k = jnp.asarray(np.exp(jlimber.k_lattice(GRID)))
    # One spectra evaluation at the lattice k and the table k together
    # (elementwise in k); split below.
    k_all = jnp.concatenate([k, jnp.exp(projection._k_table(GRID)[0])])
    kw = dict(power_spec="power_gg", grid=GRID, include_lensing=True,
              z_pivot=Z_PIVOT)
    pipe = make_pipeline(default_halo(), default_hod(), jax_dist(), **kw)
    table = make_pipeline(default_halo(), default_hod(), jax_dist(),
                          method="table", **kw)

    def one(c):
        model = jhalo.build_halo_model(c, default_halo(), default_hod(),
                                       Z_PIVOT, False, GRID)
        integrals = (jhalo.two_halo_integrals(c, default_halo(), model, k)
                     + jhalo.one_halo_integrals(c, default_halo(), model, k,
                                                False, GRID))
        p_all = jhalo.powers(c, default_halo(), model, k_all, False, GRID)
        out = flatten(model, {kind: p[:k.shape[0]]
                              for kind, p in p_all.items()}, integrals)
        res = pipe(c)
        out.update({f"pipe.{key}": res[key] for key in PIPELINE})
        res = table(c)
        out.update({f"table.{key}": res[key] for key in PIPELINE})
        out.update(table_pieces(c, model,
                                p_all["power_gg"][k.shape[0]:]))
        return out

    out = jax.jit(jax.vmap(one))(jax_batch())
    return {name: np.asarray(v) for name, v in out.items()}


@lru_cache(maxsize=None)
def port_table_inputs():
    """The port's side of :func:`table_pieces` (float64 CPU, same inputs):
    a namespace with the statics ``st``, the batch ``cosmo``, the windows
    ``win_g`` / ``win_k``, the halo ``model`` at Z_PIVOT and the ln P
    ``tables`` ("power_gg", "linear")."""
    import torch

    from chomp_tpu_torch import halo as port_halo
    from chomp_tpu_torch import projection as port_proj
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.utils import convert

    kw = dict(device="cpu", dtype=torch.float64)
    st = Statics(GRID, **kw)
    cosmo = convert.cosmo_batch(jax_batch(), **kw)
    dist = convert.dndz_gaussian(jax_dist(), **kw)
    hp = convert.halo_params(default_halo(), **kw)
    model = port_halo.build_halo_model(
        cosmo, hp, convert.hod_zheng(default_hod(), **kw),
        torch.tensor([Z_PIVOT], **kw), st)
    tables = {"power_gg": port_proj.power_table_halo(cosmo, hp, model,
                                                     "power_gg", st),
              "linear": port_proj.power_table_linear(cosmo, st)}
    return SimpleNamespace(st=st, cosmo=cosmo, model=model, tables=tables,
                           win_g=port_proj.WindowGalaxy(dist),
                           win_k=port_proj.WindowConvergence(dist))

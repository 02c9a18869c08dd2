"""Write the JAX reference values of the port's two routes.

Runs the JAX package on the CPU: bench.py configuration A
(``make_pipeline(default_halo(), default_hod(), DNdzGaussian(0, 2, 1,
0.2), power_spec="power_gg", include_lensing=True, z_pivot=1.0)`` on
DEFAULT_GRID) for cosmologies taken from bench.py's 512-point linspaces
(omega_m 0.24..0.32 with omega_l = 1 - omega_m, sigma_8 0.75..0.88), and
writes

- ``tests/data/torch_slice_reference.json``: the lattice route
  (``method="fft"``), float64, w(theta) and gamma_t at 3 cosmologies;
- ``tests/data/torch_table_reference.json``: the GL + cubic-table route
  (``method="table"``), float64, at the same 3 cosmologies, plus two
  figures measured on the 9 cosmologies that ``chip_smoke.py`` compares
  (its 8 checked ones and the 3 above): the worst-bin error of the JAX
  package's own float32 table route against its float64 one, and the
  worst-bin gap between the float64 table and lattice routes;
- ``tests/data/torch_grad_reference.json``: ``jax.jacfwd`` of the data
  vector (w(theta), then gamma_t) with respect to (omega_m0, sigma_8),
  omega_l0 = 1 - omega_m0, float64, for both routes at DEFAULT_GRID (the
  3 cosmologies above and the fiducial 0.278, 0.811) and on the parity
  tests' tiny grid (``tests/torch_parity.GRID`` and its 3 cosmologies),
  plus d P_gg(k = 1) / d omega_m0 at z = 0 on that grid (the quantity of
  tests/test_halo.py::test_jit_grad_through_halo_power).  Each block
  records its grid spec, so a test can tell when the file is stale;
- ``tests/data/torch_exactz_reference.json``: bench.py configuration B
  (``exact_z_anchors=6``, z_pivot 0, 64-point linspaces) at 3
  cosmologies, w(theta) and gamma_t with their ``jax.jacfwd``;
  configuration A with ``include_shear=True`` on both routes (xi_plus,
  xi_minus, w, gamma_t) at the 3 cosmologies of the files above, and the
  float64 gap between the routes' xi_+- on the 9 cosmologies that
  ``chip_smoke.py`` compares; ``projection.limber_cl_exact_z`` (32 GL
  nodes, each with its own halo model) and ``limber_fft.
  limber_cl_fft_exact_z`` (J = 8) at the configuration of
  tests/test_exact_z_lattice.py::test_exact_z_gg_matches_table_route;
  and, on the parity tests' tiny grid at its 3 cosmologies, the outputs
  of an exact-z pipeline with shear (J = 4) and of both separable routes
  with shear, and the exact-z pipeline's ``jax.jacfwd``.

- ``tests/data/torch_tomo_reference.json``: the tomographic cell of
  ``chip_smoke.py`` phases 13-14, a DES Y3-like 3x2pt layout (Abbott et
  al. 2022, arXiv:2105.13549: 5 lens bins, 4 source bins, 45 probes;
  ``make_tomographic_pipeline`` with per-bin Zheng HODs, z_pivot 0.6,
  ``with_nuisance`` and ``include_magnification`` on DEFAULT_GRID), its
  definition (the Gaussian stand-in dN/dz, the HODs, and the nuisance
  point drawn from ``--seed`` at DES Y3 prior widths), its outputs at 3
  cosmologies of the 512-point linspaces and the ``jax.jacfwd`` of its
  data vector with respect to (omega_m0, sigma_8, dz_src, m, a_ia) at the
  fiducial; and, for tests/test_torch_tomographic.py, the ``jax.jacfwd``
  of that file's magnification case on the parity grid (float64).

- ``tests/data/torch_options_reference.json``: the option cells of
  ``chip_smoke.py`` phases 15-19 (``OPTION_CELLS``: config A with BAO,
  halofit, the kappa_CMB row and the non-Limber repair with RSD, and its
  jacfwd; the curved sky at DES Y3 theta with Tinker and linear mm legs;
  config B curved with halofit; the table route with BAO and Tinker; the
  tomographic cell above with every option) at DEFAULT_GRID and the 3
  reference cosmologies, each in a process of its own; and, for
  tests/test_torch_options.py, the same cells on the tomographic tests'
  tiny grid at TINY_THETA_DEG with the flat cell's jacfwd.

- ``tests/data/torch_emulator_reference.json``: for
  tests/test_torch_emulator.py, on that file's own numpy inputs: the JAX
  package's ``Emulator`` of its seeded weights, its ``emu(p)`` and
  ``jax.jacfwd(emu)`` at its points, and ``train_emulator``'s scalings,
  basis and rank (one epoch) on each of its PCA cases.

- ``tests/data/torch_cov_reference.json``: the flat-sky covariance stack
  (``covariance``, ``ssc``, ``mask``, ``trispectrum``), eager float64
  JAX one cosmology at a time: ``tiny``, the cases of
  tests/torch_cov_cases.py (the covariance tests' grid and cosmologies)
  with the CPU seconds each took; ``chip_joint``, chip_smoke.py phase
  27's joint w(theta) + gamma_t matrix (``JOINT_CELL``: the survey of
  examples/joint_covariance_example.py on DEFAULT_GRID at the builders'
  defaults, cNG + SSC + clip) at 3 cosmologies of the 64-point
  linspaces, with the worst block gap of ``jax.jit(jax.vmap)`` to the
  scalar program (the gap tests/test_covariance.py:506 measured); and
  ``chip_tomo``, phase 28's gate, bins 0-1 of the tomographic cell with
  DES Y3's survey (``DES_Y3_SURVEY``) at ``DES_THETA_EDGES_DEG``, raw
  (``cov_raw``, ``psd_guard=None``) and clipped (``cov``).  Each
  block is made in a process of its own (``--cov-part tiny|chip_joint|
  chip_tomo <file>``; on an 8-core CPU 17 min, about 20 min and 57 min:
  the 78 probe-pair blocks of the 2 x 2 run take eager JAX that long).

``chip_smoke.py`` holds the port's GPU runs against these numbers.

    python tools/torch_slice_reference.py [--seed N] [FILE ...]

writes the named files (all of them by default).
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
N_COSMO = 512
INDICES = (0, 255, 511)
N_CHECK = 8          # chip_smoke.py's float64 check set


def measured_indices():
    """INDICES and chip_smoke.py's checked cosmologies, sorted."""
    check = np.unique(np.linspace(0, N_COSMO - 1, N_CHECK).round())
    return sorted(set(check.astype(int).tolist()) | set(INDICES))


def cosmologies(idx, n=N_COSMO):
    """(omega_m0, sigma_8) at ``idx`` of bench.py's n-point linspaces."""
    oms = np.linspace(0.24, 0.32, n)[list(idx)]
    s8s = np.linspace(0.75, 0.88, n)[list(idx)]
    return oms, s8s


def jax_batch(oms, s8s):
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo
    from chomp_tpu.parallel.sweep import broadcast_cosmo

    return broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(oms),
                           omega_l0=jnp.asarray(1.0 - oms),
                           sigma_8=jnp.asarray(s8s))


def run(method, idx, **options):
    """{"w_theta", "gamma_t", "theta_deg"} (and ``xi_plus`` /
    ``xi_minus`` with ``include_shear=True`` in ``options``) of one route
    at the JAX package's current precision (x64 on or off)."""
    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import broadcast_cosmo, make_pipeline

    dist = projection.DNdzGaussian(
        z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
        z0=jnp.asarray(1.0), sigma_z=jnp.asarray(0.2))
    fn = make_pipeline(default_halo(), default_hod(), dist,
                       power_spec="power_gg", grid=DEFAULT_GRID,
                       include_lensing=True, z_pivot=1.0, method=method,
                       **options)
    oms, s8s = cosmologies(idx)
    batch = broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(oms),
                            omega_l0=jnp.asarray(1.0 - oms),
                            sigma_8=jnp.asarray(s8s))
    out = jax.jit(jax.vmap(fn))(batch)
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()
            if k != "n_g"}


def worst_bin(got, ref):
    return float(max(np.max(np.abs(got[k] / ref[k] - 1.0))
                     for k in ("w_theta", "gamma_t")))


#: The fiducial (omega_m0, sigma_8) of the gradient reference and of
#: chip_smoke.py's inference phase.
FIDUCIAL = (0.278, 0.811)


def jax_pipeline(grid, **options):
    """The JAX make_pipeline of bench.py's configurations on ``grid``
    (power_gg, lensing, DNdzGaussian(0, 2, 1, 0.2)); ``options`` as
    make_pipeline's (z_pivot 1.0 unless given)."""
    from chomp_tpu import default_halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import make_pipeline
    from tests import torch_parity as tp

    return make_pipeline(default_halo(), default_hod(), tp.jax_dist(),
                         power_spec="power_gg", grid=grid,
                         include_lensing=True,
                         **{"z_pivot": 1.0, **options})


def jacobians(fn, batch):
    """{"value": (B, 2 n_theta), "jacobian": (B, 2 n_theta, 2)}: the
    pipeline ``fn``'s data vector (w, then gamma_t) and its
    ``jax.jacfwd`` with respect to (omega_m0, sigma_8) at each cosmology
    of ``batch`` (a batched JAX CosmoParams), omega_l0 = 1 - omega_m0,
    float64."""
    import jax
    import jax.numpy as jnp

    def one(c):
        def vec(p):
            out = fn(dataclasses.replace(c, omega_m0=p[0],
                                         omega_l0=1.0 - p[0], sigma_8=p[1]))
            return jnp.concatenate([out["w_theta"], out["gamma_t"]])

        p = jnp.stack([c.omega_m0, c.sigma_8])
        return vec(p), jax.jacfwd(vec)(p)

    val, jac = jax.jit(jax.vmap(one))(batch)
    return {"value": np.asarray(val).tolist(),
            "jacobian": np.asarray(jac).tolist()}


def grad_reference():
    """The content of tests/data/torch_grad_reference.json (JAX float64)."""
    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo, halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import broadcast_cosmo
    from tests import torch_parity as tp

    oms, s8s = cosmologies(INDICES)
    oms = np.append(oms, FIDUCIAL[0])
    s8s = np.append(s8s, FIDUCIAL[1])
    batch = broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(oms),
                            omega_l0=jnp.asarray(1.0 - oms),
                            sigma_8=jnp.asarray(s8s))
    full = {"grid": dataclasses.asdict(DEFAULT_GRID),
            "indices": list(INDICES) + ["fiducial"],
            "omega_m0": oms.tolist(), "sigma_8": s8s.tolist()}
    tiny = {"grid": dataclasses.asdict(tp.GRID), "cosmo": tp.COSMO}
    for method in ("fft", "table"):
        full[method] = jacobians(jax_pipeline(DEFAULT_GRID, method=method),
                                 batch)
        tiny[method] = jacobians(jax_pipeline(tp.GRID, method=method),
                                 tp.jax_batch())

    def p_gg(om):
        c = dataclasses.replace(default_cosmo(), omega_m0=om,
                                omega_l0=1.0 - om)
        model = halo.build_halo_model(c, default_halo(), default_hod(), 0.0,
                                      False, tp.GRID)
        return halo.power_gg(c, default_halo(), model, jnp.asarray([1.0]),
                             False, tp.GRID)[0]

    val, grad = jax.jit(jax.value_and_grad(p_gg))(jnp.asarray(FIDUCIAL[0]))
    return {"config": "bench.py configuration A (both routes), JAX float64 "
                      "CPU; data vector = w_theta then gamma_t; columns = "
                      "(omega_m0, sigma_8) with omega_l0 = 1 - omega_m0",
            "default_grid": full, "tiny_grid": tiny,
            "p_gg_k1": {"grid": dataclasses.asdict(tp.GRID), "z": 0.0,
                        "omega_m0": FIDUCIAL[0], "value": float(val),
                        "d_domega_m0": float(grad)}}


def write_grad_reference():
    path = DATA / "torch_grad_reference.json"
    path.write_text(json.dumps(grad_reference(), indent=1) + "\n")
    print(f"wrote {path}")


#: bench.py's configuration B: N_COSMO_EXACT cosmologies, J anchors.
N_COSMO_EXACT = 64
EXACT_J = 6
EXACT_INDICES = (0, 27, 63)
#: The anchors of the tiny-grid exact-z pipeline with shear.
TINY_J = 4


def _peak_gap(got, ref):
    """max over rows of max|got - ref| / max|ref| (axis 1 = theta)."""
    return float(np.max(np.max(np.abs(got - ref), axis=1)
                        / np.max(np.abs(ref), axis=1)))


def exactz_reference():
    """The content of tests/data/torch_exactz_reference.json (JAX
    float64; see the module docstring)."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo, limber_fft, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from tests import test_exact_z_lattice as tz
    from tests import torch_parity as tp

    t0 = time.perf_counter()

    def lap(what):
        print(f"[{time.perf_counter() - t0:7.1f} s] {what}", flush=True)

    oms, s8s = cosmologies(EXACT_INDICES, N_COSMO_EXACT)
    fn_b = jax_pipeline(DEFAULT_GRID, z_pivot=0.0,
                        exact_z_anchors=EXACT_J)
    jac_b = jacobians(fn_b, jax_batch(oms, s8s))
    n_theta = DEFAULT_GRID.n_theta
    value = np.asarray(jac_b["value"])
    config_b = {
        "config": "bench.py configuration B: make_pipeline(default_halo(), "
                  "default_hod(), DNdzGaussian(0, 2, 1, 0.2), power_spec="
                  "'power_gg', include_lensing=True, exact_z_anchors=6) "
                  "(z_pivot 0), JAX float64 CPU; jacobian columns = "
                  "(omega_m0, sigma_8) with omega_l0 = 1 - omega_m0, rows "
                  "w_theta then gamma_t",
        "grid": dataclasses.asdict(DEFAULT_GRID), "exact_z_anchors": EXACT_J,
        "z_pivot": 0.0, "n_cosmo": N_COSMO_EXACT,
        "indices": list(EXACT_INDICES), "omega_m0": oms.tolist(),
        "sigma_8": s8s.tolist(),
        "w_theta": value[:, :n_theta].tolist(),
        "gamma_t": value[:, n_theta:].tolist(),
        "jacobian": jac_b["jacobian"]}
    lap("configuration B and its jacfwd")

    idx = measured_indices()
    routes = {m: run(m, idx, include_shear=True) for m in ("fft", "table")}
    pos = [idx.index(i) for i in INDICES]
    keys = ("w_theta", "gamma_t", "xi_plus", "xi_minus")
    lat, tab = routes["fft"], routes["table"]
    gaps = {}
    for k in ("xi_plus", "xi_minus"):
        gaps[f"{k}_worst_bin"] = float(np.max(np.abs(tab[k] / lat[k] - 1.0)))
        gaps[f"{k}_row_peak"] = _peak_gap(tab[k], lat[k])
    oms_a, s8s_a = cosmologies(INDICES)
    shear = {
        "config": "bench.py configuration A with include_shear=True "
                  "(z_pivot 1), both routes, JAX float64 CPU; "
                  "jax_table_vs_lattice: float64 table route against the "
                  "lattice route on the cosmologies 'measured_on'",
        "grid": dataclasses.asdict(DEFAULT_GRID), "n_cosmo": N_COSMO,
        "indices": list(INDICES), "omega_m0": oms_a.tolist(),
        "sigma_8": s8s_a.tolist(),
        "theta_deg": lat["theta_deg"][0].tolist(),
        "fft": {k: lat[k][pos].tolist() for k in keys},
        "table": {k: tab[k][pos].tolist() for k in keys},
        "measured_on": idx, "jax_table_vs_lattice": gaps}
    lap(f"shear, both routes ({len(idx)} cosmologies): gaps {gaps}")

    win = tz._win()
    ells = np.logspace(1, 3, 6)
    fid = default_cosmo()
    h, hod = default_halo(), default_hod()
    cl_table = jax.jit(lambda c: projection.limber_cl_exact_z(
        c, h, hod, win, win, jnp.asarray(ells), "power_gg", n_z=32,
        grid=tz.G))(fid)
    cl_lat = jax.jit(lambda c: limber_fft.limber_cl_fft_exact_z(
        c, h, hod, win, win, ells, "power_gg", n_z_anchor=8,
        grid=tz.G))(fid)
    cl_table, cl_lat = np.asarray(cl_table), np.asarray(cl_lat)
    dist = win.dist
    cl = {"config": "tests/test_exact_z_lattice.py::test_exact_z_gg_"
                    "matches_table_route: default_cosmo(), power_gg, "
                    "WindowGalaxy(DNdzGaussian(z_min, z_max, z0, sigma_z)) "
                    "on both sides; 'table': projection.limber_cl_exact_z "
                    "(n_z = 32), 'lattice': limber_fft.limber_cl_fft_exact_z "
                    "(n_z_anchor = 8, anchors on [1e-3, 3]); JAX float64 CPU",
          "grid": dataclasses.asdict(tz.G),
          "dist": [float(dist.z_min), float(dist.z_max), float(dist.z0),
                   float(dist.sigma_z)],
          "ells": ells.tolist(), "n_z": 32, "n_z_anchor": 8,
          "table": cl_table.tolist(), "lattice": cl_lat.tolist(),
          "jax_lattice_vs_table_worst": float(np.max(np.abs(
              cl_lat / cl_table - 1.0)))}
    lap(f"exact-z C_ell at G: JAX lattice vs table "
        f"{cl['jax_lattice_vs_table_worst']:.3e}")

    fn_t = jax_pipeline(tp.GRID, z_pivot=tp.Z_PIVOT, exact_z_anchors=TINY_J,
                        include_shear=True)
    fns = {"exact_z": fn_t,
           "fft": jax_pipeline(tp.GRID, z_pivot=tp.Z_PIVOT,
                               include_shear=True),
           "table": jax_pipeline(tp.GRID, z_pivot=tp.Z_PIVOT,
                                 include_shear=True, method="table")}
    outs = jax.jit(jax.vmap(lambda c: {name: fn(c) for name, fn
                                       in fns.items()}))(tp.jax_batch())
    tiny = {"config": "on tests/torch_parity.GRID at its 3 cosmologies, "
                      "z_pivot 1, include_shear=True, JAX float64 CPU: "
                      "'exact_z' make_pipeline(..., exact_z_anchors=4), "
                      "'fft' and 'table' the separable routes; 'value' and "
                      "'jacobian': (w_theta, gamma_t) of 'exact_z' and its "
                      "jacfwd",
            "grid": dataclasses.asdict(tp.GRID), "cosmo": tp.COSMO,
            "exact_z_anchors": TINY_J,
            **{name: {k: np.asarray(v).tolist() for k, v in out.items()
                      if k != "theta_deg"} for name, out in outs.items()},
            **jacobians(fn_t, tp.jax_batch())}
    lap("tiny-grid pipelines and the exact-z jacfwd")
    return {"config_b": config_b, "shear": shear, "cl_exact_z": cl,
            "tiny_grid": tiny}


def write_exactz_reference():
    path = DATA / "torch_exactz_reference.json"
    path.write_text(json.dumps(exactz_reference(), indent=1) + "\n")
    print(f"wrote {path}")


def write(name, config, idx, out, **extra):
    oms, s8s = cosmologies(idx)
    pos = [measured_indices().index(i) for i in idx]
    data = {"config": config, "n_cosmo": N_COSMO, "indices": list(idx),
            "omega_m0": oms.tolist(), "sigma_8": s8s.tolist(),
            "theta_deg": out["theta_deg"][0].tolist(),
            "w_theta": out["w_theta"][pos].tolist(),
            "gamma_t": out["gamma_t"][pos].tolist(), **extra}
    path = DATA / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {path}")


#: The tomographic cell: lens and source bins of DES Y3 (Abbott et al.
#: 2022, arXiv:2105.13549; redMaGiC lens edges 0.15/0.35/0.50/0.65/0.80/
#: 0.90, source edges 0/0.358/0.631/0.872/2.0) with Gaussian stand-ins for
#: their tabulated n(z), and per-bin Zheng HODs brighter with redshift.
TOMO_CELL = dict(
    lens_z0=[0.25, 0.425, 0.575, 0.725, 0.85], lens_sigma_z=0.06,
    lens_z_max=1.5, src_z0=[0.33, 0.52, 0.75, 0.94],
    src_sigma_z=[0.15, 0.15, 0.17, 0.22], src_z_max=2.5,
    log10_m_min=[11.9, 12.0, 12.1, 12.2, 12.3], log10_m_1p_offset=1.3,
    z_pivot=0.6, alpha_lens=[1.3, 0.5, 0.8, 2.2, 2.0], a_ia=0.5,
    eta_ia=0.0, z0_ia=0.62,
    prior_sigma=dict(dz_lens=0.007, dz_src=0.02, m=0.01))
#: The Jacobian's parameters: cosmology, then nuisance fields.
TOMO_COSMO_NAMES = ("omega_m0", "sigma_8")
TOMO_NUISANCE_NAMES = ("dz_src", "m", "a_ia")


def tomo_nuisance(seed: int) -> dict:
    """The cell's nuisance point: photo-z shifts and shear calibrations
    drawn from ``seed`` at the DES Y3 prior widths, the fixed IA and
    magnification values (numpy float64)."""
    rng = np.random.default_rng(seed)
    ps = TOMO_CELL["prior_sigma"]
    return dict(dz_lens=rng.normal(0.0, ps["dz_lens"], 5),
                dz_src=rng.normal(0.0, ps["dz_src"], 4),
                m=rng.normal(0.0, ps["m"], 4),
                a_ia=np.asarray(TOMO_CELL["a_ia"]),
                eta_ia=np.asarray(TOMO_CELL["eta_ia"]),
                z0_ia=np.asarray(TOMO_CELL["z0_ia"]),
                alpha_lens=np.asarray(TOMO_CELL["alpha_lens"]))


def tomo_jax_pipeline(grid):
    """The cell's JAX pipeline on ``grid``."""
    import jax.numpy as jnp

    from chomp_tpu import default_halo, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import make_tomographic_pipeline

    c = TOMO_CELL

    def gauss(z0, sz, z_max):
        return projection.DNdzGaussian(
            z_min=jnp.asarray(0.0), z_max=jnp.asarray(z_max),
            z0=jnp.asarray(z0), sigma_z=jnp.asarray(sz))

    lens = [gauss(z0, c["lens_sigma_z"], c["lens_z_max"])
            for z0 in c["lens_z0"]]
    src = [gauss(z0, sz, c["src_z_max"])
           for z0, sz in zip(c["src_z0"], c["src_sigma_z"])]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + c["log10_m_1p_offset"])
            for m in c["log10_m_min"]]
    return make_tomographic_pipeline(default_halo(), hods, lens, src,
                                     grid=grid, z_pivot=c["z_pivot"],
                                     with_nuisance=True,
                                     include_magnification=True)


def tomo_jacobian(fn, cosmo, nuisance, nuisance_names):
    """(vector, jax.jacfwd of it) at one cosmology and nuisance point
    with respect to (omega_m0, sigma_8, *nuisance_names), omega_l0 =
    1 - omega_m0."""
    import jax
    import jax.numpy as jnp

    sizes = [int(np.size(getattr(nuisance, n))) for n in nuisance_names]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int) + 2

    def vec(p):
        c = dataclasses.replace(cosmo, omega_m0=p[0], omega_l0=1.0 - p[0],
                                sigma_8=p[1])
        nu = dataclasses.replace(nuisance, **{
            n: p[offs[i]:offs[i + 1]].reshape(
                np.shape(getattr(nuisance, n)))
            for i, n in enumerate(nuisance_names)})
        return fn(c, nu)["vector"]

    p = jnp.concatenate([jnp.stack([cosmo.omega_m0, cosmo.sigma_8])]
                        + [jnp.ravel(getattr(nuisance, n))
                           for n in nuisance_names])
    val, jac = jax.jit(lambda q: (vec(q), jax.jacfwd(vec)(q)))(p)
    return np.asarray(val), np.asarray(jac)


def tomo_reference(seed: int):
    """The content of tests/data/torch_tomo_reference.json (JAX float64;
    see the module docstring)."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import (Nuisance3x2pt,
                                          make_tomographic_pipeline)
    from tests import test_torch_tomographic as tt

    t0 = time.perf_counter()
    fn = tomo_jax_pipeline(DEFAULT_GRID)
    nu_np = tomo_nuisance(seed)
    nu = Nuisance3x2pt(**{k: jnp.asarray(v) for k, v in nu_np.items()})
    oms, s8s = cosmologies(INDICES)
    out = jax.jit(jax.vmap(fn, in_axes=(0, None)))(jax_batch(oms, s8s), nu)
    keys = ("w_theta", "gamma_t", "xi_plus", "xi_minus", "n_g")
    full = {"grid": dataclasses.asdict(DEFAULT_GRID), "n_cosmo": N_COSMO,
            "indices": list(INDICES), "omega_m0": oms.tolist(),
            "sigma_8": s8s.tolist(),
            **{k: np.asarray(out[k]).tolist() for k in keys}}
    print(f"cell outputs: {time.perf_counter() - t0:.1f} s", flush=True)
    fid = dataclasses.replace(default_cosmo(), omega_m0=FIDUCIAL[0],
                              omega_l0=1.0 - FIDUCIAL[0],
                              sigma_8=FIDUCIAL[1])
    val, jac = tomo_jacobian(fn, fid, nu, TOMO_NUISANCE_NAMES)
    full["jacobian"] = {"omega_m0": FIDUCIAL[0], "sigma_8": FIDUCIAL[1],
                        "cosmo_names": list(TOMO_COSMO_NAMES),
                        "nuisance_names": list(TOMO_NUISANCE_NAMES),
                        "vector": val.tolist(), "jacobian": jac.tolist()}
    print(f"cell jacfwd: {time.perf_counter() - t0:.1f} s", flush=True)

    # The parity grid: the four cases of tests/test_torch_tomographic.py
    # and the jacfwd at row 1 of its magnification case.
    row = 1
    om, s8 = tt.cosmologies()
    pts = {k: v[row] for k, v in tt.nuisance_points(True).items()}
    fn_tiny = make_tomographic_pipeline(
        default_halo(), [default_hod(), default_hod(**tt.HOD_B)], tt.LENS,
        tt.SRC, grid=tt.GRID, z_pivot=tt.Z_PIVOT, with_nuisance=True,
        include_magnification=True)
    c = dataclasses.replace(default_cosmo(), omega_m0=om[row],
                            omega_l0=1.0 - om[row], sigma_8=s8[row])
    val, jac = tomo_jacobian(
        fn_tiny, c, Nuisance3x2pt(**{k: jnp.asarray(v)
                                     for k, v in pts.items()}),
        TOMO_NUISANCE_NAMES)
    cases = tt.jax_cases()
    tiny = {"grid": dataclasses.asdict(tt.GRID), "omega_m0": om.tolist(),
            "sigma_8": s8.tolist(),
            "cases": {case: {k: v.tolist() for k, v in out.items()}
                      for case, out in cases.items()},
            "row": row,
            "nuisance": {k: np.asarray(v).tolist() for k, v in pts.items()},
            "nuisance_names": list(TOMO_NUISANCE_NAMES),
            "vector": val.tolist(), "jacobian": jac.tolist()}
    print(f"parity-grid jacfwd: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"config": "DES Y3-like tomographic 3x2pt cell "
                      "(make_tomographic_pipeline, per-bin HODs, "
                      "with_nuisance, include_magnification), JAX float64 "
                      "CPU",
            "seed": seed, "cell": TOMO_CELL,
            "nuisance": {k: np.asarray(v).tolist() for k, v in nu_np.items()},
            "default_grid": full, "tiny_grid": tiny}


def write_tomo_reference(seed: int):
    path = DATA / "torch_tomo_reference.json"
    path.write_text(json.dumps(tomo_reference(seed), indent=1) + "\n")
    print(f"wrote {path}")


#: The survey of the tomographic cell's covariance (chip_smoke.py phase
#: 28): DES Y3's footprint, 4143 deg^2, the redMaGiC lens densities per
#: arcmin^2 and the source bins' n_eff per arcmin^2 and shape dispersion
#: per component, as Abbott et al. 2022 (arXiv:2105.13549) report them.
DES_Y3_SURVEY = dict(area_deg2=4143.0,
                     lens_n_arcmin2=[0.022, 0.038, 0.058, 0.029, 0.025],
                     src_n_eff_arcmin2=[1.476, 1.479, 1.484, 1.461],
                     src_sigma_e=[0.243, 0.262, 0.259, 0.301])


#: DES Y3's 20 log-spaced angular bins from 2.5' to 250' (Abbott et al.
#: 2022, arXiv:2105.13549), at their geometric centres, in degrees.
DES_THETA_DEG = (2.5 * 10.0 ** ((np.arange(20) + 0.5) / 10.0) / 60.0).tolist()
#: Theta of the CPU tests' option cases (>= 0.5 deg, so that the curved
#: operators' lmax stays small), in degrees.
TINY_THETA_DEG = np.geomspace(0.5, 4.0, 5).tolist()
#: The option cells of chip_smoke.py phases 15-19: the configuration
#: ("A": bench.py configuration A, "B": configuration B, "tomo": the
#: tomographic cell of torch_tomo_reference.json), the pipeline options,
#: the theta points ("default": the grid's bins, "des": DES_THETA_DEG) and
#: HaloParams.mass_fn.
OPTION_CELLS = {
    "flat_options": dict(
        config="A", theta="default", mass_fn=0.0, options=dict(
            include_shear=True, with_bao=True, matter_power="halofit",
            include_cmb_lensing=True, nonlimber_ell_switch=60,
            nonlimber_rsd=True)),
    "curved": dict(config="A", theta="des", mass_fn=1.0, options=dict(
        geometry="curved", matter_power="linear", include_shear=True,
        include_cmb_lensing=True, nonlimber_ell_switch=60)),
    "exact_z": dict(config="B", theta="des", mass_fn=0.0, options=dict(
        exact_z_anchors=EXACT_J, geometry="curved", matter_power="halofit",
        with_bao=True, include_shear=True, include_cmb_lensing=True)),
    "table": dict(config="A", theta="default", mass_fn=1.0, options=dict(
        method="table", with_bao=True, include_shear=True)),
    "tomographic": dict(config="tomo", theta="des", mass_fn=0.0,
                        options=dict(geometry="curved",
                                     matter_power="halofit", with_bao=True,
                                     include_cmb_lensing=True,
                                     nonlimber_ell_switch=60,
                                     nonlimber_rsd=True)),
}


def option_pipeline(name, grid, theta_deg, tomo=None, **overrides):
    """The JAX pipeline of option cell ``name`` on ``grid`` at
    ``theta_deg`` (``tomo``: (lens, src, hods, z_pivot) of the
    tomographic layout), ``overrides`` replacing its options."""
    import dataclasses as dc

    import jax.numpy as jnp

    from chomp_tpu import default_halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import (make_pipeline,
                                          make_tomographic_pipeline)
    from tests import torch_parity as tp

    cell = OPTION_CELLS[name]
    options = dict(cell["options"], **overrides)
    hp = dc.replace(default_halo(), mass_fn=jnp.asarray(cell["mass_fn"]))
    if cell["config"] == "tomo":
        lens, src, hods, z_pivot = tomo
        return make_tomographic_pipeline(
            hp, hods, lens, src, grid=grid, z_pivot=z_pivot,
            theta_deg=theta_deg, with_nuisance=True,
            include_magnification=True, **options)
    return make_pipeline(hp, default_hod(), tp.jax_dist(),
                         power_spec="power_gg", grid=grid,
                         include_lensing=True, theta_deg=theta_deg,
                         z_pivot=1.0 if cell["config"] == "A" else 0.0,
                         **options)


def _vector(out):
    import jax.numpy as jnp

    keys = [k for k in ("w_theta", "gamma_t", "xi_plus", "xi_minus",
                        "w_gk_cmb") if k in out]
    return jnp.concatenate([out[k] for k in keys])


def option_cell_reference(name):
    """One option cell at DEFAULT_GRID (JAX float64, one cosmology after
    another under lax.map): its outputs at the reference cosmologies and,
    for "flat_options", the jacfwd of its data vector (w, gamma_t, xi_+,
    xi_-, w_gk_cmb) with respect to (omega_m0, sigma_8)."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import Nuisance3x2pt

    t0 = time.perf_counter()
    cell = OPTION_CELLS[name]
    theta = (DES_THETA_DEG if cell["theta"] == "des"
             else correlation_theta(DEFAULT_GRID))
    if cell["config"] == "B":
        idx, n = EXACT_INDICES, N_COSMO_EXACT
    else:
        idx, n = INDICES, N_COSMO
    oms, s8s = cosmologies(idx, n)
    batch = jax_batch(oms, s8s)
    block = {"indices": list(idx), "n_cosmo": n, "omega_m0": oms.tolist(),
             "sigma_8": s8s.tolist(), "theta_deg": list(theta)}
    if cell["config"] == "tomo":
        ref = json.loads((DATA / "torch_tomo_reference.json").read_text())
        tomo = tomo_layout(DEFAULT_GRID)
        fn = option_pipeline(name, DEFAULT_GRID, theta, tomo)
        nu = Nuisance3x2pt(**{k: jnp.asarray(v)
                              for k, v in ref["nuisance"].items()})
        out = jax.jit(lambda b: jax.lax.map(lambda c: fn(c, nu), b))(batch)
        block["nuisance_seed"] = ref["seed"]
    else:
        fn = option_pipeline(name, DEFAULT_GRID, theta)
        out = jax.jit(lambda b: jax.lax.map(fn, b))(batch)
    block["outputs"] = {k: np.asarray(v).tolist() for k, v in out.items()
                        if k != "theta_deg"}
    print(f"[{time.perf_counter() - t0:7.1f} s] {name} outputs", flush=True)
    if name == "flat_options":
        def one(c):
            def vec(p):
                return _vector(fn(dataclasses.replace(
                    c, omega_m0=p[0], omega_l0=1.0 - p[0], sigma_8=p[1])))

            p = jnp.stack([c.omega_m0, c.sigma_8])
            return vec(p), jax.jacfwd(vec)(p)

        val, jac = jax.jit(lambda b: jax.lax.map(one, b))(batch)
        block["vector"] = np.asarray(val).tolist()
        block["jacobian"] = np.asarray(jac).tolist()
        print(f"[{time.perf_counter() - t0:7.1f} s] {name} jacfwd",
              flush=True)
    return block


def correlation_theta(grid):
    from chomp_tpu import correlation

    return np.asarray(correlation.theta_bins_deg(grid)).tolist()


def tomo_layout(grid):
    """(lens, src, hods, z_pivot) of the DES Y3-like tomographic cell."""
    import jax.numpy as jnp

    from chomp_tpu import projection
    from chomp_tpu.hod import default_hod

    c = TOMO_CELL

    def gauss(z0, sz, z_max):
        return projection.DNdzGaussian(
            z_min=jnp.asarray(0.0), z_max=jnp.asarray(z_max),
            z0=jnp.asarray(z0), sigma_z=jnp.asarray(sz))

    lens = [gauss(z0, c["lens_sigma_z"], c["lens_z_max"])
            for z0 in c["lens_z0"]]
    src = [gauss(z0, sz, c["src_z_max"])
           for z0, sz in zip(c["src_z0"], c["src_sigma_z"])]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + c["log10_m_1p_offset"])
            for m in c["log10_m_min"]]
    return lens, src, hods, c["z_pivot"]


def option_tiny_reference():
    """The option cells on tests/test_torch_tomographic.py's tiny grid at
    TINY_THETA_DEG (the CPU tests' block): the make_pipeline cells at
    tests/torch_parity's 3 cosmologies (config B's cell with J = 4), the
    tomographic cell on that file's 2 lens x 2 source layout at its 3
    cosmologies and magnification nuisance points, and the jacfwd of the
    flat cell's data vector."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import Nuisance3x2pt
    from tests import test_torch_tomographic as tt
    from tests import torch_parity as tp

    t0 = time.perf_counter()
    cells = {}
    for name, cell in OPTION_CELLS.items():
        if cell["config"] == "tomo":
            tomo = (tt.LENS, tt.SRC, [default_hod(), default_hod(**tt.HOD_B)],
                    tt.Z_PIVOT)
            fn = option_pipeline(name, tt.GRID, TINY_THETA_DEG, tomo)
            pts = tt.nuisance_points(True)
            nus = Nuisance3x2pt(**{k: jnp.asarray(v) for k, v in pts.items()})
            out = jax.jit(jax.vmap(fn))(tt.jax_batch(), nus)
        else:
            j = {"exact_z_anchors": TINY_J} if cell["config"] == "B" else {}
            fn = option_pipeline(name, tt.GRID, TINY_THETA_DEG, **j)
            out = jax.jit(jax.vmap(fn))(tp.jax_batch())
        cells[name] = {k: np.asarray(v).tolist() for k, v in out.items()
                       if k != "theta_deg"}
        print(f"[{time.perf_counter() - t0:7.1f} s] tiny {name}", flush=True)
    fn = option_pipeline("flat_options", tt.GRID, TINY_THETA_DEG)

    def one(c):
        def vec(p):
            return _vector(fn(dataclasses.replace(
                c, omega_m0=p[0], omega_l0=1.0 - p[0], sigma_8=p[1])))

        p = jnp.stack([c.omega_m0, c.sigma_8])
        return vec(p), jax.jacfwd(vec)(p)

    val, jac = jax.jit(jax.vmap(one))(tp.jax_batch())
    print(f"[{time.perf_counter() - t0:7.1f} s] tiny jacfwd", flush=True)
    return {"grid": dataclasses.asdict(tt.GRID),
            "theta_deg": TINY_THETA_DEG, "cosmo": tp.COSMO,
            "exact_z_anchors": TINY_J, "cells": cells,
            "flat_options_jacobian": {"vector": np.asarray(val).tolist(),
                                      "jacobian": np.asarray(jac).tolist()}}


def write_options_reference():
    """tests/data/torch_options_reference.json: each DEFAULT_GRID cell and
    the tiny-grid block in a process of its own, one after another (the
    non-Limber programs need ~25 GB each).  A block whose part file
    (``tests/data/.options_<name>.json``, written by ``--options-cell
    <name> <file>``, ``tiny`` for the tiny-grid block) exists already is
    taken as it is, so the parts may be made in parallel first."""
    import subprocess

    from chomp_tpu.params import DEFAULT_GRID

    blocks = {}
    for name in (*OPTION_CELLS, "tiny"):
        part = DATA / f".options_{name}.json"
        if not part.exists():
            subprocess.run([sys.executable, __file__, "--options-cell", name,
                            str(part)], check=True)
        blocks[name] = json.loads(part.read_text())
    tiny = blocks.pop("tiny")
    data = {"config": "the option cells of chip_smoke.py phases 15-19 "
                      "(OPTION_CELLS of tools/torch_slice_reference.py), "
                      "JAX float64 CPU; 'vector' and 'jacobian': w, gamma_t, "
                      "xi_+, xi_-, w_gk_cmb concatenated, jacfwd columns "
                      "(omega_m0, sigma_8) with omega_l0 = 1 - omega_m0",
            "cells": OPTION_CELLS, "des_theta_deg": DES_THETA_DEG,
            "default_grid": {"grid": dataclasses.asdict(DEFAULT_GRID),
                             "cells": blocks},
            "tiny_grid": tiny}
    path = DATA / "torch_options_reference.json"
    path.write_text(json.dumps(data, indent=1) + "\n")
    for name in (*OPTION_CELLS, "tiny"):
        (DATA / f".options_{name}.json").unlink()
    print(f"wrote {path}")


#: The Gauss-Legendre exact-z C_ell of chip_smoke.py phase 22: power_gg
#: through configuration A's window at 20 log-spaced ells over 10..3000,
#: n_z GL nodes (each with its own halo model).
GL_ELLS = np.geomspace(10.0, 3000.0, 20).tolist()
GL_N_Z = 32
#: The anchors of the lattice exact-z C_ell held to the GL route there.
GL_LATTICE_J = 8
#: The exact-z tomographic cases of tests/test_torch_exactz_tomo.py on the
#: 2 lens x 2 source layout of tests/test_torch_tomographic.py (J =
#: TINY_J): one HOD shared by both lens bins or per-bin HODs, the grid's
#: theta bins or TINY_THETA_DEG ("tiny", where the curved operators stay
#: small), and the pipeline options.
EXACTZ_TOMO_CASES = {
    "shared": dict(per_bin=False, theta="grid", options={}),
    "per_bin": dict(per_bin=True, theta="grid", options={}),
    "shared_curved": dict(per_bin=False, theta="tiny", options=dict(
        geometry="curved", matter_power="halofit",
        include_cmb_lensing=True)),
    "per_bin_curved": dict(per_bin=True, theta="tiny", options=dict(
        geometry="curved", matter_power="halofit", with_bao=True,
        include_cmb_lensing=True, nonlimber_ell_switch=60,
        nonlimber_rsd=True)),
    "shared_options": dict(per_bin=False, theta="tiny", options=dict(
        matter_power="linear", with_bao=True, include_cmb_lensing=True,
        nonlimber_ell_switch=60, nonlimber_rsd=True)),
    "per_bin_options": dict(per_bin=True, theta="tiny", options=dict(
        matter_power="halofit", with_bao=True, include_cmb_lensing=True,
        nonlimber_ell_switch=60, nonlimber_rsd=True)),
}
EXACTZ_TOMO_KEYS = ("w_theta", "gamma_t", "xi_plus", "xi_minus", "w_gk_cmb",
                    "n_g", "vector")


def exactz_tomo_part(name):
    """One block of tests/data/torch_exactz_tomo_reference.json (JAX
    float64 CPU): "tiny" (the EXACTZ_TOMO_CASES at the tomographic tests'
    3 cosmologies, and the jacfwd of the "per_bin" case's data vector),
    "gl" (``projection.limber_cl_exact_z`` at the configuration of
    tests/test_exact_z_lattice.py and its jacfwd), "chip_tomo" (the DES
    Y3-like cell with per-bin HODs, exact_z_anchors = EXACT_J, flat, at
    DEFAULT_GRID and the 3 configuration-B cosmologies, one after another
    under lax.map) or "chip_gl" (the GL C_ell of chip_smoke.py phase 22 at
    DEFAULT_GRID and those cosmologies)."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo, default_halo, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import make_tomographic_pipeline
    from tests import test_exact_z_lattice as tz
    from tests import test_torch_tomographic as tt
    from tests import torch_parity as tp

    t0 = time.perf_counter()

    def keep(out):
        return {k: np.asarray(out[k]).tolist() for k in EXACTZ_TOMO_KEYS
                if k in out}

    def cl_fn(grid, win, ells, n_z):
        def cl(c):
            return projection.limber_cl_exact_z(
                c, default_halo(), default_hod(), win, win,
                jnp.asarray(ells), "power_gg", n_z=n_z, grid=grid)
        return cl

    if name == "tiny":
        hods = [default_hod(), default_hod(**tt.HOD_B)]
        cases = {}
        for case, spec in EXACTZ_TOMO_CASES.items():
            theta = (TINY_THETA_DEG if spec["theta"] == "tiny" else None)
            fn = make_tomographic_pipeline(
                default_halo(), hods if spec["per_bin"] else hods[0],
                tt.LENS, tt.SRC, theta_deg=theta, grid=tt.GRID,
                z_pivot=tt.Z_PIVOT, exact_z_anchors=TINY_J,
                **spec["options"])
            cases[case] = keep(jax.jit(jax.vmap(fn))(tt.jax_batch()))
            print(f"[{time.perf_counter() - t0:7.1f} s] tiny {case}",
                  flush=True)
        fn = make_tomographic_pipeline(default_halo(), hods, tt.LENS, tt.SRC,
                                       grid=tt.GRID, z_pivot=tt.Z_PIVOT,
                                       exact_z_anchors=TINY_J)

        def one(c):
            def vec(p):
                return fn(dataclasses.replace(
                    c, omega_m0=p[0], omega_l0=1.0 - p[0],
                    sigma_8=p[1]))["vector"]

            p = jnp.stack([c.omega_m0, c.sigma_8])
            return vec(p), jax.jacfwd(vec)(p)

        val, jac = jax.jit(jax.vmap(one))(tt.jax_batch())
        om, s8 = tt.cosmologies()
        print(f"[{time.perf_counter() - t0:7.1f} s] tiny jacfwd", flush=True)
        return {"grid": dataclasses.asdict(tt.GRID), "omega_m0": om.tolist(),
                "sigma_8": s8.tolist(), "exact_z_anchors": TINY_J,
                "theta_tiny": TINY_THETA_DEG, "cases": cases,
                "per_bin_jacobian": {"vector": np.asarray(val).tolist(),
                                     "jacobian": np.asarray(jac).tolist()}}
    if name == "gl":
        ells = np.logspace(1, 3, 6)
        cl = cl_fn(tz.G, tz._win(), ells, 32)
        fid = default_cosmo()

        def vec(p):
            return cl(dataclasses.replace(fid, omega_m0=p[0],
                                          omega_l0=1.0 - p[0], sigma_8=p[1]))

        p = jnp.stack([fid.omega_m0, fid.sigma_8])
        val, jac = jax.jit(lambda q: (vec(q), jax.jacfwd(vec)(q)))(p)
        print(f"[{time.perf_counter() - t0:7.1f} s] gl jacfwd", flush=True)
        return {"grid": dataclasses.asdict(tz.G), "ells": ells.tolist(),
                "n_z": 32, "omega_m0": float(fid.omega_m0),
                "sigma_8": float(fid.sigma_8),
                "value": np.asarray(val).tolist(),
                "jacobian": np.asarray(jac).tolist()}
    oms, s8s = cosmologies(EXACT_INDICES, N_COSMO_EXACT)
    block = {"grid": dataclasses.asdict(DEFAULT_GRID),
             "n_cosmo": N_COSMO_EXACT, "indices": list(EXACT_INDICES),
             "omega_m0": oms.tolist(), "sigma_8": s8s.tolist()}
    batch = jax_batch(oms, s8s)
    if name == "chip_tomo":
        lens, src, hods, z_pivot = tomo_layout(DEFAULT_GRID)
        fn = make_tomographic_pipeline(default_halo(), hods, lens, src,
                                       grid=DEFAULT_GRID, z_pivot=z_pivot,
                                       exact_z_anchors=EXACT_J)
        out = jax.jit(lambda b: jax.lax.map(fn, b))(batch)
        block.update(exact_z_anchors=EXACT_J, outputs=keep(out))
    elif name == "chip_gl":
        from chomp_tpu import limber_fft

        win = projection.WindowGalaxy(dist=tp.jax_dist())
        cl = cl_fn(DEFAULT_GRID, win, np.asarray(GL_ELLS), GL_N_Z)
        out = np.asarray(jax.jit(lambda b: jax.lax.map(cl, b))(batch))
        lat = np.asarray(jax.jit(lambda b: jax.lax.map(
            lambda c: limber_fft.limber_cl_fft_exact_z(
                c, default_halo(), default_hod(), win, win,
                np.asarray(GL_ELLS), "power_gg", n_z_anchor=GL_LATTICE_J,
                grid=DEFAULT_GRID), b))(batch))
        block.update(ells=GL_ELLS, n_z=GL_N_Z, cl=out.tolist(),
                     lattice_j=GL_LATTICE_J, lattice=lat.tolist(),
                     jax_lattice_vs_gl_worst=float(np.max(np.abs(
                         lat / out - 1.0))))
    else:
        raise SystemExit(f"unknown exact-z tomography block {name!r}")
    print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
    return block


EXACTZ_TOMO_PARTS = ("tiny", "gl", "chip_tomo", "chip_gl")


def write_exactz_tomo_reference():
    """tests/data/torch_exactz_tomo_reference.json: each block in a
    process of its own, one after another; a block whose part file
    (``tests/data/.exactz_tomo_<name>.json``, written by
    ``--exactz-tomo-part <name> <file>``) exists already is taken as it
    is, so the parts may be made in parallel first."""
    import subprocess

    blocks = {}
    for name in EXACTZ_TOMO_PARTS:
        part = DATA / f".exactz_tomo_{name}.json"
        if not part.exists():
            subprocess.run([sys.executable, __file__, "--exactz-tomo-part",
                            name, str(part)], check=True)
        blocks[name] = json.loads(part.read_text())
    data = {"config": "exact-z tomography (make_tomographic_pipeline with "
                      "exact_z_anchors) and the Gauss-Legendre exact-z "
                      "C_ell (projection.limber_cl_exact_z, power_gg), JAX "
                      "float64 CPU; 'tiny': EXACTZ_TOMO_CASES of tools/"
                      "torch_slice_reference.py on tests/test_torch_"
                      "tomographic.py's layout and grid; 'gl': at tests/"
                      "test_exact_z_lattice.py's configuration; 'chip_tomo' "
                      "and 'chip_gl': chip_smoke.py phases 20 and 22 at "
                      "DEFAULT_GRID; jacobian columns (omega_m0, sigma_8) "
                      "with omega_l0 = 1 - omega_m0",
            "cases": EXACTZ_TOMO_CASES, "cell": TOMO_CELL, **blocks}
    path = DATA / "torch_exactz_tomo_reference.json"
    path.write_text(json.dumps(data, indent=1) + "\n")
    for name in EXACTZ_TOMO_PARTS:
        (DATA / f".exactz_tomo_{name}.json").unlink()
    print(f"wrote {path}")


#: The HOD families of tests/data/torch_families_reference.json: the JAX
#: class and its fields (those of the JAX package's tests/test_hod.py).
HOD_FAMILIES = {
    "poisson": ("HODPoisson", dict(log10_m_min=12.0, alpha=1.0)),
    "mandelbaum": ("HODMandelbaum", dict(m0=1.0e12, w=1.5)),
    "kravtsov": ("HODKravtsov", dict(log10_m_min=11.5, log10_m_1=12.5,
                                     alpha=1.0)),
}
#: The per-bin HODs of the mixed-family tomographic cells: on the
#: tomographic tests' grid (2 lens bins) and in chip_smoke.py phase 23
#: (TOMO_CELL's 5 lens bins: Mandelbaum with M0 at the cell's M_min,
#: Kravtsov with M_1 = 20 M_min, then the cell's Zheng HODs).
MIXED_TINY_HODS = [HOD_FAMILIES["mandelbaum"], HOD_FAMILIES["kravtsov"]]


def mixed_chip_hods():
    c = TOMO_CELL
    m = c["log10_m_min"]
    zheng = [("HODZheng", dict(log10_m_min=v, sigma=0.15, log10_m_0=v,
                               log10_m_1p=v + c["log10_m_1p_offset"],
                               alpha=1.0)) for v in m[3:]]
    return ([("HODMandelbaum", dict(m0=10.0 ** v, w=1.5)) for v in m[:2]]
            + [("HODKravtsov", dict(log10_m_min=m[2],
                                    log10_m_1=m[2] + c["log10_m_1p_offset"],
                                    alpha=1.0))] + zheng)


def jax_hod(spec):
    """A JAX HOD from (class name, fields)."""
    import jax.numpy as jnp

    from chomp_tpu import hod

    cls, fields = spec
    return getattr(hod, cls)(**{k: jnp.asarray(float(v))
                                for k, v in fields.items()})


#: The float32 gate's grids (the JAX package's tests/test_f32_budget.py)
#: and its cosmologies: the prior corners, then two near-fiducial points.
def f32_budget_grids():
    from chomp_tpu.params import GridSpec

    return (GridSpec(n_mass=256, lattice_dln=0.016, n_ell=512, n_theta=16),
            GridSpec(n_mass=256, lattice_dln=0.016, n_ell=512, n_theta=8,
                     theta_min_deg=0.2, theta_max_deg=5.0))


def corner_batch():
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo
    from chomp_tpu.parallel.sweep import broadcast_cosmo
    from chomp_tpu.utils.corners import corner_arrays

    om, ol, s8, w0, wa = corner_arrays(
        extra=[(0.25, 0.75, 0.811, -1.0, 0.0), (0.31, 0.69, 0.811, -1.0, 0.0)])
    return broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(om),
                           omega_l0=jnp.asarray(ol), sigma_8=jnp.asarray(s8),
                           w0=jnp.asarray(w0), wa=jnp.asarray(wa))


def _outputs(out):
    return {k: np.asarray(v).tolist() for k, v in out.items()
            if k != "theta_deg"}


def families_part(name):
    """One block of tests/data/torch_families_reference.json (JAX
    float64): "tiny" (each family through both routes of bench.py's
    configuration A on the parity grid, Mandelbaum exact-z with J = 4,
    and the mixed-family tomographic pipeline on the tomographic tests'
    grid), "corners" (the float32 gate's pipelines on its grids at the
    corners), "chip_families", "chip_tomo" and "chip_corners" (chip_smoke.py
    phases 23-24 at DEFAULT_GRID)."""
    import time

    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_halo, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import (Nuisance3x2pt, make_pipeline,
                                          make_tomographic_pipeline)
    from tests import torch_parity as tp

    t0 = time.perf_counter()

    def done(what):
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}: {what}",
              flush=True)

    def mapped(fn, batch, *args):
        return jax.jit(lambda b: jax.lax.map(lambda c: fn(c, *args), b))(
            batch)

    def family_pipe(grid, fam, **options):
        return make_pipeline(default_halo(), jax_hod(HOD_FAMILIES[fam]),
                             tp.jax_dist(), power_spec="power_gg",
                             grid=grid, include_lensing=True,
                             **{"z_pivot": 1.0, **options})

    block = {}
    if name == "tiny":
        from tests import test_torch_tomographic as tt

        block["grid"] = dataclasses.asdict(tp.GRID)
        for fam in HOD_FAMILIES:
            for method in ("fft", "table"):
                out = jax.jit(jax.vmap(family_pipe(tp.GRID, fam,
                                                   method=method)))(
                    tp.jax_batch())
                block[f"{fam}_{method}"] = _outputs(out)
                done(f"{fam} {method}")
        out = jax.jit(jax.vmap(family_pipe(
            tp.GRID, "mandelbaum", exact_z_anchors=TINY_J)))(tp.jax_batch())
        block["mandelbaum_exact_z"] = _outputs(out)
        done("mandelbaum exact-z")
        fn = make_tomographic_pipeline(
            default_halo(), [jax_hod(h) for h in MIXED_TINY_HODS], tt.LENS,
            tt.SRC, grid=tt.GRID, z_pivot=tt.Z_PIVOT)
        block["tomo_grid"] = dataclasses.asdict(tt.GRID)
        block["tomo_mixed"] = _outputs(jax.jit(jax.vmap(fn))(
            tt.jax_batch()))
        done("mixed tomographic")
    elif name == "corners":
        grid, grid_c = f32_budget_grids()
        dist = projection.DNdzGaussian(
            z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
            z0=jnp.asarray(1.0), sigma_z=jnp.asarray(0.2))
        for key, g, geom in (("flat", grid, "flat"),
                             ("curved", grid_c, "curved")):
            fn = make_pipeline(default_halo(), default_hod(), dist,
                               grid=g, geometry=geom)
            out = jax.jit(jax.vmap(fn))(corner_batch())
            block[key] = _outputs(out) | {"theta_deg": np.asarray(
                out["theta_deg"][0]).tolist(), "grid": dataclasses.asdict(g)}
            done(key)
    elif name == "chip_families":
        oms, s8s = cosmologies(INDICES)
        block.update(indices=list(INDICES), omega_m0=oms.tolist(),
                     sigma_8=s8s.tolist())
        for fam in HOD_FAMILIES:
            for method in ("fft", "table"):
                out = mapped(family_pipe(DEFAULT_GRID, fam, method=method),
                             jax_batch(oms, s8s))
                block[f"{fam}_{method}"] = _outputs(out)
                done(f"{fam} {method}")
    elif name == "chip_tomo":
        ref = json.loads((DATA / "torch_tomo_reference.json").read_text())
        lens, src, _hods, z_pivot = tomo_layout(DEFAULT_GRID)
        fn = make_tomographic_pipeline(
            default_halo(), [jax_hod(h) for h in mixed_chip_hods()], lens,
            src, grid=DEFAULT_GRID, z_pivot=z_pivot, with_nuisance=True,
            include_magnification=True)
        nu = Nuisance3x2pt(**{k: jnp.asarray(v)
                              for k, v in ref["nuisance"].items()})
        oms, s8s = cosmologies(INDICES)
        out = mapped(fn, jax_batch(oms, s8s), nu)
        block.update(indices=list(INDICES), omega_m0=oms.tolist(),
                     sigma_8=s8s.tolist(), nuisance_seed=ref["seed"],
                     hods=[list(h) for h in mixed_chip_hods()],
                     outputs=_outputs(out))
        done("outputs")
    elif name == "chip_corners":
        dist = projection.DNdzGaussian(
            z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
            z0=jnp.asarray(1.0), sigma_z=jnp.asarray(0.2))
        grid_c = DEFAULT_GRID.replace(n_theta=8, theta_min_deg=0.2,
                                      theta_max_deg=5.0)
        for key, g, geom in (("flat", DEFAULT_GRID, "flat"),
                             ("curved", grid_c, "curved")):
            fn = make_pipeline(default_halo(), default_hod(), dist,
                               grid=g, geometry=geom)
            out = mapped(fn, corner_batch())
            block[key] = _outputs(out) | {"theta_deg": np.asarray(
                out["theta_deg"][0]).tolist(), "grid": dataclasses.asdict(g)}
            done(key)
    else:
        raise SystemExit(f"unknown families part {name!r}")
    return block


FAMILIES_PARTS = ("tiny", "corners", "chip_families", "chip_tomo",
                  "chip_corners")


def write_families_reference():
    """tests/data/torch_families_reference.json: each block in a process
    of its own, one after another; a block whose part file
    (``tests/data/.families_<name>.json``, written by ``--families-part
    <name> <file>``) exists already is taken as it is."""
    import subprocess

    blocks = {}
    for name in FAMILIES_PARTS:
        part = DATA / f".families_{name}.json"
        if not part.exists():
            subprocess.run([sys.executable, __file__, "--families-part",
                            name, str(part)], check=True)
        blocks[name] = json.loads(part.read_text())
    from chomp_tpu.utils.corners import PRIOR_CORNERS

    data = {"config": "the other HOD families (Poisson, Mandelbaum, "
                      "Kravtsov) through make_pipeline's routes and a "
                      "mixed-family make_tomographic_pipeline, and the "
                      "float32 gate's pipelines at the prior corners (the "
                      "JAX package's tests/test_f32_budget.py), JAX float64 "
                      "CPU; 'tiny' and 'corners' for tests/test_torch_hod.py "
                      "and tests/test_torch_corners.py, 'chip_*' for "
                      "chip_smoke.py phases 23-24 at DEFAULT_GRID",
            "families": {k: list(v) for k, v in HOD_FAMILIES.items()},
            "mixed_tiny_hods": [list(h) for h in MIXED_TINY_HODS],
            "prior_corners": {k: list(v) for k, v in PRIOR_CORNERS.items()},
            "near_fiducial": [[0.25, 0.75, 0.811, -1.0, 0.0],
                              [0.31, 0.69, 0.811, -1.0, 0.0]],
            "cell": TOMO_CELL, **blocks}
    path = DATA / "torch_families_reference.json"
    path.write_text(json.dumps(data, indent=1) + "\n")
    for name in FAMILIES_PARTS:
        (DATA / f".families_{name}.json").unlink()
    print(f"wrote {path}")


def write_emulator_reference():
    """tests/data/torch_emulator_reference.json (float64)."""
    import jax

    from chomp_tpu import emulator as jemu
    from tests import test_torch_emulator as te

    jax_emu = te.jax_emulator()
    p = te.converted_points()
    data = {"config": "the JAX package's emulator on the inputs of "
                      "tests/test_torch_emulator.py, JAX float64 CPU",
            "converted": {
                "p": p.tolist(),
                "emu": np.asarray(jax.vmap(jax_emu)(p)).tolist(),
                "jacfwd": np.asarray(jax.vmap(jax.jacfwd(jax_emu))(p)
                                     ).tolist()},
            "pca": []}
    x, y = te.sweep_data()
    for kw in te.PCA_CASES:
        extra = ({"j_train": te.sweep_jacobians()} if "jac_weight" in kw
                 else {})
        emu, rep = jemu.train_emulator(None, te.BOUNDS, jax.random.PRNGKey(1),
                                       x_train=x, y_train=y, n_epochs=1,
                                       hidden=(8,), **kw, **extra)
        data["pca"].append({"kw": kw, "n_pca": rep.n_pca,
                            "n_train": rep.n_train, "n_val": rep.n_val,
                            **{name: np.asarray(getattr(emu, name)).tolist()
                               for name in te.TAIL}})
    path = DATA / "torch_emulator_reference.json"
    path.write_text(json.dumps(data) + "\n")
    print(f"wrote {path}")


# ---------------------------------------------------------------------------
# The covariance stack: tests/data/torch_cov_reference.json
# ---------------------------------------------------------------------------

#: chip_smoke.py phase 27, the Morrison & Schneider joint w(theta) + gamma_t
#: covariance: the survey of examples/joint_covariance_example.py (1000
#: deg^2, 2 lenses and 10 sources per arcmin^2, sigma_e 0.26 per component,
#: 8 bins from 0.01 to 1 deg, the halo model at z = 0.5), on DEFAULT_GRID
#: at the JAX builders' default knobs with the connected and super-sample
#: terms and the PSD clip; cosmologies of bench.py's 64-point linspaces.
JOINT_CELL = dict(area_deg2=1000.0, lens_n_arcmin2=2.0, src_n_arcmin2=10.0,
                  sigma_e=0.26, lens=dict(z_min=0.0, z_max=1.2, z0=0.5,
                                          sigma_z=0.15),
                  src=dict(z_min=0.0, z_max=2.5, z0=1.2, sigma_z=0.3),
                  z_model=0.5, edges_deg=np.logspace(-2, 0, 9).tolist())
JOINT_INDICES = EXACT_INDICES
#: chip_smoke.py phase 28: the tomographic cell (TOMO_CELL, its nuisance
#: point and per-bin HODs) with DES_Y3_SURVEY, DES Y3's 20 bins used as
#: bin edges from 2.5' to 250'; the JAX values are of its first
#: TOMO_COV_BINS (lens, source) bins, at TOMO_COV_INDICES of the 64-point
#: linspaces, by the scalar program only (an eager JAX run of its 78
#: probe-pair blocks takes about an hour on the CPU; the gate takes phase
#: 27's batch-vs-scalar gap).
DES_THETA_EDGES_DEG = (2.5 * 10.0 ** (np.arange(21) / 10.0) / 60.0).tolist()
TOMO_COV_BINS = (2, 2)
TOMO_COV_INDICES = (0,)
PER_SR = (180.0 * 60.0 / np.pi) ** 2


def survey_numbers(area_deg2, lens_n, src_n, sigma_e):
    """(omega_s in sr, lens n2d per sr, shape noise per component) of
    densities per arcmin^2 (scalars or lists)."""
    omega = area_deg2 * (np.pi / 180.0) ** 2
    n2d = np.asarray(lens_n, dtype=float) * PER_SR
    sn = np.asarray(sigma_e, dtype=float) ** 2 / (
        np.asarray(src_n, dtype=float) * PER_SR)
    return float(omega), n2d, sn


def _jax_gauss(spec):
    import jax.numpy as jnp

    from chomp_tpu import projection

    return projection.DNdzGaussian(**{k: jnp.asarray(float(v))
                                      for k, v in spec.items()})


def _cosmo_at(om, s8):
    import jax.numpy as jnp

    from chomp_tpu import default_cosmo

    return dataclasses.replace(default_cosmo(), omega_m0=jnp.asarray(om),
                               omega_l0=jnp.asarray(1.0 - om),
                               sigma_8=jnp.asarray(s8))


def _block_gap(batched, scalar, nb):
    """max over cosmologies and nb x nb blocks of max|a - b| / max|b|."""
    worst = 0.0
    n = scalar.shape[-1] // nb
    for c in range(scalar.shape[0]):
        for i in range(n):
            for j in range(n):
                a = batched[c, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
                b = scalar[c, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
                worst = max(worst, float(np.max(np.abs(a - b))
                                         / max(np.max(np.abs(b)), 1e-300)))
    return worst


def joint_cov_fn(grid, **kw):
    """The phase-27 builder of one JAX cosmology on ``grid``."""
    from chomp_tpu import covariance, default_halo, halo
    from chomp_tpu.hod import default_hod

    c = JOINT_CELL
    lens, src = _jax_gauss(c["lens"]), _jax_gauss(c["src"])
    omega, n2d, sn = survey_numbers(c["area_deg2"], c["lens_n_arcmin2"],
                                    c["src_n_arcmin2"], c["sigma_e"])
    hp, hod = default_halo(), default_hod()
    opts = dict(include_nongaussian=True, include_ssc=True,
                psd_guard="clip")
    opts.update(kw)

    def f(cosmo):
        m = halo.build_halo_model(cosmo, hp, hod, c["z_model"], False, grid)
        return covariance.joint_wtheta_gammat_covariance(
            cosmo, hp, m, lens, src, c["edges_deg"], omega, float(n2d),
            float(sn), grid=grid, **opts)

    return f


def tomo_cov_fn(grid, n_lens, n_src, **kw):
    """The phase-28 builder (first ``n_lens`` x ``n_src`` bins of the
    cell) of one JAX cosmology on ``grid``."""
    import jax.numpy as jnp

    from chomp_tpu import covariance, default_halo, halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import Nuisance3x2pt

    c = TOMO_CELL
    nu = json.loads((DATA / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    lens = [_jax_gauss(dict(z_min=0.0, z_max=c["lens_z_max"], z0=z0,
                            sigma_z=c["lens_sigma_z"]))
            for z0 in c["lens_z0"][:n_lens]]
    src = [_jax_gauss(dict(z_min=0.0, z_max=c["src_z_max"], z0=z0,
                           sigma_z=sz))
           for z0, sz in list(zip(c["src_z0"], c["src_sigma_z"]))[:n_src]]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + c["log10_m_1p_offset"])
            for m in c["log10_m_min"][:n_lens]]
    sv = DES_Y3_SURVEY
    omega, n2d, sn = survey_numbers(
        sv["area_deg2"], sv["lens_n_arcmin2"][:n_lens],
        sv["src_n_eff_arcmin2"][:n_src], sv["src_sigma_e"][:n_src])
    nuis = Nuisance3x2pt(
        dz_lens=jnp.asarray(nu["dz_lens"][:n_lens]),
        dz_src=jnp.asarray(nu["dz_src"][:n_src]),
        m=jnp.asarray(nu["m"][:n_src]), a_ia=jnp.asarray(nu["a_ia"]),
        eta_ia=jnp.asarray(nu["eta_ia"]), z0_ia=jnp.asarray(nu["z0_ia"]),
        alpha_lens=jnp.asarray(nu["alpha_lens"][:n_lens]))
    hp = default_halo()
    opts = dict(include_nongaussian=True, include_ssc=True,
                psd_guard="clip", nuisance=nuis,
                include_magnification=True)
    opts.update(kw)

    def f(cosmo):
        models = halo.build_halo_models(cosmo, hp, hods, c["z_pivot"],
                                        False, grid)
        return covariance.tomographic_3x2pt_covariance(
            cosmo, hp, models, lens, src, DES_THETA_EDGES_DEG, omega,
            n2d.tolist(), sn.tolist(), grid=grid, **opts)

    return f


def _scalar_and_batched(f, oms, s8s, nb):
    """Each cosmology's matrix by the scalar program (eager), then all of
    them by ``jax.jit(jax.vmap(f))`` (the batched program of the JAX
    package's tests/test_covariance.py:506, which measured the gap this
    reports), with the seconds and the worst block gap."""
    import time

    import jax

    t0 = time.perf_counter()
    scalar, secs = [], []
    for om, s8 in zip(oms, s8s):
        t1 = time.perf_counter()
        scalar.append(np.asarray(f(_cosmo_at(om, s8))))
        secs.append(time.perf_counter() - t1)
        print(f"  scalar cosmology: {secs[-1]:.1f} s", flush=True)
    scalar = np.stack(scalar)
    t1 = time.perf_counter()
    batched = np.asarray(jax.jit(jax.vmap(f))(jax_batch(oms, s8s)))
    vm_s = time.perf_counter() - t1
    gap = _block_gap(batched, scalar, nb)
    print(f"  vmap: {vm_s:.1f} s, batch-vs-scalar gap {gap:.3e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return scalar, dict(scalar_seconds=secs, vmap_seconds=vm_s,
                        batch_vs_scalar_gap=gap)


def cov_chip_part(name):
    """One DEFAULT_GRID block of tests/data/torch_cov_reference.json:
    "chip_joint" (phase 27) or "chip_tomo" (phase 28's 2 x 2 gate)."""
    import time

    from chomp_tpu.params import DEFAULT_GRID

    if name == "chip_joint":
        nb = len(JOINT_CELL["edges_deg"]) - 1
        oms, s8s = cosmologies(JOINT_INDICES, N_COSMO_EXACT)
        full, info = _scalar_and_batched(joint_cov_fn(DEFAULT_GRID), oms,
                                         s8s, nb)
        # The pieces at the first cosmology, each timed: the Gaussian
        # part, then + cNG, then + SSC (no clip).
        c0 = _cosmo_at(oms[0], s8s[0])
        pieces, piece_s = {}, {}
        for key, kw in (("gaussian", dict(include_nongaussian=False,
                                          include_ssc=False,
                                          psd_guard=None)),
                        ("gaussian_cng", dict(include_ssc=False,
                                              psd_guard=None)),
                        ("unclipped", dict(psd_guard=None))):
            t0 = time.perf_counter()
            pieces[key] = np.asarray(
                joint_cov_fn(DEFAULT_GRID, **kw)(c0)).tolist()
            piece_s[key] = time.perf_counter() - t0
            print(f"  {key}: {piece_s[key]:.1f} s", flush=True)
        return {"n_cosmo": N_COSMO_EXACT, "indices": list(JOINT_INDICES),
                "omega_m0": oms.tolist(), "sigma_8": s8s.tolist(),
                "cov": full.tolist(), "pieces_at_first": pieces,
                "piece_seconds": piece_s, **info}
    if name == "chip_tomo":
        from chomp_tpu.covariance import psd_clip

        n_l, n_s = TOMO_COV_BINS
        oms, s8s = cosmologies(TOMO_COV_INDICES, N_COSMO_EXACT)
        # The raw matrix (psd_guard=None) and its clip: the builder's
        # psd_guard="clip" is psd_clip of that raw matrix, eagerly.
        f = tomo_cov_fn(DEFAULT_GRID, n_l, n_s, psd_guard=None)
        raw, full, secs = [], [], []
        for om, s8 in zip(oms, s8s):
            t0 = time.perf_counter()
            raw.append(np.asarray(f(_cosmo_at(om, s8))))
            full.append(np.asarray(psd_clip(raw[-1])))
            secs.append(time.perf_counter() - t0)
            print(f"  scalar cosmology: {secs[-1]:.1f} s", flush=True)
        return {"n_cosmo": N_COSMO_EXACT, "indices": list(TOMO_COV_INDICES),
                "omega_m0": oms.tolist(), "sigma_8": s8s.tolist(),
                "bins": list(TOMO_COV_BINS), "cov": np.stack(full).tolist(),
                "cov_raw": np.stack(raw).tolist(), "scalar_seconds": secs}
    raise SystemExit(f"unknown covariance part {name!r}")


#: The rows of tests/torch_cov_cases.py's cosmologies that each tiny case
#: is computed at (eager JAX, one cosmology at a time).
COV_TINY_ROWS = dict(joint=(0, 1, 2), gaussian_masked=(2,), pixel=(2,),
                     table=(2,), x3x2pt=(2,), tomo=(2,), pieces=(0, 2))


def cov_tiny_part(name="tiny"):
    """The ``tiny`` block of tests/data/torch_cov_reference.json: the JAX
    values of the covariance tests' cases (tests/torch_cov_cases.py), each
    at its cosmology rows, with the CPU seconds each took."""
    import time

    import jax.numpy as jnp

    from chomp_tpu import covariance, halo, mask as jmask, projection
    from chomp_tpu import ssc, trispectrum
    from tests import torch_cov_cases as C

    rows = COV_TINY_ROWS
    out, secs = {}, {}

    def put(case, row, fn):
        t0 = time.perf_counter()
        val = fn()
        val = {k: np.asarray(v).tolist() for k, v in val.items()} \
            if isinstance(val, dict) else np.asarray(val).tolist()
        out.setdefault(case, {})[str(row)] = val
        secs[f"{case}/{row}"] = time.perf_counter() - t0
        print(f"  {case} row {row}: {secs[f'{case}/{row}']:.1f} s",
              flush=True)

    grid = C.GRID
    kw = dict(grid=grid, **C.KW)
    joint_cov = covariance.joint_wtheta_gammat_covariance
    for row in sorted({r for v in rows.values() for r in v}):
        J = C.jax_side(row)
        win_g = projection.WindowGalaxy(dist=J.dist)
        win_k = projection.WindowConvergence(dist=J.dist)
        base = (J.cosmo, J.halo, J.model, J.dist, J.dist, C.EDGES,
                C.OMEGA_S, C.N2D, C.SHAPE_NOISE)
        if row in rows["joint"]:
            put("joint", row, lambda: joint_cov(
                *base, include_ssc=True, psd_guard="clip", **kw))
        if row in rows["gaussian_masked"]:
            put("gaussian_masked", row, lambda: {
                "disc": covariance.joint_3x2pt_covariance(
                    *base, include_nongaussian=False, mask=J.disc, **kw),
                "beyond": covariance.joint_3x2pt_covariance(
                    *base, include_nongaussian=False, mask=J.disc,
                    beyond_nka=True, **kw),
                "uniform": covariance.joint_wtheta_gammat_covariance(
                    *base, include_nongaussian=False, mask=J.uniform,
                    **kw)})
        if row in rows["pixel"]:
            put("pixel", row, lambda: joint_cov(
                *base, include_ssc=True, mask=J.pixel, **kw))
        if row in rows["table"]:
            put("table", row, lambda: joint_cov(
                *base, cl_method="table", tri_method="table", n_z_tri=24,
                **kw))
        if row in rows["x3x2pt"]:
            put("x3x2pt", row, lambda: covariance.joint_3x2pt_covariance(
                *base, include_ssc=True, psd_guard="clip", **kw))
        if row in rows["tomo"]:
            t = C.TOMO
            put("tomo", row, lambda: covariance.tomographic_3x2pt_covariance(
                J.cosmo, J.halo, J.models, J.lens, J.src, C.EDGES,
                C.OMEGA_S, t["n2d"], t["shape_noise"], grid=grid,
                n_ell_cov_g=C.KW["n_ell_cov_g"], include_nongaussian=True,
                nuisance=J.nuisance, include_magnification=True,
                include_ssc=True, psd_guard="clip",
                ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"],
                                u_stride=C.KW["u_stride"]),
                n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=C.KW["n_k_tri"],
                u_stride=C.KW["u_stride"]))
        if row in rows["pieces"]:
            k = jnp.asarray(C.K_TRI)
            k1, k2 = np.meshgrid(C.K_TRI, C.K_TRI, indexing="ij")
            k1, k2 = jnp.asarray(k1.ravel()), jnp.asarray(k2.ravel())
            leg = (J.models[0], J.models[1], J.models[1], J.models[0])

            def pieces():
                m = J.model
                res = {}
                for i, v in enumerate(halo.two_halo_integrals(
                        J.cosmo, J.halo, m, k)
                        + halo.one_halo_integrals(J.cosmo, J.halo, m, k,
                                                  grid=grid)):
                    res[f"integrals.{i}"] = v
                res["y_matrix"] = halo._y_matrix(J.cosmo, J.halo, m, k)
                res["y_gal"] = halo._y_gal(J.cosmo, J.halo, m, k)
                res["y_matter"] = halo._y_matter(J.cosmo, J.halo, m, k)
                res["y_gal_matter"] = halo._y_gal_matter(J.cosmo, J.halo,
                                                         m, k)
                res["linear_power"] = halo.linear_power(J.cosmo, m, k,
                                                        grid=grid)
                res["bias_avg"] = halo.galaxy_bias_avg(m)
                for j, v in enumerate(halo.union_gal_pack(
                        J.cosmo, J.halo, J.models, grid=grid)):
                    res[f"union.{j}"] = v
                for trs in ("gggg", "gggm", "gmgm", "ggmm", "mmmm"):
                    res[f"tri.{trs}"] = \
                        trispectrum.trispectrum_parallelogram_tracers(
                            J.cosmo, J.halo, m, k1, k2, tuple(trs),
                            grid=grid)
                    res[f"tri_legs.{trs}"] = \
                        trispectrum.trispectrum_parallelogram_tracers(
                            J.cosmo, J.halo, leg, k1, k2, tuple(trs),
                            grid=grid)
                res["tri.matter"] = trispectrum.trispectrum_parallelogram(
                    J.cosmo, J.halo, m, k1, k2, grid=grid)
                res["tri.galaxy"] = \
                    trispectrum.trispectrum_parallelogram_galaxy(
                        J.cosmo, J.halo, m, k1, k2, grid=grid)
                res["t_pt"] = trispectrum.t_pt_parallelogram(
                    J.cosmo, k1, k2, grid=grid, z=0.4)
                res["b_pt"] = trispectrum.b_pt_avg(J.cosmo, k1, k2,
                                                   grid=grid, z=0.4)
                pos, cnt = ssc.power_response_parts(J.cosmo, J.halo, m, k,
                                                    grid=grid)
                for key in ("mm", "gm", "gg"):
                    res[f"pos.{key}"] = pos[key]
                    res[f"cnt.{key}"] = cnt[key]
                for key, v in ssc.power_responses(
                        J.cosmo, J.halo, m, k, grid=grid,
                        local_counts=False).items():
                    res[f"resp_nolocal.{key}"] = v
                for j, v in enumerate(ssc.response_one_halo_integrals(
                        J.cosmo, J.halo, m, k)):
                    res[f"resp_1h.{j}"] = v
                res["dlnk3p"] = ssc._dln_k3p_dlnk(J.cosmo, k)
                chi = jnp.asarray(np.geomspace(200.0, 3000.0, 5))
                g = jnp.asarray(np.linspace(0.9, 0.5, 5))
                for mname in ("disc", "pixel", "uniform"):
                    res[f"sigma_b2.{mname}"] = ssc.sigma_b2_flat(
                        J.cosmo, getattr(J, mname), chi, g, grid=grid)
                res["sigma_b2.omega"] = ssc.sigma_b2_fn(
                    J.cosmo, C.OMEGA_S, grid=grid)(chi, g)
                for case, (ws, ts, mi, mj) in {
                        "gggg": ((win_g,) * 4, ("g",) * 4, 0, 0),
                        "gggm": ((win_g, win_g, win_g, win_k),
                                 ("g", "g", "g", "m"), 0, 2),
                        "mmmm": ((win_k,) * 4, ("m",) * 4, 4, 4)}.items():
                    res[f"ssc.{case}"] = ssc.ssc_covariance(
                        J.cosmo, J.halo, m, J.dist, C.EDGES, J.disc,
                        windows=ws, tracers=ts, mu_i=mi, mu_j=mj,
                        grid=grid, n_ell_cov=12, u_stride=2)
                    res[f"cng.{case}"] = covariance.nongaussian_covariance(
                        J.cosmo, J.halo, m, J.dist, C.EDGES, C.OMEGA_S,
                        windows=ws, tracers=ts, mu_i=mi, mu_j=mj,
                        grid=grid, n_ell_cov=12, n_k_tri=16, u_stride=2)
                res["ssc.pair"] = ssc.projected_ssc(
                    J.cosmo, J.halo, (J.models[0], J.models[1]), C.ELLS,
                    C.ELLS[:5], (win_g, win_g, win_g, win_k),
                    ("g", "g", "g", "m"),
                    ssc.sigma_b2_fn(J.cosmo, C.OMEGA_S, grid=grid),
                    grid=grid, n_k_ssc=32, u_stride=2)
                for meth in ("lattice", "table"):
                    for trs, mdl in (("gggg", m), ("gmgm", leg)):
                        res[f"proj.{meth}.{trs}"] = \
                            covariance.projected_trispectrum(
                                J.cosmo, J.halo, mdl, J.dist, C.ELLS,
                                grid=grid, n_k_tri=16, n_z_tri=24,
                                windows=(win_g, win_k, win_g, win_k)
                                if trs == "gmgm" else None,
                                tracers=tuple(trs), method=meth,
                                u_stride=2)
                res["wtheta_cov"] = covariance.wtheta_covariance(
                    J.cosmo, J.halo, m, J.dist,
                    covariance.lattice_cl_callables(
                        J.cosmo, J.halo, m, J.dist, J.dist,
                        grid=grid)[0], C.EDGES, C.OMEGA_S, C.N2D,
                    grid=grid, n_k_tri=16, n_z_tri=8)
                cl_gg, cl_gk, cl_kk = covariance.lattice_cl_callables(
                    J.cosmo, J.halo, m, J.dist, J.dist, grid=grid)
                res["cl.gg"] = cl_gg(C.ELLS)
                res["cl.gk"] = cl_gk(C.ELLS)
                res["cl.kk"] = cl_kk(C.ELLS)
                return res

            put("pieces", row, pieces)
    return {"grid": dataclasses.asdict(grid), "rows": rows, "cases": out,
            "seconds": secs}




def cov_part(name):
    """The block ``name`` of tests/data/torch_cov_reference.json."""
    if name.startswith("chip_"):
        return cov_chip_part(name)
    return cov_tiny_part(name)


COV_PARTS = ("tiny", "chip_joint", "chip_tomo")


def write_cov_reference():
    """tests/data/torch_cov_reference.json: each block in a process of
    its own, one after another; a block whose part file
    (``tests/data/.cov_<name>.json``, written by ``--cov-part <name>
    <file>``) exists already is taken as it is, so the parts may be made
    in parallel first (on an 8-core CPU: 17 min; about 20 min, of which
    jit(vmap) 5 min; 57 min)."""
    import subprocess

    blocks = {}
    for name in COV_PARTS:
        part = DATA / f".cov_{name}.json"
        if not part.exists():
            subprocess.run([sys.executable, __file__, "--cov-part", name,
                            str(part)], check=True)
        blocks[name] = json.loads(part.read_text())
    data = {"config": "the flat-sky covariance stack, JAX float64 CPU; "
                      "'tiny': tests/torch_cov_cases.py's cases (eager, "
                      "one cosmology at a time); 'chip_joint': "
                      "chip_smoke.py phase 27 (JOINT_CELL on DEFAULT_GRID "
                      "at the builders' default knobs, cNG + SSC + clip), "
                      "with the worst block gap of jax.jit(jax.vmap) to "
                      "the scalar program; 'chip_tomo': phase 28's gate, "
                      "the first TOMO_COV_BINS lens x source bins of the "
                      "tomographic cell with DES_Y3_SURVEY at "
                      "DES_THETA_EDGES_DEG (cNG + SSC on every block; "
                      "cov_raw unclipped, cov clipped)",
            "joint_cell": JOINT_CELL, "tomo_cell": TOMO_CELL,
            "des_y3_survey": DES_Y3_SURVEY,
            "des_theta_edges_deg": DES_THETA_EDGES_DEG, **blocks}
    path = DATA / "torch_cov_reference.json"
    path.write_text(json.dumps(data) + "\n")
    for name in COV_PARTS:
        (DATA / f".cov_{name}.json").unlink()
    print(f"wrote {path}")


# ---------------------------------------------------------------------------
# The rest of the covariance stack: tests/data/torch_cov_more_reference.json
# ---------------------------------------------------------------------------

#: chip_smoke.py phase 29, the curved-sky joint covariances on a footprint
#: no azimuthal profile can represent: the two 20-degree caps of
#: examples/curved_sky_example.py (``two_cap_weight_map``, a 256 x 512
#: PixelSphereMask), its lens and source dN/dz, edges, n2d and shape noise
#: and its halo-model redshift, on DEFAULT_GRID at ell_max 4096 with the
#: connected and super-sample terms (raw matrices: the JAX
#: curved_joint_3x2pt_covariance ignores psd_guard); cosmologies of
#: bench.py's 64-point linspaces.
CURVED_CELL = dict(n_ring=256, n_phi=512, cap_radius_deg=20.0,
                   cap2_center=[2.0, 1.0],
                   lens=dict(z_min=0.0, z_max=2.0, z0=0.7, sigma_z=0.2),
                   src=dict(z_min=0.0, z_max=2.5, z0=1.1, sigma_z=0.3),
                   z_model=0.0, edges_deg=[1.0, 2.0, 4.0, 8.0], n2d=3.0e7,
                   shape_noise=1.0e-9, ell_max=4096)
CURVED_INDICES = EXACT_INDICES
#: chip_smoke.py phase 30: phase 27's JOINT_CELL with exact_z_anchors=6 on
#: the connected and super-sample terms (at EXACTZ_COV_INDICES), and with
#: exact_z=True (per-node rebuilds of the table route, the separable SSC
#: left out) at the first of them.
EXACTZ_COV_J = 6
EXACTZ_COV_INDICES = EXACT_INDICES
#: chip_smoke.py phase 31: phase 28's cell with cmb_lensing=True (the
#: default CMBLensingSpec), flat and on a SphericalCapMask of DES Y3's
#: area; the JAX values are of its first TOMO_COV_BINS bins at
#: TOMO_COV_INDICES, raw.
CMB_COV_INDICES = TOMO_COV_INDICES


def two_cap_weight_map(n_ring=256, n_phi=512, radius_deg=20.0,
                       center2=(2.0, 1.0)):
    """Binary two-cap footprint on the iso-latitude grid (the map of
    examples/curved_sky_example.py)."""
    th = (np.arange(n_ring) + 0.5) * np.pi / n_ring
    ph = np.arange(n_phi) * 2 * np.pi / n_phi
    rad = np.radians(radius_deg)

    def cap(center):
        ct0, st0 = np.cos(center[0]), np.sin(center[0])
        mu = (ct0 * np.cos(th)[:, None] + st0 * np.sin(th)[:, None]
              * np.cos(ph[None, :] - center[1]))
        return mu >= np.cos(rad)

    return (cap((0.0, 0.0)) | cap(center2)).astype(float)


def cap_radius_of_area(area_deg2):
    """The radius in radians of the polar cap of ``area_deg2``."""
    omega = area_deg2 * (np.pi / 180.0) ** 2
    return float(np.arccos(1.0 - omega / (2.0 * np.pi)))


def curved_cov_fn(grid, builder, **kw):
    """The phase-29 builder (``curved.<builder>``) of one JAX cosmology on
    ``grid``."""
    from chomp_tpu import curved, default_halo, halo
    from chomp_tpu.hod import default_hod

    c = CURVED_CELL
    mask = curved.PixelSphereMask(two_cap_weight_map(
        c["n_ring"], c["n_phi"], c["cap_radius_deg"], c["cap2_center"]))
    lens, src = _jax_gauss(c["lens"]), _jax_gauss(c["src"])
    hp, hod = default_halo(), default_hod()
    opts = dict(include_nongaussian=True, include_ssc=True, psd_guard=None,
                ell_max=c["ell_max"])
    opts.update(kw)
    fn = getattr(curved, builder)

    def f(cosmo):
        m = halo.build_halo_model(cosmo, hp, hod, c["z_model"], False, grid)
        return fn(cosmo, hp, m, lens, src, c["edges_deg"], c["n2d"],
                  c["shape_noise"], mask, grid=grid, **opts)

    return f


def cmb_tomo_cov_fn(grid, n_lens, n_src, curved_sky, **kw):
    """The phase-31 builder: phase 28's (tomo_cov_fn) with the kappa_CMB
    probes, flat or on the DES Y3-area polar cap, raw."""
    if not curved_sky:
        return tomo_cov_fn(grid, n_lens, n_src, cmb_lensing=True,
                           psd_guard=None, **kw)
    import jax.numpy as jnp

    from chomp_tpu import curved, default_halo, halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import Nuisance3x2pt

    c = TOMO_CELL
    nu = json.loads((DATA / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    lens = [_jax_gauss(dict(z_min=0.0, z_max=c["lens_z_max"], z0=z0,
                            sigma_z=c["lens_sigma_z"]))
            for z0 in c["lens_z0"][:n_lens]]
    src = [_jax_gauss(dict(z_min=0.0, z_max=c["src_z_max"], z0=z0,
                           sigma_z=sz))
           for z0, sz in list(zip(c["src_z0"], c["src_sigma_z"]))[:n_src]]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + c["log10_m_1p_offset"])
            for m in c["log10_m_min"][:n_lens]]
    sv = DES_Y3_SURVEY
    _, n2d, sn = survey_numbers(
        sv["area_deg2"], sv["lens_n_arcmin2"][:n_lens],
        sv["src_n_eff_arcmin2"][:n_src], sv["src_sigma_e"][:n_src])
    nuis = Nuisance3x2pt(
        dz_lens=jnp.asarray(nu["dz_lens"][:n_lens]),
        dz_src=jnp.asarray(nu["dz_src"][:n_src]),
        m=jnp.asarray(nu["m"][:n_src]), a_ia=jnp.asarray(nu["a_ia"]),
        eta_ia=jnp.asarray(nu["eta_ia"]), z0_ia=jnp.asarray(nu["z0_ia"]),
        alpha_lens=jnp.asarray(nu["alpha_lens"][:n_lens]))
    mask = curved.SphericalCapMask(cap_radius_of_area(sv["area_deg2"]))
    hp = default_halo()
    opts = dict(include_nongaussian=True, include_ssc=True, psd_guard=None,
                nuisance=nuis, include_magnification=True, cmb_lensing=True)
    opts.update(kw)

    def f(cosmo):
        models = halo.build_halo_models(cosmo, hp, hods, c["z_pivot"],
                                        False, grid)
        return curved.curved_tomographic_3x2pt_covariance(
            cosmo, hp, models, lens, src, DES_THETA_EDGES_DEG,
            n2d.tolist(), sn.tolist(), mask, grid=grid, **opts)

    return f


def _scalar_runs(f, oms, s8s):
    """Each cosmology's matrix by the eager scalar program, with the
    seconds each took."""
    import time

    out, secs = [], []
    for om, s8 in zip(oms, s8s):
        t0 = time.perf_counter()
        out.append(np.asarray(f(_cosmo_at(om, s8))))
        secs.append(time.perf_counter() - t0)
        print(f"  scalar cosmology: {secs[-1]:.1f} s", flush=True)
    return np.stack(out), secs


def cov_more_chip_part(name):
    """One DEFAULT_GRID block of tests/data/torch_cov_more_reference.json:
    "chip_curved_joint" / "chip_curved_3x2pt" (phase 29),
    "chip_exactz_anchors_<i>" (phase 30, the i-th of EXACTZ_COV_INDICES),
    "chip_exactz_pernode" (phase 30's exact_z=True run),
    "chip_cmb_flat" / "chip_cmb_curved" (phase 31)."""
    from chomp_tpu.params import DEFAULT_GRID

    if name in ("chip_curved_joint", "chip_curved_3x2pt"):
        builder = ("curved_joint_wtheta_gammat_covariance"
                   if name == "chip_curved_joint"
                   else "curved_joint_3x2pt_covariance")
        nb = len(CURVED_CELL["edges_deg"]) - 1
        oms, s8s = cosmologies(CURVED_INDICES, N_COSMO_EXACT)
        f = curved_cov_fn(DEFAULT_GRID, builder)
        if name == "chip_curved_joint":
            raw, info = _scalar_and_batched(f, oms, s8s, nb)
        else:
            raw, secs = _scalar_runs(f, oms, s8s)
            info = dict(scalar_seconds=secs)
        return {"n_cosmo": N_COSMO_EXACT, "indices": list(CURVED_INDICES),
                "omega_m0": oms.tolist(), "sigma_8": s8s.tolist(),
                "cov_raw": raw.tolist(), **info}
    if name.startswith("chip_exactz_anchors_"):
        i = int(name.rsplit("_", 1)[1])
        idx = (EXACTZ_COV_INDICES[i],)
        oms, s8s = cosmologies(idx, N_COSMO_EXACT)
        raw, secs = _scalar_runs(joint_cov_fn(
            DEFAULT_GRID, exact_z_anchors=EXACTZ_COV_J, psd_guard=None),
            oms, s8s)
        return {"index": idx[0], "omega_m0": oms.tolist(),
                "sigma_8": s8s.tolist(), "cov_raw": raw[0].tolist(),
                "scalar_seconds": secs}
    if name == "chip_exactz_pernode":
        idx = EXACTZ_COV_INDICES[:1]
        oms, s8s = cosmologies(idx, N_COSMO_EXACT)
        raw, secs = _scalar_runs(joint_cov_fn(
            DEFAULT_GRID, exact_z=True, include_ssc=False, psd_guard=None),
            oms, s8s)
        return {"indices": list(idx), "omega_m0": oms.tolist(),
                "sigma_8": s8s.tolist(), "cov_raw": raw.tolist(),
                "scalar_seconds": secs}
    if name in ("chip_cmb_flat", "chip_cmb_curved"):
        n_l, n_s = TOMO_COV_BINS
        oms, s8s = cosmologies(CMB_COV_INDICES, N_COSMO_EXACT)
        raw, secs = _scalar_runs(cmb_tomo_cov_fn(
            DEFAULT_GRID, n_l, n_s, name == "chip_cmb_curved"), oms, s8s)
        return {"indices": list(CMB_COV_INDICES), "omega_m0": oms.tolist(),
                "sigma_8": s8s.tolist(), "bins": list(TOMO_COV_BINS),
                "cov_raw": raw.tolist(), "scalar_seconds": secs}
    raise SystemExit(f"unknown covariance part {name!r}")


def cov_more_tiny_part(name):
    """One third of the ``tiny`` block of
    tests/data/torch_cov_more_reference.json, on tests/torch_cov_cases.py's
    grid and cosmology rows (eager JAX, the CPU seconds of each case):
    "tiny_exactz" (the exact-z connected and super-sample routes and
    builders), "tiny_cmb" (the kappa_CMB callables and tomographic
    blocks), "tiny_curved" (the curved-sky blocks and builders)."""
    import time

    import jax.numpy as jnp

    from chomp_tpu import covariance, curved, projection, ssc
    from chomp_tpu.cmblens import CMBLensingSpec
    from tests import torch_cov_cases as C

    out, secs = {}, {}

    def put(case, row, fn):
        t0 = time.perf_counter()
        val = fn()
        val = {k: np.asarray(v).tolist() for k, v in val.items()} \
            if isinstance(val, dict) else np.asarray(val).tolist()
        out.setdefault(case, {})[str(row)] = val
        secs[f"{case}/{row}"] = time.perf_counter() - t0
        print(f"  {case} row {row}: {secs[f'{case}/{row}']:.1f} s",
              flush=True)

    grid = C.GRID
    t = C.TOMO
    spec = CMBLensingSpec(nl_ell=C.CMB_NL_ELL, nl=C.CMB_NL)
    cv = C.CURVED
    for row in (0, 2):
        J = C.jax_side(row)
        win_g = projection.WindowGalaxy(dist=J.dist)
        win_k = projection.WindowConvergence(dist=J.dist)
        leg = (J.models[0], J.models[1], J.models[1], J.models[0])
        base = (J.cosmo, J.halo, J.model, J.dist, J.dist, C.EDGES,
                C.OMEGA_S, C.N2D, C.SHAPE_NOISE)
        proj_kw = dict(grid=grid, n_k_tri=16, u_stride=2)
        if name == "tiny_exactz":
            put("proj_anchors", row, lambda: {
                "gggg": covariance.projected_trispectrum(
                    J.cosmo, J.halo, J.model, J.dist, C.ELLS,
                    exact_z_anchors=C.J_ANCHORS, **proj_kw),
                "gmgm": covariance.projected_trispectrum(
                    J.cosmo, J.halo, leg, J.dist, C.ELLS,
                    windows=(win_g, win_k, win_g, win_k),
                    tracers=tuple("gmgm"), exact_z_anchors=C.J_ANCHORS,
                    **proj_kw)})
            if row != 2:
                continue
            put("proj_exact", row, lambda: {
                "table": covariance.projected_trispectrum(
                    J.cosmo, J.halo, J.model, J.dist, C.ELLS, exact_z=True,
                    n_z_tri=C.N_Z_EXACT, **proj_kw),
                "lattice": covariance.projected_trispectrum(
                    J.cosmo, J.halo, leg, J.dist, C.ELLS,
                    windows=(win_g, win_k, win_g, win_k),
                    tracers=tuple("gmgm"), exact_z=True, method="lattice",
                    **proj_kw)})
            put("ssc_anchors", row, lambda: {
                "pair": ssc.projected_ssc(
                    J.cosmo, J.halo, (J.models[0], J.models[1]), C.ELLS,
                    C.ELLS[:5], (win_g, win_g, win_g, win_k),
                    ("g", "g", "g", "m"),
                    ssc.sigma_b2_fn(J.cosmo, C.OMEGA_S, grid=grid),
                    grid=grid, n_k_ssc=32, u_stride=2,
                    exact_z_anchors=C.J_ANCHORS),
                "gggm": ssc.ssc_covariance(
                    J.cosmo, J.halo, J.model, J.dist, C.EDGES, J.disc,
                    windows=(win_g, win_g, win_g, win_k),
                    tracers=("g", "g", "g", "m"), mu_i=0, mu_j=2,
                    grid=grid, n_ell_cov=12, u_stride=2, n_k_ssc=32,
                    exact_z_anchors=C.J_ANCHORS)})
            put("joint_anchors", row, lambda: (
                covariance.joint_wtheta_gammat_covariance(
                    *base, include_ssc=True, exact_z_anchors=C.J_ANCHORS,
                    grid=grid, **C.KW)))
            put("joint_pernode", row, lambda: (
                covariance.joint_wtheta_gammat_covariance(
                    *base, exact_z=True, n_z_tri=C.N_Z_EXACT, grid=grid,
                    **C.KW)))
            put("tomo_anchors", row, lambda: (
                covariance.tomographic_3x2pt_covariance(
                    J.cosmo, J.halo, J.models, J.lens, J.src, C.EDGES,
                    C.OMEGA_S, t["n2d"], t["shape_noise"], grid=grid,
                    n_ell_cov_g=C.KW["n_ell_cov_g"],
                    include_nongaussian="autos", include_ssc="autos",
                    nuisance=J.nuisance,
                    ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"],
                                    u_stride=2, n_k_ssc=32,
                                    exact_z_anchors=C.J_ANCHORS),
                    n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=16, u_stride=2,
                    exact_z_anchors=C.J_ANCHORS)))
        elif name == "tiny_cmb":
            if row != 2:
                continue

            def cls():
                c = covariance.tomographic_lattice_cl_callables(
                    J.cosmo, J.halo, J.models, J.lens, J.src, False, grid,
                    J.nuisance, True, cmb=spec)
                return {"gK0": c[("gK", 0)](C.ELLS),
                        "gK1": c[("gK", 1)](C.ELLS),
                        "kK0": c[("kK", 0)](C.ELLS),
                        "kK1": c[("kK", 1)](C.ELLS),
                        "KK": c[("KK",)](C.ELLS)}

            put("cmb_cls", row, cls)
            put("cmb_tomo", row, lambda: (
                covariance.tomographic_3x2pt_covariance(
                    J.cosmo, J.halo, J.models, J.lens, J.src, C.EDGES,
                    C.OMEGA_S, t["n2d"], t["shape_noise"], grid=grid,
                    n_ell_cov_g=C.KW["n_ell_cov_g"], include_nongaussian=True,
                    nuisance=J.nuisance, include_magnification=True,
                    include_ssc=True, cmb_lensing=spec,
                    ssc_kwargs=dict(n_ell_cov=C.KW["n_ell_cov_ng"],
                                    u_stride=2, n_k_ssc=32),
                    n_ell_cov=C.KW["n_ell_cov_ng"], n_k_tri=16,
                    u_stride=2)))
        elif name == "tiny_curved":
            cap, pix = C.curved_masks(curved)
            ckw = dict(ell_max=cv["ell_max"], ell_split=cv["ell_split"],
                       grid=grid)
            ng = dict(n_ell_tbl=cv["n_ell_tbl"], n_k_tri=16, u_stride=2)
            skw = dict(n_ell_tbl=cv["n_ell_tbl"], u_stride=2,
                       n_k_ssc=cv["n_k_ssc"])
            cbase = (J.cosmo, J.halo, J.model, J.dist, J.dist,
                     cv["edges_deg"], C.N2D, C.SHAPE_NOISE)
            put("curved_joint", row, lambda: (
                curved.curved_joint_wtheta_gammat_covariance(
                    *cbase, pix, include_nongaussian=True, include_ssc=True,
                    ssc_kwargs=skw, **ckw, **ng)))
            if row != 2:
                continue

            def blocks():
                res = {}
                for case, (ws, ts, mi, mj) in {
                        "gggg": ((win_g,) * 4, ("g",) * 4, 0, 0),
                        "gggm": ((win_g, win_g, win_g, win_k),
                                 ("g", "g", "g", "m"), 0, 2),
                        "mmmm": ((win_k,) * 4, ("m",) * 4, "xip",
                                 "xim")}.items():
                    res[f"cng.{case}"] = curved.curved_nongaussian_covariance(
                        J.cosmo, J.halo, J.model, J.dist, cv["edges_deg"],
                        cap, mi, mj, cv["ell_max"], windows=ws, tracers=ts,
                        grid=grid, **ng)
                    res[f"ssc.{case}"] = ssc.curved_ssc_covariance(
                        J.cosmo, J.halo, J.model, J.dist, cv["edges_deg"],
                        cap, windows=ws, tracers=ts, mu_i=mi, mu_j=mj,
                        ell_max=cv["ell_max"], grid=grid, **skw)
                res["ssc.omega"] = ssc.curved_ssc_covariance(
                    J.cosmo, J.halo, J.model, J.dist, cv["edges_deg"],
                    C.OMEGA_S, ell_max=cv["ell_max"], grid=grid,
                    exact_z_anchors=C.J_ANCHORS, **skw)
                chi = jnp.asarray(np.geomspace(200.0, 3000.0, 5))
                g = jnp.asarray(np.linspace(0.9, 0.5, 5))
                for mname, m in (("cap", cap), ("pixel", pix)):
                    res[f"sigma_b2.{mname}"] = ssc.sigma_b2_curved(
                        J.cosmo, m, chi, g, grid=grid)
                res["sigma_b2.omega"] = ssc.sigma_b2_fn(
                    J.cosmo, C.OMEGA_S, "curved", grid=grid)(chi, g)
                return res

            put("curved_blocks", row, blocks)
            put("curved_3x2pt", row, lambda: (
                curved.curved_joint_3x2pt_covariance(
                    *cbase, cap, include_nongaussian=True, include_ssc=True,
                    ssc_kwargs=skw, **ckw, **ng)))
            put("curved_tomo", row, lambda: (
                curved.curved_tomographic_3x2pt_covariance(
                    J.cosmo, J.halo, J.models, J.lens, J.src,
                    cv["edges_deg"], t["n2d"], t["shape_noise"], cap,
                    include_nongaussian=True, nuisance=J.nuisance,
                    include_magnification=True, include_ssc=True,
                    cmb_lensing=spec, ssc_kwargs=skw, **ckw, **ng)))
        else:
            raise SystemExit(f"unknown covariance part {name!r}")
    return {"grid": dataclasses.asdict(grid), "cases": out, "seconds": secs}


def cov_more_part(name):
    """The block ``name`` of tests/data/torch_cov_more_reference.json."""
    if name.startswith("chip_"):
        return cov_more_chip_part(name)
    return cov_more_tiny_part(name)


COV_MORE_TINY = ("tiny_exactz", "tiny_cmb", "tiny_curved")
COV_MORE_PARTS = (*COV_MORE_TINY, "chip_curved_joint", "chip_curved_3x2pt",
                  *(f"chip_exactz_anchors_{i}"
                    for i in range(len(EXACTZ_COV_INDICES))),
                  "chip_exactz_pernode", "chip_cmb_flat", "chip_cmb_curved")


def write_cov_more_reference():
    """tests/data/torch_cov_more_reference.json: each block in a process
    of its own, one after another; a block whose part file
    (``tests/data/.covmore_<name>.json``, written by ``--cov-more-part
    <name> <file>``) exists already is taken as it is, so the parts may
    be made in parallel first.  The chip_exactz_anchors_<i> parts merge
    into one ``chip_exactz_anchors`` block; a missing
    ``chip_exactz_pernode`` part (eager JAX's per-node rebuilds at
    DEFAULT_GRID: skipped where they take too long) is recorded as
    null."""
    import subprocess

    blocks = {}
    for name in COV_MORE_PARTS:
        part = DATA / f".covmore_{name}.json"
        if not part.exists():
            subprocess.run([sys.executable, __file__, "--cov-more-part",
                            name, str(part)], check=True)
        blocks[name] = json.loads(part.read_text())
    tiny = [blocks.pop(name) for name in COV_MORE_TINY]
    blocks["tiny"] = {"grid": tiny[0]["grid"],
                      "cases": {k: v for b in tiny
                                for k, v in b["cases"].items()},
                      "seconds": {k: v for b in tiny
                                  for k, v in b["seconds"].items()}}
    anchors = [blocks.pop(f"chip_exactz_anchors_{i}")
               for i in range(len(EXACTZ_COV_INDICES))]
    blocks["chip_exactz_anchors"] = {
        "indices": [a["index"] for a in anchors],
        "omega_m0": [a["omega_m0"][0] for a in anchors],
        "sigma_8": [a["sigma_8"][0] for a in anchors],
        "cov_raw": [a["cov_raw"] for a in anchors],
        "scalar_seconds": [a["scalar_seconds"][0] for a in anchors],
        "j": EXACTZ_COV_J}
    data = {"config": "the rest of the covariance stack, JAX float64 CPU; "
                      "'tiny': tests/torch_cov_cases.py's grid, "
                      "cosmologies and curved masks (the parts "
                      "COV_MORE_TINY, eager, one cosmology at a time); "
                      "'chip_curved_joint' / 'chip_curved_3x2pt': "
                      "chip_smoke.py phase 29 (CURVED_CELL on DEFAULT_GRID,"
                      " cNG + curved SSC, raw), the joint one with the "
                      "worst block gap of jax.jit(jax.vmap) to the scalar "
                      "program; 'chip_exactz_anchors' / "
                      "'chip_exactz_pernode': phase 30 (JOINT_CELL with "
                      "exact_z_anchors=EXACTZ_COV_J on cNG and SSC; with "
                      "exact_z=True and no SSC), raw; 'chip_cmb_flat' / "
                      "'chip_cmb_curved': phase 31 (bins 0-1 of phase 28's "
                      "cell with cmb_lensing=True, flat and on the DES "
                      "Y3-area polar cap), raw",
            "curved_cell": CURVED_CELL, "joint_cell": JOINT_CELL,
            "tomo_cell": TOMO_CELL, "des_y3_survey": DES_Y3_SURVEY,
            "des_theta_edges_deg": DES_THETA_EDGES_DEG, **blocks}
    path = DATA / "torch_cov_more_reference.json"
    path.write_text(json.dumps(data) + "\n")
    for name in COV_MORE_PARTS:
        part = DATA / f".covmore_{name}.json"
        if part.exists():
            part.unlink()
    print(f"wrote {path}")


FILES = ("torch_slice_reference.json", "torch_table_reference.json",
         "torch_grad_reference.json", "torch_exactz_reference.json",
         "torch_tomo_reference.json", "torch_options_reference.json",
         "torch_exactz_tomo_reference.json",
         "torch_families_reference.json", "torch_emulator_reference.json",
         "torch_cov_reference.json", "torch_cov_more_reference.json")


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    args = sys.argv[1:]
    if args[:1] == ["--options-cell"]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        Path(args[2]).write_text(json.dumps(
            option_tiny_reference() if args[1] == "tiny"
            else option_cell_reference(args[1])))
        return
    if args[:1] == ["--exactz-tomo-part"]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        Path(args[2]).write_text(json.dumps(exactz_tomo_part(args[1])))
        return
    if args[:1] == ["--cov-part"]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        Path(args[2]).write_text(json.dumps(cov_part(args[1])))
        return
    if args[:1] == ["--cov-more-part"]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        Path(args[2]).write_text(json.dumps(cov_more_part(args[1])))
        return
    if args[:1] == ["--families-part"]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        Path(args[2]).write_text(json.dumps(families_part(args[1])))
        return
    seed = 0
    if "--seed" in args:
        i = args.index("--seed")
        seed = int(args[i + 1])
        del args[i:i + 2]
    names = args or list(FILES)
    unknown = set(names) - set(FILES)
    if unknown:
        raise SystemExit(f"unknown file(s) {sorted(unknown)}; choose from "
                         f"{FILES}")
    jax.config.update("jax_platforms", "cpu")
    if set(names) & set(FILES[:2]):
        write_slice_and_table()
    else:
        jax.config.update("jax_enable_x64", True)
    if FILES[2] in names:
        write_grad_reference()
    if FILES[3] in names:
        write_exactz_reference()
    if FILES[4] in names:
        write_tomo_reference(seed)
    if FILES[5] in names:
        write_options_reference()
    if FILES[6] in names:
        write_exactz_tomo_reference()
    if FILES[7] in names:
        write_families_reference()
    if FILES[8] in names:
        write_emulator_reference()
    if FILES[9] in names:
        write_cov_reference()
    if FILES[10] in names:
        write_cov_more_reference()


def write_slice_and_table():
    """The first two files (either asked for writes both: they share the
    runs)."""
    import jax

    idx = measured_indices()
    # The float32 leg runs first, before 64-bit mode is switched on.
    jax.config.update("jax_enable_x64", False)
    table32 = run("table", idx)
    jax.config.update("jax_enable_x64", True)
    lattice = run("fft", idx)
    table = run("table", idx)
    f32_err = worst_bin(table32, table)
    cross = worst_bin(table, lattice)
    print(f"JAX float32 table route vs float64: worst bin {f32_err:.3e}; "
          f"float64 table vs lattice route: worst bin {cross:.3e} "
          f"({len(idx)} cosmologies)")
    write("torch_slice_reference.json",
          "bench.py configuration A, DEFAULT_GRID, JAX float64 CPU",
          INDICES, lattice)
    write("torch_table_reference.json",
          "bench.py configuration A with method='table', DEFAULT_GRID, "
          "JAX float64 CPU", INDICES, table,
          measured_on=idx, jax_f32_vs_f64_worst_bin=f32_err,
          jax_table_vs_lattice_worst_bin=cross)


if __name__ == "__main__":
    main()

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
  records its grid spec, so a test can tell when the file is stale.

``chip_smoke.py`` holds the port's GPU runs against these numbers.

    python tools/torch_slice_reference.py
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


def cosmologies(idx):
    oms = np.linspace(0.24, 0.32, N_COSMO)[list(idx)]
    s8s = np.linspace(0.75, 0.88, N_COSMO)[list(idx)]
    return oms, s8s


def run(method, idx):
    """{"w_theta", "gamma_t", "theta_deg"} of one route at the JAX
    package's current precision (x64 on or off)."""
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
                       include_lensing=True, z_pivot=1.0, method=method)
    oms, s8s = cosmologies(idx)
    batch = broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(oms),
                            omega_l0=jnp.asarray(1.0 - oms),
                            sigma_8=jnp.asarray(s8s))
    out = jax.jit(jax.vmap(fn))(batch)
    return {k: np.asarray(out[k], dtype=np.float64)
            for k in ("w_theta", "gamma_t", "theta_deg")}


def worst_bin(got, ref):
    return float(max(np.max(np.abs(got[k] / ref[k] - 1.0))
                     for k in ("w_theta", "gamma_t")))


#: The fiducial (omega_m0, sigma_8) of the gradient reference and of
#: chip_smoke.py's inference phase.
FIDUCIAL = (0.278, 0.811)


def jacobians(method, grid, batch):
    """{"value": (B, 2 n_theta), "jacobian": (B, 2 n_theta, 2)}: the
    route's data vector (w, then gamma_t) and its ``jax.jacfwd`` with
    respect to (omega_m0, sigma_8) at each cosmology of ``batch`` (a
    batched JAX CosmoParams), omega_l0 = 1 - omega_m0, float64."""
    import jax
    import jax.numpy as jnp

    from chomp_tpu import default_halo
    from chomp_tpu.hod import default_hod
    from chomp_tpu.parallel.sweep import make_pipeline
    from tests import torch_parity as tp

    fn = make_pipeline(default_halo(), default_hod(), tp.jax_dist(),
                       power_spec="power_gg", grid=grid, include_lensing=True,
                       z_pivot=1.0, method=method)

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
        full[method] = jacobians(method, DEFAULT_GRID, batch)
        tiny[method] = jacobians(method, tp.GRID, tp.jax_batch())

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


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
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
    write_grad_reference()


if __name__ == "__main__":
    main()

"""Write the JAX float64 reference values of the port's slice.

Runs the JAX package on the CPU in float64: bench.py configuration A
(``make_pipeline(default_halo(), default_hod(), DNdzGaussian(0, 2, 1,
0.2), power_spec="power_gg", include_lensing=True, z_pivot=1.0)`` on
DEFAULT_GRID) for 3 cosmologies taken from bench.py's 512-point
linspaces (omega_m 0.24..0.32 with omega_l = 1 - omega_m, sigma_8
0.75..0.88), and writes w(theta) and gamma_t to
``tests/data/torch_slice_reference.json``.  ``chip_smoke.py`` holds the
port's float32 run on the GPU against these numbers.

    python tools/torch_slice_reference.py
"""

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_slice_reference.json"
N_COSMO = 512
INDICES = (0, 255, 511)


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from chomp_tpu import default_cosmo, default_halo, projection
    from chomp_tpu.hod import default_hod
    from chomp_tpu.params import DEFAULT_GRID
    from chomp_tpu.parallel.sweep import broadcast_cosmo, make_pipeline

    dist = projection.DNdzGaussian(
        z_min=jnp.asarray(0.0), z_max=jnp.asarray(2.0),
        z0=jnp.asarray(1.0), sigma_z=jnp.asarray(0.2))
    fn = make_pipeline(default_halo(), default_hod(), dist,
                       power_spec="power_gg", grid=DEFAULT_GRID,
                       include_lensing=True, z_pivot=1.0)
    oms = np.linspace(0.24, 0.32, N_COSMO)[list(INDICES)]
    s8s = np.linspace(0.75, 0.88, N_COSMO)[list(INDICES)]
    batch = broadcast_cosmo(default_cosmo(), omega_m0=jnp.asarray(oms),
                            omega_l0=jnp.asarray(1.0 - oms),
                            sigma_8=jnp.asarray(s8s))
    out = jax.jit(jax.vmap(fn))(batch)
    data = {
        "config": "bench.py configuration A, DEFAULT_GRID, JAX float64 CPU",
        "n_cosmo": N_COSMO,
        "indices": list(INDICES),
        "omega_m0": oms.tolist(),
        "sigma_8": s8s.tolist(),
        "theta_deg": np.asarray(out["theta_deg"][0]).tolist(),
        "w_theta": np.asarray(out["w_theta"]).tolist(),
        "gamma_t": np.asarray(out["gamma_t"]).tolist(),
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

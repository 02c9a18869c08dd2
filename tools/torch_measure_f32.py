"""Measure the port's float32 serving path against float64: the
counterpart of the JAX package's ``tools/measure_f32.py``.

    python tools/torch_measure_f32.py             # 5-cosmology omega_m spread
    python tools/torch_measure_f32.py --corners   # the prior corners
    python tools/torch_measure_f32.py --curved    # geometry="curved",
                                                  # theta 0.2-5 deg x 8

The pipeline is the JAX tool's, ``make_pipeline(default_halo(),
default_hod(), DNdzGaussian(0, 2, 1, 0.2), z_pivot=0.0)`` on
DEFAULT_GRID (the curved one at chip_smoke.py phase 24's theta: the JAX
tool's 0.02 deg needs curved operators at the 2^18 lmax cap).  On a CUDA
card the float32 kernels run against the float64 kernels on the card;
without one the float32 and float64 plain versions run on the CPU.  With
``--corners`` the float64 outputs are also held to the JAX package's
float64 values committed in tests/data/torch_families_reference.json
("chip_corners", from tools/torch_slice_reference.py).  Prints the
worst and median |x32/x64 - 1| per observable as JSON.
"""

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(REPO))
    import torch

    from chomp_tpu_torch import (DNdzGaussian, default_cosmo, default_halo,
                                 default_hod)
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo, make_pipeline
    from chomp_tpu_torch.utils.corners import corner_batch

    corners, curved = "--corners" in sys.argv, "--curved" in sys.argv
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    grid = (DEFAULT_GRID.replace(n_theta=8, theta_min_deg=0.2,
                                 theta_max_deg=5.0) if curved
            else DEFAULT_GRID)

    def run(dtype):
        kw = dict(device=dev, dtype=dtype)
        dist = DNdzGaussian(*(torch.tensor(v, **kw)
                              for v in (0.0, 2.0, 1.0, 0.2)))
        pipe = make_pipeline(default_halo(**kw), default_hod(**kw), dist,
                             grid=grid, geometry="curved" if curved
                             else "flat", **kw)
        if corners:
            batch = corner_batch(default_cosmo(**kw))
        else:
            oms = np.array([0.24, 0.26, 0.278, 0.30, 0.32])
            batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms,
                                    omega_l0=1.0 - oms)
        with torch.no_grad():
            out = pipe(batch)
        return {k: out[k].double().cpu().numpy()
                for k in ("w_theta", "gamma_t")}

    a, b = run(torch.float32), run(torch.float64)
    report = {"device": (torch.cuda.get_device_name(0) if dev == "cuda"
                         else "cpu")}
    for key, name in (("w_theta", "w"), ("gamma_t", "gt")):
        rel = np.abs(a[key] / b[key] - 1.0)
        report[name] = {"worst_bin": float(rel.max()),
                        "median": float(np.median(rel))}
    if corners:
        ref = json.loads((REPO / "tests" / "data"
                          / "torch_families_reference.json").read_text())
        block = ref["chip_corners"]["curved" if curved else "flat"]
        report["float64_vs_jax_worst_bin"] = float(max(
            np.abs(b[k] / np.asarray(block[k]) - 1.0).max()
            for k in ("w_theta", "gamma_t")))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()

"""Diagnostics of the covariance stack's agreement with the JAX package and
of its busy-share measurement.

    python tools/torch_cov_diagnostics.py            # CPU: JAX + the port
    python3 tools/torch_cov_diagnostics.py --card    # the GPU: port only

On the CPU (float64; JAX on the CPU):

1. ``trispectrum.k13_kernel`` of both packages, the JAX one jitted, and
   the exact value (mpmath, 50 digits) from r = 1e-9 to 1e9: the bracket
   of the 1-loop P13 kernel cancels catastrophically far from r = 1, so
   the packages' values there are rounding noise that differs between
   them (the cause of the connected blocks' tolerances in
   tests/test_torch_covariance.py).
2. chip_smoke.py phase 28's 2 x 2 gate matrix built by the port on the
   CPU, raw and clipped (the port's ``psd_clip``, and a numpy ``eigh``
   rebuild of the whole matrix as the JAX package's clip does it),
   against the JAX float64 values of tests/data/torch_cov_reference.json
   (raw, and clipped by LAPACK's ``eigh``), and how far each clip moves
   the raw matrix: a rebuild of the whole matrix rounds its small blocks.

On the card (``--card``; builds the kernels): phase 27's joint matrix at
B = 64, phase 28's 5 x 4 matrix at B = 1 and an earlier cell, config A's
forward+backward of phase 9 (the lattice route at B = 512, float32),
each with its device time by ``chip_smoke.device_ms`` (torch.profiler
``key_averages``: kernels only) and by ``chip_smoke.busy_ms`` (the kineto
device-activity sum: kernels, copies, sets) and the seconds each
measurement takes.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _reference():
    return json.loads((REPO / "tests" / "data"
                       / "torch_cov_reference.json").read_text())


def k13_table():
    """Rows (r, port, JAX eager, JAX jit, exact)."""
    import jax
    import mpmath as mp
    import torch

    from chomp_tpu import trispectrum as jt
    from chomp_tpu_torch import trispectrum as pt

    r = np.geomspace(1e-9, 1e9, 36)
    port = pt.k13_kernel(torch.tensor(r)).numpy()
    eager = np.asarray(jt.k13_kernel(r))
    jitted = np.asarray(jax.jit(jt.k13_kernel)(r))
    mp.mp.dps = 50

    def exact(x):
        x = mp.mpf(x)
        br = (12 / x**2 - 158 + 100 * x**2 - 42 * x**4
              + 3 / x**3 * (x**2 - 1) ** 3 * (7 * x**2 + 2)
              * mp.log(abs((1 + x) / (1 - x))))
        return float(br / (504 * x**2))

    return [(x, p, e, j, exact(x))
            for x, p, e, j in zip(r, port, eager, jitted)]


def tomo_gate_on_cpu():
    """{figure: value} of phase 28's 2 x 2 matrix built on the CPU."""
    import torch

    import chip_smoke as cs
    from chomp_tpu_torch import (DNdzGaussian, covariance, default_cosmo,
                                 default_halo, default_hod, halo)
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import (Nuisance3x2pt,
                                                broadcast_cosmo)

    kw = dict(device="cpu", dtype=torch.float64)
    ref = _reference()
    nu_ref = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    tc, sv, rt = ref["tomo_cell"], ref["des_y3_survey"], ref["chip_tomo"]
    n_l, n_s = rt["bins"]
    edges = np.asarray(ref["des_theta_edges_deg"])

    def gauss(z0, sz, z_max):
        return DNdzGaussian(*(torch.tensor(float(v), **kw)
                              for v in (0.0, z_max, z0, sz)))

    lens = [gauss(z0, tc["lens_sigma_z"], tc["lens_z_max"])
            for z0 in tc["lens_z0"][:n_l]]
    src = [gauss(z0, sz, tc["src_z_max"]) for z0, sz in
           list(zip(tc["src_z0"], tc["src_sigma_z"]))[:n_s]]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + tc["log10_m_1p_offset"], **kw)
            for m in tc["log10_m_min"][:n_l]]
    om, n2d, sn = cs.survey_numbers(
        sv["area_deg2"], sv["lens_n_arcmin2"][:n_l],
        sv["src_n_eff_arcmin2"][:n_s], sv["src_sigma_e"][:n_s])
    per_bin = {"dz_lens": n_l, "alpha_lens": n_l, "dz_src": n_s, "m": n_s}
    nu = Nuisance3x2pt(**{
        k: torch.tensor(v[:per_bin[k]] if k in per_bin else v, **kw)
        for k, v in nu_ref.items()})
    oms = np.asarray(rt["omega_m0"])
    cosmo = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms,
                            omega_l0=1.0 - oms,
                            sigma_8=np.asarray(rt["sigma_8"]))
    st = Statics(DEFAULT_GRID, **kw)
    hp = default_halo(**kw)
    models = halo.build_halo_models(
        cosmo, hp, hods, torch.tensor([tc["z_pivot"]], **kw), st)
    with torch.no_grad():
        raw = covariance.tomographic_3x2pt_covariance(
            cosmo, hp, models, lens, src, edges, om, n2d.tolist(),
            sn.tolist(), include_nongaussian=True, include_ssc=True,
            nuisance=nu, include_magnification=True, st=st)
    nb = len(edges) - 1
    want, want_raw = np.asarray(rt["cov"]), np.asarray(rt["cov_raw"])
    r = raw.numpy()
    clip = covariance.psd_clip(raw).numpy()
    lam, v = np.linalg.eigh(0.5 * (r[0] + r[0].T))
    np_clip = ((v * np.maximum(lam, 0.0)[None, :]) @ v.T)[None]
    err = cs.cov_blocks_err
    return {"raw vs JAX raw": err(r, want_raw, nb),
            "port clip vs JAX clip": err(clip, want, nb),
            "numpy eigh rebuild vs JAX clip": err(np_clip, want, nb),
            "port clip move": err(clip, r, nb),
            "numpy eigh rebuild move": err(np_clip, r, nb),
            "JAX clip move": err(want, want_raw, nb),
            "least eigenvalue / peak": float(lam.min() / np.abs(r).max())}


def card():
    """Phase 27's and 28's builds, each device time two ways."""
    import torch

    import chip_smoke as cs
    from chomp_tpu_torch import (DNdzGaussian, covariance, default_cosmo,
                                 default_halo, default_hod, halo)
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.ops import build
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import (Nuisance3x2pt,
                                                broadcast_cosmo)

    if not torch.cuda.is_available():
        raise SystemExit("--card needs a CUDA GPU")
    build.build_all(["halo_contract", "df_contract", "hankel_matmul"])
    kw = dict(device=torch.device("cuda", 0), dtype=torch.float64)
    st = Statics(DEFAULT_GRID, **kw)
    ref = _reference()
    o_all = np.linspace(0.24, 0.32, 64)
    s_all = np.linspace(0.75, 0.88, 64)

    def batch(idx):
        return broadcast_cosmo(default_cosmo(**kw), omega_m0=o_all[idx],
                               omega_l0=1.0 - o_all[idx],
                               sigma_8=s_all[idx])

    def gauss(spec):
        return DNdzGaussian(*(torch.tensor(float(v), **kw) for v in spec))

    cell = ref["joint_cell"]
    om, n2d, sn = cs.survey_numbers(cell["area_deg2"],
                                    cell["lens_n_arcmin2"],
                                    cell["src_n_arcmin2"], cell["sigma_e"])
    lens, src = (gauss([d[k] for k in ("z_min", "z_max", "z0", "sigma_z")])
                 for d in (cell["lens"], cell["src"]))
    b64 = batch(np.arange(64))
    hp = default_halo(**kw)

    def joint():
        with torch.no_grad():
            m = halo.build_halo_model(b64, hp, default_hod(**kw),
                                      torch.tensor([cell["z_model"]], **kw),
                                      st)
            return covariance.joint_wtheta_gammat_covariance(
                b64, hp, m, lens, src, np.asarray(cell["edges_deg"]), om,
                float(n2d), float(sn), include_ssc=True, psd_guard="clip",
                st=st)

    tc, sv = ref["tomo_cell"], ref["des_y3_survey"]
    nu_ref = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    lens_t = [gauss((0.0, tc["lens_z_max"], z0, tc["lens_sigma_z"]))
              for z0 in tc["lens_z0"]]
    src_t = [gauss((0.0, tc["src_z_max"], z0, sz))
             for z0, sz in zip(tc["src_z0"], tc["src_sigma_z"])]
    hods = [default_hod(log10_m_min=m, log10_m_0=m,
                        log10_m_1p=m + tc["log10_m_1p_offset"], **kw)
            for m in tc["log10_m_min"]]
    om_t, n2d_t, sn_t = cs.survey_numbers(
        sv["area_deg2"], sv["lens_n_arcmin2"], sv["src_n_eff_arcmin2"],
        sv["src_sigma_e"])
    nu = Nuisance3x2pt(**{k: torch.tensor(v, **kw)
                          for k, v in nu_ref.items()})
    b1 = batch(np.array([0]))

    def tomo():
        with torch.no_grad():
            models = halo.build_halo_models(
                b1, hp, hods, torch.tensor([tc["z_pivot"]], **kw), st)
            return covariance.tomographic_3x2pt_covariance(
                b1, hp, models, lens_t, src_t,
                np.asarray(ref["des_theta_edges_deg"]), om_t,
                n2d_t.tolist(), sn_t.tolist(), include_nongaussian=True,
                include_ssc=True, psd_guard="clip", nuisance=nu,
                include_magnification=True, st=st)

    from chomp_tpu_torch import make_pipeline

    f32 = torch.float32
    batch_a, hp_a, hod_a, dist_a = cs.setup(f32)
    pipe_a = make_pipeline(hp_a, hod_a, dist_a, power_spec="power_gg",
                           grid=DEFAULT_GRID, include_lensing=True,
                           z_pivot=1.0, device=kw["device"], dtype=f32)
    weights = cs.seeded((cs.N_COSMO, 2 * DEFAULT_GRID.n_theta), 22, f32)
    o_a = np.linspace(0.24, 0.32, cs.N_COSMO)
    s_a = np.linspace(0.75, 0.88, cs.N_COSMO)

    def config_a():
        """chip_smoke.py phase 9's grad_run on the lattice route."""
        om = torch.tensor(o_a, dtype=f32, device=kw["device"],
                          requires_grad=True)
        s8 = torch.tensor(s_a, dtype=f32, device=kw["device"],
                          requires_grad=True)
        out = pipe_a(broadcast_cosmo(
            default_cosmo(device=kw["device"], dtype=f32), omega_m0=om,
            omega_l0=1.0 - om, sigma_8=s8))
        vec = torch.cat([out["w_theta"], out["gamma_t"]], dim=-1)
        return torch.autograd.grad((vec * weights).sum(), (om, s8))

    print(cs.gpu_line(), flush=True)
    for label, fn in (("config A forward+backward, B=512", config_a),
                      ("joint covariance, B=64", joint),
                      ("tomographic covariance, B=1", tomo)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        by_averages = cs.device_ms(fn, reps=1)
        t1 = time.perf_counter()
        by_kineto = cs.busy_ms(fn)
        t2 = time.perf_counter()
        wall = cs.median_wall(fn, 3) * 1e3
        print(f"{label}: key_averages {cs.fmt_ms(by_averages)} in "
              f"{t1 - t0:.1f} s; kineto sum {cs.fmt_ms(by_kineto)} in "
              f"{t2 - t1:.1f} s; wall {wall:.1f} ms (median of 3)",
              flush=True)


def main():
    if "--card" in sys.argv[1:]:
        card()
        return
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print("k13_kernel: r, port, JAX eager, JAX jit, exact")
    for row in k13_table():
        print("  " + "  ".join(f"{v: .6e}" for v in row))
    for name, val in tomo_gate_on_cpu().items():
        print(f"phase 28's 2 x 2 matrix on the CPU: {name} {val:.3e}")


if __name__ == "__main__":
    main()

"""Where the time of the port's slice goes on one CUDA GPU.

    python3 tools/torch_slice_profile.py [--method fft|table|tomographic]
                                         [--n-cosmo 512] [--reps 5]

Runs bench.py configuration A (DEFAULT_GRID, float32) through
``chomp_tpu_torch`` on the lattice route (``--method fft``, the default)
or the GL + cubic-table route (``--method table``), or the tomographic
3x2pt cell of ``chip_smoke.py`` phases 13-14 (``--method tomographic``,
defined by tests/data/torch_tomo_reference.json), and prints, for the
same batch:

- the wall time of each stage of the forward, median over ``--reps``
  runs, each stage timed on the host clock between synchronizations:
  fft: halo model, the lattice spectra with kernel A, the lattice window
  weights, the grouped convolution, the two kernel C contractions;
  table: halo model, the ln P tables with kernel A, the galaxy-galaxy
  and the convergence-galaxy Limber C_ell, the two kernel B products;
  tomographic: the per-bin halo models with the spectra (kernel A over
  B x n_lens rows), the lattice weights and grouped convolution of the
  65 probe rows (``TomographicPipeline.conv_rows``), the three kernel C
  contractions;
- a ``torch.profiler`` table of device time by kernel over one run,
  and that device time as a share of the unprofiled median wall time
  (the device's busy share; the rest is idle, waiting on the host).

Needs a CUDA GPU; prints the card's name and power limit first.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", choices=("fft", "table", "tomographic"),
                    default="fft")
    ap.add_argument("--n-cosmo", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_slice_profile: needs a CUDA GPU")
    sys.path.insert(0, str(REPO))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chomp_tpu_torch import (DNdzGaussian, broadcast_cosmo,
                                 default_cosmo, default_halo, default_hod,
                                 halo, limber_fft, make_pipeline,
                                 projection)
    from chomp_tpu_torch.ops.hankel_matmul import hankel_matmul
    from chomp_tpu_torch.parallel.sweep import _fused_probe_rows

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    kw = dict(device=torch.device("cuda", 0), dtype=torch.float32)
    oms = np.linspace(0.24, 0.32, args.n_cosmo)
    batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms,
                            omega_l0=1.0 - oms,
                            sigma_8=np.linspace(0.75, 0.88, args.n_cosmo))
    dist = DNdzGaussian(*(torch.tensor(v, **kw)
                          for v in (0.0, 2.0, 1.0, 0.2)))
    args_fwd = (batch,)
    if args.method == "tomographic":
        from chip_smoke import tomo_cell

        pipe, nu = tomo_cell(json.loads(
            (REPO / "tests" / "data" / "torch_tomo_reference.json")
            .read_text()), **kw)
        args_fwd = (batch, nu)
    else:
        pipe = make_pipeline(default_halo(**kw), default_hod(**kw), dist,
                             power_spec="power_gg", include_lensing=True,
                             z_pivot=1.0, method=args.method, **kw)
    st, z = pipe.st, torch.ones(1, **kw)

    def stages():
        """The forward, cut at its layer boundaries."""
        t = {}

        def mark(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            return out

        if args.method == "tomographic":
            models = mark("halo models + spectra (kernel A)",
                          lambda: pipe.spectra(batch))[0]
            rows = pipe.probe_rows(batch, nu)[3]
            j_lo = min(w[0] for w in pipe.windows)
            j_hi = max(w[1] for w in pipe.windows)
            c = mark("lattice_g + conv (65 rows)", lambda: pipe.conv_rows(
                batch, models, rows, j_lo, j_hi))
            mark("kernel C x3", lambda: _fused_probe_rows(
                lambda _lo, _hi: c, [r[3] for r in rows], pipe.operator))
            return t
        if args.method == "table":
            model = mark("halo_model", lambda: halo.build_halo_model(
                batch, pipe.halo_params, pipe.hod, z, st))
            tabs = mark("ln P tables (kernel A)",
                        lambda: projection.power_tables_halo(
                            batch, pipe.halo_params, model,
                            ("power_gg", "power_gm"), st))
            cls = [mark(f"limber_cl {name}", lambda: projection.limber_cl(
                batch, wa, pipe.win_g, pipe.ells, tabs[kind], st))
                for name, wa, kind in (("gg", pipe.win_g, "power_gg"),
                                       ("kappa-g", pipe.win_k, "power_gm"))]
            mark("kernel B x2", lambda: [hankel_matmul(cl, op) for cl, op
                                         in zip(cls, (pipe.op0_t,
                                                      pipe.op1_t))])
            return t
        model = mark("halo_model", lambda: halo.build_halo_model(
            batch, pipe.halo_params, pipe.hod, z, st))
        p_all = mark("spectra (kernel A)", lambda: limber_fft
                     .p_lattice_halo_all(batch, pipe.halo_params, model, st))
        pairs = [(pipe.win_g, pipe.win_g), (pipe.win_k, pipe.win_g)]
        p_rows = torch.stack([p_all["power_gg"], p_all["power_gm"]], dim=1)

        def conv(j_lo, j_hi):
            return limber_fft._conv_direct_rows(
                p_rows, limber_fft._lattice_g_rows(batch, pairs, st,
                                                   model.mass.growth),
                j_lo, j_hi)

        mark("lattice_g+conv+kernel C", lambda: _fused_probe_rows(
            conv, [[0], [1]], pipe.operator))
        g = mark("lattice_g", lambda: limber_fft._lattice_g_rows(
            batch, pairs, st, model.mass.growth))
        j_lo, j_hi = pipe.windows[0]
        mark("conv", lambda: limber_fft._conv_direct_rows(p_rows, g, j_lo,
                                                          j_hi))
        return t

    pipe(*args_fwd)
    runs = [stages() for _ in range(args.reps)]
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(*args_fwd)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"{args.method} route forward wall, B={args.n_cosmo}: median {np.median(walls):.2f} ms"
          f" (quartiles {np.percentile(walls, 25):.2f}, "
          f"{np.percentile(walls, 75):.2f}; {args.reps} runs)")
    for name in runs[0]:
        vals = [r[name] for r in runs]
        print(f"  stage {name:28s} median {np.median(vals):9.3f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(*args_fwd)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Kernels only: the aten ops that launched them carry the same time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled run: wall {wall:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms = {100 * busy / np.median(walls):.1f}% of the "
          f"unprofiled median wall; {len(events)} kernel kinds")
    for e in events[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()

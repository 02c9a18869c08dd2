"""Where the time and the memory of the port's forward+backward go on one
CUDA GPU.

    python3 tools/torch_grad_profile.py [--n-cosmo 512] [--reps 5]

For bench.py configuration A (DEFAULT_GRID, float32) on both routes
(``method="fft"`` and ``method="table"``) and the same batch, prints:

- the forward wall and the forward+backward wall (one
  ``torch.autograd.grad`` of the summed (w, gamma_t) with respect to
  (omega_m0, sigma_8)), medians over ``--reps`` runs on the host clock
  between synchronizations;
- the peak device memory of one forward+backward as the port runs it
  (the quadratures recompute their integrands in the backward,
  ``grids.recompute_in_backward``) and with every intermediate kept
  (``recompute_in_backward`` bypassed), or the out-of-memory error;
- a ``torch.profiler`` table of device time by kernel over one
  forward+backward, and that device time as a share of its wall (the
  device's busy share).

Needs a CUDA GPU; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-cosmo", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_grad_profile: needs a CUDA GPU")
    sys.path.insert(0, str(REPO))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chomp_tpu_torch import (DNdzGaussian, broadcast_cosmo, default_cosmo,
                                 default_halo, default_hod, grids,
                                 make_pipeline)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kw = dict(device=torch.device("cuda", 0), dtype=torch.float32)
    dist = DNdzGaussian(*(torch.tensor(v, **kw) for v in (0.0, 2.0, 1.0,
                                                          0.2)))
    oms = np.linspace(0.24, 0.32, args.n_cosmo)
    s8s = np.linspace(0.75, 0.88, args.n_cosmo)
    batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms,
                            omega_l0=1.0 - oms, sigma_8=s8s)

    def fwd_bwd(pipe):
        om = torch.tensor(oms, **kw, requires_grad=True)
        s8 = torch.tensor(s8s, **kw, requires_grad=True)
        out = pipe(broadcast_cosmo(default_cosmo(**kw), omega_m0=om,
                                   omega_l0=1.0 - om, sigma_8=s8))
        return torch.autograd.grad(out["w_theta"].sum()
                                   + out["gamma_t"].sum(), (om, s8))

    def wall(fn):
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as err:
            return f"out of memory ({str(err).splitlines()[0]})"
        return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"

    for method in ("fft", "table"):
        pipe = make_pipeline(default_halo(**kw), default_hod(**kw), dist,
                             power_spec="power_gg", include_lensing=True,
                             z_pivot=1.0, method=method, **kw)
        fwd_bwd(pipe)                                   # warm-up
        with torch.no_grad():
            ms_fwd = wall(lambda: pipe(batch))
        ms_fb = wall(lambda: fwd_bwd(pipe))
        mem = peak_gb(lambda: fwd_bwd(pipe))
        saved = grids.recompute_in_backward
        grids_fns = [m for m in sys.modules.values()
                     if getattr(m, "recompute_in_backward", None) is saved]
        for m in grids_fns:
            m.recompute_in_backward = lambda fn, *a, track=(): fn(*a)
        try:
            mem_kept = peak_gb(lambda: fwd_bwd(pipe))
        finally:
            for m in grids_fns:
                m.recompute_in_backward = saved
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd_bwd(pipe)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        print(f"[{method}] B={args.n_cosmo} float32 | forward wall "
              f"{ms_fwd:.1f} ms, forward+backward {ms_fb:.1f} ms (medians "
              f"of {args.reps}) | peak device memory of forward+backward "
              f"{mem} with the quadratures recomputed in the backward, "
              f"{mem_kept} with every intermediate kept | device busy "
              f"{busy:.1f} ms over {len(events)} kernel kinds in one "
              f"profiled forward+backward ({busy / ms_fb:.1%} of the "
              f"unprofiled wall)", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"{e.count:6d} x  {e.key[:110]}", flush=True)


if __name__ == "__main__":
    main()

"""How often a torch.profiler session on the GPU records no kernel.

    python3 tools/torch_profiler_probe.py [--sessions N]

chip_smoke.py takes each kernel's device time from one profiler session
that records CUDA activity only, over 5-20 back-to-back calls.  This
probe runs such sessions on a short matrix product (a few microseconds a
call, like kernel C's smallest rows) after a long session (a 4096^3
product, milliseconds a call), as the script does, and counts the
sessions whose ``key_averages()`` hold no device time:

- ``plain``: the session as chip_smoke.device_ms opens it;
- ``padded``: the same, with ``pad`` ms of idle host time inside the
  window before the first launch and after the last synchronisation;
- ``cpu``: CPU and CUDA activity both recorded.

Prints one JSON line: sessions, empty sessions and the recorded
milliseconds per call of each variant, and the card's name and power
limit.
"""

import json
import subprocess
import sys
import time


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_probe: needs a CUDA GPU")
    n = int(sys.argv[sys.argv.index("--sessions") + 1]
            if "--sessions" in sys.argv else 100)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    small = (torch.randn(512, 2220, device=dev, dtype=torch.float64,
                         generator=g),
             torch.randn(2220, 8, device=dev, dtype=torch.float64,
                         generator=g))
    large = (torch.randn(4096, 4096, device=dev, generator=g),) * 2

    def session(fn, reps, activities, pad=0.0):
        fn()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / reps / 1e3

    cuda_only = [ProfilerActivity.CUDA]
    variants = {"plain": (cuda_only, 0.0), "padded": (cuda_only, 0.02),
                "cpu": ([ProfilerActivity.CPU, ProfilerActivity.CUDA], 0.0)}
    out = {}
    t0 = time.perf_counter()
    for name, (acts, pad) in variants.items():
        ms, long_empty = [], 0
        for _ in range(n):
            long_empty += session(lambda: large[0] @ large[1], 5, acts,
                                  pad) == 0.0
            ms.append(session(lambda: small[0] @ small[1], 20, acts, pad))
        rec = [m for m in ms if m > 0.0]
        out[name] = {"sessions": n, "empty": n - len(rec),
                     "long_sessions_empty": long_empty,
                     "ms_median": (sorted(rec)[len(rec) // 2] if rec
                                   else None),
                     "seconds": time.perf_counter() - t0}
        print(f"[probe] {name}: {out[name]}", flush=True)
        t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "variants": out}))


if __name__ == "__main__":
    main()

"""Kernel A's design moves, one at a time, on one CUDA GPU.

    python3 tools/halo_contract_ablation.py [--parent OLD.cu] [--rounds 4]

Builds ``chomp_tpu_torch/csrc/halo_contract.cu`` as it is and in copies
with one design move taken out (or, for ``hybrid``, one added), edited
from the source text, into ``build/ablation/``:

- ``no_small_route``: b = (1+c)x <= 4 takes the Si/Ci power series at b
  (f - 1/x and g from one series, log and sincos) instead of the moment
  series;
- ``no_shared_profiles``: every galaxy node evaluates its matter and its
  galaxy profile, even where the two coincide;
- ``library_sincos``: sin, cos of c x from the library ``sincosf`` (its
  Payne-Hanek slow path above |cx| = 105615) instead of the reduction in
  double;
- ``hybrid``: the library ``sincosf`` below |cx| = 105615, the
  reduction in double above;
- ``parent``: the file given with ``--parent`` (an earlier kernel A with
  the same C interface), if any.

Each variant runs on the main path's kernel-A inputs (bench.py
configuration A at DEFAULT_GRID, 512 cosmologies, float32): the lattice
k with the main node set and with the feedback hooks on (bary_c = 1.2,
bary_eta = 0.1), and the table route's 4096 k with the main node set.
Prints each variant's float32 error against the plain version in float64
on the same inputs (relative to each output's peak) and its time: CUDA
events around 5 back-to-back launches, over 5, in ``--rounds`` rounds
that alternate the variants' order; mean (min-max).  Needs a CUDA GPU;
prints the card's name and power limit first.
"""

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# (anchor in the source, replacement) per variant.
_SMALL_AT_B = '''
template <typename T>
__device__ __forceinline__ void aux_fg_small(T b, T& fm, T& g) {
  using L = Lens<T>;
  const T t = b * b;
  T si = T(0), ci = T(0);
#pragma unroll
  for (int k = L::series - 1; k >= 0; --k) {
    si = fma(si, t, tab<T>(OFF_SI + k));
    if (k >= 1) ci = fma(ci, t, tab<T>(OFF_CI + k));
  }
  si = si * b;
  ci = fma(ci, t, T(EULER_GAMMA)) + log_(b);
  T s, c;
  sincos_(b, &s, &c);
  fm = ((T(HALF_PI) - si) * c + ci * s) - rcp_(b);
  g = (T(HALF_PI) - si) * s - ci * c;
}

// A staged profile'''
EDITS = {
    "no_small_route": [
        ("\n// A staged profile", _SMALL_AT_B),
        ("  if (b <= T(SMALL_B)) {", "  if (false) {"),
        ("  aux_fg_large(b, u, fm, g);\n",
         "  if (b <= T(SMALL_B)) aux_fg_small(b, fm, g);\n"
         "  else aux_fg_large(b, u, fm, g);\n")],
    "no_shared_profiles": [
        ("const bool same = q[0] == q[2] && q[1] == q[3];",
         "const bool same = false;")],
    "library_sincos": [
        ("sincos_big(p.c * x, &s, &co);", "sincos_(p.c * x, &s, &co);")],
    "hybrid": [
        ("void sincos_big(float a, float* s, float* c) {\n",
         "void sincos_big(float a, float* s, float* c) {\n"
         "  if (fabsf(a) <= 105615.0f) {\n    sincosf(a, s, c);\n"
         "    return;\n  }\n")],
}


def variant_sources(parent):
    """{name: path} of the sources to build, edited copies written into
    build/ablation/."""
    src = REPO / "chomp_tpu_torch" / "csrc" / "halo_contract.cu"
    out = REPO / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    paths = {"kernel": src}
    for name, edits in EDITS.items():
        t = text
        for anchor, repl in edits:
            if t.count(anchor) != 1:
                raise SystemExit(f"ablation {name}: anchor not found once in "
                                 f"{src.name}: {anchor!r}")
            t = t.replace(anchor, repl)
        paths[name] = out / f"{name}.cu"
        paths[name].write_text(t)
    if parent:
        paths["parent"] = Path(parent).resolve()
    return paths


def build(paths):
    """One nvcc per source, all started together; {name: ctypes lib}."""
    from chomp_tpu_torch.ops.build import ARCH, nvcc

    procs = {}
    for name, src in paths.items():
        so = REPO / "build" / "ablation" / f"lib{name}.so"
        procs[name] = so, subprocess.Popen(
            [nvcc(), *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        regs = [ln.split(":")[-1].strip() for ln in err.splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {' ; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.halo_contract_launch.restype = ctypes.c_int
        lib.halo_contract_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.halo_contract_error.restype = ctypes.c_char_p
        lib.halo_contract_error.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier halo_contract.cu to time "
                    "beside the variants")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("halo_contract_ablation: needs a CUDA GPU")
    sys.path.insert(0, str(REPO))
    from chomp_tpu_torch import default_cosmo, default_halo, default_hod, halo
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.ops import halo_contract as hc
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(variant_sources(args.parent))
    kw = dict(device=torch.device("cuda", 0), dtype=torch.float32)
    oms = np.linspace(0.24, 0.32, 512)
    hooks = dict(bary_c=np.full(512, 1.2), bary_eta=np.full(512, 0.1))
    st = Statics(DEFAULT_GRID, **kw)

    def nodes(**extra):
        batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms,
                                omega_l0=1.0 - oms,
                                sigma_8=np.linspace(0.75, 0.88, 512), **extra)
        model = halo.build_halo_model(batch, default_halo(**kw),
                                      default_hod(**kw), torch.ones(1, **kw),
                                      st)
        return halo.contraction_nodes(batch, default_halo(**kw), model)

    main_nodes, fb_nodes = nodes(), nodes(**hooks)
    sets = {"lattice k, main nodes": (st.lattice_k, *main_nodes),
            "lattice k, feedback on": (st.lattice_k, *fb_nodes),
            "table k, main nodes": (st.k_table, *main_nodes)}

    def use(name):
        hc._lib = lambda: libs[name]

    def rel(got, ref):
        d = (got.double() - ref).abs().amax(dim=(0, 2))
        return float((d / ref.abs().amax(dim=(0, 2))).max())

    for sname, (k, mat, gal) in list(sets.items())[:2]:
        exact = hc.halo_contract_ref(k.double(), mat.double(), gal.double())
        errs = []
        for name in libs:
            use(name)
            got = hc.halo_contract(k, mat, gal, st.cheb)
            errs.append(f"{name} {rel(got, exact):.3e}")
        print(f"[error] {sname}: f32 vs plain version in f64, rel_to_peak: "
              + " | ".join(errs), flush=True)

    def events_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    times = {(n, s): [] for n in libs for s in sets}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            use(name)
            for sname, (k, mat, gal) in sets.items():
                times[(name, sname)].append(events_ms(
                    lambda: hc.halo_contract(k, mat, gal, st.cheb)))
    for sname in sets:
        print(f"[time ms] {sname}: " + " | ".join(
            f"{n} {np.mean(times[(n, sname)]):.3f} ("
            f"{min(times[(n, sname)]):.3f}-{max(times[(n, sname)]):.3f})"
            for n in libs), flush=True)
    print(f"[time] {time.perf_counter() - t0:.1f} s for {args.rounds} rounds",
          flush=True)


if __name__ == "__main__":
    main()

"""Kernel A's and A''s design moves, one at a time, on one CUDA GPU.

    python3 tools/halo_contract_ablation.py [--backward] [--parent OLD.cu]
                                            [--rounds 4]

Builds ``chomp_tpu_torch/csrc/halo_contract.cu`` as it is and in copies
with one design move taken out (or, where the name says so, one added),
edited from the source text, into ``build/ablation/``.  Forward (kernel
A, the default):

- ``no_small_route``: b = (1+c)x <= 4 takes the Si/Ci power series at b
  (f - 1/x and g from one series, log and sincos) instead of the moment
  series;
- ``no_shared_profiles``: every galaxy node evaluates its matter and its
  galaxy profile, even where the two coincide;
- ``library_sincos``: sin, cos of c x from the library ``sincosf`` (its
  Payne-Hanek slow path above |cx| = 105615) instead of the reduction in
  double;
- ``hybrid``: the library ``sincosf`` below |cx| = 105615, the
  reduction in double above.

Backward (kernel A', ``--backward``):

- ``bwd_double_accumulation`` (move 2 out): the cotangent staged as
  double and every (k, node) product formed in double from values
  converted once each, as a float64 contraction type W;
- ``bwd_two_sum`` (added): the float runs summed with a compensated
  two-sum per field instead of plain float sums;
- ``bwd_no_shared_profiles``: every gal node evaluates both profiles;
- ``bwd_small_route_sincos`` (move 3 out): dN/dc on the moment route from
  ``sincosf`` and a reciprocal, as before the series;
- ``bwd_min_blocks_3`` (added): ``__launch_bounds__`` also asks for 3
  resident blocks of 256 threads in float (at most 80 registers);
- ``bwd_no_spill`` (added): ``__launch_bounds__`` asks for 2 resident
  blocks (at most 128 registers: no spill, two blocks an SM).

The layout (move 1) carries the others (the staged unit, the butterfly),
so its ablation is ``parent``: the file given with ``--parent`` (an
earlier kernel, with this C interface or the one before the k row stride
and grad_k arguments), if any.

Inputs are the main path's (bench.py configuration A at DEFAULT_GRID, 512
cosmologies, float32): the lattice k with the main node set and with the
feedback hooks on (bary_c = 1.2, bary_eta = 0.1), and the table route's
4096 k with the main node set; the backward runs under the seeded normal
cotangent of chip_smoke.py's phase 8 (seed 13).  Prints each variant's
float32 error against the plain version (forward) or plain backward in
float64 on the same inputs, relative to each output's or gradient field's
peak (the backward beside the plain float32 backward's own error, and the
gates of phase 8: 2e-5 and 1.5x that), and its time: CUDA events around
5 back-to-back launches, over 5, in ``--rounds`` rounds that alternate the
variants' order; mean (min-max).  With ``--parent``, first checks that
kernel A's outputs of the current build equal the parent's bit for bit
(float32 on the three sets, float64 on 8 cosmologies), and with
``--backward`` A''s as well.  Needs a CUDA GPU; prints the card's name and
power limit first.
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
_RUN = '''template <typename W>
struct Run {
  W s = W(0);
  __device__ __forceinline__ void add(W a, W b) { s = fma(a, b, s); }
  __device__ __forceinline__ double take() {
    const double v = (double)s;
    s = W(0);
    return v;
  }
};
'''
_RUN_TWO_SUM = '''__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
template <typename W>
struct Run {
  W s = W(0), c = W(0);
  __device__ __forceinline__ void add(W a, W b) {
    const W p = mul_rn(a, b);
    const W pe = fma(a, b, -p);
    const W t = add_rn(s, p);
    const W bp = add_rn(t, -s);
    const W err = add_rn(add_rn(s, -add_rn(t, -bp)), add_rn(p, -bp));
    c = add_rn(c, add_rn(err, pe));
    s = t;
  }
  __device__ __forceinline__ double take() {
    const double v = (double)s + (double)c;
    s = W(0);
    c = W(0);
    return v;
  }
};
'''
EDITS = {
    "no_small_route": [
        ("\n// A staged profile", _SMALL_AT_B),
        ("  if (b <= T(SMALL_B)) {\n    const T x2 = x * x;\n"
         "    T n = p.a[Lens<T>::moments - 1];",
         "  if (false) {\n    const T x2 = x * x;\n"
         "    T n = p.a[Lens<T>::moments - 1];"),
        ("  aux_fg_large(b, u, fm, g);\n  return aux_g(x, p.c1 * u)",
         "  if (b <= T(SMALL_B)) aux_fg_small(b, fm, g);\n"
         "  else aux_fg_large(b, u, fm, g);\n  return aux_g(x, p.c1 * u)")],
    "no_shared_profiles": [
        ("const bool same = q[0] == q[2] && q[1] == q[3];",
         "const bool same = false;")],
    "library_sincos": [
        ("  T s, co, fm, g;\n  sincos_big(p.c * x, &s, &co);",
         "  T s, co, fm, g;\n  sincos_(p.c * x, &s, &co);")],
    "hybrid": [
        ("void sincos_big(float a, float* s, float* c) {\n",
         "void sincos_big(float a, float* s, float* c) {\n"
         "  if (fabsf(a) <= 105615.0f) {\n    sincosf(a, s, c);\n"
         "    return;\n  }\n")],
}
BWD_EDITS = {
    "bwd_double_accumulation": [
        ("template <> struct BwdShape<float> {\n  using W = float;",
         "template <> struct BwdShape<float> {\n  using W = double;")],
    "bwd_two_sum": [(_RUN, _RUN_TWO_SUM)],
    "bwd_no_shared_profiles": [
        ("    s_same[j] = q[0] == q[2] && q[1] == q[3];",
         "    s_same[j] = false;")],
    "bwd_small_route_sincos": [
        ("    dc = e;\n",
         "    T s_, c_;\n    sincos_(p.c * x, &s_, &c_);\n"
         "    dc = s_ * rcp_(b) * p.inv_c1;\n")],
    "bwd_min_blocks_3": [
        ("__global__ void __launch_bounds__(BWD_BLOCK)\n",
         "__global__ void __launch_bounds__(BWD_BLOCK, sizeof(T) == 4 ? 3 : 1)"
         "\n")],
    "bwd_no_spill": [
        ("__global__ void __launch_bounds__(BWD_BLOCK)\n",
         "__global__ void __launch_bounds__(BWD_BLOCK, 2)\n")],
}


def variant_sources(edits, parent):
    """{name: path} of the sources to build, edited copies written into
    build/ablation/."""
    src = REPO / "chomp_tpu_torch" / "csrc" / "halo_contract.cu"
    out = REPO / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    paths = {"kernel": src}
    for name, pairs in edits.items():
        t = text
        for anchor, repl in pairs:
            if t.count(anchor) != 1:
                raise SystemExit(f"ablation {name}: anchor not found once in "
                                 f"{src.name}: {anchor!r}")
            t = t.replace(anchor, repl)
        paths[name] = out / f"{name}.cu"
        paths[name].write_text(t)
    if parent:
        paths["parent"] = Path(parent).resolve()
    return paths


_TABLE_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p]


class _BeforeRowStride:
    """A library of the C interface before the k row stride and the grad_k
    arguments, called through the current one (shared k only)."""

    def __init__(self, lib):
        self.lib = lib
        lib.halo_contract_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + _TABLE_ARGS)
        lib.halo_contract_bwd_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
            + _TABLE_ARGS)
        self.halo_contract_error = lib.halo_contract_error

    def halo_contract_launch(self, dev, is_double, k, k_stride, nk, *rest):
        assert k_stride == 0, "the parent takes a shared k only"
        return self.lib.halo_contract_launch(dev, is_double, k, nk, *rest)

    def halo_contract_bwd_launch(self, dev, is_double, k, k_stride, nk, mat,
                                 nm, gal, ng, grad, gmat, ggal, gk_part, gk,
                                 *rest):
        assert k_stride == 0 and gk is None, "the parent has no grad_k"
        return self.lib.halo_contract_bwd_launch(
            dev, is_double, k, nk, mat, nm, gal, ng, grad, gmat, ggal, *rest)


def build(paths):
    """One nvcc per source, all started together; {name: ctypes lib}."""
    from chomp_tpu_torch.ops.halo_contract import _lib_argtypes
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
        lib = _lib_argtypes(ctypes.CDLL(str(so)))
        libs[name] = (lib if "int k_stride" in paths[name].read_text()
                      else _BeforeRowStride(lib))
    return libs


def events_ms(fn, reps=5):
    import torch

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier halo_contract.cu to time "
                    "beside the variants")
    ap.add_argument("--backward", action="store_true",
                    help="kernel A''s variants instead of kernel A's")
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
    libs = build(variant_sources(BWD_EDITS if args.backward else EDITS,
                                 args.parent))
    dev = torch.device("cuda", 0)
    oms = np.linspace(0.24, 0.32, 512)
    s8s = np.linspace(0.75, 0.88, 512)
    hooks = dict(bary_c=np.full(512, 1.2), bary_eta=np.full(512, 0.1))
    check = np.unique(np.linspace(0, 511, 8).round()).astype(int)

    def nodes(dtype, idx=slice(None), **extra):
        kw = dict(device=dev, dtype=dtype)
        st = Statics(DEFAULT_GRID, **kw)
        batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=oms[idx],
                                omega_l0=1.0 - oms[idx], sigma_8=s8s[idx],
                                **{n: v[idx] for n, v in extra.items()})
        model = halo.build_halo_model(batch, default_halo(**kw),
                                      default_hod(**kw), torch.ones(1, **kw),
                                      st)
        return (st, *halo.contraction_nodes(batch, default_halo(**kw), model))

    st, *main_nodes = nodes(torch.float32)
    _, *fb_nodes = nodes(torch.float32, **hooks)
    sets = {"lattice k, main nodes": (st.lattice_k, *main_nodes),
            "lattice k, feedback on": (st.lattice_k, *fb_nodes),
            "table k, main nodes": (st.k_table, *main_nodes)}

    def use(name):
        hc._lib = lambda: libs[name]

    if "parent" in libs:
        st64, mat64, gal64 = nodes(torch.float64, check)
        runs = [(f"f32 {n}", s, st.cheb) for n, s in sets.items()] + [
            ("f64 lattice k, main nodes, 8 cosmologies",
             (st64.lattice_k, mat64, gal64), st64.cheb)]
        same = []
        for sname, (k, mat, gal), cheb in runs:
            outs = []
            for name in ("kernel", "parent"):
                use(name)
                outs.append(hc.halo_contract(k, mat, gal, cheb))
            same.append(f"{sname} {torch.equal(*outs)}")
        print("[forward] kernel A of this build vs the parent, bit for bit: "
              + " | ".join(same), flush=True)
        if args.backward:
            same = []
            for sname, (k, mat, gal), cheb in runs:
                g = torch.tensor(np.random.default_rng(13).normal(
                    size=(mat.shape[0], hc.N_OUT, k.numel())),
                    dtype=k.dtype, device=dev)
                outs = []
                for name in ("kernel", "parent"):
                    use(name)
                    outs.append(hc.halo_contract_bwd(k, mat, gal, cheb, g))
                same.append(f"{sname} " + str(all(
                    torch.equal(a, b) for a, b in zip(*outs))))
            print("[backward] kernel A' of this build vs the parent, bit for "
                  "bit: " + " | ".join(same), flush=True)

    def rel(got, ref):
        d = (got.double() - ref).abs().amax(dim=(0, 2))
        return float((d / ref.abs().amax(dim=(0, 2))).max())

    def field_rel(got, ref):
        d = (got.double() - ref).abs().amax(dim=(0, 1))
        return float((d / ref.abs().amax(dim=(0, 1))).max())

    cot = {s: torch.tensor(np.random.default_rng(13).normal(
        size=(512, hc.N_OUT, k.numel())), dtype=torch.float32, device=dev)
        for s, (k, _, _) in sets.items()}
    if args.backward:
        for sname, (k, mat, gal) in sets.items():
            g = cot[sname]
            exact = hc.halo_contract_bwd_ref(k.double(), mat.double(),
                                             gal.double(), st.cheb.double(),
                                             g.double())
            plain = max(field_rel(a, r) for a, r in zip(
                hc.halo_contract_bwd_ref(k, mat, gal, st.cheb, g), exact))
            errs = []
            for name in libs:
                use(name)
                e = max(field_rel(a, r) for a, r in zip(
                    hc.halo_contract_bwd(k, mat, gal, st.cheb, g), exact))
                ok = e <= 2e-5 and e <= 1.5 * plain
                errs.append(f"{name} {e:.3e}{'' if ok else ' (FAILS)'}")
            print(f"[error] {sname}: f32 vs plain backward in f64, "
                  f"field_peak_rel (plain f32 backward {plain:.3e}; gates "
                  f"2e-5 and 1.5x it): " + " | ".join(errs), flush=True)

        def call(k, mat, gal, g):
            return lambda: hc.halo_contract_bwd(k, mat, gal, st.cheb, g)
    else:
        for sname, (k, mat, gal) in list(sets.items())[:2]:
            exact = hc.halo_contract_ref(k.double(), mat.double(),
                                         gal.double())
            errs = []
            for name in libs:
                use(name)
                got = hc.halo_contract(k, mat, gal, st.cheb)
                errs.append(f"{name} {rel(got, exact):.3e}")
            print(f"[error] {sname}: f32 vs plain version in f64, "
                  f"rel_to_peak: " + " | ".join(errs), flush=True)

        def call(k, mat, gal, g):
            return lambda: hc.halo_contract(k, mat, gal, st.cheb)

    times = {(n, s): [] for n in libs for s in sets}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            use(name)
            for sname, (k, mat, gal) in sets.items():
                times[(name, sname)].append(
                    events_ms(call(k, mat, gal, cot[sname])))
    what = "A'" if args.backward else "A"
    for sname in sets:
        print(f"[time ms] {what}, {sname}: " + " | ".join(
            f"{n} {np.mean(times[(n, sname)]):.3f} ("
            f"{min(times[(n, sname)]):.3f}-{max(times[(n, sname)]):.3f})"
            for n in libs), flush=True)
    print(f"[time] {time.perf_counter() - t0:.1f} s for {args.rounds} rounds",
          flush=True)


if __name__ == "__main__":
    main()

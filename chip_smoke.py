#!/usr/bin/env python3
"""Smoke test of chomp_tpu_torch on one CUDA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``chomp_tpu_torch/csrc`` and runs, in
order (any failure exits nonzero; nothing falls back):

1. device: requires CUDA; prints the card's name and power limit;
2. kernel A (halo_contract) against its plain PyTorch version on the
   node arrays of the main path's 512 cosmologies at DEFAULT_GRID, and
   on a second node set with the feedback hooks on (bary_c = 1.2,
   bary_eta = 0.1): float64 on 8 of them to 1e-12; float32 on all to
   2e-6 against the plain version evaluated in float64 on the same
   float32 inputs, and no worse than 1.5x the plain float32 version's
   own error against that reference (all relative to each output's
   peak); two launches bit for bit; the same gates on the ragged
   (NK, NM, NG) = (1000, 37, 5); the share of profile evaluations per
   route of the kernel on both routes' k grids; with its times;
3. kernel C (df_contract) against its plain version at (512, 2220) x
   (64, 2220): float64 to 1e-12; float32 (the main path's kernel) to
   1e-6 of peak against the plain version and 1e-7 of peak against the
   exact float64 contraction of the same float32 inputs (an
   uncompensated float32 sum misses it by ~100x); two launches on the
   same inputs bit for bit (float32 and float64); the same gates at the
   ragged (8, 2220) x (64, 2220) and on the hostile-cancellation case of
   tests/test_df32.py, (1, 1024) x (8, 1024), which must also stay
   < 5e-6 against float64; with its times and launch geometry;
4. the lattice convolution (float32 in and out, float64 accumulation)
   on the pipeline's own rows against float64 (1e-6), and its time;
5. the lattice slice: bench.py configuration A (``method="fft"``) on
   512 cosmologies in float32 through kernels A and C; launch counts, finiteness, worst-bin error
   < 1e-4 against the port's float64 plain path on the card (8
   cosmologies) and against the committed JAX float64 values
   (tests/data/torch_slice_reference.json); in float64 the card's
   kernels against its plain path (1e-12) and the plain path against
   the JAX values (1e-10); and the median wall time of 5 repetitions;
6. kernel B (hankel_matmul) on the table route's own C_ell rows of the
   512 cosmologies against its plain version (float64 to 1e-12 of each
   row's peak; float32 to 2e-5 per element) and, in float32, against
   the exact float64 product of the same inputs (no worse than 2x the
   float32 ``torch.matmul``); two launches bit for bit; the ragged
   (37, 1000) @ (1000, 13) and (1, 1024) @ (1024, 64), cut from the same
   rows and operator, at the same float64 and plain-version gates; with
   its times and launch geometry;
7. the table slice: the same configuration with ``method="table"`` on
   512 cosmologies in float32; one launch of kernel A and two of kernel
   B; finiteness; worst bin < 1e-4 against the card's float64 plain path
   and the committed JAX float64 values
   (tests/data/torch_table_reference.json); float64 kernels vs plain
   path (1e-12) and plain path vs JAX (1e-10); the float64 table route
   against phase 5's float64 lattice route (3e-5, or 2x the JAX
   package's own gap at DEFAULT_GRID where that is larger); peak device
   memory and the median wall time of 5 repetitions;
8. the backward kernels against their plain versions under seeded
   cotangents: A' (halo_contract_bwd) on phase 2's main, feedback and
   ragged node sets (float64 on 8 cosmologies to 1e-12 of each gradient
   field's peak; float32 within 2e-5 of the plain backward in float64 on
   the same float32 inputs and no worse than 1.5x the plain float32
   backward's own error), B' (hankel_matmul_bwd) at phase 6's shapes and
   C' (df_contract_bwd) at phase 3's (float64 to 1e-12 of each row's
   peak; float32 no worse than 2x the float32 torch.matmul against the
   exact product); two launches bit for bit; times, bounds, library
   times; A''s times on the feedback set and the table k, its launch
   geometry as the built library reports it (held to ops/tiles.py's
   mirror), ptxas' registers and spills, and the route mix per warp of
   its profile evaluations in a thread-per-node layout and in this one;
9. gradients of both slices at B = 512, float32: one
   ``torch.autograd.grad`` of a seeded linear functional of (w, gamma_t)
   with respect to (omega_m0, sigma_8), with every launch count, forward
   and backward, set to 0 just before and read just after (lattice A 1,
   C 2; table A 1, B 2; the same in the backward); finiteness, peak
   device memory, forward+backward against forward-only walls (medians
   of 3), the float64 grouped conv1d's forward+backward time; the
   Jacobians at the 3 reference cosmologies through
   ``inference.jacobian`` against the card's float64 plain path (float32
   < 1e-3 of each column's peak over theta; float64 kernels < 1e-10) and
   the JAX jacfwd of tests/data/torch_grad_reference.json (float64 plain
   < 1e-9, float32 < 1e-3);
10. inference on the lattice route: the float64 data vector at the
   fiducial with a diagonal covariance (5% + 1e-3 of the peak); the
   Fisher matrix in float32 against float64 (1e-3 of sqrt(F_ii F_jj));
   ``map_fit`` from 2 sigma off must end nearer the fiducial; ``hmc``
   over 512 chains (Fisher mass, 3 steps x 4 leapfrogs, eps 0.3) must
   stay finite with mean acceptance > 0.5;
11. exact-z: bench.py configuration B (``exact_z_anchors=6``, z_pivot 0)
   on its 64 cosmologies in float32: launch counts (A 1 over the B x J =
   384 anchor rows, C 2; the same in the backward), finiteness, worst bin
   < 1e-4 against the card's float64 plain path (8 cosmologies) and the
   committed JAX float64 values (tests/data/torch_exactz_reference.json),
   float64 kernels against the plain path (1e-12) and the plain path
   against JAX (1e-10); the J-channel convolution (float32 in, float64
   sums) against float64 on its own rows (1e-6); kernel A and A' on the
   anchors' node set at phase 2's and phase 8's gates, with their branch
   mix, per-warp route mix, times and bounds, and one launch over 384 rows
   against six of 64 in turns; the lattice exact-z C_ell (float64, J = 8)
   at the JAX package's tests/test_exact_z_lattice.py configuration
   against its ``projection.limber_cl_exact_z`` (1e-4) and its lattice
   route (1e-10); forward and forward+backward walls and peak memory; the
   Jacobians at the 3 reference cosmologies (float32 < 1e-3 and float64
   kernels < 1e-9 against the JAX jacfwd at all 3; at the first, float32
   < 1e-3 against the card's float64 plain path, float64 kernels <
   1e-10, float64 plain against the JAX jacfwd < 1e-9);
12. shear: configuration A with ``include_shear=True`` on both routes at
   B = 512, float32: launch counts forward and backward (lattice A 1, C
   3; table A 1, B 4); w, gamma_t and xi+ worst bin and xi- relative to
   each row's peak < 1e-4 against the card's float64 plain path and the
   committed JAX values, float64 kernels vs plain path (1e-12), plain vs
   JAX (1e-10); the float64 table route's xi+- against the lattice
   route's (3e-5, or 2x the JAX package's own gap); kernel C on the mu =
   4 operator at phase 3's gates and kernel B on the kappa-kappa C_ell
   rows with it at phase 6's; forward and forward+backward walls and peak
   memory per route;
13. the tomographic 3x2pt cell, DES Y3-like (tests/data/
   torch_tomo_reference.json: 5 lens x 4 source bins, per-bin Zheng
   HODs, z_pivot 0.6, ``with_nuisance`` and ``include_magnification`` at
   the file's nuisance point, 65 convolution rows) at B = 512, float32:
   launch counts (A 1 over the B x 5 = 2560 folded rows, C 3); finiteness
   and shapes; w, gamma_t and xi+ worst bin (rows that change sign over
   theta, and xi-, relative to the row's peak) < 1e-4 against the card's
   float64 plain path and the committed JAX float64 values, float64
   kernels vs plain (1e-12), plain vs JAX (1e-10); kernels A and A' on 8
   of the 2560 folded rows at phase 2's and 8's gates, with their times
   over all rows and bounds; kernel C on
   the forward's own rows of each operator (M = 12800, 20480, 5120) at
   phase 3's gates, with its time, the float64 ``torch.matmul``'s and the
   bound; the forward wall and peak memory;
14. tomographic gradients: one ``torch.autograd.grad`` of a seeded
   linear functional of the data vector with respect to (omega_m0,
   sigma_8) per cosmology and the nuisance point's (dz_src, m, a_ia),
   launch counts forward and backward (A 1, C 3 each), walls and peak
   memory; the Jacobian of the vector over (omega_m0, sigma_8, dz_src[4],
   m[4], a_ia) at the fiducial through ``inference.make_theory_fn``'s
   nuisance slots (float32 < 1e-3 of each column's peak over theta
   against the card's float64, float64 < 1e-9 against the committed JAX
   jacfwd, exact zeros where JAX's column is zero); ``hmc`` over 64
   chains (2 steps x 5 leapfrogs, Fisher mass with the DES Y3 priors)
   must stay finite with mean acceptance > 0.5;
15-19. the pipelines' options, the cells of tests/data/
   torch_options_reference.json (OPTION_CELLS of
   tools/torch_slice_reference.py), each in float32 at full width: launch
   counts around the forward (and forward+backward), finiteness and
   shapes, the same gates as phases 5-14 (worst bin < 1e-4 against the
   card's float64 plain path on the checked cosmologies and against the
   committed JAX float64 values, relative to the row's peak for xi- and
   for rows that change sign; float64 kernels vs plain 1e-12, plain vs
   JAX 1e-10), walls and peak memory:
   15. config A with shear, BAO, halofit, the kappa_CMB row and the
       non-Limber repair at ell 60 with RSD (A 1, C 3; A' 1, C' 3), its
       non-Limber corrections in float32 against float64 (1e-6 of the
       corrected row's peak), kernel A on its BAO nodes (phase 2's
       gates) and the Jacobian over (omega_m0, sigma_8) at the 3
       reference cosmologies (float32 < 1e-3 of each column's peak
       against float64 and JAX, float64 < 1e-9 against the JAX jacfwd);
   16. curved sky at the 20 DES Y3 theta, Tinker, linear mm legs, kappa_CMB
       and the curved non-Limber operator (A 1, C 4; A' 1, C' 4), kernel A
       on its Tinker nodes and kernel C on the forward's own rows at each
       curved operator (phase 3's gates, with the float64 torch.matmul);
   17. config B (J = 6, 64 cosmologies) curved at DES theta with halofit
       at the 384 anchor rows, BAO, shear and kappa_CMB (A 1, C 4);
   18. the table route with BAO, Tinker and shear (A 1, B 4) and kernel B
       on its gg C_ell rows (phase 6's gates);
   19. the tomographic cell of phase 13 curved at DES theta with halofit,
       BAO, kappa_CMB and the non-Limber repair with RSD (A 1 over 2560
       rows, C 4; A' 1, C' 4), its non-Limber corrections in float32
       against float64, A and A' on the 8 checked rows (phase 2's and
       8's gates) with their times over all rows, and C and C' at each
       curved operator's row count;
20. exact-z tomography: the cell of phases 13-14 without its nuisances
   (exact-z refuses them), per-bin HODs, ``exact_z_anchors=6``, flat, at
   configuration B's 64 cosmologies (tests/data/
   torch_exactz_tomo_reference.json, ``chip_tomo``), float32: launch
   counts (A 1 over the B x J x 5 = 1920 folded anchor rows, C 3; A' 1,
   C' 3 in the backward); the gates of phase 13 against the card's
   float64 plain path (8 cosmologies) and the committed JAX values (3);
   kernels A and A' on 8 of the 1920 rows (phase 2's and 8's gates) with
   their times over all rows and bounds; C and C' on the forward's own
   J-channel convolution rows of each operator (phase 3's and 8's gates,
   the float64 torch.matmul beside them); forward and forward+backward
   walls (one call each) and peak memory; the Jacobian over (omega_m0,
   sigma_8) at 180 of the 2880 data entries, float32 against float64
   (1e-3 of each probe row's column peak);
21. the same cell curved at the 20 DES theta with halofit at the anchor
   rows, BAO, kappa_CMB and the non-Limber repair at ell 60 with RSD (A
   2: the anchors and the pivot; C 4): forward only, float32 against the
   card's float64 plain path (1e-4), float64 kernels against plain
   (1e-12), wall and peak;
22. the Gauss-Legendre exact-z C_ell (``projection.limber_cl_exact_z``,
   power_gg, configuration A's window, 64 cosmologies x 32 GL nodes =
   2048 halo-model rows, 20 ells over 10-3000; ``chip_gl`` of the same
   file): A 1 with a k row per row (A' 1 with grad_k in the backward);
   float32 against float64 (1e-4), float64 kernels against plain
   (1e-12), float64 against JAX (1e-10), the anchored lattice (J = 8)
   against JAX's (1e-10) and within 1e-4 of the GL route on all 64
   cosmologies at the ells <= 1000 of the JAX package's slow test (over
   all 20 within 2x the JAX package's own gap, which opens at ell > ~1500:
   2.2e-4); kernel A with a k row per
   row at phase 2's gates (and each row's launch with its k shared equal
   to its row, bit for bit), A' with grad_k at phase 8's (grad_k a
   field), their times, bounds and A''s launch geometry against
   ops/tiles.py; walls and peaks; ``limber_cl_fft(conv_method="fft")``
   against the direct route (float64 1e-10; the float32 result's error
   and both times reported);
23. the HOD families (tests/data/torch_families_reference.json): bench.py
   configuration A at 512 cosmologies with a Poisson, a Mandelbaum and a
   Kravtsov HOD on both routes (A 1 and C 2; A 1 and B 2), float32
   against the card's float64 plain path (8) and JAX (3) at 1e-4, the
   float64 kernels against plain (1e-12) and plain against JAX (1e-10);
   kernels A and A' on Mandelbaum's node set (two breakpoints and two
   switch masses: 5 panels of 64, NG = 320) at phase 2's and 8's gates,
   with times and bounds; then the DES Y3-like cell of phase 13 with
   per-bin families (Mandelbaum, Mandelbaum, Kravtsov, Zheng, Zheng): A
   once per distinct galaxy node count (2), C 3, phase 13's gates, A and
   A' on each fold (8 rows gated, all timed), forward and
   forward+backward walls and peaks;
24. the float32 gate at the prior corners (``utils.corners``: 5 corners
   and 2 near-fiducial points): the lattice route at DEFAULT_GRID, flat
   (worst |w32/w64 - 1| < 1e-5 and median < 2e-6, against the card's
   float64 plain path and the committed JAX float64 values) and curved
   at theta 0.2-5 deg (w and gamma_t < 1e-4); float64 kernels against
   plain (1e-12) and plain against JAX (1e-10); the table route's figures
   and each corner's worst bin reported;
25. the rest of inference on phase 10's lattice likelihood:
   ``adaptive_hmc`` (64 chains in Fisher-whitened coordinates, two
   warmup windows, diagonal mass: finite, step in (0.05, 5), mean
   acceptance in (0.6, 0.99)); MOPED (the compressed Fisher equals the
   full one in float64 to 1e-8 of its largest entry);
   ``external_loglike(vectorized=True)`` over 64 walkers in one call and
   a short ``ensemble_sample``; walls per leapfrog, warmup window and
   ensemble step; likelihoods built from numpy data hold their tensors
   on the card (the Cholesky factor there, chi^2 equal to the tensor
   data's);
26. the emulator on configuration A's lattice w and gamma_t over an
   (omega_m0, sigma_8) box: a design sweep of 256 + 64 nodes in one
   batched float32 call, value training (holdout max_rel < 4e-2), and a
   Sobolev run on the float64 Jacobians of a 128 + 32 node design with
   the box's vertices and faces (holdout max_rel < 5e-3 and jac_max_rel
   < 2e-2, the JAX tests' gates); walls of the sweep, the Jacobians and
   training;
27. the flat-sky covariance stack, float64 (tests/data/
   torch_cov_reference.json): the Morrison & Schneider joint w(theta) +
   gamma_t matrix of examples/joint_covariance_example.py's survey on
   DEFAULT_GRID at the JAX builders' defaults, Gaussian + connected +
   super-sample + PSD clip, at 64 cosmologies in one call (kernel A
   launched and counted): against the JAX float64 values at 3 of them
   (each 8 x 8 block to 1e-9 of its peak; JAX's own jit(vmap)-vs-scalar
   gap is printed beside it), its pieces at the first of them (Gaussian,
   + connected, + super-sample, unclipped) likewise, symmetric, PSD, and
   its Gaussian-only matrix on the card against the port's plain run on
   the CPU (1e-12); wall (median of 3), per cosmology, peak memory and
   (with the device times) the busy share;
28. the DES Y3-like tomographic 3x2pt covariance: phase 13's cell (5 lens
   x 4 source bins, per-bin HODs, nuisances, magnification) with DES
   Y3's survey at its 20 bins as edges, 45 probes, a 900 x 900 matrix,
   Gaussian + connected + SSC on every block + clip, at B = 1 and 8: the
   2 x 2 run of bins 0-1 against JAX, raw to 1e-9 of each block's peak,
   clipped to that or twice what JAX's own clip moves its raw matrix
   where that is larger, every raw block of the 5 x 4 matrix over bins
   0-1 equal to the 2 x 2 run's (1e-10 of its peak; what the clip, which
   acts on the whole matrix, moves is reported), the clipped matrices
   symmetric and PSD, B = 8's row against B = 1; walls, peak memory and
   busy share;
29. the curved-sky joint covariances on a footprint no azimuthal profile
   can represent: examples/curved_sky_example.py's two 20-degree caps (a
   256 x 512 PixelSphereMask), its dN/dz, edges and noise on
   DEFAULT_GRID at ell_max 4096 with cNG, curved SSC and the clip, the
   joint w + gamma_t and the 3x2pt builders at B = 64 in one call each:
   the raw matrices at 3 cosmologies against
   tests/data/torch_cov_more_reference.json (1e-9 of each block's peak;
   JAX's own jit(vmap)-vs-scalar gap is printed beside it), the 3x2pt
   [w, gamma_t] corner equal to the joint matrix (1e-10), the
   UniformSphereMask Gaussian-only matrix on the card against the plain
   CPU run (1e-12), symmetric and PSD after the clip; walls, peak memory,
   kernel A's launches and the host seconds of the mask and Ξ;
30. exact-z covariance on phase 27's survey: exact_z_anchors=6 on the
   connected and super-sample terms at B = 64 (the anchors' responses in
   one kernel A launch over B x J rows) and exact_z=True (the table
   route's per-node rebuilds, in chunks) at B = 8, each against JAX
   (1e-9), the anchors against the per-node route (connected blocks,
   5e-3 of each block's peak, the JAX package's own gate), kernel A at
   the anchors' response rows against its plain version (float64,
   1e-12) with its time and bound;
31. the kappa_CMB probes on phase 28's cell (50 probes, 1000 x 1000),
   flat at B = 1 and 8 and on a SphericalCapMask of DES Y3's area at B =
   1, Gaussian + cNG + SSC + clip: the 2 x 2 + kappa runs of both
   builders against JAX (raw, 1e-9), the flat raw matrix without its wgk
   rows equal to phase 28's raw matrix (1e-10), symmetric and PSD; the
   flat 2 x 2 + kappa run with exact_z_anchors=6 on cNG and SSC launches
   kernel A twice (every block's anchor span primed at once), finite and
   symmetric; walls, peak memory and busy shares (measured after every
   covariance wall of 27-31).

Each phase prints its seconds (``[time] phase N``).  Kernel times: CUDA events around 100 back-to-back calls of the wrapper,
over 100, taken in turns with the library call or plain version (other,
kernel, kernel, other; a plain version of kernel A or A' that takes
seconds a call: one call, before the kernel's two turns); after phase 10, each kernel's and library call's device
time per call from torch.profiler's kernel records ("not measured" where
it records none), and the device's busy share (the kineto device
activity of one call, ``busy_ms``) of one forward+backward per route, of
configuration B's and of the tomographic cell's (and of its forward) and
of each option cell's forward; phase 31 ends with the busy shares of the
covariance builds of 27-31.  Each main path (phases 5, 7, each route's
forward+backward in 9, the forwards and forward+backwards of 11-19, and
the covariance builds of 27-31) runs with every launch count set to 0
just before it and read just after.  The last lines are the card
(``nvidia-smi``), the kernels' JSON record (times, launches, and the
least time the card could take, from the H100 SXM's published 67 TFLOP/s
FP32 / FP64 tensor-core rate and 3.35 TB/s) and ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_COSMO = 512
N_CHECK = 8
REPO = Path(__file__).resolve().parent
PEAK_FLOPS = 67e12   # H100 SXM: FP32 CUDA cores and FP64 tensor cores alike
HBM_BYTES = 3.35e12  # H100 SXM, device memory


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps=100):
    """Milliseconds per call of ``fn()`` from CUDA events around ``reps``
    back-to-back calls (after one warm-up call)."""
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


def in_turns_ms(kernel, other, reps=100, other_reps=100, other_turns=2):
    """(kernel ms, other ms): :func:`events_ms` in the order other, kernel,
    kernel, other, each the mean of its two turns; ``other_turns=1`` drops
    the last turn (a plain version that takes seconds a call)."""
    o = [events_ms(other, other_reps)]
    k1, k2 = events_ms(kernel, reps), events_ms(kernel, reps)
    if other_turns > 1:
        o.append(events_ms(other, other_reps))
    return (k1 + k2) / 2, sum(o) / len(o)


def device_ms(fn, reps=20):
    """Device milliseconds per call of ``fn()``: the CUDA kernel time that
    torch.profiler's ``key_averages()`` records over ``reps`` calls, over
    ``reps``; None where it records no device time.  The profiler records
    kernel activity only (recording the host ops as well took three times
    as long over this script's profiled calls).  A session now and then
    records no kernel in either mode (tools/torch_profiler_probe.py
    counts them): its row reads "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def busy_ms(fn, warm=True):
    """Device milliseconds of one call of ``fn()``, for the busy shares:
    the sum of the device activity that torch.profiler's kineto results
    record (kernels, copies, sets); None where it records none.  A
    covariance build launches ~10^5 small kernels a call, where
    ``key_averages`` (device_ms) takes over a minute to aggregate them:
    on phase 27's and 28's builds the two read 234.3 / 234.6 ms and
    551.6 / 545.9 ms and took 9.4 / 3.3 s and 72.3 / 19.3 s
    (tools/torch_cov_diagnostics.py --card, NVIDIA H100 80GB HBM3, 700.00
    W).  ``warm=False`` skips the warm-up call (``fn`` has run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda_type)
    return ns / 1e6 if ns > 0 else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def rel_to_peak(got, ref):
    """max over outputs of max|got - ref| / max|ref| (axis 1 = output)."""
    d = (got - ref).abs().amax(dim=(0, 2))
    return float((d / ref.abs().amax(dim=(0, 2))).max())


def worst_bin(got, ref):
    return float(np.max(np.abs(np.asarray(got) / np.asarray(ref) - 1.0)))


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operation time at 67
    TFLOP/s and the device-memory time of the work."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def one_profile(gal):
    """(B, NG) mask of the galaxy nodes whose matter and galaxy profile
    parameters coincide: kernel A evaluates their profile once."""
    return (gal[..., 0] == gal[..., 2]) & (gal[..., 1] == gal[..., 3])


def k_block(k, i, n):
    """Columns [i, i + n) of kernel A's k as (B|1, n, 1): the shared k
    (NK,) or each row's of (B, NK)."""
    return (k[i:i + n][None, :, None] if k.dim() == 1
            else k[:, i:i + n, None])


def halo_contract_flops(k, mat, gal, lens, moments):
    """Floating-point operations kernel A does on these inputs, counted
    from csrc/halo_contract.cu per route (moment series b <= 4; beyond it
    g(x) by series x <= 4, Chebyshev x <= 64 or asymptotic, and f - 1/x,
    g at b by Chebyshev b <= 64 or asymptotic), for the route each
    (cosmology, k, profile) takes, with one profile where a galaxy node's
    matter and galaxy parameters coincide; sincos, log and a reciprocal
    as one operation each, an FMA as two.  The double-precision
    accumulations are counted at the FP32 rate, so the bound stays a
    lower one."""
    import torch

    afm, ag, bfm, bg, series, g_asym = lens

    def profile(x, c):
        b = (1.0 + c) * x
        gx = torch.where(x <= 4, 4 * series + 8, torch.where(
            x <= 16, 3 * ag + 6, torch.where(x <= 64, 3 * bg + 6,
                                             2 * g_asym + 3)))
        fg = torch.where(b <= 16, 3 * (afm + ag) + 7, torch.where(
            b <= 64, 3 * (bfm + bg) + 7, 2 * g_asym + 17))
        return 2 + torch.where(b <= 4, 2 * moments - 1, 6 + gx + fg)

    same = one_profile(gal)
    total = 0.0
    for i in range(0, k.shape[-1], 64):
        kk = k_block(k, i, 64)
        total += float(profile(kk * mat[:, None, :, 0],
                               mat[:, None, :, 1]).double().sum()
                       + 5 * mat.shape[0] * kk.shape[1] * mat.shape[1])
        n_g = profile(kk * gal[:, None, :, 2], gal[:, None, :, 3])
        total += float((profile(kk * gal[:, None, :, 0], gal[:, None, :, 1])
                        + torch.where(same[:, None, :], 0, n_g)
                        ).double().sum()
                       + 10 * gal.shape[0] * kk.shape[1] * gal.shape[1])
    return total


def branch_mix(k, mat, gal):
    """Shares of kernel A's profile evaluations per route on these inputs
    (one evaluation where a galaxy node's two profiles coincide), the
    share of |c x| above 105615 (where the library sincosf leaves its fast
    path) and at or above 2^27 (where the kernel calls it), and max c x."""
    import torch

    same = one_profile(gal)
    profs = [(mat[..., 0], mat[..., 1], torch.ones_like(mat[..., 0])),
             (gal[..., 0], gal[..., 1], torch.ones_like(gal[..., 0])),
             (gal[..., 2], gal[..., 3], (~same).to(gal.dtype))]
    names = ("moment series b<=4", "g(x) series x<=4<b",
             "g(x) Chebyshev 4<x<=64", "g(x) asymptotic x>64",
             "f,g(b) Chebyshev 4<b<=64", "f,g(b) asymptotic b>64",
             "|cx|>105615", "|cx|>=2^27")
    cnt = torch.zeros(len(names), dtype=torch.float64, device=k.device)
    tot, cx_max = 0.0, 0.0
    for i in range(0, k.shape[-1], 64):
        kk = k_block(k, i, 64)
        for rs, c, w in profs:
            x = kk * rs[:, None, :]
            c = c[:, None, :]
            b, cx = (1.0 + c) * x, (c * x).abs()
            w = w[:, None, :].expand_as(x).double()
            big = b > 4
            masks = (~big, big & (x <= 4), big & (x > 4) & (x <= 64),
                     big & (x > 64), big & (b <= 64), big & (b > 64),
                     big & (cx > 105615), big & (cx >= 2.0 ** 27))
            cnt += torch.stack([(w * m).sum() for m in masks])
            tot += float(w.sum())
            cx_max = max(cx_max, float(cx.max()))
    shares = (cnt / tot).tolist()
    return ({n: v for n, v in zip(names, shares)}, float(same.double().mean()),
            cx_max)


def geometry(rows, n, t):
    """The launch geometry kernels B and C use at this shape."""
    from chomp_tpu_torch.ops.tiles import split_k

    g = split_k(rows, n, t)
    last = g.bounds[-1][1] - g.bounds[-1][0]
    return (f"grid {g.grid} = {g.ctas} CTAs in clusters of {g.cluster}, K "
            f"per rank {g.kc} (last {last})")


def max_rel(got, ref):
    """max over elements of |got - ref| / |ref|."""
    return float(((got - ref).abs() / ref.abs()).max())


def row_peak_rel(got, ref):
    """max over rows of max|got - ref| / max|ref| (axis 1 = columns)."""
    return float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())


@contextlib.contextmanager
def plain_path():
    """Route the slice through the kernels' plain versions, forward and
    backward: kernel A's plain forward with its plain backward
    (``halo_contract_bwd_ref``), B's and C's plain versions under
    autograd (matrix products).  A's plain backward stands in for
    autograd of the plain forward, which would keep every (row, k, node)
    intermediate of its k blocks at the Jacobians' row counts; the CPU
    tests hold the one to the other (tests/test_torch_grad.py)."""
    import torch

    from chomp_tpu_torch import halo
    from chomp_tpu_torch.ops import df32, halo_contract as hc, hankel_matmul
    from chomp_tpu_torch.parallel import sweep

    class PlainA(torch.autograd.Function):
        @staticmethod
        def forward(ctx, k, mat, gal, cheb):
            ctx.save_for_backward(k, mat, gal, cheb)
            return hc.halo_contract_ref(k, mat, gal)

        @staticmethod
        def backward(ctx, grad):
            need_k = ctx.needs_input_grad[0]
            g = hc.halo_contract_bwd_ref(*ctx.saved_tensors,
                                         grad.contiguous(), grad_k=need_k)
            return (g[2] if need_k else None), g[0], g[1], None

    saved = halo.halo_contract, sweep.df_contract, sweep.hankel_matmul
    halo.halo_contract = PlainA.apply
    sweep.df_contract = df32.df_contract_ref
    sweep.hankel_matmul = hankel_matmul.hankel_matmul_ref
    try:
        yield
    finally:
        halo.halo_contract, sweep.df_contract, sweep.hankel_matmul = saved


def halo_contract_bwd_flops(k, mat, gal, lens, moments, grad_k=False):
    """Floating-point operations of kernel A's backward on these inputs,
    counted from csrc/halo_contract.cu (profile_nd and the accumulation
    of halo_contract_bwd_kernel) per route, as halo_contract_flops counts
    the forward: the moment series with its derivative series for b <= 4;
    beyond it f - 1/x and g at b and at x (series for x <= 4, Chebyshev
    for x <= 64, else asymptotic) and the three derivative formulas; one
    profile where a galaxy node's two coincide; the double accumulations
    (12 a mat node, 26 a gal node, per k; with ``grad_k`` 3 and 6 more)
    at the FP32 rate, so the bound stays a lower one."""
    import torch

    afm, ag, bfm, bg, series, g_asym = lens

    def fg(v):
        return torch.where(v <= 16, 3 * (afm + ag) + 7, torch.where(
            v <= 64, 3 * (bfm + bg) + 7, 2 * g_asym + 17))

    def profile(x, c):
        b = (1.0 + c) * x
        fgx = torch.where(x <= 4, 4 * series + 12, fg(x))
        return 4 + torch.where(b <= 4, 5 * moments - 3, 14 + fg(b) + fgx)

    same = one_profile(gal)
    acc_m, acc_g = (15, 32) if grad_k else (12, 26)
    total = 0.0
    for i in range(0, k.shape[-1], 64):
        kk = k_block(k, i, 64)
        total += float(profile(kk * mat[:, None, :, 0],
                               mat[:, None, :, 1]).double().sum()
                       + acc_m * mat.shape[0] * kk.shape[1] * mat.shape[1])
        n_g = profile(kk * gal[:, None, :, 2], gal[:, None, :, 3])
        total += float((profile(kk * gal[:, None, :, 0], gal[:, None, :, 1])
                        + torch.where(same[:, None, :], 0, n_g)
                        ).double().sum()
                       + acc_g * gal.shape[0] * kk.shape[1] * gal.shape[1])
    return total


def bwd_route_mix(k, mat, gal, lens, moments):
    """Divergence of kernel A''s profile_nd per warp on these inputs, in
    a thread-per-node layout (a warp-step is 32 consecutive nodes
    of a cosmology at one k, the galaxy profile of a gal node whose two
    differ a second step) and in this one (lanes on k: a warp-step is one
    profile of one node at 32 consecutive k of a 32-aligned tile).  A
    warp-step issues every branch arm any active lane takes, priced as
    halo_contract_bwd_flops prices the routes; useful work is the lanes'
    own paths.  {layout: (issued / useful, share of warp-steps whose
    active lanes take more than one path)}."""
    import torch

    afm, ag, bfm, bg, series, g_asym = lens
    c_b = torch.tensor([3 * (afm + ag) + 7, 3 * (bfm + bg) + 7,
                        2 * g_asym + 17], device=k.device)
    c_x = torch.cat([torch.tensor([4 * series + 12], device=k.device), c_b])
    c_small, c_large, common = 5 * moments - 3, 14, 4
    same = one_profile(gal)
    profs = [(mat[..., 0], mat[..., 1], None), (gal[..., 0], gal[..., 1], None),
             (gal[..., 2], gal[..., 3], ~same)]
    tot = {"per_node": [0.0, 0.0, 0, 0], "lanes_on_k": [0.0, 0.0, 0, 0]}
    for rs, c, live in profs:
        for i in range(0, k.numel(), 256):
            kk = k[i:i + 256]
            x = kk[None, None, :] * rs[:, :, None]          # (B, N, K)
            b = (1.0 + c[:, :, None]) * x
            small = b <= 4
            barm = (b > 16).long() + (b > 64).long()
            xarm = (x > 4).long() + (x > 16).long() + (x > 64).long()
            act = (torch.ones_like(small) if live is None
                   else live[:, :, None].expand_as(small).clone())
            ind = [small, ~small] + [~small & (barm == j) for j in range(3)] \
                + [~small & (xarm == j) for j in range(4)]
            cost = torch.tensor([c_small, c_large], device=k.device)
            cost = torch.cat([cost, c_b, c_x]).double()
            lane = torch.where(small, c_small, c_large + c_b[barm]
                               + c_x[xarm]) + common
            pid = torch.where(small, 0, 1 + 4 * barm + xarm)
            for layout, dim in (("per_node", 1), ("lanes_on_k", 2)):
                pad = -x.shape[dim] % 32
                shape = list(x.shape)
                shape[dim:dim + 1] = [(x.shape[dim] + pad) // 32, 32]

                def grp(t, fill):
                    if pad:
                        filler = list(t.shape)
                        filler[dim] = pad
                        t = torch.cat([t, t.new_full(filler, fill)], dim)
                    return t.reshape(shape)

                a = grp(act, False)
                on = a.any(dim + 1)
                anyarm = torch.stack([grp(t & act, False).any(dim + 1)
                                      for t in ind], -1)
                issued = common * on.double().sum() + (
                    anyarm.double() * cost).sum()
                useful = grp(torch.where(act, lane, 0), 0).double().sum() / 32
                hi = grp(torch.where(act, pid, -1), -1).amax(dim + 1)
                lo = grp(torch.where(act, pid, 99), 99).amin(dim + 1)
                t_ = tot[layout]
                t_[0] += float(issued)
                t_[1] += float(useful)
                t_[2] += int(on.sum())
                t_[3] += int((on & (hi != lo)).sum())
    return {n: (v[0] / v[1], v[3] / v[2]) for n, v in tot.items()}


def ptxas_of(log, kernel):
    """nvcc's -Xptxas -v lines for each instantiation of ``kernel``: the
    stack and spill line and the registers line, per mangled name."""
    lines = log.splitlines()
    out = []
    for j, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            ty = "f32" if f"{kernel}IfE" in ln else "f64"
            regs = next((r.split(":", 1)[-1].strip() for r in lines[j + 2:j + 4]
                         if "registers" in r), "")
            out.append(f"{ty}: {lines[j + 1].strip()}; {regs}")
    return out


def field_peak_rel(got, ref):
    """max over gradient fields of max|got - ref| / max|ref| (last axis =
    field of a node)."""
    d = (got - ref).abs().amax(dim=(0, 1))
    return float((d / ref.abs().amax(dim=(0, 1))).max())


def jac_err(got, ref):
    """max over (cosmology, probe, parameter) of the worst entry over
    theta relative to that column's peak over theta; got / ref (m,
    2 n_theta, n_par), w(theta) then gamma_t."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    m, n, p = ref.shape
    d = np.abs(got - ref).reshape(m, 2, n // 2, p).max(axis=2)
    return float(np.max(d / np.abs(ref).reshape(m, 2, n // 2, p).max(
        axis=2)))


def tomo_cell(ref, *, device, dtype, halo_params=None, nuisance=True,
              hods=None, **options):
    """(pipeline, nuisance point without a batch axis) of the tomographic
    cell that ``ref`` (tests/data/torch_tomo_reference.json) defines:
    Gaussian lens and source dN/dz, per-bin Zheng HODs, DEFAULT_GRID,
    ``with_nuisance`` and ``include_magnification`` (both off, and the
    point None, with ``nuisance=False``: exact-z tomography refuses
    them); ``hods`` replace the per-bin Zheng HODs; ``options`` (and
    ``halo_params``) as make_tomographic_pipeline's."""
    import torch

    from chomp_tpu_torch import (DNdzGaussian, default_halo, default_hod,
                                 make_tomographic_pipeline)
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import Nuisance3x2pt

    cell = ref["cell"]
    kw = dict(device=device, dtype=dtype)

    def gauss(z0, sz, z_max):
        return DNdzGaussian(*(torch.tensor(v, **kw)
                              for v in (0.0, z_max, z0, sz)))

    lens = [gauss(z0, cell["lens_sigma_z"], cell["lens_z_max"])
            for z0 in cell["lens_z0"]]
    src = [gauss(z0, sz, cell["src_z_max"])
           for z0, sz in zip(cell["src_z0"], cell["src_sigma_z"])]
    hods = hods or [default_hod(log10_m_min=m, log10_m_0=m,
                                log10_m_1p=m + cell["log10_m_1p_offset"],
                                **kw) for m in cell["log10_m_min"]]
    pipe = make_tomographic_pipeline(
        halo_params or default_halo(**kw), hods, lens, src,
        grid=DEFAULT_GRID, z_pivot=cell["z_pivot"], with_nuisance=nuisance,
        include_magnification=nuisance, **options, **kw)
    if not nuisance:
        return pipe, None
    return pipe, Nuisance3x2pt(**{k: torch.tensor(v, **kw)
                                  for k, v in ref["nuisance"].items()})


def hod_of(spec, **kw):
    """A port HOD from (class name, fields) of
    tests/data/torch_families_reference.json."""
    import torch

    from chomp_tpu_torch import hod

    cls, fields = spec
    return getattr(hod, cls)(**{k: torch.tensor(float(v), **kw)
                                for k, v in fields.items()})


def cuda():
    import torch

    return torch.device("cuda", 0)


@functools.cache
def cheb(dtype):
    """DEFAULT_GRID's Chebyshev matrix on the card, in ``dtype``."""
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.params import DEFAULT_GRID

    return Statics(DEFAULT_GRID, device=cuda(), dtype=dtype).cheb


def counted_kernels():
    """The kernel wrappers that count their launches, by kernel name."""
    from chomp_tpu_torch.ops import df32, halo_contract as hc
    from chomp_tpu_torch.ops import hankel_matmul as hm

    return {"halo_contract": hc.halo_contract,
            "df_contract": df32.df_contract,
            "hankel_matmul": hm.hankel_matmul}


def counts_zero():
    for fn in counted_kernels().values():
        fn.launches = 0
        fn.bwd_launches = 0


def counts():
    """(forward, backward) launch counts by kernel name."""
    counted = counted_kernels()
    return ({n: fn.launches for n, fn in counted.items()},
            {n: fn.bwd_launches for n, fn in counted.items()})


def setup(dtype, idx=None, feedback=False, n=N_COSMO):
    """(batch, halo, hod, dist) at ``idx`` of bench.py's n-point
    linspaces (all n by default)."""
    import torch

    from chomp_tpu_torch import (DNdzGaussian, default_cosmo, default_halo,
                                 default_hod)
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo

    o_all = np.linspace(0.24, 0.32, n)
    s_all = np.linspace(0.75, 0.88, n)
    o = o_all if idx is None else o_all[idx]
    s = s_all if idx is None else s_all[idx]
    kw = dict(device=cuda(), dtype=dtype)
    # The feedback hooks (c x 1.2, k x nu^0.05) make every galaxy
    # node's matter profile differ from its galaxy profile.
    hooks = (dict(bary_c=np.full(len(o), 1.2),
                  bary_eta=np.full(len(o), 0.1)) if feedback else {})
    batch = broadcast_cosmo(default_cosmo(**kw), omega_m0=o,
                            omega_l0=1.0 - o, sigma_8=s, **hooks)
    dist = DNdzGaussian(*(torch.tensor(v, **kw)
                          for v in (0.0, 2.0, 1.0, 0.2)))
    return batch, default_halo(**kw), default_hod(**kw), dist


def seeded(shape, seed, dtype=None):
    """Seeded normal numbers on the card (float64 by default)."""
    import torch

    return torch.tensor(np.random.default_rng(seed).normal(size=shape),
                        dtype=dtype or torch.float64, device=cuda())


def check_a(k, mat32, gal32, k64, mat64, gal64, cheb32, cheb64):
    """Kernel A in float64 against its plain version (relative to each
    output's peak); in float32 against the plain version on the same
    float32 inputs in float64, beside the plain float32 version's own
    error against that reference; two launches bit for bit."""
    import torch

    from chomp_tpu_torch.ops import halo_contract as hc

    got64 = hc.halo_contract(k64, mat64, gal64, cheb64)
    got32 = hc.halo_contract(k, mat32, gal32, cheb32)
    exact = hc.halo_contract_ref(k.double(), mat32.double(),
                                 gal32.double())
    plain32, plain_ms = once_ms(lambda: hc.halo_contract_ref(k, mat32,
                                                             gal32))
    return {"f64": rel_to_peak(got64, hc.halo_contract_ref(k64, mat64,
                                                           gal64)),
            "plain_ms": plain_ms,
            "f32": rel_to_peak(got32.double(), exact),
            "abs": float((got32.double() - exact).abs().max()),
            "plain32": rel_to_peak(plain32.double(), exact),
            "vs_plain32": rel_to_peak(got32, plain32),
            "same": (torch.equal(got32, hc.halo_contract(
                k, mat32, gal32, cheb32)) and torch.equal(
                    got64, hc.halo_contract(k64, mat64, gal64, cheb64)))}


def bound_a_of(k, mat, gal):
    """Kernel A's (bound_ms, bound_by) in float32 on these inputs."""
    import torch

    from chomp_tpu_torch.ops import halo_contract as hc

    f32 = torch.float32
    return bound(halo_contract_flops(k, mat, gal, hc._lens(f32),
                                     hc.n_moments(f32)),
                 4 * (k.numel() + mat.numel() + gal.numel()
                      + cheb(f32).numel() + hc.N_OUT * mat.shape[0]
                      * k.shape[-1]))


def bwd_ref_rows(k, mat, gal, cheb_, g, step=512, grad_k=False):
    """Kernel A's plain backward in blocks of ``step`` rows (each row
    is its own sum; whole, its float64 products at the tomographic
    rows would take tens of GB); ``k`` shared or a row per row."""
    import torch

    from chomp_tpu_torch.ops import halo_contract as hc

    parts = [hc.halo_contract_bwd_ref(
        k if k.dim() == 1 else k[i:i + step], mat[i:i + step],
        gal[i:i + step], cheb_, g[i:i + step], grad_k=grad_k)
        for i in range(0, mat.shape[0], step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def check_a_bwd(k, mat32, gal32, k64, mat64, gal64, seed, grad_k=False):
    """Kernel A's backward under a seeded normal cotangent: float64
    against the plain backward (relative to each gradient field's
    peak, grad_k one more field with ``grad_k``: k a row per row);
    float32 against the plain backward in float64 on the same float32
    inputs, beside the plain float32 backward's own error (and the
    host ms of that one call); two launches bit for bit."""
    import torch

    from chomp_tpu_torch.ops import halo_contract as hc

    f32 = torch.float32
    cheb32, cheb64 = cheb(f32), cheb(torch.float64)
    kw_ = dict(grad_k=grad_k)
    g32 = seeded((mat32.shape[0], hc.N_OUT, k.shape[-1]), seed, f32)
    g64 = g32[:mat64.shape[0]].double()
    got64 = hc.halo_contract_bwd(k64, mat64, gal64, cheb64, g64, **kw_)
    ref64 = bwd_ref_rows(k64, mat64, gal64, cheb64, g64, **kw_)
    got32 = hc.halo_contract_bwd(k, mat32, gal32, cheb32, g32, **kw_)
    exact = bwd_ref_rows(k.double(), mat32.double(), gal32.double(),
                         cheb64, g32.double(), **kw_)
    plain32, plain_ms = once_ms(lambda: bwd_ref_rows(
        k, mat32, gal32, cheb32, g32, **kw_))
    again32 = hc.halo_contract_bwd(k, mat32, gal32, cheb32, g32, **kw_)
    again64 = hc.halo_contract_bwd(k64, mat64, gal64, cheb64, g64, **kw_)
    return {"f64": max(field_peak_rel(a, r) for a, r in zip(got64, ref64)),
            "f32": max(field_peak_rel(a.double(), r)
                       for a, r in zip(got32, exact)),
            "abs": max(float((a.double() - r).abs().max())
                       for a, r in zip(got32, exact)),
            "plain32": max(field_peak_rel(a.double(), r)
                           for a, r in zip(plain32, exact)),
            "plain_ms": plain_ms,
            "same": all(torch.equal(a, b) for a, b in
                        zip(got32 + got64, again32 + again64))}


def bound_abwd_of(k, mat, gal, g, grad_k=False):
    """Kernel A''s (bound_ms, bound_by) in float32 on these inputs."""
    import torch

    from chomp_tpu_torch.ops import halo_contract as hc

    f32 = torch.float32
    return bound(
        halo_contract_bwd_flops(k, mat, gal, hc._lens(f32),
                                hc.n_moments(f32), grad_k),
        4 * ((2 if grad_k else 1) * k.numel()
             + 2 * (mat.numel() + gal.numel())
             + cheb(f32).numel() + g.numel()))


def phases_23_26(*, oms, s8s, check, k32, k64, cheb32, cheb64,
                 pipe_a32, pipe_a64, profiled, lap):
    """Phases 23-26 (HOD families, the float32 gate at the prior corners,
    the rest of inference and the emulator), on main()'s cosmology grid
    (``oms``, ``s8s``, the ``check`` indices), k grids, Chebyshev
    matrices and configuration A's float32 and float64 lattice pipelines.
    Returns the figures of the kernels' JSON line: launch counts by path
    and kernel A / A' at the new node sets."""
    import dataclasses

    import torch

    from chomp_tpu_torch import (DNdzGaussian, default_cosmo, default_halo,
                                 default_hod, emulator, halo, inference)
    from chomp_tpu_torch.ops import halo_contract as hc
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo, make_pipeline
    from chomp_tpu_torch.utils import corners

    dev, f32, f64 = cuda(), torch.float32, torch.float64
    ref = json.loads((REPO / "tests" / "data"
                      / "torch_families_reference.json").read_text())
    paths, bwd_paths, kern, busy = {}, {}, {}, []

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    def counted(fn):
        """(fn(), its forward launch counts)."""
        torch.cuda.synchronize()
        counts_zero()
        out = fn()
        torch.cuda.synchronize()
        return out, counts()[0]

    def counted_fb(fn):
        """(fn(), (forward, backward) launch counts)."""
        torch.cuda.synchronize()
        counts_zero()
        out = fn()
        torch.cuda.synchronize()
        return out, counts()

    # -- 23. the HOD families ---------------------------------------------
    rf = ref["chip_families"]
    idx_f = np.asarray(rf["indices"])
    if not np.allclose(rf["omega_m0"], oms[idx_f]):
        fail("families reference file does not match this run's "
             "cosmologies")
    meas = sorted(set(check.tolist()) | set(idx_f.tolist()))
    pos_chk = [meas.index(i) for i in check]
    pos_ref = [meas.index(i) for i in idx_f]
    batch32 = setup(f32)[0]
    batch64 = setup(f64, meas)[0]
    want = {"fft": {"halo_contract": 1, "df_contract": 2,
                    "hankel_matmul": 0},
            "table": {"halo_contract": 1, "df_contract": 0,
                      "hankel_matmul": 2}}

    def family_pipe(spec, method, dtype):
        kw = dict(device=dev, dtype=dtype)
        dist = DNdzGaussian(*(torch.tensor(v, **kw)
                              for v in (0.0, 2.0, 1.0, 0.2)))
        return make_pipeline(default_halo(**kw), hod_of(spec, **kw), dist,
                             power_spec="power_gg", grid=DEFAULT_GRID,
                             include_lensing=True, z_pivot=1.0,
                             method=method, **kw)

    def host(out, keys=("w_theta", "gamma_t")):
        return {k: out[k].double().cpu().numpy() for k in keys}

    def errs(got, ref_):
        return max(worst_bin(got[k], ref_[k]) for k in ("w_theta",
                                                         "gamma_t"))

    fam_rows = {}
    for fam, spec in ref["families"].items():
        for method in ("fft", "table"):
            pipe32 = family_pipe(spec, method, f32)
            with torch.no_grad():
                out32, launches = counted(lambda: pipe32(batch32))
            got = host(out32)
            finite = all(bool(np.all(np.isfinite(v))) for v in got.values())
            pipe64 = family_pipe(spec, method, f64)
            with torch.no_grad():
                with plain_path():
                    plain = host(pipe64(batch64))
                kern64 = host(pipe64(batch64))
                wall = median_wall(lambda: pipe32(batch32), reps=3)
            jref = {k: np.asarray(rf[f"{fam}_{method}"][k])
                    for k in ("w_theta", "gamma_t")}
            e = {"vs_plain": errs({k: v[check] for k, v in got.items()},
                                  {k: v[pos_chk] for k, v in plain.items()}),
                 "vs_jax": errs({k: v[idx_f] for k, v in got.items()}, jref),
                 "k64": errs(kern64, plain),
                 "plain_vs_jax": errs({k: v[pos_ref] for k, v in
                                       plain.items()}, jref)}
            fam_rows[(fam, method)] = dict(e, wall=wall, launches=launches)
            paths[f"hod_{fam}_{method}"] = launches
            print(f"[families] {fam} ({spec[0]}), method={method}, "
                  f"DEFAULT_GRID, B={N_COSMO}, float32 | launches "
                  f"{launches} | finite={finite} | worst bin vs card f64 "
                  f"plain path {e['vs_plain']:.3e} (8 cosmologies, gate "
                  f"1e-4) | vs JAX f64 {e['vs_jax']:.3e} (3, gate 1e-4) | "
                  f"f64 kernels vs plain {e['k64']:.3e} (gate 1e-12) | f64 "
                  f"plain vs JAX {e['plain_vs_jax']:.3e} (gate 1e-10) | wall "
                  f"median of 3 = {wall * 1e3:.1f} ms", flush=True)
            if launches != want[method]:
                fail(f"{fam} {method} launches {launches}; want "
                     f"{want[method]}")
            if not finite:
                fail(f"{fam} {method}: outputs not finite")
            for name, gate in (("vs_plain", 1e-4), ("vs_jax", 1e-4),
                               ("k64", 1e-12), ("plain_vs_jax", 1e-10)):
                if not e[name] <= gate:
                    fail(f"{fam} {method} {name}: {e[name]} (gate {gate})")
            if (fam, method) == ("mandelbaum", "fft"):
                busy.append(("families mandelbaum lattice forward",
                             no_grad(lambda p=pipe32: p(batch32)),
                             wall * 1e3, N_COSMO))
            del pipe32, pipe64, out32

    # Kernels A and A' on Mandelbaum's node set: two breakpoints and two
    # switch masses make 5 panels of 64 nodes (NG = 320).
    from chomp_tpu_torch.grids import Statics

    spec_m = ref["families"]["mandelbaum"]

    def mand_nodes(dtype, idx=None):
        st = Statics(DEFAULT_GRID, device=dev, dtype=dtype)
        batch_, hp_, _, _ = setup(dtype, idx)
        z = torch.ones(1, device=dev, dtype=dtype)
        model = halo.build_halo_model(batch_, hp_,
                                      hod_of(spec_m, device=dev,
                                             dtype=dtype), z, st)
        return halo.contraction_nodes(batch_, hp_, model)

    mat_m32, gal_m32 = mand_nodes(f32)
    mat_m64, gal_m64 = mand_nodes(f64, check)
    ng_m = gal_m32.shape[1]
    if ng_m != 320:
        fail(f"Mandelbaum galaxy pack has {ng_m} nodes; want 320")
    a_m = check_a(k32, mat_m32, gal_m32, k64, mat_m64, gal_m64,
                    cheb32, cheb64)
    ms_am, plain_ms_am = in_turns_ms(
        lambda: hc.halo_contract(k32, mat_m32, gal_m32, cheb32),
        lambda: hc.halo_contract_ref(k32, mat_m32, gal_m32),
        other_reps=1, other_turns=1)
    bound_am = bound_a_of(k32, mat_m32, gal_m32)
    # A' on 64 rows for the float32 gate (the plain backward in float64
    # over all 512 would take tens of seconds); its time covers 512.
    bwd_m = check_a_bwd(k32, mat_m32[:64].contiguous(),
                          gal_m32[:64].contiguous(), k64, mat_m64,
                          gal_m64, 40)
    g_m = seeded((N_COSMO, hc.N_OUT, k32.numel()), 41, f32)
    ms_abm, plain_ms_abm = in_turns_ms(
        lambda: hc.halo_contract_bwd(k32, mat_m32, gal_m32, cheb32, g_m),
        lambda: hc.halo_contract_bwd_ref(k32, mat_m32, gal_m32, cheb32,
                                         g_m), other_reps=1, other_turns=1)
    bound_abm = bound_abwd_of(k32, mat_m32, gal_m32, g_m)
    profiled["halo_contract NG=320"] = (lambda: hc.halo_contract(
        k32, mat_m32, gal_m32, cheb32), None, 5)
    profiled["halo_contract_bwd NG=320"] = (lambda: hc.halo_contract_bwd(
        k32, mat_m32, gal_m32, cheb32, g_m), None, 5)
    print(f"[families A] Mandelbaum nodes B={N_COSMO} NK={k32.numel()} "
          f"NM={mat_m32.shape[1]} NG={ng_m} | f64 rel_to_peak="
          f"{a_m['f64']:.3e} (gate 1e-12) | f32 vs plain in f64 "
          f"{a_m['f32']:.3e} (gate 2e-6, <= 1.5x the plain f32's "
          f"{a_m['plain32']:.3e}) | deterministic={a_m['same']} | kernel "
          f"{ms_am:.3f} ms, plain {plain_ms_am:.3f} ms (CUDA events, in "
          f"turns) | bound {bound_am[0]:.4f} ms by {bound_am[1]}",
          flush=True)
    print(f"[families A'] the same nodes | f64 field_peak_rel="
          f"{bwd_m['f64']:.3e} (gate 1e-12) | f32 (64 rows) vs plain "
          f"backward in f64 {bwd_m['f32']:.3e} (gate 2e-5, <= 1.5x the "
          f"plain f32's {bwd_m['plain32']:.3e}) | deterministic="
          f"{bwd_m['same']} | kernel {ms_abm:.3f} ms, plain "
          f"{plain_ms_abm:.3f} ms | bound {bound_abm[0]:.4f} ms by "
          f"{bound_abm[1]}", flush=True)
    if not (a_m["f64"] <= 1e-12 and a_m["f32"] <= 2e-6
            and a_m["f32"] <= 1.5 * a_m["plain32"] and a_m["same"]):
        fail(f"halo_contract on the Mandelbaum nodes: {a_m}")
    if not (bwd_m["f64"] <= 1e-12 and bwd_m["f32"] <= 2e-5
            and bwd_m["f32"] <= 1.5 * bwd_m["plain32"] and bwd_m["same"]):
        fail(f"halo_contract_bwd on the Mandelbaum nodes: {bwd_m}")
    kern["ng320"] = {"rows": N_COSMO, "ng": ng_m, "ms": ms_am,
                     "plain_ms": plain_ms_am, "bound_ms": bound_am[0],
                     "bound_by": bound_am[1], "max_abs_err": a_m["abs"],
                     "bwd_ms": ms_abm, "bwd_plain_ms": plain_ms_abm,
                     "bwd_bound_ms": bound_abm[0],
                     "bwd_bound_by": bound_abm[1],
                     "bwd_max_abs_err": bwd_m["abs"]}

    # The DES Y3-like tomographic cell with mixed per-bin families.
    rt = ref["chip_tomo"]
    ref_tm = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())
    idx_t = np.asarray(rt["indices"])
    if (not np.allclose(rt["omega_m0"], oms[idx_t])
            or rt["nuisance_seed"] != ref_tm["seed"]):
        fail("mixed tomographic reference does not match this run")
    keys_tm = ("w_theta", "gamma_t", "xi_plus", "xi_minus")

    def mixed_of(dtype):
        kw = dict(device=dev, dtype=dtype)
        return tomo_cell(ref_tm, hods=[hod_of(s, **kw) for s in rt["hods"]],
                         **kw)

    def tomo_err(got, ref_):
        """The worst bin of the rows that keep one sign over theta (xi_-
        and rows that change sign: relative to the row's peak)."""
        e = []
        for k in keys_tm:
            g, r = np.asarray(got[k]), np.asarray(ref_[k])
            peak = np.abs(g - r).max(-1) / np.abs(r).max(-1)
            bins = np.abs(g / r - 1.0).max(-1)
            one = ((r > 0).all(-1) | (r < 0).all(-1)) & (k != "xi_minus")
            e.append(float(np.where(one, bins, peak).max()))
        return max(e)

    pipe_x, nu_x = mixed_of(f32)
    launch_rows = pipe_x.contraction_rows(batch32)
    ngs = sorted(int(g.shape[1]) for _, g in launch_rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out_x, launches_x = counted(lambda: pipe_x(batch32, nu_x))
    peak_x = torch.cuda.max_memory_allocated() / 1e9
    got_x = {k: out_x[k].double().cpu().numpy() for k in keys_tm}
    finite_x = all(bool(np.all(np.isfinite(v))) for v in got_x.values())
    del out_x
    pipe_x64, nu_x64 = mixed_of(f64)
    with torch.no_grad():
        with plain_path():
            plain_x = pipe_x64(batch64, nu_x64)
            plain_x = {k: plain_x[k].cpu().numpy() for k in keys_tm}
        kern_x = pipe_x64(batch64, nu_x64)
        kern_x = {k: kern_x[k].cpu().numpy() for k in keys_tm}
        wall_x = median_wall(lambda: pipe_x(batch32, nu_x), 1)
    jref_x = {k: np.asarray(rt["outputs"][k]) for k in keys_tm}
    err_x = {"vs_plain": tomo_err({k: v[check] for k, v in got_x.items()},
                                  {k: v[pos_chk] for k, v in
                                   plain_x.items()}),
             "vs_jax": tomo_err({k: v[idx_t] for k, v in got_x.items()},
                                jref_x),
             "k64": tomo_err(kern_x, plain_x),
             "plain_vs_jax": tomo_err({k: v[pos_ref] for k, v in
                                       plain_x.items()}, jref_x)}
    w_x = seeded((N_COSMO, 45 * DEFAULT_GRID.n_theta), 42, f32)

    def grad_run_x():
        om = torch.tensor(oms, dtype=f32, device=dev, requires_grad=True)
        s8 = torch.tensor(s8s, dtype=f32, device=dev, requires_grad=True)
        out = pipe_x(broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                     omega_m0=om, omega_l0=1.0 - om,
                                     sigma_8=s8), nu_x)
        return torch.autograd.grad((out["vector"] * w_x).sum(), (om, s8))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g_x, fb_x = counted_fb(grad_run_x)
    peak_x_fb = torch.cuda.max_memory_allocated() / 1e9
    finite_gx = all(bool(torch.isfinite(g).all()) for g in g_x)
    del g_x
    wall_x_fb = median_wall(grad_run_x, 1)
    paths["tomographic_mixed"] = launches_x
    busy.append(("tomographic mixed forward",
                 no_grad(lambda: pipe_x(batch32, nu_x)), wall_x * 1e3,
                 N_COSMO))
    bwd_paths["tomographic_mixed"] = {f"{n}_bwd": c
                                      for n, c in fb_x[1].items()}
    want_x = {"halo_contract": len(set(ngs)), "df_contract": 3,
              "hankel_matmul": 0}
    print(f"[families tomo] DES Y3-like cell with per-bin HODs "
          f"{[s[0] for s in rt['hods']]}, B={N_COSMO}, float32 | kernel A "
          f"launches by galaxy node count {ngs} | forward launches "
          f"{launches_x} | forward+backward {fb_x} | finite="
          f"{finite_x and finite_gx} | vs card f64 plain path "
          f"{err_x['vs_plain']:.3e} (8 cosmologies, gate 1e-4) | vs JAX f64 "
          f"{err_x['vs_jax']:.3e} (3, gate 1e-4) | f64 kernels vs plain "
          f"{err_x['k64']:.3e} (gate 1e-12) | f64 plain vs JAX "
          f"{err_x['plain_vs_jax']:.3e} (gate 1e-10) | forward wall "
          f"{wall_x * 1e3:.1f} ms, peak {peak_x:.2f} GB | forward+backward "
          f"wall {wall_x_fb * 1e3:.1f} ms, peak {peak_x_fb:.2f} GB (one call"
          f" each)", flush=True)
    if launches_x != want_x or len(set(ngs)) != 2:
        fail(f"mixed tomographic launches {launches_x} (node counts {ngs}); "
             f"want {want_x}, two node counts")
    if fb_x[1]["halo_contract"] != len(set(ngs)):
        fail(f"mixed tomographic backward launches {fb_x[1]}")
    if not (finite_x and finite_gx):
        fail("mixed tomographic outputs or gradients not finite")
    for name, gate in (("vs_plain", 1e-4), ("vs_jax", 1e-4), ("k64", 1e-12),
                       ("plain_vs_jax", 1e-10)):
        if not err_x[name] <= gate:
            fail(f"mixed tomographic {name}: {err_x[name]} (gate {gate})")
    # A and A' on each fold of the cell (the launches of its forward),
    # held on 8 rows at phase 2's and 8's gates, timed over all rows.
    launch_64 = pipe_x64.contraction_rows(batch64)
    kern["mixed_fold"] = []
    for (mat32, gal32), (mat64, gal64) in zip(launch_rows, launch_64):
        mat32, gal32 = mat32.contiguous(), gal32.contiguous()
        sel = torch.arange(8, device=dev) * (mat64.shape[0] // 8)
        m64, g64_ = mat64[sel].contiguous(), gal64[sel].contiguous()
        sel32 = torch.arange(8, device=dev) * (mat32.shape[0] // 8)
        a_f = check_a(k32, mat32[sel32].contiguous(),
                        gal32[sel32].contiguous(), k64, m64, g64_,
                        cheb32, cheb64)
        b_f = check_a_bwd(k32, mat32[sel32].contiguous(),
                            gal32[sel32].contiguous(), k64, m64, g64_, 43)
        g_f = seeded((mat32.shape[0], hc.N_OUT, k32.numel()), 44, f32)
        ms_f = events_ms(lambda: hc.halo_contract(k32, mat32, gal32,
                                                  cheb32), reps=20)
        ms_fb = events_ms(lambda: hc.halo_contract_bwd(
            k32, mat32, gal32, cheb32, g_f), reps=20)
        b_a, b_ab = (bound_a_of(k32, mat32, gal32),
                     bound_abwd_of(k32, mat32, gal32, g_f))
        ng = int(gal32.shape[1])
        profiled[f"halo_contract mixed NG={ng}"] = (
            lambda m=mat32, g=gal32: hc.halo_contract(k32, m, g, cheb32),
            None, 5)
        profiled[f"halo_contract_bwd mixed NG={ng}"] = (
            lambda m=mat32, g=gal32, c=g_f: hc.halo_contract_bwd(
                k32, m, g, cheb32, c), None, 5)
        print(f"[families tomo A/A'] fold NG={ng}: {mat32.shape[0]} rows | "
              f"A f64 {a_f['f64']:.3e} f32 {a_f['f32']:.3e} (plain f32 "
              f"{a_f['plain32']:.3e}) same={a_f['same']} | A' f64 "
              f"{b_f['f64']:.3e} f32 {b_f['f32']:.3e} (plain f32 "
              f"{b_f['plain32']:.3e}) same={b_f['same']} (8 rows) | A "
              f"{ms_f:.3f} ms (bound {b_a[0]:.4f} by {b_a[1]}), A' "
              f"{ms_fb:.3f} ms (bound {b_ab[0]:.4f} by {b_ab[1]}) (CUDA "
              f"events, 20 calls)", flush=True)
        if not (a_f["f64"] <= 1e-12 and a_f["f32"] <= 2e-6
                and a_f["f32"] <= 1.5 * a_f["plain32"] and a_f["same"]):
            fail(f"halo_contract on the mixed fold NG={ng}: {a_f}")
        if not (b_f["f64"] <= 1e-12 and b_f["f32"] <= 2e-5
                and b_f["f32"] <= 1.5 * b_f["plain32"] and b_f["same"]):
            fail(f"halo_contract_bwd on the mixed fold NG={ng}: {b_f}")
        kern["mixed_fold"].append(
            {"rows": int(mat32.shape[0]), "ng": ng, "ms": ms_f,
             "bound_ms": b_a[0], "bound_by": b_a[1],
             "max_abs_err": a_f["abs"], "bwd_ms": ms_fb,
             "bwd_bound_ms": b_ab[0], "bwd_bound_by": b_ab[1],
             "bwd_max_abs_err": b_f["abs"]})
    del pipe_x64, launch_64
    lap("23")

    # -- 24. the float32 gate at the prior corners --------------------------
    rc = ref["chip_corners"]
    names = list(corners.PRIOR_CORNERS) + ["near_fiducial_0.25",
                                           "near_fiducial_0.31"]
    corner = {}

    def corner_pipe(grid, geometry, method, dtype):
        kw = dict(device=dev, dtype=dtype)
        dist = DNdzGaussian(*(torch.tensor(v, **kw)
                              for v in (0.0, 2.0, 1.0, 0.2)))
        return make_pipeline(default_halo(**kw), default_hod(**kw), dist,
                             grid=grid, geometry=geometry, method=method,
                             **kw)

    def rel_bins(a, b):
        return np.abs(np.asarray(a) / np.asarray(b) - 1.0)

    grid_c = DEFAULT_GRID.replace(n_theta=8, theta_min_deg=0.2,
                                  theta_max_deg=5.0)
    for label, grid, geometry, method in (
            ("flat", DEFAULT_GRID, "flat", "fft"),
            ("curved", grid_c, "curved", "fft"),
            ("table", DEFAULT_GRID, "flat", "table")):
        if dataclasses.asdict(grid) != rc[label if label != "table"
                                          else "flat"]["grid"]:
            fail(f"corner reference grid of {label} differs")
        b32 = corners.corner_batch(default_cosmo(device=dev, dtype=f32))
        b64 = corners.corner_batch(default_cosmo(device=dev, dtype=f64))
        p32 = corner_pipe(grid, geometry, method, f32)
        p64 = corner_pipe(grid, geometry, method, f64)
        with torch.no_grad():
            o32, launches = counted(lambda: p32(b32))
            o32 = host(o32)
            with plain_path():
                plain = host(p64(b64))
            kern64 = host(p64(b64))
        jref = {k: np.asarray(rc["flat" if label == "table" else label][k])
                for k in ("w_theta", "gamma_t")}
        rw = rel_bins(o32["w_theta"], plain["w_theta"])
        rg = rel_bins(o32["gamma_t"], plain["gamma_t"])
        rwj = rel_bins(o32["w_theta"], jref["w_theta"])
        rgj = rel_bins(o32["gamma_t"], jref["gamma_t"])
        q = {"w_worst": float(rw.max()), "w_median": float(np.median(rw)),
             "gt_worst": float(rg.max()), "gt_median": float(np.median(rg)),
             "w_worst_jax": float(rwj.max()),
             "w_median_jax": float(np.median(rwj)),
             "gt_worst_jax": float(rgj.max()),
             "k64": errs(kern64, plain), "plain_vs_jax": errs(plain, jref),
             "per_corner_w": rw.max(-1).tolist(),
             "per_corner_gt": rg.max(-1).tolist(), "launches": launches,
             "finite": all(bool(np.all(np.isfinite(v)))
                           for v in o32.values())}
        corner[label] = q
        if label == "flat":
            with torch.no_grad():
                wall_c = median_wall(lambda: p32(b32), reps=3)
            busy.append(("corners flat forward",
                         no_grad(lambda p=p32, b=b32: p(b)), wall_c * 1e3,
                         len(names)))
            q["wall"] = wall_c
        paths[f"corners_{label}"] = launches
        print(f"[corners] {label} ({geometry}, method={method}, theta "
              f"{grid.theta_min_deg}-{grid.theta_max_deg} deg x "
              f"{grid.n_theta}), 5 prior corners + 2 near-fiducial, float32 "
              f"vs the card's f64 plain path: w worst |w32/w64-1| "
              f"{q['w_worst']:.3e} median {q['w_median']:.3e}, gamma_t worst "
              f"{q['gt_worst']:.3e} median {q['gt_median']:.3e} | vs JAX "
              f"f64: w worst {q['w_worst_jax']:.3e} median "
              f"{q['w_median_jax']:.3e}, gamma_t worst {q['gt_worst_jax']:.3e}"
              f" | f64 kernels vs plain {q['k64']:.3e} (gate 1e-12) | f64 "
              f"plain vs JAX {q['plain_vs_jax']:.3e} (gate 1e-10; the table "
              f"route's against JAX's lattice route is reported) | launches "
              f"{launches} | "
              f"worst w bin by corner: " + ", ".join(
                  f"{n} {v:.2e}" for n, v in zip(names, q["per_corner_w"]))
              + " | gamma_t: " + ", ".join(
                  f"{v:.2e}" for v in q["per_corner_gt"]), flush=True)
        if not q["finite"]:
            fail(f"corners {label}: outputs not finite")
        if not q["k64"] <= 1e-12:
            fail(f"corners {label}: f64 kernels vs plain {q['k64']}")
        if label != "table" and not q["plain_vs_jax"] <= 1e-10:
            fail(f"corners {label}: f64 plain vs JAX {q['plain_vs_jax']}")
        del p32, p64
    cf, cc = corner["flat"], corner["curved"]
    print(f"[corners] gates: flat w worst {cf['w_worst']:.3e} (< 1e-5) and "
          f"median {cf['w_median']:.3e} (< 2e-6) against the card's f64 "
          f"and against JAX ({cf['w_worst_jax']:.3e}, "
          f"{cf['w_median_jax']:.3e}); curved w {cc['w_worst']:.3e} and "
          f"gamma_t {cc['gt_worst']:.3e} (< 1e-4); the table route's "
          f"figures are reported", flush=True)
    for name, val, gate in (
            ("flat w worst bin", cf["w_worst"], 1e-5),
            ("flat w median", cf["w_median"], 2e-6),
            ("flat w worst bin vs JAX", cf["w_worst_jax"], 1e-5),
            ("flat w median vs JAX", cf["w_median_jax"], 2e-6),
            ("curved w worst bin", cc["w_worst"], 1e-4),
            ("curved gamma_t worst bin", cc["gt_worst"], 1e-4),
            ("curved w worst bin vs JAX", cc["w_worst_jax"], 1e-4),
            ("curved gamma_t worst bin vs JAX", cc["gt_worst_jax"], 1e-4)):
        if not val < gate:
            fail(f"corners: {name} {val} (gate {gate})")
    lap("24")

    # -- 25. the rest of inference on the lattice route ---------------------
    # Phase 10's likelihood: float64 data at the fiducial, a diagonal
    # covariance, the float32 theory.
    fid = torch.tensor([0.278, 0.811], dtype=f64, device=dev)
    th64, _ = inference.make_theory_fn(pipe_a64, default_cosmo(
        device=dev, dtype=f64))
    th32, _ = inference.make_theory_fn(pipe_a32, default_cosmo(
        device=dev, dtype=f32))
    with torch.no_grad():
        data = th64(fid)[0]
    sig = 0.05 * data.abs() + 1e-3 * data.abs().max()
    cov = torch.diag(sig * sig)
    fisher64 = inference.fisher_matrix(th64, cov, fid)
    like = inference.GaussianLikelihood(th32, data, cov)
    # adaptive_hmc in Fisher-whitened coordinates (p = fid + u L^-1, F =
    # L L^T), so that its unit-scale defaults fit the posterior.
    chol_f = torch.linalg.cholesky(fisher64)
    a_w = torch.linalg.inv(chol_f).T.contiguous()

    def nlp_w(u):
        return like.neg_log_post(fid + u @ a_w.T)

    n_chains, n_warm, n_samp, n_leap = 64, 16, 8, 3
    gen = torch.Generator(device=dev).manual_seed(25)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ah, fb_ah = counted_fb(lambda: inference.adaptive_hmc(
        nlp_w, torch.zeros(2, dtype=f64, device=dev), gen,
        n_warmup=n_warm, n_samples=n_samp, n_chains=n_chains, n_leap=n_leap,
        init_jitter=0.5, init_step=0.3))
    wall_ah = time.perf_counter() - t0
    n_sweeps = n_warm + n_samp
    per_leap = wall_ah / (n_sweeps * n_leap + 2)
    samples_p = fid + ah["samples"] @ a_w.T
    acc_ah = float(ah["accept"].mean())
    finite_ah = bool(torch.isfinite(samples_p).all())
    paths["adaptive_hmc"] = fb_ah[0]
    bwd_paths["adaptive_hmc"] = {f"{n}_bwd": c for n, c in fb_ah[1].items()}
    print(f"[inference+] adaptive_hmc on phase 10's lattice likelihood "
          f"(float32 pipeline, Fisher-whitened), {n_chains} chains, "
          f"{n_warm} warmup sweeps (two windows), {n_samp} samples, "
          f"{n_leap} leapfrogs, diagonal mass | finite={finite_ah} | step "
          f"size {ah['step_size']:.4f} (gate (0.05, 5)) | mean acceptance "
          f"{acc_ah:.4f} (gate (0.6, 0.99)) | mass_diag {ah['mass_diag']} | "
          f"sample mean {samples_p.reshape(-1, 2).mean(0).tolist()} | "
          f"launches forward/backward {fb_ah} | wall {wall_ah:.2f} s = "
          f"{per_leap * 1e3:.1f} ms per leapfrog (one gradient of {n_chains} "
          f"chains), {per_leap * n_leap * n_warm / 2:.2f} s per warmup "
          f"window, {per_leap * n_leap * 1e3:.1f} ms per sweep", flush=True)
    u_chains = torch.full((n_chains, 2), 0.3, dtype=f64, device=dev,
                          requires_grad=True)
    busy.append(("adaptive_hmc leapfrog gradient",
                 lambda: torch.autograd.grad(nlp_w(u_chains).sum(), u_chains),
                 per_leap * 1e3, n_chains))
    if not finite_ah:
        fail("adaptive_hmc samples not finite")
    if not 0.05 < ah["step_size"] < 5.0:
        fail(f"adaptive_hmc step size {ah['step_size']}")
    if not 0.6 < acc_ah < 0.99:
        fail(f"adaptive_hmc mean acceptance {acc_ah}")

    # MOPED on the float64 theory: the compressed Fisher is the full one.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (b_mat, compress), fb_mo = counted_fb(
        lambda: inference.moped_compression(th64, cov, fid))
    f_comp = inference.fisher_matrix(lambda p: compress(th64(p)),
                                     torch.eye(2, dtype=f64, device=dev),
                                     fid)
    wall_mo = time.perf_counter() - t0
    mo_err = float((f_comp - fisher64).abs().max()
                   / fisher64.abs().max())
    cov_y = b_mat @ cov.to(f64) @ b_mat.T
    unit_err = float((cov_y - torch.eye(2, dtype=f64, device=dev)).abs()
                     .max())
    paths["moped"] = fb_mo[0]
    bwd_paths["moped"] = {f"{n}_bwd": c for n, c in fb_mo[1].items()}
    print(f"[inference+] MOPED (float64 pipeline): compressed vs full Fisher "
          f"{mo_err:.3e} of its largest entry (gate 1e-8) | Cov(y) - I "
          f"{unit_err:.3e} | launches {fb_mo} | wall {wall_mo:.2f} s (two "
          f"Jacobians of {2 * DEFAULT_GRID.n_theta} replica rows)",
          flush=True)
    if not mo_err <= 1e-8:
        fail(f"MOPED compressed Fisher vs full: {mo_err}")

    # external_loglike over 64 walkers in one call, then a short ensemble.
    lp_vec = inference.external_loglike(like, vectorized=True, device=dev)
    z = torch.randn((64, 2), generator=gen, device=dev, dtype=f64)
    walkers = (fid + z @ a_w.T).cpu().numpy()
    (lp_w, launches_ext) = counted(lambda: lp_vec(walkers))
    with torch.no_grad():
        lp_ref = -like.neg_log_post(torch.as_tensor(
            walkers, device=dev)).cpu().numpy()
    ext_err = float(np.abs(lp_w - lp_ref).max() / np.abs(lp_ref).max())
    n_ens = 10
    t0 = time.perf_counter()
    (chain, acc_e), launches_ens = counted(lambda: inference.ensemble_sample(
        lp_vec, walkers, n_ens, seed=25, vectorized=True))
    wall_e = time.perf_counter() - t0
    paths["external_loglike"] = launches_ext
    paths["ensemble_sample"] = launches_ens
    print(f"[inference+] external_loglike(vectorized=True): 64 walkers, "
          f"shape {lp_w.shape}, launches {launches_ext} (one pipeline call), "
          f"finite={bool(np.all(np.isfinite(lp_w)))}, vs -neg_log_post "
          f"{ext_err:.3e} of its largest (gate 1e-12) | ensemble_sample "
          f"{n_ens} steps x 64 walkers "
          f"(vectorized: one call of 32 walkers per half-step): acceptance "
          f"{acc_e:.3f}, launches {launches_ens}, wall {wall_e:.2f} s = "
          f"{wall_e / n_ens * 1e3:.1f} ms per ensemble step", flush=True)
    if not (lp_w.shape == (64,) and np.all(np.isfinite(lp_w))
            and ext_err <= 1e-12):
        fail(f"external_loglike: shape {lp_w.shape}, error {ext_err}")
    if launches_ext["halo_contract"] != 1:
        fail(f"external_loglike launches {launches_ext}; want one forward")
    if not (np.all(np.isfinite(chain)) and 0.0 < acc_e < 1.0):
        fail(f"ensemble_sample: acceptance {acc_e}")
    # A likelihood built from numpy data and covariance, as a script
    # ported from the JAX API builds it: its tensors land on the card.
    like_np = inference.GaussianLikelihood(th32, data.cpu().numpy(),
                                           cov.cpu().numpy())
    pois_np = inference.PoissonLikelihood(th32, data.abs().cpu().numpy())
    with torch.no_grad():
        chi_np = float(like_np.chi2(fid[None])[0])
        chi_t = float(like.chi2(fid[None])[0])
    print(f"[inference+] GaussianLikelihood / PoissonLikelihood of numpy "
          f"data: Cholesky factor on {like_np._chol.device}, data on "
          f"{pois_np.data.device}; chi2 at the fiducial {chi_np:.6e} (tensor "
          f"data {chi_t:.6e})", flush=True)
    if (like_np._chol.device.type != "cuda"
            or pois_np.data.device.type != "cuda" or chi_np != chi_t):
        fail(f"likelihood of numpy data: Cholesky factor on "
             f"{like_np._chol.device}, Poisson data on "
             f"{pois_np.data.device}, chi2 {chi_np} vs {chi_t}")
    lap("25")

    # -- 26. the emulator on the pipeline -----------------------------------
    bounds = np.array([[0.26, 0.30], [0.78, 0.84]])
    egen = torch.Generator().manual_seed(26)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_all = emulator.latin_hypercube(egen, 320, bounds)
    with torch.no_grad():
        y_all, launches_sw = counted(lambda: th32(torch.as_tensor(
            x_all, device=dev)))
    y_all = y_all.double().cpu().numpy()
    wall_sw = time.perf_counter() - t0
    paths["emulator_sweep"] = launches_sw
    busy.append(("emulator design sweep forward", no_grad(
        lambda: th32(torch.as_tensor(x_all, device=dev))), wall_sw * 1e3,
        len(x_all)))
    t0 = time.perf_counter()
    n_ep_v = 1500
    emu_v, rep_v = emulator.train_emulator(
        None, bounds, egen, x_train=x_all[:256], y_train=y_all[:256],
        x_val=x_all[256:], y_val=y_all[256:], n_pca=None, hidden=(64, 64),
        n_epochs=n_ep_v, batch_size=128, learning_rate=5e-3, device=dev)
    torch.cuda.synchronize()
    wall_tv = time.perf_counter() - t0
    # Sobolev on a smaller design (box vertices and faces included), with
    # float64 values and Jacobians.
    n_s, n_sv = 128, 32
    t0 = time.perf_counter()
    x_s = emulator.design_nodes(egen, bounds, n_s, n_sv, sobolev=True)
    with torch.no_grad():
        y_s = th64(torch.as_tensor(x_s, device=dev)).cpu().numpy()
    j_s, fb_js = counted_fb(lambda: inference.jacobian(
        th64, torch.as_tensor(x_s, device=dev), chunk=1024))
    j_s = j_s.cpu().numpy()
    torch.cuda.synchronize()
    wall_js = time.perf_counter() - t0
    paths["emulator_jacobians"] = fb_js[0]
    bwd_paths["emulator_jacobians"] = {f"{n}_bwd": c
                                       for n, c in fb_js[1].items()}
    t0 = time.perf_counter()
    n_ep_s = 16000
    emu_s, rep_s = emulator.train_emulator(
        None, bounds, egen, x_train=x_s[:n_s], y_train=y_s[:n_s],
        x_val=x_s[n_s:], y_val=y_s[n_s:], j_train=j_s[:n_s],
        j_val=j_s[n_s:], jac_weight=10.0, n_pca=None, hidden=(32, 32),
        n_epochs=n_ep_s, batch_size=n_s, learning_rate=3e-2, device=dev)
    torch.cuda.synchronize()
    wall_ts = time.perf_counter() - t0
    steps_v = n_ep_v * 2
    print(f"[emulator] configuration A's lattice w + gamma_t (float32 "
          f"pipeline) over omega_m0 {bounds[0].tolist()} x sigma_8 "
          f"{bounds[1].tolist()} | design sweep of 256 + 64 nodes in one "
          f"batched call: {wall_sw:.2f} s, launches {launches_sw} | value "
          f"training (PCA full rank {rep_v.n_pca}, (64, 64), {n_ep_v} epochs "
          f"of 2 minibatches of 128, float64 on the card): holdout max_rel "
          f"{rep_v.max_rel_err:.3e} (gate 4e-2), rms {rep_v.rms_err:.3e}, "
          f"{wall_tv:.1f} s = {steps_v / wall_tv:.0f} steps/s | Sobolev: "
          f"{n_s} + {n_sv} nodes, float64 values and Jacobians "
          f"({(n_s + n_sv) * 2 * DEFAULT_GRID.n_theta} replica rows in "
          f"chunks of 1024, launches {fb_js}) {wall_js:.1f} s; training "
          f"((32, 32), {n_ep_s} full-batch epochs) {wall_ts:.1f} s = "
          f"{n_ep_s / wall_ts:.0f} steps/s, Jacobian weight 10: holdout "
          f"max_rel {rep_s.max_rel_err:.3e} (gate 5e-3, the JAX tests'), "
          f"jac_max_rel {rep_s.jac_max_rel_err:.3e} (gate 2e-2, the JAX "
          f"tests'; the JAX package's own on its pipeline is 5e-2, "
          f"examples/emulator_example.py:82)", flush=True)
    if not rep_v.max_rel_err < 4e-2:
        fail(f"emulator value training: max_rel {rep_v.max_rel_err}")
    if not (rep_s.max_rel_err < 5e-3 and rep_s.jac_max_rel_err < 2e-2):
        fail(f"emulator Sobolev training: max_rel {rep_s.max_rel_err}, "
             f"jac {rep_s.jac_max_rel_err}")
    lap("26")
    return {"paths": paths, "bwd_paths": bwd_paths, "kernels": kern,
            "corners": corner, "families": fam_rows, "busy": busy}


def cov_blocks_err(got, ref, nb):
    """The worst max|got - ref| / max|ref| over the nb x nb blocks of two
    (B, N, N) stacks (numpy)."""
    n = ref.shape[-1] // nb
    worst = 0.0
    for i in range(n):
        for j in range(n):
            a = got[:, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            b = ref[:, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            worst = max(worst, float(np.max(
                np.max(np.abs(a - b), axis=(1, 2))
                / np.maximum(np.max(np.abs(b), axis=(1, 2)), 1e-300))))
    return worst


def survey_numbers(area_deg2, lens_n, src_n, sigma_e):
    """(Omega_s in sr, lens galaxies per sr, shape noise per component)
    from densities per arcmin^2 (tools/torch_slice_reference.py's)."""
    per_sr = (180.0 * 60.0 / np.pi) ** 2
    omega = area_deg2 * (np.pi / 180.0) ** 2
    return (float(omega), np.asarray(lens_n, dtype=float) * per_sr,
            np.asarray(sigma_e, dtype=float) ** 2
            / (np.asarray(src_n, dtype=float) * per_sr))


def cov_counted(fn):
    """(fn()'s output without autograd, the launch counts of that call,
    set to 0 just before it)."""
    import torch

    torch.cuda.synchronize()
    counts_zero()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, counts()[0]


def cov_timed(fn, reps=3):
    """(the first call's output, its launch counts, the peak device memory
    in GiB over the calls above what was allocated before them (earlier
    phases keep tensors alive), the median wall of ``reps`` calls (the
    first one included), the no-grad runner for the busy share)."""
    import torch

    def run():
        with torch.no_grad():
            return fn()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    walls = []
    for i in range(reps):
        torch.cuda.synchronize()
        if i == 0:
            counts_zero()
        t0 = time.perf_counter()
        out_i = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            out, launches = out_i, counts()[0]
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    return out, launches, peak, float(np.median(walls)), run


def cov_busy(busy):
    """Print the device's busy share of each covariance build of ``busy``
    [(label, runner, wall ms, B)]: measured after every covariance wall
    (a profiler session slows later launches)."""
    for label, run, wall_b, n_run in busy:
        dev_ms = busy_ms(run, warm=False)
        print(f"[device time] {label}, B={n_run}: device busy "
              f"{fmt_ms(dev_ms)} of a {wall_b:.1f} ms wall"
              + (f" ({dev_ms / wall_b:.1%} busy)" if dev_ms else "")
              + " (kineto device-activity sum)", flush=True)


def phases_27_28(*, lap):
    """Phases 27-28, the flat-sky covariance stack in float64: the
    Morrison & Schneider joint w + gamma_t covariance at 64 cosmologies
    and the DES Y3-like tomographic 3x2pt covariance at 1 and 8, against
    tests/data/torch_cov_reference.json, with the builds' device busy
    shares measured after phase 31 (:func:`cov_busy`).  Returns the launch
    counts by path, the builds to profile and phase 28's raw 5 x 4
    matrix (phase 31 holds its kappa_CMB extension to it)."""
    import torch

    from chomp_tpu_torch import (DNdzGaussian, covariance, default_cosmo,
                                 default_halo, default_hod, halo)
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import Nuisance3x2pt, broadcast_cosmo

    dev, f64 = cuda(), torch.float64
    ref = json.loads((REPO / "tests" / "data"
                      / "torch_cov_reference.json").read_text())
    paths, busy = {}, []
    st = Statics(DEFAULT_GRID, device=dev, dtype=f64)
    st_cpu = Statics(DEFAULT_GRID, device="cpu", dtype=f64)
    n_b = 64
    o_all = np.linspace(0.24, 0.32, n_b)
    s_all = np.linspace(0.75, 0.88, n_b)

    def batch_of(idx, device):
        kw = dict(device=device, dtype=f64)
        return broadcast_cosmo(default_cosmo(**kw), omega_m0=o_all[idx],
                               omega_l0=1.0 - o_all[idx],
                               sigma_8=s_all[idx])

    counted, timed = cov_counted, cov_timed

    # -- 27. the Morrison & Schneider joint w(theta) + gamma_t covariance --
    rj, cell = ref["chip_joint"], ref["joint_cell"]
    # Every matrix against eager JAX float64 at 1e-9 of each block's peak
    # (psd_clip leaves a PSD matrix as it is); JAX's own jit(vmap)-vs-
    # scalar gap is printed beside it.
    gap = rj["batch_vs_scalar_gap"]
    gate = 1e-9
    omega, n2d, sn = survey_numbers(cell["area_deg2"],
                                    cell["lens_n_arcmin2"],
                                    cell["src_n_arcmin2"], cell["sigma_e"])
    edges = np.asarray(cell["edges_deg"])
    nb = len(edges) - 1

    def joint_of(device, st_, idx, **opts):
        kw = dict(device=device, dtype=f64)
        dists = [DNdzGaussian(*(torch.tensor(float(d[k]), **kw) for k in
                                ("z_min", "z_max", "z0", "sigma_z")))
                 for d in (cell["lens"], cell["src"])]
        b = batch_of(idx, device)
        hp, hod = default_halo(**kw), default_hod(**kw)
        z = torch.tensor([cell["z_model"]], **kw)
        base = dict(include_nongaussian=True, include_ssc=True,
                    psd_guard="clip")
        base.update(opts)

        def run():
            model = halo.build_halo_model(b, hp, hod, z, st_)
            return covariance.joint_wtheta_gammat_covariance(
                b, hp, model, *dists, edges, omega, float(n2d), float(sn),
                st=st_, **base)
        return run

    all_idx = np.arange(n_b)
    cov_j, launches_j, peak_j, wall_j, run_j = timed(
        joint_of(dev, st, all_idx))
    cov_np = cov_j.cpu().numpy()
    idx_j = np.asarray(rj["indices"])
    if not np.allclose(rj["omega_m0"], o_all[idx_j]):
        fail("covariance reference file does not match phase 27's "
             "cosmologies")
    err_j = cov_blocks_err(cov_np[idx_j], np.asarray(rj["cov"]), nb)
    sym_j = float(np.max(np.abs(cov_np - cov_np.transpose(0, 2, 1)))
                  / np.max(np.abs(cov_np)))
    eig_j = float(np.min(np.linalg.eigvalsh(cov_np)
                         / np.abs(cov_np).max(axis=(1, 2))[:, None]))
    # The Gaussian-only matrix on the card against its plain run on the
    # CPU (kernel A's plain version there), at the reference rows.
    gauss_opts = dict(include_nongaussian=False, include_ssc=False,
                      psd_guard=None)
    g_card, launches_g = counted(joint_of(dev, st, idx_j, **gauss_opts))
    with torch.no_grad():
        g_cpu = joint_of("cpu", st_cpu, idx_j, **gauss_opts)()
    err_g = cov_blocks_err(g_card.cpu().numpy(), g_cpu.numpy(), nb)
    # The pieces at the first reference cosmology against JAX's: the
    # Gaussian part, + cNG, + SSC (unclipped).
    pieces = {"gaussian": g_card[:1]}
    for key, opts in (("gaussian_cng", dict(include_ssc=False,
                                            psd_guard=None)),
                      ("unclipped", dict(psd_guard=None))):
        pieces[key] = counted(joint_of(dev, st, idx_j[:1], **opts))[0]
    err_pieces = {key: cov_blocks_err(
        v.cpu().numpy(), np.asarray(rj["pieces_at_first"][key])[None], nb)
        for key, v in pieces.items()}
    busy.append(("joint covariance forward", run_j, wall_j * 1e3, n_b))
    paths["joint_covariance"] = launches_j
    print(f"[joint covariance] examples/joint_covariance_example.py's "
          f"survey (1000 deg^2, 2 + 10 per arcmin^2, sigma_e 0.26, 8 bins "
          f"0.01-1 deg, z 0.5) on DEFAULT_GRID at the JAX defaults (n_k_tri "
          f"96, n_ell_cov_ng 96, n_ell_cov_g 4096, u_stride 4), Gaussian + "
          f"cNG + SSC + clip, float64, B={n_b}: launches {launches_j} | "
          f"against JAX (rows {idx_j.tolist()}): worst block "
          f"{err_j:.3e} (gate {gate:.0e}; JAX's own jit(vmap)-vs-scalar "
          f"gap {gap:.3e}); at row {idx_j[0]} "
          + ", ".join(f"{k} {v:.3e}" for k, v in err_pieces.items())
          + f" (gate {gate:.0e}) | symmetry {sym_j:.1e}, least eigenvalue / "
          f"peak {eig_j:.2e} | Gaussian-only card vs CPU plain {err_g:.3e} "
          f"(gate 1e-12; launches {launches_g}) | wall {wall_j:.3f} s "
          f"(median of 3) = {wall_j / n_b * 1e3:.2f} ms per cosmology, peak "
          f"{peak_j:.2f} GiB above the earlier phases'", flush=True)
    if not np.all(np.isfinite(cov_np)) or cov_np.shape != (n_b, 2 * nb,
                                                           2 * nb):
        fail(f"joint covariance: shape {cov_np.shape} or non-finite")
    if launches_j != {"halo_contract": 2, "df_contract": 0,
                      "hankel_matmul": 0}:
        fail(f"joint covariance launches {launches_j}: want kernel A twice "
             f"(the lattice C_ell, the SSC responses)")
    for name, val, g in (("vs JAX", err_j, gate), ("symmetry", sym_j, 1e-12),
                         ("least eigenvalue", -eig_j, 1e-10),
                         ("Gaussian-only card vs CPU", err_g, 1e-12),
                         *((f"{k} vs JAX", v, gate)
                           for k, v in err_pieces.items())):
        if not val <= g:
            fail(f"joint covariance {name}: {val} (gate {g})")
    lap("27")

    # -- 28. the DES Y3-like tomographic 3x2pt covariance ------------------
    rt, tc, sv = ref["chip_tomo"], ref["tomo_cell"], ref["des_y3_survey"]
    nu_ref = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    t_edges = np.asarray(ref["des_theta_edges_deg"])
    nb_t = len(t_edges) - 1

    def tomo_of(n_l, n_s, idx, **opts):
        kw = dict(device=dev, dtype=f64)

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
        om, n2d_t, sn_t = survey_numbers(
            sv["area_deg2"], sv["lens_n_arcmin2"][:n_l],
            sv["src_n_eff_arcmin2"][:n_s], sv["src_sigma_e"][:n_s])
        per_bin = {"dz_lens": n_l, "alpha_lens": n_l, "dz_src": n_s,
                   "m": n_s}
        nu = Nuisance3x2pt(**{
            k: torch.tensor(v[:per_bin[k]] if k in per_bin else v, **kw)
            for k, v in nu_ref.items()})
        b = batch_of(idx, dev)
        hp = default_halo(**kw)
        z = torch.tensor([tc["z_pivot"]], **kw)
        base = dict(include_nongaussian=True, include_ssc=True,
                    psd_guard="clip", nuisance=nu,
                    include_magnification=True)
        base.update(opts)

        def run():
            models = halo.build_halo_models(b, hp, hods, z, st)
            return covariance.tomographic_3x2pt_covariance(
                b, hp, models, lens, src, t_edges, om, n2d_t.tolist(),
                sn_t.tolist(), st=st, **base)
        return run

    idx_t = np.asarray(rt["indices"])
    if not np.allclose(rt["omega_m0"], o_all[idx_t]):
        fail("covariance reference file does not match phase 28's "
             "cosmologies")
    n_l, n_s = rt["bins"]
    # The builder's clip is psd_clip of its raw matrix (_apply_psd_guard):
    # one raw run gives both.
    sub_raw, launches_sub = counted(tomo_of(n_l, n_s, idx_t,
                                            psd_guard=None))
    sub = covariance.psd_clip(sub_raw).cpu().numpy()
    sub_raw = sub_raw.cpu().numpy()
    jax_raw, jax_clip = np.asarray(rt["cov_raw"]), np.asarray(rt["cov"])
    err_raw_t = cov_blocks_err(sub_raw, jax_raw, nb_t)
    err_t = cov_blocks_err(sub, jax_clip, nb_t)
    # JAX's clip rebuilds the whole matrix (LAPACK's eigh): the clipped
    # matrix's gate is twice what that moves, where it exceeds 1e-9.
    jax_move = cov_blocks_err(jax_clip, jax_raw, nb_t)
    gate_clip = max(gate, 2.0 * jax_move)
    sub_raw = sub_raw[0]
    # The full 5 x 4 matrix at B = 1, raw (its blocks over bins 0-1 must
    # equal the 2 x 2 run's) and clipped as the builder clips it.
    full_raw = counted(tomo_of(5, 4, idx_t[:1], psd_guard=None))[0]
    full_clip = covariance.psd_clip(full_raw).cpu().numpy()[0]
    full_raw = full_raw.cpu().numpy()[0]
    probes = covariance.tomographic_probes(5, 4)
    probes_sub = covariance.tomographic_probes(n_l, n_s)
    name_sub = [p[0] for p in probes_sub]
    names = [p[0] for p in probes]

    def in_sub(name):
        return name in name_sub

    worst_sub, worst_clip = 0.0, 0.0
    for a, pa in enumerate(names):
        for c, pc in enumerate(names):
            if not (in_sub(pa) and in_sub(pc)):
                continue
            ia, ic = name_sub.index(pa), name_sub.index(pc)
            blk = full_raw[a * nb_t:(a + 1) * nb_t, c * nb_t:(c + 1) * nb_t]
            want = sub_raw[ia * nb_t:(ia + 1) * nb_t,
                           ic * nb_t:(ic + 1) * nb_t]
            den = max(np.abs(want).max(), 1e-300)
            worst_sub = max(worst_sub, float(np.abs(blk - want).max() / den))
            clip = full_clip[a * nb_t:(a + 1) * nb_t,
                             c * nb_t:(c + 1) * nb_t]
            worst_clip = max(worst_clip, float(np.abs(clip - blk).max()
                                               / den))
    sym_t = float(np.max(np.abs(full_clip - full_clip.T))
                  / np.abs(full_clip).max())
    eig_raw = np.linalg.eigvalsh(0.5 * (full_raw + full_raw.T))
    eig_t = float(np.linalg.eigvalsh(full_clip).min()
                  / np.abs(full_clip).max())
    idx8 = np.unique(np.linspace(0, n_b - 1, 8).round()).astype(int)
    _, launches_1, peak1, wall1, run1_ng = timed(tomo_of(5, 4, idx_t[:1]),
                                                 reps=1)
    cov8, launches_8, peak8, wall8, run8_ng = timed(tomo_of(5, 4, idx8),
                                                    reps=1)
    cov8 = cov8.cpu().numpy()
    eig8 = float(min(np.linalg.eigvalsh(c).min() / np.abs(c).max()
                     for c in cov8))
    row0 = int(np.nonzero(idx8 == idx_t[0])[0][0])
    err_18 = float(np.abs(cov8[row0] - full_clip).max()
                   / np.abs(full_clip).max())
    busy.append(("tomographic covariance forward", run1_ng, wall1 * 1e3, 1))
    busy.append(("tomographic covariance forward", run8_ng, wall8 * 1e3, 8))
    paths["tomographic_covariance"] = launches_8
    n_probe = len(probes)
    print(f"[tomographic covariance] the cell of phase 13 (5 lens x 4 "
          f"source bins, per-bin Zheng HODs, nuisances, magnification) with "
          f"DES Y3's survey (4143 deg^2, n and sigma_e per bin) at its 20 "
          f"bins as edges 2.5'-250': {n_probe} probes, a "
          f"{n_probe * nb_t} x {n_probe * nb_t} matrix, Gaussian + cNG + "
          f"SSC + clip, float64 | {n_l} x {n_s} run against JAX (row "
          f"{idx_t.tolist()}), worst block: raw {err_raw_t:.3e} (gate "
          f"{gate:.0e}), clipped {err_t:.3e} (gate {gate_clip:.1e}: JAX's "
          f"clip moves its raw matrix {jax_move:.3e}), launches "
          f"{launches_sub} | 5 x 4 raw blocks over bins 0-1 "
          f"against the {n_l} x {n_s} raw run: {worst_sub:.3e} (gate "
          f"1e-10); the clip moves them by {worst_clip:.3e} of their peak "
          f"(the builder's PSD clip of the whole matrix is the one step "
          f"that mixes every bin: raw least eigenvalue / peak "
          f"{eig_raw.min() / np.abs(full_raw).max():.2e}) | clipped: "
          f"symmetry {sym_t:.1e}, least eigenvalue / peak {eig_t:.2e}, B=8 "
          f"{eig8:.2e}; B=8 row {row0} vs B=1 {err_18:.1e} | launches B=1 "
          f"{launches_1}, B=8 {launches_8} | wall B=1 {wall1:.3f} s, B=8 "
          f"{wall8:.3f} s (one call each) = {wall8 / len(idx8) * 1e3:.1f} ms "
          f"per cosmology | peak above the earlier phases' B=1 {peak1:.2f} "
          f"GiB, B=8 {peak8:.2f} GiB", flush=True)
    if not (np.all(np.isfinite(cov8)) and np.all(np.isfinite(full_clip))):
        fail("tomographic covariance: non-finite")
    for launches_b in (launches_1, launches_8):
        if launches_b != {"halo_contract": 2, "df_contract": 0,
                          "hankel_matmul": 0}:
            fail(f"tomographic covariance launches {launches_b}: want "
                 f"kernel A twice (every pack's lattice spectra, every "
                 f"sample's SSC responses)")
    for name, val, g in (("2x2 raw vs JAX", err_raw_t, gate),
                         ("2x2 clipped vs JAX", err_t, gate_clip),
                         ("5x4 vs 2x2 blocks", worst_sub, 1e-10),
                         ("symmetry", sym_t, 1e-12),
                         ("least eigenvalue", -eig_t, 1e-10),
                         ("B=8 least eigenvalue", -eig8, 1e-10),
                         ("B=8 vs B=1", err_18, 1e-10)):
        if not val <= g:
            fail(f"tomographic covariance {name}: {val} (gate {g})")
    lap("28")
    return {"paths": paths, "busy": busy, "tomo_raw": full_raw}


def two_cap_weight_map(n_ring=256, n_phi=512, radius_deg=20.0,
                       center2=(2.0, 1.0)):
    """Binary two-cap footprint on the iso-latitude grid (the map of
    examples/curved_sky_example.py, which imports jax)."""
    th = (np.arange(n_ring) + 0.5) * np.pi / n_ring
    ph = np.arange(n_phi) * 2 * np.pi / n_phi
    rad = np.radians(radius_deg)

    def cap(center):
        ct0, st0 = np.cos(center[0]), np.sin(center[0])
        mu = (ct0 * np.cos(th)[:, None] + st0 * np.sin(th)[:, None]
              * np.cos(ph[None, :] - center[1]))
        return mu >= np.cos(rad)

    return (cap((0.0, 0.0)) | cap(center2)).astype(float)


def sym_and_eig(cov):
    """(max asymmetry / peak, least eigenvalue / peak over the batch) of
    (B, N, N) numpy matrices."""
    peak = np.abs(cov).max()
    sym = float(np.max(np.abs(cov - cov.transpose(0, 2, 1))) / peak)
    eig = float(min(np.linalg.eigvalsh(c).min() / np.abs(c).max()
                    for c in cov))
    return sym, eig


def phases_29_31(*, lap, tomo_raw):
    """Phases 29-31, the rest of the covariance stack in float64: the
    curved-sky joint matrices on the two-cap pixel footprint, exact-z
    covariance (anchors and per-node rebuilds), and the kappa_CMB probes
    of the DES Y3-like cell flat and curved, against
    tests/data/torch_cov_more_reference.json.  Returns the launch counts
    by path, the builds to profile and kernel A's record at the anchors'
    response rows."""
    import torch

    from chomp_tpu_torch import (DNdzGaussian, covariance, curved,
                                 default_cosmo, default_halo, default_hod,
                                 halo, projection, ssc)
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.ops import halo_contract as hc
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import Nuisance3x2pt, broadcast_cosmo

    dev, f64 = cuda(), torch.float64
    ref = json.loads((REPO / "tests" / "data"
                      / "torch_cov_more_reference.json").read_text())
    paths, busy = {}, []
    st = Statics(DEFAULT_GRID, device=dev, dtype=f64)
    st_cpu = Statics(DEFAULT_GRID, device="cpu", dtype=f64)
    n_b = 64
    o_all = np.linspace(0.24, 0.32, n_b)
    s_all = np.linspace(0.75, 0.88, n_b)
    gate = 1e-9
    gap27 = json.loads((REPO / "tests" / "data" / "torch_cov_reference.json")
                       .read_text())["chip_joint"]["batch_vs_scalar_gap"]
    two_a = {"halo_contract": 2, "df_contract": 0, "hankel_matmul": 0}

    def batch_of(idx, device):
        kw = dict(device=device, dtype=f64)
        return broadcast_cosmo(default_cosmo(**kw), omega_m0=o_all[idx],
                               omega_l0=1.0 - o_all[idx],
                               sigma_8=s_all[idx])

    def check_rows(block, idx):
        if not np.allclose(block["omega_m0"], o_all[np.asarray(idx)]):
            fail("covariance reference file does not match the phase's "
                 "cosmologies")

    def gauss_of(spec, kw):
        return DNdzGaussian(*(torch.tensor(float(spec[k]), **kw) for k in
                              ("z_min", "z_max", "z0", "sigma_z")))

    def gated(label, checks):
        for name, val, g in checks:
            if not val <= g:
                fail(f"{label} {name}: {val} (gate {g})")

    # -- 29. the curved-sky joint covariances on the two-cap footprint ----
    cc = ref["curved_cell"]
    t0 = time.perf_counter()
    mask = curved.PixelSphereMask(two_cap_weight_map(
        cc["n_ring"], cc["n_phi"], cc["cap_radius_deg"], cc["cap2_center"]))
    mask_s = time.perf_counter() - t0
    ell_max = cc["ell_max"]
    split = curved._auto_ell_split(mask, ell_max)
    t0 = time.perf_counter()
    curved._xi_matrices(mask, split, curved._XI_KINDS)
    xi_s = time.perf_counter() - t0
    edges_c = np.asarray(cc["edges_deg"])
    nb_c = len(edges_c) - 1

    def curved_of(builder, device, st_, idx, mask_=mask, **opts):
        kw = dict(device=device, dtype=f64)
        lens, src = gauss_of(cc["lens"], kw), gauss_of(cc["src"], kw)
        b = batch_of(idx, device)
        hp, hod = default_halo(**kw), default_hod(**kw)
        z = torch.tensor([cc["z_model"]], **kw)
        base = dict(include_nongaussian=True, include_ssc=True,
                    psd_guard="clip", ell_max=ell_max)
        base.update(opts)
        fn = getattr(curved, builder)

        def run():
            model = halo.build_halo_model(b, hp, hod, z, st_)
            return fn(b, hp, model, lens, src, edges_c, cc["n2d"],
                      cc["shape_noise"], mask_, st=st_, **base)
        return run

    joint_b, x3_b = ("curved_joint_wtheta_gammat_covariance",
                     "curved_joint_3x2pt_covariance")
    all_idx = np.arange(n_b)
    cov_jc, launch_jc, peak_jc, wall_jc, run_jc = cov_timed(
        curved_of(joint_b, dev, st, all_idx))
    cov_xc, launch_xc, peak_xc, wall_xc, run_xc = cov_timed(
        curved_of(x3_b, dev, st, all_idx))
    rj, rx = ref["chip_curved_joint"], ref["chip_curved_3x2pt"]
    idx_c = np.asarray(rj["indices"])
    check_rows(rj, idx_c)
    check_rows(rx, idx_c)
    raw_jc = cov_counted(curved_of(joint_b, dev, st, idx_c,
                                   psd_guard=None))[0].cpu().numpy()
    raw_xc = cov_counted(curved_of(x3_b, dev, st, idx_c,
                                   psd_guard=None))[0].cpu().numpy()
    # The committed values are eager scalar JAX: the raw matrices are held
    # to them at 1e-9; JAX's own jit(vmap)-vs-scalar gap is information.
    gap_c = rj["batch_vs_scalar_gap"]
    err_jc = cov_blocks_err(raw_jc, np.asarray(rj["cov_raw"]), nb_c)
    err_xc = cov_blocks_err(raw_xc, np.asarray(rx["cov_raw"]), nb_c)
    corner = cov_blocks_err(raw_xc[:, :2 * nb_c, :2 * nb_c], raw_jc, nb_c)
    uni = curved.UniformSphereMask()
    g_opts = dict(include_nongaussian=False, include_ssc=False,
                  psd_guard=None)
    g_card = cov_counted(curved_of(joint_b, dev, st, idx_c, uni,
                                   **g_opts))[0].cpu().numpy()
    with torch.no_grad():
        g_cpu = curved_of(joint_b, "cpu", st_cpu, idx_c, uni,
                          **g_opts)().numpy()
    err_gc = cov_blocks_err(g_card, g_cpu, nb_c)
    cj, cx = cov_jc.cpu().numpy(), cov_xc.cpu().numpy()
    sym_jc, eig_jc = sym_and_eig(cj)
    sym_xc, eig_xc = sym_and_eig(cx)
    busy += [("curved joint w + gamma_t covariance", run_jc, wall_jc * 1e3,
              n_b),
             ("curved 3x2pt covariance", run_xc, wall_xc * 1e3, n_b)]
    paths["curved_joint_covariance"] = launch_jc
    paths["curved_3x2pt_covariance"] = launch_xc
    print(f"[curved covariance] examples/curved_sky_example.py's two 20-deg "
          f"caps ({cc['n_ring']} x {cc['n_phi']} PixelSphereMask, fsky "
          f"{mask.area2 / (4 * np.pi):.3f}), its dN/dz, edges "
          f"{edges_c.tolist()} deg, n2d {cc['n2d']:g}, shape noise "
          f"{cc['shape_noise']:g}, DEFAULT_GRID, ell_max {ell_max} "
          f"(ell_split {split}), cNG + curved SSC + clip, float64, B={n_b} "
          f"| static geometry on the host: mask {mask_s:.2f} s, Xi "
          f"{xi_s:.2f} s | against JAX raw (rows {idx_c.tolist()}): joint "
          f"{err_jc:.3e}, 3x2pt {err_xc:.3e} (gate {gate:.0e}; JAX's own "
          f"jit(vmap)-vs-scalar gap {gap_c:.3e}) | 3x2pt "
          f"[w, gt] corner vs joint {corner:.3e} (gate 1e-10) | "
          f"UniformSphereMask Gaussian-only card vs CPU plain {err_gc:.3e} "
          f"(gate 1e-12) | clipped: symmetry {sym_jc:.1e} / {sym_xc:.1e}, "
          f"least eigenvalue / peak {eig_jc:.2e} / {eig_xc:.2e} | launches "
          f"{launch_jc} / {launch_xc} | wall {wall_jc:.3f} / {wall_xc:.3f} s "
          f"(median of 3) = {wall_jc / n_b * 1e3:.2f} / "
          f"{wall_xc / n_b * 1e3:.2f} ms per cosmology, peak {peak_jc:.2f} "
          f"/ {peak_xc:.2f} GiB above the earlier phases'", flush=True)
    for c, n in ((cj, 2), (cx, 4)):
        if not np.all(np.isfinite(c)) or c.shape != (n_b, n * nb_c,
                                                     n * nb_c):
            fail(f"curved covariance: shape {c.shape} or non-finite")
    for launches_b in (launch_jc, launch_xc):
        if launches_b != two_a:
            fail(f"curved covariance launches {launches_b}: want kernel A "
                 f"twice (the lattice C_ell, the SSC responses)")
    gated("curved covariance", (
        ("joint vs JAX", err_jc, gate), ("3x2pt vs JAX", err_xc, gate),
        ("3x2pt corner vs joint", corner, 1e-10),
        ("Gaussian-only card vs CPU", err_gc, 1e-12),
        ("joint symmetry", sym_jc, 1e-12), ("3x2pt symmetry", sym_xc, 1e-12),
        ("joint least eigenvalue", -eig_jc, 1e-10),
        ("3x2pt least eigenvalue", -eig_xc, 1e-10)))
    lap("29")

    # -- 30. exact-z covariance ----------------------------------------------
    jc_ = ref["joint_cell"]
    ra, rp = ref["chip_exactz_anchors"], ref["chip_exactz_pernode"]
    n_anchor = ra["j"]
    per_sr = (180.0 * 60.0 / np.pi) ** 2
    omega = jc_["area_deg2"] * (np.pi / 180.0) ** 2
    n2d_j = jc_["lens_n_arcmin2"] * per_sr
    sn_j = jc_["sigma_e"] ** 2 / (jc_["src_n_arcmin2"] * per_sr)
    edges_j = np.asarray(jc_["edges_deg"])
    nb_j = len(edges_j) - 1

    def exact_of(device, st_, idx, **opts):
        kw = dict(device=device, dtype=f64)
        lens, src = gauss_of(jc_["lens"], kw), gauss_of(jc_["src"], kw)
        b = batch_of(idx, device)
        hp, hod = default_halo(**kw), default_hod(**kw)
        z = torch.tensor([jc_["z_model"]], **kw)
        base = dict(include_nongaussian=True, include_ssc=True,
                    psd_guard="clip")
        base.update(opts)

        def run():
            model = halo.build_halo_model(b, hp, hod, z, st_)
            return covariance.joint_wtheta_gammat_covariance(
                b, hp, model, lens, src, edges_j, omega, float(n2d_j),
                float(sn_j), st=st_, **base)
        return run

    anchors = dict(exact_z_anchors=n_anchor)
    cov_a, launch_a, peak_a, wall_a, run_a = cov_timed(
        exact_of(dev, st, all_idx, **anchors))
    idx_a = np.asarray(ra["indices"])
    check_rows(ra, idx_a)
    raw_a = cov_counted(exact_of(dev, st, idx_a, psd_guard=None,
                                 **anchors))[0].cpu().numpy()
    err_a = cov_blocks_err(raw_a, np.asarray(ra["cov_raw"]), nb_j)
    idx8 = np.unique(np.linspace(0, n_b - 1, 8).round()).astype(int)
    pernode = dict(exact_z=True, include_ssc=False, psd_guard=None)
    cov_p, launch_p, peak_p, wall_p, run_p = cov_timed(
        exact_of(dev, st, idx8, **pernode), reps=1)
    cov_p = cov_p.cpu().numpy()
    gauss8 = cov_counted(exact_of(
        dev, st, idx8, include_nongaussian=False, include_ssc=False,
        psd_guard=None))[0].cpu().numpy()
    anc8 = cov_counted(exact_of(dev, st, idx8, include_ssc=False,
                                psd_guard=None, **anchors))[0].cpu().numpy()
    # The anchors against the per-node rebuilds: the connected parts,
    # each block relative to the per-node block's peak.
    err_ap = cov_blocks_err(anc8 - gauss8, cov_p - gauss8, nb_j)
    idx_p = np.asarray(rp["indices"])
    check_rows(rp, idx_p)
    row_p = [int(np.nonzero(idx8 == i)[0][0]) for i in idx_p]
    err_p = cov_blocks_err(cov_p[row_p], np.asarray(rp["cov_raw"]), nb_j)
    ca = cov_a.cpu().numpy()
    sym_a, eig_a = sym_and_eig(ca)
    busy += [("exact-z anchors covariance", run_a, wall_a * 1e3, n_b),
             ("exact-z per-node covariance", run_p, wall_p * 1e3,
              len(idx8))]
    paths["exact_z_covariance"] = launch_a
    paths["exact_z_pernode_covariance"] = launch_p

    # Kernel A at the anchors' response rows (B x J at the 128 k of
    # n_k_ssc), float64 against its plain version; A's time there.
    kw = dict(device=dev, dtype=f64)
    b_all = batch_of(all_idx, dev)
    hp64 = default_halo(**kw)
    model64 = halo.build_halo_model(b_all, hp64, default_hod(**kw),
                                    torch.tensor([jc_["z_model"]], **kw), st)
    win = [projection.WindowGalaxy(dist=gauss_of(jc_["lens"], kw))]
    span = covariance._anchor_span(win)
    memo = covariance._Memo()
    rows, hp_rows, rebuilt = covariance._anchor_models(
        b_all, hp64, [model64], (span,), n_anchor, st, memo)
    mat_r, gal_r = halo.contraction_nodes(rows, hp_rows, rebuilt[0])
    k_ssc = ssc._k_ssc(128, st)[2]
    got_r = hc.halo_contract(k_ssc, mat_r, gal_r, st.cheb)
    sub = slice(0, 8)
    err_r = rel_to_peak(got_r[sub], hc.halo_contract_ref(
        k_ssc, mat_r[sub], gal_r[sub]))
    abs_r = float((got_r[sub] - hc.halo_contract_ref(
        k_ssc, mat_r[sub], gal_r[sub])).abs().max())
    ms_r, plain_ms_r = in_turns_ms(
        lambda: hc.halo_contract(k_ssc, mat_r, gal_r, st.cheb),
        lambda: hc.halo_contract_ref(k_ssc, mat_r[sub], gal_r[sub]),
        reps=20, other_reps=1)
    bound_r = bound(halo_contract_flops(k_ssc, mat_r, gal_r,
                                        hc._lens(f64), hc.n_moments(f64)),
                    8 * (k_ssc.numel() + mat_r.numel() + gal_r.numel()
                         + st.cheb.numel() + hc.N_OUT * mat_r.shape[0]
                         * k_ssc.numel()))
    a_rows = {"rows": int(mat_r.shape[0]), "nk": int(k_ssc.numel()),
              "dtype": "float64", "max_abs_err": abs_r, "ms": ms_r,
              "plain_ms": plain_ms_r, "plain_rows": 8,
              "bound_ms": bound_r[0], "bound_by": bound_r[1],
              "device_ms": device_ms(lambda: hc.halo_contract(
                  k_ssc, mat_r, gal_r, st.cheb), 20)}
    print(f"[exact-z covariance] phase 27's survey with exact_z_anchors="
          f"{n_anchor} on the connected and super-sample terms, B={n_b}: "
          f"launches {launch_a} | against JAX raw (rows {idx_a.tolist()}): "
          f"{err_a:.3e} (gate {gate:.0e}; phase 27's JAX jit(vmap)-vs-scalar "
          f"gap {gap27:.3e}) | clipped: symmetry {sym_a:.1e}, "
          f"least eigenvalue / peak {eig_a:.2e} | wall {wall_a:.3f} s "
          f"(median of 3) = {wall_a / n_b * 1e3:.2f} ms per cosmology, peak "
          f"{peak_a:.2f} GiB | exact_z=True (the table route's 24 GL nodes "
          f"rebuilt in chunks of {covariance._NODE_ROWS} rows, no SSC), "
          f"B={len(idx8)}: launches {launch_p}, wall {wall_p:.3f} s (one "
          f"call), peak {peak_p:.2f} GiB, against JAX {err_p:.3e} (gate "
          f"{gate:.0e}, rows {idx_p.tolist()}) | anchors vs per-node, "
          f"connected blocks: {err_ap:.3e} of each block's peak "
          f"(gate 5e-3) | kernel A at the anchors' {a_rows['rows']} "
          f"response rows x {a_rows['nk']} k, float64: vs plain (8 rows) "
          f"{err_r:.2e} of peak (gate 1e-12), {ms_r:.4f} ms (events), "
          f"device {fmt_ms(a_rows['device_ms'])}, bound "
          f"{bound_r[0]:.4f} ms ({bound_r[1]}), plain {plain_ms_r:.1f} ms "
          f"(8 rows)", flush=True)
    if not (np.all(np.isfinite(ca)) and np.all(np.isfinite(cov_p))):
        fail("exact-z covariance: non-finite")
    if launch_a != two_a:
        fail(f"exact-z covariance launches {launch_a}: want kernel A twice "
             f"(the lattice C_ell, the anchors' responses in one launch)")
    if launch_p != {"halo_contract": 1, "df_contract": 0,
                    "hankel_matmul": 0}:
        fail(f"exact-z per-node launches {launch_p}: want kernel A once")
    gated("exact-z covariance", (
        ("anchors vs JAX", err_a, gate),
        ("per-node vs JAX", err_p, gate),
        ("anchors vs per-node", err_ap, 5e-3), ("symmetry", sym_a, 1e-12),
        ("least eigenvalue", -eig_a, 1e-10),
        ("kernel A at the anchor rows vs plain", err_r, 1e-12)))
    lap("30")

    # -- 31. kappa_CMB on the DES Y3-like cell, flat and curved --------------
    tc, sv = ref["tomo_cell"], ref["des_y3_survey"]
    nu_ref = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())[
        "nuisance"]
    t_edges = np.asarray(ref["des_theta_edges_deg"])
    nb_t = len(t_edges) - 1
    cap = curved.SphericalCapMask(float(np.arccos(
        1.0 - sv["area_deg2"] * (np.pi / 180.0) ** 2 / (2.0 * np.pi))))

    def cmb_of(n_l, n_s, idx, curved_sky=False, **opts):
        kw = dict(device=dev, dtype=f64)

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
        om, n2d_t, sn_t = survey_numbers(
            sv["area_deg2"], sv["lens_n_arcmin2"][:n_l],
            sv["src_n_eff_arcmin2"][:n_s], sv["src_sigma_e"][:n_s])
        per_bin = {"dz_lens": n_l, "alpha_lens": n_l, "dz_src": n_s,
                   "m": n_s}
        nu = Nuisance3x2pt(**{
            k: torch.tensor(v[:per_bin[k]] if k in per_bin else v, **kw)
            for k, v in nu_ref.items()})
        b = batch_of(idx, dev)
        hp = default_halo(**kw)
        z = torch.tensor([tc["z_pivot"]], **kw)
        base = dict(include_nongaussian=True, include_ssc=True,
                    psd_guard="clip", nuisance=nu,
                    include_magnification=True, cmb_lensing=True)
        base.update(opts)

        def run():
            models = halo.build_halo_models(b, hp, hods, z, st)
            if curved_sky:
                return curved.curved_tomographic_3x2pt_covariance(
                    b, hp, models, lens, src, t_edges, n2d_t.tolist(),
                    sn_t.tolist(), cap, st=st, **base)
            return covariance.tomographic_3x2pt_covariance(
                b, hp, models, lens, src, t_edges, om, n2d_t.tolist(),
                sn_t.tolist(), st=st, **base)
        return run

    rf, rcv = ref["chip_cmb_flat"], ref["chip_cmb_curved"]
    idx_k = np.asarray(rf["indices"])
    check_rows(rf, idx_k)
    check_rows(rcv, idx_k)
    n_l, n_s = rf["bins"]
    sub_f = cov_counted(cmb_of(n_l, n_s, idx_k, psd_guard=None))[0]
    sub_c = cov_counted(cmb_of(n_l, n_s, idx_k, True, psd_guard=None))[0]
    err_kf = cov_blocks_err(sub_f.cpu().numpy(), np.asarray(rf["cov_raw"]),
                            nb_t)
    err_kc = cov_blocks_err(sub_c.cpu().numpy(), np.asarray(rcv["cov_raw"]),
                            nb_t)
    # The tomographic builders' anchored route on the same runs: every
    # super-sample block's anchor span is primed at once, so kernel A runs
    # twice (the lattice C_ell, every span's and sample's responses).
    anc_k, launch_ak = cov_counted(cmb_of(
        n_l, n_s, idx_k, psd_guard=None, exact_z_anchors=6,
        ssc_kwargs=dict(exact_z_anchors=6)))
    anc_k = anc_k.cpu().numpy()
    sym_ak = sym_and_eig(anc_k)[0]
    sub_np = sub_f.cpu().numpy()
    move_ak = float(np.abs(anc_k - sub_np).max() / np.abs(sub_np).max())
    full_f = cov_counted(cmb_of(5, 4, idx_k[:1], psd_guard=None))[0]
    full_f = full_f.cpu().numpy()[0]
    n_old = tomo_raw.shape[-1]
    ext = cov_blocks_err(full_f[None, :n_old, :n_old], tomo_raw[None], nb_t)
    cf1, launch_f1, peak_f1, wall_f1, run_f1 = cov_timed(
        cmb_of(5, 4, idx_k[:1]))
    cf8, launch_f8, peak_f8, wall_f8, run_f8 = cov_timed(
        cmb_of(5, 4, idx8))
    ccv, launch_c1, peak_c1, wall_c1, run_c1 = cov_timed(
        cmb_of(5, 4, idx_k[:1], True))
    n_probe = len(covariance.tomographic_probes(5, 4, cmb_lensing=True))
    sym_f, eig_f = sym_and_eig(cf8.cpu().numpy())
    sym_c, eig_c = sym_and_eig(ccv.cpu().numpy())
    busy += [("kappa_CMB tomographic covariance", run_f1, wall_f1 * 1e3, 1),
             ("kappa_CMB tomographic covariance", run_f8, wall_f8 * 1e3,
              len(idx8)),
             ("kappa_CMB curved tomographic covariance", run_c1,
              wall_c1 * 1e3, 1)]
    paths["cmb_tomographic_covariance"] = launch_f8
    paths["cmb_curved_tomographic_covariance"] = launch_c1
    print(f"[kappa_CMB covariance] phase 28's cell with cmb_lensing=True: "
          f"{n_probe} probes, a {n_probe * nb_t} x {n_probe * nb_t} matrix, "
          f"Gaussian + cNG + SSC + clip, flat and on a SphericalCapMask of "
          f"{sv['area_deg2']:g} deg^2 | {n_l} x {n_s} + kappa runs against "
          f"JAX raw (row {idx_k.tolist()}): flat {err_kf:.3e}, curved "
          f"{err_kc:.3e} (gate {gate:.0e}; phase 27's JAX jit(vmap)-vs-"
          f"scalar gap {gap27:.3e}) | flat raw without its wgk rows "
          f"vs phase 28's raw: {ext:.3e} (gate 1e-10) | {n_l} x {n_s} + "
          f"kappa flat with exact_z_anchors=6 on cNG and SSC: launches "
          f"{launch_ak}, symmetry {sym_ak:.1e}, moves the separable matrix "
          f"by {move_ak:.3e} of its peak | clipped: symmetry "
          f"{sym_f:.1e} / {sym_c:.1e}, least eigenvalue / peak {eig_f:.2e} "
          f"(flat B=8) / {eig_c:.2e} (curved) | launches flat B=1 "
          f"{launch_f1}, B=8 {launch_f8}, curved {launch_c1} | wall flat "
          f"B=1 {wall_f1:.3f} s, B=8 {wall_f8:.3f} s "
          f"({wall_f8 / len(idx8) * 1e3:.1f} ms per cosmology), curved B=1 "
          f"{wall_c1:.3f} s (medians of 3) | peak flat {peak_f1:.2f} / "
          f"{peak_f8:.2f} GiB, curved {peak_c1:.2f} GiB", flush=True)
    for c in (cf8, ccv, torch.from_numpy(anc_k)):
        if not torch.all(torch.isfinite(c)):
            fail("kappa_CMB covariance: non-finite")
    for launches_b in (launch_f1, launch_f8, launch_c1, launch_ak):
        if launches_b != two_a:
            fail(f"kappa_CMB covariance launches {launches_b}: want kernel "
                 f"A twice (every pack's lattice spectra, every sample's "
                 f"SSC responses)")
    gated("kappa_CMB covariance", (
        ("flat 2x2 + kappa vs JAX", err_kf, gate),
        ("curved 2x2 + kappa vs JAX", err_kc, gate),
        ("flat without wgk vs phase 28", ext, 1e-10),
        ("flat symmetry", sym_f, 1e-12), ("curved symmetry", sym_c, 1e-12),
        ("anchored flat symmetry", sym_ak, 1e-12),
        ("flat least eigenvalue", -eig_f, 1e-10),
        ("curved least eigenvalue", -eig_c, 1e-10)))
    lap("31")
    return {"paths": paths, "busy": busy, "anchor_rows": a_rows}


def once_ms(fn):
    """(fn(), host-clock ms of that one call between synchronizations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def median_wall(fn, reps=3):
    """Median host-clock seconds of ``fn()`` between synchronizations."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA GPU")
    sys.path.insert(0, str(REPO))
    from chomp_tpu_torch import (DNdzGaussian, background, default_cosmo,
                                 default_halo, default_hod, halo, limber_fft,
                                 projection)
    from chomp_tpu_torch.grids import Statics
    from chomp_tpu_torch.ops import build, df32, halo_contract as hc, tiles
    from chomp_tpu_torch.ops import hankel_matmul as hm
    from chomp_tpu_torch.params import DEFAULT_GRID
    from chomp_tpu_torch.parallel.sweep import broadcast_cosmo, make_pipeline

    dev = torch.device("cuda", 0)
    f32, f64 = torch.float32, torch.float64
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    builds = build.build_all(["halo_contract", "df_contract",
                              "hankel_matmul"])
    smem = {"df_contract": df32._lib().df_contract_smem_bytes,
            "hankel_matmul": hm._lib().hankel_matmul_smem_bytes}
    for name, (path, log) in builds.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        dyn = (f" | dynamic shared memory f32 {smem[name](0)} B, f64 "
               f"{smem[name](1)} B" if name in smem else "")
        print(f"[build] {name}: {path.name} | {' ; '.join(regs)}{dyn}",
              flush=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s (in parallel)",
          flush=True)
    t_lap = [time.perf_counter()]

    def lap(phase):
        """Print the seconds since the last lap (or the build)."""
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    oms = np.linspace(0.24, 0.32, N_COSMO)
    s8s = np.linspace(0.75, 0.88, N_COSMO)
    check = np.unique(np.linspace(0, N_COSMO - 1, N_CHECK).round()
                      ).astype(int)

    # -- 2. kernel A ----------------------------------------------------
    def model_for(dtype, idx=None, feedback=False):
        st = Statics(DEFAULT_GRID, device=dev, dtype=dtype)
        batch, hp, hod, dist = setup(dtype, idx, feedback)
        z = torch.ones(1, device=dev, dtype=dtype)
        return st, batch, hp, dist, halo.build_halo_model(batch, hp, hod, z,
                                                          st)

    def nodes(dtype, idx=None, feedback=False):
        st, batch, hp, dist, model = model_for(dtype, idx, feedback)
        mat, gal = halo.contraction_nodes(batch, hp, model)
        return st, mat, gal

    st64, mat64, gal64 = nodes(f64, check)
    st32, mat32, gal32 = nodes(f32)
    k32, k64 = st32.lattice_k, st64.lattice_k
    _, matf64, galf64 = nodes(f64, check, feedback=True)
    _, matf32, galf32 = nodes(f32, feedback=True)
    cheb32, cheb64 = st32.cheb, st64.cheb
    sets_a = {
        "main": check_a(k32, mat32, gal32, k64, mat64, gal64, cheb32,
                        cheb64),
        "feedback": check_a(k32, matf32, galf32, k64, matf64, galf64,
                            cheb32, cheb64)}
    # The ragged case: 1000 k (the lattice's every third, so the k tile
    # and node tiles end part-full), 37 mass nodes (every seventh) and 5
    # galaxy nodes (every fiftieth from the 26th: the lightest carry no
    # galaxies, so their outputs are 0).
    kr32, kr64 = (kk[::3][:1000].contiguous() for kk in (k32, k64))
    sets_a["ragged"] = check_a(
        kr32, mat32[:, ::7].contiguous(), gal32[:, 25::50].contiguous(),
        kr64, mat64[:, ::7].contiguous(), gal64[:, 25::50].contiguous(),
        cheb32, cheb64)
    # 100 back-to-back launches of the kernel, twice; 1 of its plain
    # version (2.2 s a call) before them.
    ms_a, plain_ms_a = in_turns_ms(
        lambda: hc.halo_contract(k32, mat32, gal32, cheb32),
        lambda: hc.halo_contract_ref(k32, mat32, gal32), other_reps=1,
        other_turns=1)
    ms_a_fb = events_ms(lambda: hc.halo_contract(k32, matf32, galf32,
                                                 cheb32))
    # Device times (torch.profiler) are taken after phase 7: a profiler
    # session leaves CUPTI attached, which slows every later launch from
    # the host and would inflate the walls and event times that follow.
    profiled = {
        "halo_contract": (lambda: hc.halo_contract(k32, mat32, gal32,
                                                   cheb32), None, 5),
        "halo_contract feedback": (lambda: hc.halo_contract(
            k32, matf32, galf32, cheb32), None, 5),
        "halo_contract table k": (lambda: hc.halo_contract(
            st32.k_table, mat32, gal32, cheb32), None, 5)}

    bound_a = bound_a_of(k32, mat32, gal32)
    bound_a_fb = bound_a_of(k32, matf32, galf32)
    bound_a_tab = bound_a_of(st32.k_table, mat32, gal32)
    abs_a32 = sets_a["main"]["abs"]
    for name, q in sets_a.items():
        print(f"[halo_contract] {name}: f64 rel_to_peak={q['f64']:.3e} (8 "
              f"cosmologies, gate 1e-12) | f32 vs plain version on the "
              f"same inputs in f64: rel_to_peak={q['f32']:.3e} max_abs="
              f"{q['abs']:.3e} (gate 2e-6, and <= 1.5x the plain f32 "
              f"version's own {q['plain32']:.3e}) | f32 vs plain f32 "
              f"{q['vs_plain32']:.3e} | deterministic={q['same']}",
              flush=True)
    print(f"[halo_contract] B={N_COSMO} NK={k32.numel()} NM="
          f"{mat32.shape[1]} NG={gal32.shape[1]} float32 | kernel "
          f"{ms_a:.3f} ms (feedback set {ms_a_fb:.3f} ms), plain "
          f"{plain_ms_a:.3f} ms (CUDA events over back-to-back calls) | "
          f"bound {bound_a[0]:.4f} ms by {bound_a[1]} (feedback set "
          f"{bound_a_fb[0]:.4f} ms, table k {bound_a_tab[0]:.4f} ms)",
          flush=True)
    for kname, kk in (("lattice", k32), ("table", st32.k_table)):
        for sname, (m, g) in (("main", (mat32, gal32)),
                              ("feedback", (matf32, galf32))):
            mix, same, cx_max = branch_mix(kk, m, g)
            print(f"[halo_contract] branch mix, {kname} k ({kk.numel()}), "
                  f"{sname} nodes: " + ", ".join(
                      f"{n} {v:.4f}" for n, v in mix.items())
                  + f" | galaxy nodes with one profile {same:.3f} | max "
                  f"|cx| {cx_max:.4g}", flush=True)
    for name, q in sets_a.items():
        if not q["f64"] <= 1e-12:
            fail(f"halo_contract {name}: float64 error {q['f64']}")
        if not q["f32"] <= 2e-6:
            fail(f"halo_contract {name}: float32 error {q['f32']}")
        if not q["f32"] <= 1.5 * q["plain32"]:
            fail(f"halo_contract {name}: float32 error {q['f32']} above "
                 f"1.5x the plain float32 version's {q['plain32']}")
        if not q["same"]:
            fail(f"halo_contract {name}: two launches differ")

    lap("2")

    # -- 3. kernel C ----------------------------------------------------
    theta = tuple(np.logspace(-3, 0, 64).tolist())
    j_lo, j_hi, a_np = limber_fft.wtheta_lattice_operator(
        theta, DEFAULT_GRID, 0.0)

    def ref_rows(c, a_hi, a_lo=None, step=1024):
        """Kernel C's plain version in blocks of ``step`` rows (its (rows,
        T, K) products would not fit the card at the tomographic rows)."""
        return torch.cat([df32.df_contract_ref(c[i:i + step], a_hi, a_lo)
                          for i in range(0, c.shape[0], step)])

    def check_c(c64, a_np, with_f64=True):
        """Kernel C on c64 (R, n) and the operator a_np (T, n): float64
        and float32 against the plain version (relative to the peak),
        float32 against the exact contraction of its inputs, and two
        launches on the same inputs bit for bit."""
        a64 = torch.tensor(a_np, device=dev)
        hi, lo = (torch.tensor(x, device=dev)
                  for x in df32.split_operator(a_np))
        c32 = c64.to(f32)
        got = df32.df_contract(c32, hi, lo)
        ref, plain_ms = once_ms(lambda: ref_rows(c32, hi, lo))
        exact = c32.double() @ a64.T
        r = {"abs": float((got - ref).abs().max()), "plain_ms": plain_ms,
             "exact": float((got.double() - exact).abs().max()
                            / exact.abs().max()),
             "same": torch.equal(got, df32.df_contract(c32, hi, lo)),
             "f64": 0.0}
        r["plain"] = r["abs"] / float(ref.abs().max())
        if with_f64:
            got = df32.df_contract(c64, a64)
            ref = ref_rows(c64, a64)
            r["f64"] = float((got - ref).abs().max() / ref.abs().max())
            r["same"] &= torch.equal(got, df32.df_contract(c64, a64))
        return r

    rng = np.random.default_rng(0)
    c64 = torch.tensor(rng.lognormal(0.0, 1.0, (N_COSMO, j_hi - j_lo)),
                       device=dev)
    main_c = check_c(c64, a_np)
    # The hostile-cancellation case of tests/test_df32.py: float32 to
    # < 5e-6 against float64 where a plain float32 matmul loses ~1e-2.
    rng = np.random.default_rng(1)
    n, m = 1024, 8
    hc64 = rng.lognormal(0.0, 2.0, n)
    ha64 = rng.normal(0.0, 1.0, (m, n))
    w_true = ha64 @ hc64
    ha64 -= np.outer(w_true / (hc64 @ hc64) * 0.9999, hc64)
    hc32 = hc64.astype(np.float32)
    h_ref = ha64 @ hc32.astype(np.float64)
    h_hi, h_lo = df32.split_operator(ha64)
    h_got = df32.df_contract(torch.tensor(hc32[None], device=dev),
                             torch.tensor(h_hi, device=dev),
                             torch.tensor(h_lo, device=dev))
    hostile = worst_bin(h_got[0].double().cpu().numpy(), h_ref)
    plain32 = torch.tensor(hc32[None], device=dev) @ torch.tensor(
        ha64.astype(np.float32), device=dev).T
    hostile_plain = worst_bin(plain32[0].double().cpu().numpy(), h_ref)
    ragged_c = {  # (rows, n, T) -> check_c
        (8, j_hi - j_lo, a_np.shape[0]): check_c(c64[:8].contiguous(), a_np),
        (1, n, m): check_c(torch.tensor(hc32[None].astype(np.float64),
                                        device=dev), ha64, with_f64=False)}

    c32 = c64.to(f32)
    a64 = torch.tensor(a_np, device=dev)
    a_hi, a_lo = (torch.tensor(x, device=dev)
                  for x in df32.split_operator(a_np))
    c32_as64 = c32.double()
    ms_c, lib_ms_c = in_turns_ms(lambda: df32.df_contract(c32, a_hi, a_lo),
                                 lambda: c32_as64 @ a64.T)
    plain_ms_c = events_ms(lambda: df32.df_contract_ref(c32, a_hi, a_lo), 20)
    profiled["df_contract"] = (lambda: df32.df_contract(c32, a_hi, a_lo),
                               lambda: c32_as64 @ a64.T, 20)
    r, n = c32.shape
    t = a_hi.shape[0]
    # The function is c @ (a_hi + a_lo)^T exact to float32 output: 2 flops
    # a term, whatever arithmetic a kernel uses to get there; each input
    # read once, the output written once.
    bound_c = bound(2.0 * r * n * t,
                    4 * (c32.numel() + a_hi.numel() + a_lo.numel() + r * t))
    print(f"[df_contract] ({r}, {n}) x ({t}, {n}) | f64 rel_to_peak="
          f"{main_c['f64']:.3e} (gate 1e-12) | f32 vs plain rel_to_peak="
          f"{main_c['plain']:.3e} max_abs={main_c['abs']:.3e} (gate 1e-6) | "
          f"f32 vs exact rel_to_peak={main_c['exact']:.3e} (gate 1e-7) | "
          f"hostile f32 worst={hostile:.3e} (gate 5e-6; plain f32 matmul "
          f"{hostile_plain:.3e}) | deterministic={main_c['same']} | f32 "
          f"kernel {ms_c:.4f} ms, library (f64 matmul) {lib_ms_c:.4f} ms, "
          f"plain {plain_ms_c:.4f} ms (CUDA events over 100 back-to-back "
          f"calls; plain 20) | bound {bound_c[0]:.5f} ms by {bound_c[1]} | "
          f"{geometry(r, n, t)}",
          flush=True)
    for (rr, nn, tt), q in ragged_c.items():
        print(f"[df_contract] ragged ({rr}, {nn}) x ({tt}, {nn}) | f64 "
              f"rel_to_peak={q['f64']:.3e} | f32 vs plain rel_to_peak="
              f"{q['plain']:.3e} | f32 vs exact rel_to_peak={q['exact']:.3e}"
              f" | deterministic={q['same']} | {geometry(rr, nn, tt)}",
              flush=True)
    for shape, q in [("main", main_c), *ragged_c.items()]:
        if not q["f64"] <= 1e-12:
            fail(f"df_contract {shape}: float64 error {q['f64']}")
        if not q["plain"] <= 1e-6:
            fail(f"df_contract {shape}: float32 vs its plain version: "
                 f"{q['plain']}")
        if not q["exact"] <= 1e-7:
            fail(f"df_contract {shape}: float32 vs the exact contraction: "
                 f"{q['exact']}")
        if not q["same"]:
            fail(f"df_contract {shape}: two launches differ")
    if not hostile < 5e-6:
        fail(f"df_contract hostile-cancellation error {hostile}")

    lap("3")

    # -- 4. convolution precision ---------------------------------------
    # The pipeline's own lattice rows (float64, 8 cosmologies), rounded
    # to float32: the comparison isolates the float32 accumulation.
    st, batch, hp, dist, model = model_for(f64, check)
    p_all = limber_fft.p_lattice_halo_all(batch, hp, model, st)
    wins = (projection.WindowGalaxy(dist), projection.WindowConvergence(dist))
    g_rows = limber_fft._lattice_g_rows(
        batch, [(wins[0], wins[0]), (wins[1], wins[0])], st,
        model.mass.growth)
    p32 = torch.stack([p_all["power_gg"], p_all["power_gm"]], 1).to(f32)
    g32 = g_rows.to(f32)
    n_k, n_chi = p32.shape[-1], g32.shape[-1]
    conv64 = limber_fft._conv_direct_rows(p32.double(), g32.double(),
                                          j_lo, j_hi)
    conv32 = limber_fft._conv_direct_rows(p32, g32, j_lo, j_hi)
    err_conv = float((conv32.double() / conv64 - 1.0).abs().max())
    del p_all, model
    p32 = p32.repeat(N_COSMO // len(check), 1, 1)
    g32 = g32.repeat(N_COSMO // len(check), 1, 1)
    conv_rows = p32, g32
    ms_conv = events_ms(lambda: limber_fft._conv_direct_rows(
        p32, g32, j_lo, j_hi), 5)
    print(f"[conv1d] ({len(check)}, 2, {n_k}) * ({len(check)}, 2, {n_chi}) "
          f"-> {j_hi - j_lo}, the pipeline's rows | float32 in/out, float64 "
          f"accumulation: worst rel={err_conv:.3e} (gate 1e-6) | "
          f"{ms_conv:.3f} ms at B={N_COSMO}", flush=True)
    if not err_conv <= 1e-6:
        fail(f"conv1d float32 error {err_conv}")

    lap("4")

    # -- 5. the slice ---------------------------------------------------
    batch, hp, hod, dist = setup(f32)
    pipe = make_pipeline(hp, hod, dist, power_spec="power_gg",
                         grid=DEFAULT_GRID, include_lensing=True,
                         z_pivot=1.0, device=dev, dtype=f32)
    kernels_of = {"halo_contract": hc.halo_contract,
                  "df_contract": df32.df_contract,
                  "hankel_matmul": hm.hankel_matmul}
    for fn in kernels_of.values():
        fn.launches = 0
    out = pipe(batch)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels_of.items()}
    w32 = out["w_theta"].double().cpu().numpy()
    g32 = out["gamma_t"].double().cpu().numpy()
    finite = bool(np.all(np.isfinite(w32)) and np.all(np.isfinite(g32)))
    shape_ok = w32.shape == g32.shape == (N_COSMO, DEFAULT_GRID.n_theta)

    batch64, hp64, hod64, dist64 = setup(f64, check)
    pipe64 = make_pipeline(hp64, hod64, dist64, power_spec="power_gg",
                           grid=DEFAULT_GRID, include_lensing=True,
                           z_pivot=1.0, device=dev, dtype=f64)
    with plain_path():
        out64 = pipe64(batch64)
    w64 = out64["w_theta"].cpu().numpy()
    g64 = out64["gamma_t"].cpu().numpy()
    err_plain = max(worst_bin(w32[check], w64), worst_bin(g32[check], g64))
    out64k = pipe64(batch64)
    err_k64 = max(worst_bin(out64k["w_theta"].cpu().numpy(), w64),
                  worst_bin(out64k["gamma_t"].cpu().numpy(), g64))

    ref = json.loads((REPO / "tests" / "data"
                      / "torch_slice_reference.json").read_text())
    idx = np.asarray(ref["indices"])
    if ref["n_cosmo"] != N_COSMO or not np.allclose(ref["omega_m0"],
                                                    oms[idx]):
        fail("reference file does not match this run's cosmologies")
    err_jax = max(worst_bin(w32[idx], ref["w_theta"]),
                  worst_bin(g32[idx], ref["gamma_t"]))
    both = [i for i, c in enumerate(check) if c in set(idx.tolist())]
    jpos = [idx.tolist().index(check[i]) for i in both]
    if not both:
        fail("no checked cosmology is in the reference file")
    err_jax64 = max(
        worst_bin(w64[both], np.asarray(ref["w_theta"])[jpos]),
        worst_bin(g64[both], np.asarray(ref["gamma_t"])[jpos]))

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    print(f"[slice] bench config A, DEFAULT_GRID, B={N_COSMO}, float32 | "
          f"launches {launches} | finite={finite} shape_ok={shape_ok} | "
          f"worst bin vs card f64 plain path={err_plain:.3e} (8 cosmologies"
          f", gate 1e-4) | vs JAX f64 reference={err_jax:.3e} (3 "
          f"cosmologies, gate 1e-4) | card f64 plain vs JAX f64="
          f"{err_jax64:.3e} (gate 1e-10) | card f64 kernels vs f64 plain="
          f"{err_k64:.3e} (gate 1e-12) | "
          f"wall median of 5 = {wall * 1e3:.1f} ms "
          f"({wall / N_COSMO * 1e3:.4f} ms/cosmology)", flush=True)
    if not (finite and shape_ok):
        fail("slice outputs not finite or of the wrong shape")
    if launches["halo_contract"] <= 0 or launches["df_contract"] <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    if not err_plain < 1e-4:
        fail(f"slice float32 vs float64 plain path: {err_plain}")
    if not err_jax < 1e-4:
        fail(f"slice float32 vs JAX float64 reference: {err_jax}")
    if not err_k64 <= 1e-12:
        fail(f"slice float64 through the kernels vs plain path: {err_k64}")
    if not err_jax64 <= 1e-10:
        fail(f"slice float64 plain path vs JAX float64 reference: "
             f"{err_jax64}")

    lap("5")

    # -- 6. kernel B ----------------------------------------------------
    # The table route's own C_ell rows (w: gg, gamma_t: kappa-g) of the
    # 512 cosmologies, float32, with the route's operators.
    pipe_t = make_pipeline(hp, hod, dist, power_spec="power_gg",
                           grid=DEFAULT_GRID, include_lensing=True,
                           z_pivot=1.0, method="table", device=dev,
                           dtype=f32)
    cosmo_t, model_t = pipe_t.halo_model(batch)
    tabs = projection.power_tables_halo(cosmo_t, pipe_t.halo_params, model_t,
                                        ("power_gg", "power_gm"), pipe_t.st)
    pairs = [(pipe_t.win_g, pipe_t.win_g, "power_gg", pipe_t.op0_t),
             (pipe_t.win_k, pipe_t.win_g, "power_gm", pipe_t.op1_t)]

    def check_b(cl, op_t):
        """Kernel B on cl (R, N) and op_t (N, T): float32 against the
        plain version (per element) and against the exact product of its
        inputs beside torch.matmul's float32 error, float64 against the
        plain version (relative to each row's peak), and two launches on
        the same inputs bit for bit."""
        got = hm.hankel_matmul(cl, op_t)
        plain = hm.hankel_matmul_ref(cl, op_t)
        exact = cl.double() @ op_t.double()
        cl64, op64 = cl.double(), op_t.double()
        got64 = hm.hankel_matmul(cl64, op64)
        return {"plain": max_rel(got, plain),
                "abs": float((got - plain).abs().max()),
                "exact": max_rel(got.double(), exact),
                "lib_exact": max_rel(plain.double(), exact),
                "f64": row_peak_rel(got64, hm.hankel_matmul_ref(cl64, op64)),
                "same": (torch.equal(got, hm.hankel_matmul(cl, op_t))
                         and torch.equal(got64,
                                         hm.hankel_matmul(cl64, op64)))}

    main_b = {}
    for wa, wb, kind, op_t in pairs:
        cl = projection.limber_cl(cosmo_t, wa, wb, pipe_t.ells, tabs[kind],
                                  pipe_t.st).contiguous()
        for key, v in check_b(cl, op_t).items():
            main_b[key] = (main_b.get(key, True) and v if key == "same"
                           else max(main_b.get(key, 0.0), v))
    cl_b, op_b = cl, op_t
    # Ragged shapes, cut from the route's own rows and operator.
    ragged_b = {(rr, nn, tt): check_b(cl_b[:rr, :nn].contiguous(),
                                      op_b[:nn, :tt].contiguous())
                for rr, nn, tt in ((37, 1000, 13), (1, 1024, 64))}
    ms_b, lib_ms_b = in_turns_ms(lambda: hm.hankel_matmul(cl_b, op_b),
                                 lambda: torch.matmul(cl_b, op_b))
    plain_ms_b = events_ms(lambda: hm.hankel_matmul_ref(cl_b, op_b))
    profiled["hankel_matmul"] = (lambda: hm.hankel_matmul(cl_b, op_b),
                                 lambda: torch.matmul(cl_b, op_b), 20)
    r, n = cl_b.shape
    t = op_b.shape[1]
    bound_b = bound(2.0 * r * n * t, 4 * (r * n + n * t + r * t))
    print(f"[hankel_matmul] ({r}, {n}) @ ({n}, {t}), the table route's C_ell "
          f"rows (w and gamma_t) | f64 rel_to_row_peak={main_b['f64']:.3e} "
          f"(gate 1e-12) | f32 vs plain max rel={main_b['plain']:.3e} "
          f"max_abs={main_b['abs']:.3e} (gate 2e-5) | f32 vs exact f64 "
          f"product max rel={main_b['exact']:.3e}, torch.matmul f32 "
          f"{main_b['lib_exact']:.3e} (gate 2x) | deterministic="
          f"{main_b['same']} | f32 kernel {ms_b:.4f} ms, library "
          f"(torch.matmul f32) {lib_ms_b:.4f} ms, plain {plain_ms_b:.4f} ms "
          f"(CUDA events over 100 back-to-back calls) | bound "
          f"{bound_b[0]:.5f} ms by {bound_b[1]} | {geometry(r, n, t)}",
          flush=True)
    for (rr, nn, tt), q in ragged_b.items():
        print(f"[hankel_matmul] ragged ({rr}, {nn}) @ ({nn}, {tt}) | f64 "
              f"rel_to_row_peak={q['f64']:.3e} | f32 vs plain max rel="
              f"{q['plain']:.3e} | f32 vs exact max rel={q['exact']:.3e}, "
              f"torch.matmul f32 {q['lib_exact']:.3e} | deterministic="
              f"{q['same']} | {geometry(rr, nn, tt)}", flush=True)
    for shape, q in [("main", main_b), *ragged_b.items()]:
        if not q["f64"] <= 1e-12:
            fail(f"hankel_matmul {shape}: float64 error {q['f64']}")
        if not q["plain"] <= 2e-5:
            fail(f"hankel_matmul {shape}: float32 vs its plain version: "
                 f"{q['plain']}")
        if not q["same"]:
            fail(f"hankel_matmul {shape}: two launches differ")
    if not main_b["exact"] <= 2.0 * main_b["lib_exact"]:
        fail(f"hankel_matmul float32 vs the exact product: "
             f"{main_b['exact']} (torch.matmul: {main_b['lib_exact']})")
    del tabs, cosmo_t, model_t

    lap("6")

    # -- 7. the table slice ---------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels_of.values():
        fn.launches = 0
    out_t = pipe_t(batch)
    torch.cuda.synchronize()
    launches_t = {name: fn.launches for name, fn in kernels_of.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wt32 = out_t["w_theta"].double().cpu().numpy()
    gt32 = out_t["gamma_t"].double().cpu().numpy()
    finite_t = bool(np.all(np.isfinite(wt32)) and np.all(np.isfinite(gt32)))
    shape_t = wt32.shape == gt32.shape == (N_COSMO, DEFAULT_GRID.n_theta)

    pipe_t64 = make_pipeline(hp64, hod64, dist64, power_spec="power_gg",
                             grid=DEFAULT_GRID, include_lensing=True,
                             z_pivot=1.0, method="table", device=dev,
                             dtype=f64)
    with plain_path():
        out_t64 = pipe_t64(batch64)
    wt64 = out_t64["w_theta"].cpu().numpy()
    gt64 = out_t64["gamma_t"].cpu().numpy()
    err_t_plain = max(worst_bin(wt32[check], wt64),
                      worst_bin(gt32[check], gt64))
    out_t64k = pipe_t64(batch64)
    err_t_k64 = max(worst_bin(out_t64k["w_theta"].cpu().numpy(), wt64),
                    worst_bin(out_t64k["gamma_t"].cpu().numpy(), gt64))
    cross = max(worst_bin(wt64, w64), worst_bin(gt64, g64))

    ref_t = json.loads((REPO / "tests" / "data"
                        / "torch_table_reference.json").read_text())
    if ref_t["indices"] != ref["indices"] or \
            not np.allclose(ref_t["omega_m0"], oms[idx]):
        fail("table reference file does not match this run's cosmologies")
    err_t_jax = max(worst_bin(wt32[idx], ref_t["w_theta"]),
                    worst_bin(gt32[idx], ref_t["gamma_t"]))
    err_t_jax64 = max(
        worst_bin(wt64[both], np.asarray(ref_t["w_theta"])[jpos]),
        worst_bin(gt64[both], np.asarray(ref_t["gamma_t"])[jpos]))
    jax_cross = ref_t["jax_table_vs_lattice_worst_bin"]
    cross_gate = max(3e-5, 2.0 * jax_cross)

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe_t(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_t = float(np.median(walls))
    print(f"[table] bench config A with method='table', DEFAULT_GRID, B="
          f"{N_COSMO}, float32 | launches {launches_t} | finite={finite_t} "
          f"shape_ok={shape_t} | worst bin vs card f64 plain path="
          f"{err_t_plain:.3e} (8 cosmologies, gate 1e-4) | vs JAX f64 "
          f"reference={err_t_jax:.3e} (3 cosmologies, gate 1e-4; JAX's own "
          f"f32 table route: {ref_t['jax_f32_vs_f64_worst_bin']:.3e}) | card "
          f"f64 plain vs JAX f64={err_t_jax64:.3e} (gate 1e-10) | card f64 "
          f"kernels vs f64 plain={err_t_k64:.3e} (gate 1e-12) | f64 table vs "
          f"lattice route={cross:.3e} (gate {cross_gate:.3e}; JAX at "
          f"DEFAULT_GRID {jax_cross:.3e}) | peak device memory "
          f"{peak_gb:.2f} GB | wall median of 5 = {wall_t * 1e3:.1f} ms "
          f"({wall_t / N_COSMO * 1e3:.4f} ms/cosmology)", flush=True)
    if not (finite_t and shape_t):
        fail("table outputs not finite or of the wrong shape")
    if launches_t["halo_contract"] != 1 or launches_t["hankel_matmul"] != 2:
        fail(f"table route launches {launches_t}: want halo_contract 1 and "
             f"hankel_matmul 2")
    if not err_t_plain < 1e-4:
        fail(f"table float32 vs float64 plain path: {err_t_plain}")
    if not err_t_jax < 1e-4:
        fail(f"table float32 vs JAX float64 reference: {err_t_jax}")
    if not err_t_k64 <= 1e-12:
        fail(f"table float64 through the kernels vs plain path: {err_t_k64}")
    if not err_t_jax64 <= 1e-10:
        fail(f"table float64 plain path vs JAX float64 reference: "
             f"{err_t_jax64}")
    if not cross < cross_gate:
        fail(f"table vs lattice route in float64: {cross}")

    lap("7")

    # -- 8. the backward kernels against their plain versions -----------
    from chomp_tpu_torch import inference

    bwd_a = {
        "main": check_a_bwd(k32, mat32, gal32, k64, mat64, gal64, 10),
        "feedback": check_a_bwd(k32, matf32, galf32, k64, matf64, galf64,
                                11),
        "ragged": check_a_bwd(
            kr32, mat32[:, ::7].contiguous(), gal32[:, 25::50].contiguous(),
            kr64, mat64[:, ::7].contiguous(), gal64[:, 25::50].contiguous(),
            12)}
    ga32 = seeded((N_COSMO, hc.N_OUT, k32.numel()), 13, f32)
    ms_abwd, plain_ms_abwd = in_turns_ms(
        lambda: hc.halo_contract_bwd(k32, mat32, gal32, cheb32, ga32),
        lambda: hc.halo_contract_bwd_ref(k32, mat32, gal32, cheb32, ga32),
        other_reps=1, other_turns=1)
    ga32_tab = seeded((N_COSMO, hc.N_OUT, st32.k_table.numel()), 13, f32)
    ms_abwd_fb = events_ms(lambda: hc.halo_contract_bwd(
        k32, matf32, galf32, cheb32, ga32))
    ms_abwd_tab = events_ms(lambda: hc.halo_contract_bwd(
        st32.k_table, mat32, gal32, cheb32, ga32_tab))

    bound_abwd = bound_abwd_of(k32, mat32, gal32, ga32)
    bound_abwd_fb = bound_abwd_of(k32, matf32, galf32, ga32)
    bound_abwd_tab = bound_abwd_of(st32.k_table, mat32, gal32, ga32_tab)
    profiled["halo_contract_bwd"] = (lambda: hc.halo_contract_bwd(
        k32, mat32, gal32, cheb32, ga32), None, 5)
    profiled["halo_contract_bwd feedback"] = (lambda: hc.halo_contract_bwd(
        k32, matf32, galf32, cheb32, ga32), None, 5)
    profiled["halo_contract_bwd table k"] = (lambda: hc.halo_contract_bwd(
        st32.k_table, mat32, gal32, cheb32, ga32_tab), None, 5)
    for name, q in bwd_a.items():
        print(f"[halo_contract_bwd] {name}: f64 field_peak_rel={q['f64']:.3e}"
              f" (8 cosmologies, gate 1e-12) | f32 vs plain backward on the "
              f"same inputs in f64: field_peak_rel={q['f32']:.3e} max_abs="
              f"{q['abs']:.3e} (gate 2e-5, and <= 1.5x the plain f32 "
              f"backward's own {q['plain32']:.3e}) | deterministic="
              f"{q['same']}", flush=True)
    print(f"[halo_contract_bwd] B={N_COSMO} NK={k32.numel()} NM="
          f"{mat32.shape[1]} NG={gal32.shape[1]} float32 | kernel "
          f"{ms_abwd:.3f} ms (feedback set {ms_abwd_fb:.3f} ms, table k "
          f"{ms_abwd_tab:.3f} ms), plain {plain_ms_abwd:.3f} ms (CUDA "
          f"events; plain 1 call) | bound {bound_abwd[0]:.4f} ms by "
          f"{bound_abwd[1]} (feedback set {bound_abwd_fb[0]:.4f} ms, table k "
          f"{bound_abwd_tab[0]:.4f} ms)", flush=True)
    # A''s launch geometry: the built library's own report, held to the
    # mirror in ops/tiles.py, and ptxas' registers and spills.
    geo_bad, geo_main = [], None
    nm_, ng_ = mat32.shape[1], gal32.shape[1]
    for kname, nk_ in (("lattice", k32.numel()),
                       ("table", st32.k_table.numel())):
        for dt in (f32, f64):
            rep = hc.bwd_launch_report(nm_, ng_, nk_, dt)
            geo = tiles.bwd_geometry(N_COSMO, nm_, ng_, nk_,
                                     8 if dt == f64 else 4)
            want = {"units": geo.grid[0], "block": geo.block,
                    "unit_m": geo.unit_m, "unit_g": geo.unit_g,
                    "kt": geo.kt, "tiles": geo.tiles,
                    "dyn_smem": geo.dyn_smem, "static_smem": geo.static_smem}
            if any(rep[n] != v for n, v in want.items()):
                geo_bad.append(f"{kname} {dt}: library {rep}, ops/tiles.py "
                               f"{want}")
            if kname == "lattice" and dt == f32:
                geo_main = rep
            blocks = rep["units"] * N_COSMO
            warps = rep["blocks_per_sm"] * rep["block"] // 32
            waves = blocks / (132 * max(1, rep["blocks_per_sm"]))
            print(f"[halo_contract_bwd] launch geometry, {kname} k ({nk_}), "
                  f"{str(dt)[6:]}: grid ({rep['units']}, {N_COSMO}) = "
                  f"{blocks} blocks of {rep['block']} threads; work unit "
                  f"{rep['unit_m']} mat + {rep['unit_g']} gal nodes of one "
                  f"cosmology ({rep['unit_m'] * 32 // rep['block']} of each "
                  f"per warp), k in {rep['tiles']} tile(s) of {rep['kt']}; "
                  f"shared memory {rep['static_smem']} B static + "
                  f"{rep['dyn_smem']} B dynamic; {rep['registers']} "
                  f"registers, {rep['local_bytes']} B local; "
                  f"{rep['blocks_per_sm']} blocks ({warps} warps) per SM, "
                  f"{waves:.2f} waves on 132 SMs", flush=True)
    print("[halo_contract_bwd] ptxas: " + " | ".join(
        ptxas_of(builds["halo_contract"][1], "halo_contract_bwd_kernel")),
        flush=True)
    for kname, kk in (("lattice", k32), ("table", st32.k_table)):
        for sname, (m, g) in (("main", (mat32, gal32)),
                              ("feedback", (matf32, galf32))):
            mix = bwd_route_mix(kk, m, g, hc._lens(f32), hc.n_moments(f32))
            print(f"[halo_contract_bwd] route mix per warp, {kname} k "
                  f"({kk.numel()}), {sname} nodes: a thread per node "
                  f"issued/useful {mix['per_node'][0]:.4f}x, warp-steps on "
                  f"more than one path {mix['per_node'][1]:.4f} | this layout "
                  f"(lanes on k) {mix['lanes_on_k'][0]:.4f}x, "
                  f"{mix['lanes_on_k'][1]:.4f}", flush=True)
    for name, q in bwd_a.items():
        if not q["f64"] <= 1e-12:
            fail(f"halo_contract_bwd {name}: float64 error {q['f64']}")
        if not q["f32"] <= 2e-5:
            fail(f"halo_contract_bwd {name}: float32 error {q['f32']}")
        if not q["f32"] <= 1.5 * q["plain32"]:
            fail(f"halo_contract_bwd {name}: float32 error {q['f32']} above "
                 f"1.5x the plain float32 backward's {q['plain32']}")
        if not q["same"]:
            fail(f"halo_contract_bwd {name}: two launches differ")
    if geo_bad:
        fail("halo_contract_bwd launch geometry differs from ops/tiles.py: "
             + "; ".join(geo_bad))

    def check_bc_bwd(bwd, g64, ops64, ops32, prod):
        """A backward product (B's or C's) under the cotangent g64:
        float64 against the float64 product (relative to each row's
        peak); float32 against the exact product of its float32 inputs
        beside torch.matmul's float32 error; two launches bit for bit."""
        got64 = bwd(g64, *ops64)
        ref64 = prod(g64, *ops64)
        g32 = g64.to(f32)
        got32 = bwd(g32, *ops32)
        exact = prod(g32.double(), *(o.double() for o in ops32))
        lib32 = prod(g32, ops32[0])
        peak = float(exact.abs().max())
        return {"f64": row_peak_rel(got64, ref64),
                "exact": float((got32.double() - exact).abs().max()) / peak,
                "lib_exact": float((lib32.double() - exact).abs().max())
                / peak,
                "abs": float((got32.double() - exact).abs().max()),
                "same": torch.equal(got32, bwd(g32, *ops32)) and torch.equal(
                    got64, bwd(g64, *ops64))}

    def prod_b(g, op_t):
        with hm.full_fp32_matmul():
            return g @ op_t.T

    def prod_c(g, a, a_lo=None):
        with hm.full_fp32_matmul():
            return g @ (a if a_lo is None else a + a_lo)

    op64_b = op_b.double()
    h64 = torch.tensor(ha64, device=dev)
    h_hi32, h_lo32 = (torch.tensor(x, device=dev)
                      for x in df32.split_operator(ha64))
    checks_bc = {
        ("hankel_matmul_bwd", (N_COSMO, 64, 1024)): check_bc_bwd(
            hm.hankel_matmul_bwd, seeded((N_COSMO, op_b.shape[1]), 14),
            (op64_b,), (op_b,), prod_b),
        ("hankel_matmul_bwd", (37, 13, 1000)): check_bc_bwd(
            hm.hankel_matmul_bwd, seeded((37, 13), 15),
            (op64_b[:1000, :13].contiguous(),),
            (op_b[:1000, :13].contiguous(),), prod_b),
        ("hankel_matmul_bwd", (1, 64, 1024)): check_bc_bwd(
            hm.hankel_matmul_bwd, seeded((1, op_b.shape[1]), 16),
            (op64_b,), (op_b,), prod_b),
        ("df_contract_bwd", (N_COSMO, 64, j_hi - j_lo)): check_bc_bwd(
            df32.df_contract_bwd, seeded((N_COSMO, a64.shape[0]), 17),
            (a64,), (a_hi, a_lo), prod_c),
        ("df_contract_bwd", (8, 64, j_hi - j_lo)): check_bc_bwd(
            df32.df_contract_bwd, seeded((8, a64.shape[0]), 18),
            (a64,), (a_hi, a_lo), prod_c),
        ("df_contract_bwd", (1, 8, 1024)): check_bc_bwd(
            df32.df_contract_bwd, seeded((1, 8), 19), (h64,),
            (h_hi32, h_lo32), prod_c)}
    gb32 = seeded((N_COSMO, op_b.shape[1]), 20, f32)
    gc32 = seeded((N_COSMO, a64.shape[0]), 21, f32)
    gc32_as64 = gc32.double()
    ms_bbwd, lib_ms_bbwd = in_turns_ms(
        lambda: hm.hankel_matmul_bwd(gb32, op_b),
        lambda: torch.matmul(gb32, op_b.T))
    plain_ms_bbwd = events_ms(lambda: hm.hankel_matmul_bwd_ref(gb32, op_b))
    ms_cbwd, lib_ms_cbwd = in_turns_ms(
        lambda: df32.df_contract_bwd(gc32, a_hi, a_lo),
        lambda: gc32_as64 @ a64)
    plain_ms_cbwd = events_ms(lambda: df32.df_contract_bwd_ref(gc32, a_hi,
                                                                a_lo))
    profiled["hankel_matmul_bwd"] = (
        lambda: hm.hankel_matmul_bwd(gb32, op_b),
        lambda: torch.matmul(gb32, op_b.T), 20)
    profiled["df_contract_bwd"] = (
        lambda: df32.df_contract_bwd(gc32, a_hi, a_lo),
        lambda: gc32_as64 @ a64, 20)
    rb, nb = gb32.shape[0], op_b.shape[0]
    tb = op_b.shape[1]
    bound_bbwd = bound(2.0 * rb * nb * tb, 4 * (rb * tb + nb * tb + rb * nb))
    rc_, nc = gc32.shape[0], a64.shape[1]
    tc = a64.shape[0]
    bound_cbwd = bound(2.0 * rc_ * nc * tc,
                       4 * (rc_ * tc + 2 * tc * nc + rc_ * nc))
    for (name, (rr, kk_, nn)), q in checks_bc.items():
        print(f"[{name}] ({rr}, {kk_}) -> ({rr}, {nn}) | f64 rel_to_row_peak"
              f"={q['f64']:.3e} (gate 1e-12) | f32 vs exact f64 product "
              f"rel_to_peak={q['exact']:.3e} max_abs={q['abs']:.3e}, "
              f"torch.matmul f32 {q['lib_exact']:.3e} (gate 2x) | "
              f"deterministic={q['same']} | {geometry(rr, kk_, nn)}",
              flush=True)
    print(f"[hankel_matmul_bwd] ({rb}, {tb}) @ ({tb}, {nb}) float32 | kernel "
          f"{ms_bbwd:.4f} ms, library (torch.matmul f32) {lib_ms_bbwd:.4f} "
          f"ms, plain {plain_ms_bbwd:.4f} ms (CUDA events over 100 calls) | "
          f"bound {bound_bbwd[0]:.5f} ms by {bound_bbwd[1]}", flush=True)
    print(f"[df_contract_bwd] ({rc_}, {tc}) @ ({tc}, {nc}) float32 | kernel "
          f"{ms_cbwd:.4f} ms, library (f64 matmul) {lib_ms_cbwd:.4f} ms, "
          f"plain {plain_ms_cbwd:.4f} ms (CUDA events over 100 calls) | "
          f"bound {bound_cbwd[0]:.5f} ms by {bound_cbwd[1]}", flush=True)
    for (name, shape), q in checks_bc.items():
        if not q["f64"] <= 1e-12:
            fail(f"{name} {shape}: float64 error {q['f64']}")
        if not q["exact"] <= 2.0 * q["lib_exact"]:
            fail(f"{name} {shape}: float32 vs the exact product "
                 f"{q['exact']} (torch.matmul: {q['lib_exact']})")
        if not q["same"]:
            fail(f"{name} {shape}: two launches differ")

    lap("8")

    # -- 9. gradients of both slices at full width ------------------------
    counted = counted_kernels()
    fwd_want = {"lattice": {"halo_contract": 1, "df_contract": 2,
                            "hankel_matmul": 0},
                "table": {"halo_contract": 1, "df_contract": 0,
                          "hankel_matmul": 2}}
    weights = seeded((N_COSMO, 2 * DEFAULT_GRID.n_theta), 22, f32)
    grad_launches, grad_info = {}, {}
    pipes = {"lattice": (pipe, pipe64), "table": (pipe_t, pipe_t64)}

    def grad_run(pipe_r):
        """One torch.autograd.grad of the seeded linear functional of (w,
        gamma_t) with respect to (omega_m0, sigma_8) at B = 512."""
        om = torch.tensor(oms, dtype=f32, device=dev, requires_grad=True)
        s8 = torch.tensor(s8s, dtype=f32, device=dev, requires_grad=True)
        out = pipe_r(broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                     omega_m0=om, omega_l0=1.0 - om,
                                     sigma_8=s8))
        vec = torch.cat([out["w_theta"], out["gamma_t"]], dim=-1)
        return torch.autograd.grad((vec * weights).sum(), (om, s8))

    for route, (pipe_r, _) in pipes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
            fn.bwd_launches = 0
        g_om, g_s8 = grad_run(pipe_r)
        torch.cuda.synchronize()
        grad_launches[route] = (
            {n: fn.launches for n, fn in counted.items()},
            {n: fn.bwd_launches for n, fn in counted.items()})
        grad_info[route] = {
            "finite": bool(torch.isfinite(g_om).all()
                           and torch.isfinite(g_s8).all()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        with torch.no_grad():
            grad_info[route]["fwd_wall"] = median_wall(lambda: pipe_r(batch))
        grad_info[route]["fwd_bwd_wall"] = median_wall(
            lambda: grad_run(pipe_r))
        grad_info[route]["fwd_wall_2"] = median_wall(lambda: pipe_r(batch))

    # The lattice route's grouped float64 conv1d (a library op) under
    # autograd, on phase 4's rows at B = 512.
    p_req, g_req = (t.clone().requires_grad_(True) for t in conv_rows)

    def conv_fwd_bwd():
        out = limber_fft._conv_direct_rows(p_req, g_req, j_lo, j_hi)
        return torch.autograd.grad(out.sum(), (p_req, g_req))

    ms_conv_fb = events_ms(conv_fwd_bwd, 5)

    ref_g = json.loads((REPO / "tests" / "data"
                        / "torch_grad_reference.json").read_text())
    full = ref_g["default_grid"]
    p_ref = np.stack([full["omega_m0"][:3], full["sigma_8"][:3]], axis=1)
    if not np.allclose(full["omega_m0"][:3], oms[idx]):
        fail("gradient reference does not match this run's cosmologies")
    jac_errs = {}
    for route, (pipe_r, pipe_r64) in pipes.items():
        key = "fft" if route == "lattice" else "table"
        th32, _ = inference.make_theory_fn(
            pipe_r, default_cosmo(device=dev, dtype=f32))
        th64, _ = inference.make_theory_fn(
            pipe_r64, default_cosmo(device=dev, dtype=f64))
        p32_ = torch.tensor(p_ref, dtype=f32, device=dev)
        p64_ = torch.tensor(p_ref, dtype=f64, device=dev)
        j32 = inference.jacobian(th32, p32_).cpu().numpy()
        j64k = inference.jacobian(th64, p64_, chunk=128).cpu().numpy()
        with plain_path():
            j64p = inference.jacobian(th64, p64_, chunk=128).cpu().numpy()
        jax_j = np.asarray(full[key]["jacobian"][:3])
        jac_errs[route] = {"f32_vs_plain64": jac_err(j32, j64p),
                           "k64_vs_plain64": jac_err(j64k, j64p),
                           "plain64_vs_jax": jac_err(j64p, jax_j),
                           "f32_vs_jax": jac_err(j32, jax_j)}
    for route in pipes:
        fw, bw = grad_launches[route]
        gi, je = grad_info[route], jac_errs[route]
        print(f"[grad] {route} route, DEFAULT_GRID, B={N_COSMO}, float32: "
              f"autograd.grad of a seeded linear functional of (w, gamma_t)"
              f" wrt (omega_m0, sigma_8) | finite={gi['finite']} | forward "
              f"launches {fw}, backward launches {bw} | peak device memory "
              f"{gi['peak_gb']:.2f} GB | forward+backward wall median of 3 "
              f"= {gi['fwd_bwd_wall'] * 1e3:.1f} ms against forward-only "
              f"{gi['fwd_wall'] * 1e3:.1f} / {gi['fwd_wall_2'] * 1e3:.1f} ms"
              f" (before / after) | Jacobian at the 3 reference cosmologies "
              f"(inference.jacobian): f32 vs card f64 plain path "
              f"{je['f32_vs_plain64']:.3e} (gate 1e-3 of each column's peak "
              f"over theta), f64 kernels vs f64 plain "
              f"{je['k64_vs_plain64']:.3e} (gate 1e-10), f64 plain vs JAX "
              f"jacfwd {je['plain64_vs_jax']:.3e} (gate 1e-9), f32 vs JAX "
              f"{je['f32_vs_jax']:.3e} (gate 1e-3)", flush=True)
    print(f"[grad] lattice conv1d (float64 accumulation, grouped, library) "
          f"forward+backward {ms_conv_fb:.3f} ms at B={N_COSMO} (forward "
          f"alone {ms_conv:.3f} ms, phase 4)", flush=True)
    for route in pipes:
        fw, bw = grad_launches[route]
        want_b = fwd_want[route]
        if fw != want_b or bw != want_b:
            fail(f"{route} route forward+backward launches: forward {fw}, "
                 f"backward {bw}; want {want_b} each")
        if not grad_info[route]["finite"]:
            fail(f"{route} route gradient not finite")
        je = jac_errs[route]
        for name, gate in (("f32_vs_plain64", 1e-3), ("k64_vs_plain64", 1e-10),
                           ("plain64_vs_jax", 1e-9), ("f32_vs_jax", 1e-3)):
            if not je[name] < gate:
                fail(f"{route} route Jacobian {name}: {je[name]} (gate "
                     f"{gate})")

    lap("9")

    # -- 10. inference on the card (lattice route) ------------------------
    fid = torch.tensor([0.278, 0.811], dtype=f64, device=dev)
    th64, p0 = inference.make_theory_fn(pipe64, default_cosmo(device=dev,
                                                              dtype=f64))
    th32, _ = inference.make_theory_fn(pipe, default_cosmo(device=dev,
                                                           dtype=f32))
    if not torch.equal(p0, fid):
        fail(f"fiducial vector {p0.tolist()}")
    with torch.no_grad():
        data = th64(fid)[0]
    sig = 0.05 * data.abs() + 1e-3 * data.abs().max()
    cov = torch.diag(sig * sig)
    fisher32 = inference.fisher_matrix(th32, cov, fid)
    fisher64 = inference.fisher_matrix(th64, cov, fid)
    scale = torch.sqrt(torch.outer(fisher64.diagonal(),
                                   fisher64.diagonal()))
    fisher_err = float(((fisher32 - fisher64).abs() / scale).max())
    sigma = torch.sqrt(torch.linalg.inv(fisher64).diagonal())
    like = inference.GaussianLikelihood(th32, data, cov)

    def fisher_dist(p):
        d = (p - fid)[None, :]
        return float(torch.sqrt((d @ fisher64 @ d.T)[0, 0]))

    start = fid + 2.0 * sigma
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_map, info = inference.map_fit(like.neg_log_post, start, n_steps=20,
                                    learning_rate=float(0.3 * sigma.min()))
    torch.cuda.synchronize()
    map_wall = time.perf_counter() - t0
    d_start, d_map = fisher_dist(start), fisher_dist(p_map)

    gen = torch.Generator(device=dev).manual_seed(0)
    chol_f = torch.linalg.cholesky(fisher64)
    z = torch.randn((N_COSMO, 2), generator=gen, device=dev, dtype=f64)
    q0 = fid + torch.linalg.solve_triangular(chol_f.T, z.T, upper=True).T
    n_steps, n_leap = 3, 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, accept = inference.hmc(like.neg_log_post, fisher64, q0, gen,
                                    n_steps=n_steps, n_leap=n_leap, eps=0.3)
    torch.cuda.synchronize()
    hmc_wall = time.perf_counter() - t0
    acc_rate = float(accept.double().mean())
    hmc_finite = bool(torch.isfinite(samples).all())
    print(f"[inference] lattice route, data = f64 w+gamma_t at the fiducial "
          f"(0.278, 0.811), diagonal cov sigma_i = 0.05|d_i| + 1e-3 max|d| | "
          f"Fisher f32 vs f64 worst |dF_ij|/sqrt(F_ii F_jj) = "
          f"{fisher_err:.3e} (gate 1e-3); sigma(omega_m0, sigma_8) = "
          f"{sigma.tolist()} | map_fit from 2 sigma off, 20 Adam steps: "
          f"Fisher distance {d_start:.3f} -> {d_map:.3f}, wall "
          f"{map_wall:.2f} s | hmc: {N_COSMO} chains x {n_steps} steps x "
          f"{n_leap} leapfrogs, eps 0.3, Fisher mass: finite={hmc_finite}, "
          f"mean acceptance {acc_rate:.4f} (gate > 0.5), wall "
          f"{hmc_wall:.2f} s = {hmc_wall / (n_steps * n_leap) * 1e3:.1f} ms "
          f"per leapfrog ({n_steps * n_leap + 1} gradient evaluations)",
          flush=True)
    if not fisher_err <= 1e-3:
        fail(f"Fisher matrix float32 vs float64: {fisher_err}")
    if not (math.isfinite(d_map) and d_map < d_start):
        fail(f"map_fit did not approach the fiducial: {d_start} -> {d_map}")
    if not (hmc_finite and acc_rate > 0.5):
        fail(f"hmc: finite={hmc_finite}, acceptance {acc_rate}")

    lap("10")

    # -- 11. exact-z: bench.py configuration B ----------------------------
    from chomp_tpu_torch.params import GridSpec

    n_x, j_x = 64, 6
    check_x = np.unique(np.linspace(0, n_x - 1, N_CHECK).round()
                        ).astype(int)
    ref_x = json.loads((REPO / "tests" / "data"
                        / "torch_exactz_reference.json").read_text())
    rb = ref_x["config_b"]
    idx_x = np.asarray(rb["indices"])
    if (rb["n_cosmo"] != n_x or rb["exact_z_anchors"] != j_x
            or not np.allclose(rb["omega_m0"],
                               np.linspace(0.24, 0.32, n_x)[idx_x])):
        fail("exact-z reference file does not match this run's cosmologies")
    both_x = [i for i, c in enumerate(check_x) if c in set(idx_x.tolist())]
    jpos_x = [idx_x.tolist().index(check_x[i]) for i in both_x]
    if not both_x:
        fail("no checked exact-z cosmology is in the reference file")

    def pipe_x_of(dtype, hp_, hod_, dist_):
        return make_pipeline(hp_, hod_, dist_, power_spec="power_gg",
                             grid=DEFAULT_GRID, include_lensing=True,
                             exact_z_anchors=j_x, device=dev, dtype=dtype)

    batch_x, hp_x, hod_x, dist_x = setup(f32, n=n_x)
    pipe_x = pipe_x_of(f32, hp_x, hod_x, dist_x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    with torch.no_grad():
        out_x = pipe_x(batch_x)
    torch.cuda.synchronize()
    launches_x = counts()[0]
    peak_x = torch.cuda.max_memory_allocated() / 1e9
    wx32 = out_x["w_theta"].double().cpu().numpy()
    gx32 = out_x["gamma_t"].double().cpu().numpy()
    finite_x = bool(np.all(np.isfinite(wx32)) and np.all(np.isfinite(gx32)))
    shape_x = wx32.shape == gx32.shape == (n_x, DEFAULT_GRID.n_theta)

    batch_x64, hp_x64, hod_x64, dist_x64 = setup(f64, check_x, n=n_x)
    pipe_x64 = pipe_x_of(f64, hp_x64, hod_x64, dist_x64)
    with plain_path():
        out_x64 = pipe_x64(batch_x64)
    wx64 = out_x64["w_theta"].cpu().numpy()
    gx64 = out_x64["gamma_t"].cpu().numpy()
    err_x_plain = max(worst_bin(wx32[check_x], wx64),
                      worst_bin(gx32[check_x], gx64))
    out_x64k = pipe_x64(batch_x64)
    err_x_k64 = max(worst_bin(out_x64k["w_theta"].cpu().numpy(), wx64),
                    worst_bin(out_x64k["gamma_t"].cpu().numpy(), gx64))
    err_x_jax = max(worst_bin(wx32[idx_x], rb["w_theta"]),
                    worst_bin(gx32[idx_x], rb["gamma_t"]))
    err_x_jax64 = max(
        worst_bin(wx64[both_x], np.asarray(rb["w_theta"])[jpos_x]),
        worst_bin(gx64[both_x], np.asarray(rb["gamma_t"])[jpos_x]))

    # The J-channel convolution on its own rows: the float64 anchor
    # spectra and weights of the 8 checked cosmologies, rounded to
    # float32 (float32 in, float64 sums) against float64.
    st_x64 = pipe_x64.st
    anchors64 = limber_fft.exact_z_anchor_spectra(
        batch_x64.batched(), pipe_x64.halo_params, pipe_x64.hod,
        pipe_x64.kinds, j_x, 1e-3, pipe_x64.z_hi_anchor, st_x64)
    gj32 = limber_fft.exact_z_g_rows(
        batch_x64.batched(), anchors64,
        [(wa, wb) for wa, wb, _k, _s in pipe_x64.probes], st_x64).to(f32)
    pj32 = torch.stack([anchors64["p_j"][kd] for _a, _b, kd, _s
                        in pipe_x64.probes], 1).to(f32)
    conv_x64 = limber_fft.anchor_conv(pj32.double(), gj32.double(), j_lo,
                                      j_hi)
    conv_x32 = limber_fft.anchor_conv(pj32, gj32, j_lo, j_hi)
    err_conv_x = float((conv_x32.double() / conv_x64 - 1.0).abs().max())
    del anchors64, gj32, pj32, conv_x64, conv_x32

    # Kernel A (and A') on the anchors' own node set: B x J = 384 rows,
    # row b J + j = cosmology b at anchor j, as the forward builds it.
    def anchor_nodes(dtype, idx=None):
        b_, hp_, hod_, _d = setup(dtype, idx, n=n_x)
        b_ = b_.batched()
        st_ = Statics(DEFAULT_GRID, device=dev, dtype=dtype)
        rows = limber_fft._repeat_rows(b_, b_.batch, j_x)
        z_nodes, _ = limber_fft._cheb_nodes(1e-3, pipe_x.z_hi_anchor, j_x)
        z_r = torch.tensor(z_nodes, dtype=dtype, device=dev).repeat(b_.batch)
        model_r = halo.build_halo_model(rows, hp_, hod_, z_r, st_)
        return halo.contraction_nodes(rows, hp_, model_r)

    matx32, galx32 = anchor_nodes(f32)
    # 8 float64 rows, one cosmology of the check set at each anchor in
    # turn (every anchor at least once).
    sel = torch.tensor([c * j_x + c % j_x for c in range(len(check_x))],
                       device=dev)
    matx64, galx64 = (t[sel].contiguous() for t in anchor_nodes(f64,
                                                                 check_x))
    rows_x = matx32.shape[0]
    a_x = check_a(k32, matx32, galx32, k64, matx64, galx64, cheb32, cheb64)
    mix_x, same_x, cx_max_x = branch_mix(k32, matx32, galx32)
    warp_x = bwd_route_mix(k32, matx32, galx32, hc._lens(f32),
                           hc.n_moments(f32))
    per_anchor = [(matx32.view(n_x, j_x, *matx32.shape[1:])[:, j]
                   .contiguous(),
                   galx32.view(n_x, j_x, *galx32.shape[1:])[:, j]
                   .contiguous()) for j in range(j_x)]

    def six_launches():
        for m, g in per_anchor:
            hc.halo_contract(k32, m, g, cheb32)

    ms_a_x, ms_a_x6 = in_turns_ms(
        lambda: hc.halo_contract(k32, matx32, galx32, cheb32), six_launches,
        reps=20, other_reps=20)
    bound_a_x = bound_a_of(k32, matx32, galx32)
    profiled["halo_contract exact-z"] = (
        lambda: hc.halo_contract(k32, matx32, galx32, cheb32), None, 5)
    bwd_x = check_a_bwd(k32, matx32, galx32, k64, matx64, galx64, 30)
    gx_a = seeded((rows_x, hc.N_OUT, k32.numel()), 31, f32)
    ms_abwd_x = events_ms(lambda: hc.halo_contract_bwd(
        k32, matx32, galx32, cheb32, gx_a), 20)
    bound_abwd_x = bound_abwd_of(k32, matx32, galx32, gx_a)
    profiled["halo_contract_bwd exact-z"] = (
        lambda: hc.halo_contract_bwd(k32, matx32, galx32, cheb32, gx_a),
        None, 5)
    z_nodes_x = limber_fft._cheb_nodes(1e-3, pipe_x.z_hi_anchor, j_x)[0]
    print(f"[exact-z A] anchor node set: B x J = {n_x} x {j_x} = {rows_x} "
          f"rows at z = {np.round(z_nodes_x, 4).tolist()}, NK={k32.numel()} "
          f"NM={matx32.shape[1]} NG={galx32.shape[1]} | f64 rel_to_peak="
          f"{a_x['f64']:.3e} (8 rows, gate 1e-12) | f32 vs plain version on "
          f"the same inputs in f64: rel_to_peak={a_x['f32']:.3e} max_abs="
          f"{a_x['abs']:.3e} (gate 2e-6, and <= 1.5x the plain f32 "
          f"version's own {a_x['plain32']:.3e}) | deterministic="
          f"{a_x['same']} | one launch over {rows_x} rows {ms_a_x:.3f} ms, "
          f"{j_x} launches of {n_x} rows {ms_a_x6:.3f} ms (CUDA events, 20 "
          f"calls, in turns), plain {a_x['plain_ms']:.1f} ms (1 call) | "
          f"bound {bound_a_x[0]:.4f} ms by {bound_a_x[1]}", flush=True)
    print(f"[exact-z A] branch mix: " + ", ".join(
        f"{n} {v:.4f}" for n, v in mix_x.items())
        + f" | galaxy nodes with one profile {same_x:.3f} | max |cx| "
        f"{cx_max_x:.4g} | per warp (lanes on k): warp-steps on more than "
        f"one path {warp_x['lanes_on_k'][1]:.4f}, issued/useful at A' "
        f"prices {warp_x['lanes_on_k'][0]:.4f}x", flush=True)
    print(f"[exact-z A'] anchor node set ({rows_x} rows): f64 "
          f"field_peak_rel={bwd_x['f64']:.3e} (8 rows, gate 1e-12) | f32 vs "
          f"plain backward on the same inputs in f64: field_peak_rel="
          f"{bwd_x['f32']:.3e} max_abs={bwd_x['abs']:.3e} (gate 2e-5, and <= "
          f"1.5x the plain f32 backward's own {bwd_x['plain32']:.3e}) | "
          f"deterministic={bwd_x['same']} | kernel {ms_abwd_x:.3f} ms (CUDA "
          f"events, 20 calls), plain {bwd_x['plain_ms']:.1f} ms (1 call) | "
          f"bound {bound_abwd_x[0]:.4f} ms by {bound_abwd_x[1]}", flush=True)
    for name, q in (("halo_contract exact-z", a_x),):
        if not q["f64"] <= 1e-12:
            fail(f"{name}: float64 error {q['f64']}")
        if not (q["f32"] <= 2e-6 and q["f32"] <= 1.5 * q["plain32"]):
            fail(f"{name}: float32 error {q['f32']} (plain float32 "
                 f"{q['plain32']})")
        if not q["same"]:
            fail(f"{name}: two launches differ")
    if not (bwd_x["f64"] <= 1e-12 and bwd_x["f32"] <= 2e-5
            and bwd_x["f32"] <= 1.5 * bwd_x["plain32"] and bwd_x["same"]):
        fail(f"halo_contract_bwd exact-z: {bwd_x}")
    del per_anchor

    # The lattice exact-z C_ell at the configuration of the JAX package's
    # tests/test_exact_z_lattice.py, float64 on the card.
    rc = ref_x["cl_exact_z"]
    kw64 = dict(device=dev, dtype=f64)
    st_g = Statics(GridSpec(**rc["grid"]), **kw64)
    win_gz = projection.WindowGalaxy(DNdzGaussian(
        *(torch.tensor(v, **kw64) for v in rc["dist"])))
    cl_g = limber_fft.limber_cl_fft_exact_z(
        default_cosmo(**kw64), default_halo(**kw64), default_hod(**kw64),
        win_gz, win_gz, np.asarray(rc["ells"]), st_g, "power_gg",
        n_z_anchor=rc["n_z_anchor"])[0].cpu().numpy()
    err_cl_tab = worst_bin(cl_g, rc["table"])
    err_cl_lat = float(np.max(np.abs(cl_g - rc["lattice"]))
                       / np.max(np.abs(rc["lattice"])))

    # Walls, peak memory, forward+backward (launch counts zeroed just
    # before and read just after), Jacobians.
    weights_x = seeded((n_x, 2 * DEFAULT_GRID.n_theta), 32, f32)
    oms_x = np.linspace(0.24, 0.32, n_x)
    s8s_x = np.linspace(0.75, 0.88, n_x)

    def grad_run_x():
        om = torch.tensor(oms_x, dtype=f32, device=dev, requires_grad=True)
        s8 = torch.tensor(s8s_x, dtype=f32, device=dev, requires_grad=True)
        out = pipe_x(broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                     omega_m0=om, omega_l0=1.0 - om,
                                     sigma_8=s8))
        vec = torch.cat([out["w_theta"], out["gamma_t"]], dim=-1)
        return torch.autograd.grad((vec * weights_x).sum(), (om, s8))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    g_x = grad_run_x()
    torch.cuda.synchronize()
    grad_launches_x = counts()
    peak_x_fb = torch.cuda.max_memory_allocated() / 1e9
    finite_gx = all(bool(torch.isfinite(g).all()) for g in g_x)
    with torch.no_grad():
        wall_x = median_wall(lambda: pipe_x(batch_x))
    wall_x_fb = median_wall(grad_run_x)

    p_ref_x = np.stack([rb["omega_m0"], rb["sigma_8"]], axis=1)
    th32, _ = inference.make_theory_fn(pipe_x, default_cosmo(device=dev,
                                                             dtype=f32))
    th64, _ = inference.make_theory_fn(pipe_x64, default_cosmo(**kw64))
    p32_ = torch.tensor(p_ref_x, dtype=f32, device=dev)
    p64_ = torch.tensor(p_ref_x, **kw64)
    # 128 replica rows a pass (~22 GB at float64).
    jx32 = inference.jacobian(th32, p32_, chunk=128).cpu().numpy()
    jx64k = inference.jacobian(th64, p64_, chunk=128).cpu().numpy()
    # The plain path's Jacobian at the first reference cosmology only (all
    # 3 until PR 8); the float64 kernels' Jacobian is held to the JAX
    # jacfwd at all 3 (gate 1e-9), the float32 one to it (gate 1e-3).
    with plain_path():
        jx64p = inference.jacobian(th64, p64_[:1], chunk=64).cpu().numpy()
    jax_jx = np.asarray(rb["jacobian"])
    je_x = {"f32_vs_plain64": jac_err(jx32[:1], jx64p),
            "k64_vs_plain64": jac_err(jx64k[:1], jx64p),
            "plain64_vs_jax": jac_err(jx64p, jax_jx[:1]),
            "f32_vs_jax": jac_err(jx32, jax_jx),
            "k64_vs_jax": jac_err(jx64k, jax_jx),
            "f32_vs_k64": jac_err(jx32, jx64k)}
    want_x = {"halo_contract": 1, "df_contract": 2, "hankel_matmul": 0}
    print(f"[exact-z] bench config B (exact_z_anchors={j_x}, z_pivot 0), "
          f"DEFAULT_GRID, B={n_x}, float32 | forward launches {launches_x} | "
          f"finite={finite_x} shape_ok={shape_x} | worst bin vs card f64 "
          f"plain path={err_x_plain:.3e} (8 cosmologies, gate 1e-4) | vs JAX "
          f"f64 reference={err_x_jax:.3e} (3 cosmologies, gate 1e-4) | card "
          f"f64 plain vs JAX f64={err_x_jax64:.3e} (gate 1e-10) | card f64 "
          f"kernels vs f64 plain={err_x_k64:.3e} (gate 1e-12) | J-channel "
          f"conv f32 in, f64 sums vs f64: worst rel={err_conv_x:.3e} (gate "
          f"1e-6) | lattice exact-z C_ell (J=8, grid G, f64 on the card) vs "
          f"JAX limber_cl_exact_z {err_cl_tab:.3e} (gate 1e-4; JAX's own "
          f"lattice route {rc['jax_lattice_vs_table_worst']:.3e}), vs JAX "
          f"lattice route {err_cl_lat:.3e} of peak (gate 1e-10) | forward "
          f"wall median of 3 = {wall_x * 1e3:.1f} ms ({wall_x / n_x * 1e3:.3f}"
          f" ms/cosmology), peak device memory {peak_x:.2f} GB", flush=True)
    print(f"[exact-z] forward+backward (autograd.grad of a seeded linear "
          f"functional of (w, gamma_t) wrt (omega_m0, sigma_8)), B={n_x}: "
          f"launches forward {grad_launches_x[0]}, backward "
          f"{grad_launches_x[1]} | finite={finite_gx} | wall median of 3 = "
          f"{wall_x_fb * 1e3:.1f} ms | peak device memory {peak_x_fb:.2f} GB"
          f" | Jacobian at the 3 reference cosmologies (inference.jacobian, "
          f"chunks of 128 replicas, the plain path at the first in 64): "
          f"f32 vs "
          f"card f64 plain path {je_x['f32_vs_plain64']:.3e} (gate 1e-3), "
          f"f64 kernels vs f64 plain {je_x['k64_vs_plain64']:.3e} (gate "
          f"1e-10), f64 plain vs JAX jacfwd {je_x['plain64_vs_jax']:.3e} "
          f"(gate 1e-9); all 3: f64 kernels vs JAX {je_x['k64_vs_jax']:.3e} "
          f"(gate 1e-9), f32 vs f64 kernels {je_x['f32_vs_k64']:.3e} (gate "
          f"1e-3), f32 vs JAX {je_x['f32_vs_jax']:.3e}", flush=True)
    if launches_x != want_x:
        fail(f"exact-z forward launches {launches_x}; want {want_x}")
    if grad_launches_x != (want_x, want_x):
        fail(f"exact-z forward+backward launches {grad_launches_x}; want "
             f"{want_x} each")
    if not (finite_x and shape_x and finite_gx):
        fail("exact-z outputs or gradient not finite, or of the wrong shape")
    for name, val, gate in (
            ("float32 vs float64 plain path", err_x_plain, 1e-4),
            ("float32 vs JAX float64", err_x_jax, 1e-4),
            ("float64 plain path vs JAX", err_x_jax64, 1e-10),
            ("float64 kernels vs plain path", err_x_k64, 1e-12),
            ("J-channel convolution float32", err_conv_x, 1e-6),
            ("lattice exact-z C_ell vs JAX table route", err_cl_tab, 1e-4),
            ("lattice exact-z C_ell vs JAX lattice route", err_cl_lat, 1e-10),
            ("Jacobian f32 vs f64 plain", je_x["f32_vs_plain64"], 1e-3),
            ("Jacobian f64 kernels vs plain", je_x["k64_vs_plain64"], 1e-10),
            ("Jacobian f64 plain vs JAX", je_x["plain64_vs_jax"], 1e-9),
            ("Jacobian f64 kernels vs JAX", je_x["k64_vs_jax"], 1e-9),
            ("Jacobian f32 vs f64 kernels", je_x["f32_vs_k64"], 1e-3)):
        if not val <= gate:
            fail(f"exact-z {name}: {val} (gate {gate})")
    del out_x, out_x64, out_x64k, g_x

    lap("11")

    # -- 12. shear: configuration A with include_shear=True ---------------
    rs = ref_x["shear"]
    idx_s = np.asarray(rs["indices"])
    if rs["n_cosmo"] != N_COSMO or not np.allclose(rs["omega_m0"],
                                                   oms[idx_s]):
        fail("shear reference file does not match this run's cosmologies")
    both_s = [i for i, c in enumerate(check) if c in set(idx_s.tolist())]
    jpos_s = [idx_s.tolist().index(check[i]) for i in both_s]
    keys_s = ("w_theta", "gamma_t", "xi_plus", "xi_minus")

    def shear_err(got, ref):
        """{key: error}: worst bin for w, gamma_t and xi+, and for xi-
        both its worst bin and its worst error relative to each row's
        peak over theta (xi- is small at small theta)."""
        e = {k: worst_bin(got[k], ref[k]) for k in keys_s}
        g, r = np.asarray(got["xi_minus"]), np.asarray(ref["xi_minus"])
        e["xi_minus_peak"] = float(np.max(np.max(np.abs(g - r), axis=1)
                                          / np.max(np.abs(r), axis=1)))
        return e

    def gated(e):
        """The gated figure of shear_err: xi- by its row peak."""
        return max(v for k, v in e.items() if k != "xi_minus")

    def pipe_s_of(dtype, method, hp_, hod_, dist_):
        return make_pipeline(hp_, hod_, dist_, power_spec="power_gg",
                             grid=DEFAULT_GRID, include_lensing=True,
                             z_pivot=1.0, include_shear=True, method=method,
                             device=dev, dtype=dtype)

    def host(out, rows=None):
        return {k: (out[k].double().cpu().numpy() if rows is None
                    else out[k].double().cpu().numpy()[rows])
                for k in keys_s}

    want_s = {"lattice": {"halo_contract": 1, "df_contract": 3,
                          "hankel_matmul": 0},
              "table": {"halo_contract": 1, "df_contract": 0,
                        "hankel_matmul": 4}}
    weights_s = seeded((N_COSMO, 4 * DEFAULT_GRID.n_theta), 33, f32)
    shear, shear64 = {}, {}
    for route, method in (("lattice", "fft"), ("table", "table")):
        pipe_s = pipe_s_of(f32, method, hp, hod, dist)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_zero()
        with torch.no_grad():
            out_s = pipe_s(batch)
        torch.cuda.synchronize()
        fw = counts()[0]
        peak_s = torch.cuda.max_memory_allocated() / 1e9
        got = host(out_s)
        finite_s = all(bool(np.all(np.isfinite(v))) for v in got.values())
        pipe_s64 = pipe_s_of(f64, method, hp64, hod64, dist64)
        with plain_path():
            plain = host(pipe_s64(batch64))
        kern64 = host(pipe_s64(batch64))
        ref_r = {k: np.asarray(rs["fft" if route == "lattice" else "table"][k])
                 for k in keys_s}
        with torch.no_grad():
            wall_s = median_wall(lambda: pipe_s(batch))

        def grad_run_s():
            om = torch.tensor(oms, dtype=f32, device=dev, requires_grad=True)
            s8 = torch.tensor(s8s, dtype=f32, device=dev, requires_grad=True)
            out = pipe_s(broadcast_cosmo(default_cosmo(device=dev,
                                                       dtype=f32),
                                         omega_m0=om, omega_l0=1.0 - om,
                                         sigma_8=s8))
            vec = torch.cat([out[k] for k in keys_s], dim=-1)
            return torch.autograd.grad((vec * weights_s).sum(), (om, s8))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_zero()
        g_s = grad_run_s()
        torch.cuda.synchronize()
        gl = counts()
        peak_s_fb = torch.cuda.max_memory_allocated() / 1e9
        finite_gs = all(bool(torch.isfinite(g).all()) for g in g_s)
        wall_s_fb = median_wall(grad_run_s)
        shear[route] = {
            "launches": fw, "grad_launches": gl, "finite": finite_s,
            "finite_grad": finite_gs, "peak": peak_s, "peak_fb": peak_s_fb,
            "wall": wall_s, "wall_fb": wall_s_fb,
            "vs_plain": shear_err({k: v[check] for k, v in got.items()},
                                  plain),
            "vs_jax": shear_err({k: v[idx_s] for k, v in got.items()}, ref_r),
            "k64": shear_err(kern64, plain),
            "plain_vs_jax": shear_err(
                {k: v[both_s] for k, v in plain.items()},
                {k: v[jpos_s] for k, v in ref_r.items()})}
        shear64[route] = plain
        if route == "table":
            pipe_ts = pipe_s
        del out_s, g_s
    gap = rs["jax_table_vs_lattice"]
    cross_s = shear_err(shear64["table"], shear64["lattice"])
    gate_p = max(3e-5, 2.0 * gap["xi_plus_worst_bin"])
    gate_m = max(3e-5, 2.0 * gap["xi_minus_row_peak"])

    # Kernel C on the mu = 4 operator (phase 3's gates), on phase 3's
    # seeded rows at its window.
    j_lo4, j_hi4, a_np4 = limber_fft.wtheta_lattice_operator(
        theta, DEFAULT_GRID, 4.0)
    c64_4 = torch.tensor(np.random.default_rng(0).lognormal(
        0.0, 1.0, (N_COSMO, j_hi4 - j_lo4)), device=dev)
    c_mu4 = check_c(c64_4, a_np4)
    # Kernel B on the kappa-kappa C_ell rows of the 512 cosmologies with
    # the mu = 4 operator (phase 6's gates).
    cosmo_ts, model_ts = pipe_ts.halo_model(batch)
    tab_mm = projection.power_tables_halo(cosmo_ts, pipe_ts.halo_params,
                                          model_ts, ("power_mm",),
                                          pipe_ts.st)["power_mm"]
    cl_kk = projection.limber_cl(cosmo_ts, pipe_ts.win_k, pipe_ts.win_k,
                                 pipe_ts.ells, tab_mm, pipe_ts.st).contiguous()
    op_mu4 = getattr(pipe_ts, f"op{pipe_ts.mus.index(4.0)}_t")
    b_mu4 = check_b(cl_kk, op_mu4)
    del cosmo_ts, model_ts, tab_mm

    for route, q in shear.items():
        print(f"[shear] {route} route, bench config A with include_shear="
              f"True, DEFAULT_GRID, B={N_COSMO}, float32 | forward launches "
              f"{q['launches']}, forward+backward {q['grad_launches'][0]} / "
              f"{q['grad_launches'][1]} | finite={q['finite']} (gradient "
              f"{q['finite_grad']}) | vs card f64 plain path (8 cosmologies):"
              f" w {q['vs_plain']['w_theta']:.3e}, gamma_t "
              f"{q['vs_plain']['gamma_t']:.3e}, xi+ "
              f"{q['vs_plain']['xi_plus']:.3e} (worst bin), xi- "
              f"{q['vs_plain']['xi_minus_peak']:.3e} of row peak (worst bin "
              f"{q['vs_plain']['xi_minus']:.3e}) (gates 1e-4) | vs JAX f64 (3 "
              f"cosmologies): xi+ {q['vs_jax']['xi_plus']:.3e}, xi- "
              f"{q['vs_jax']['xi_minus_peak']:.3e} of row peak (worst bin "
              f"{q['vs_jax']['xi_minus']:.3e}), all {gated(q['vs_jax']):.3e} "
              f"(gate 1e-4) | f64 kernels vs plain {gated(q['k64']):.3e} "
              f"(gate 1e-12) | f64 plain vs JAX "
              f"{gated(q['plain_vs_jax']):.3e} (gate 1e-10) | forward wall "
              f"median of 3 = {q['wall'] * 1e3:.1f} ms, peak {q['peak']:.2f} "
              f"GB | forward+backward wall median of 3 = "
              f"{q['wall_fb'] * 1e3:.1f} ms, peak {q['peak_fb']:.2f} GB",
              flush=True)
    print(f"[shear] f64 table vs lattice route (8 cosmologies): xi+ "
          f"{cross_s['xi_plus']:.3e} (gate {gate_p:.3e}; JAX "
          f"{gap['xi_plus_worst_bin']:.3e}), xi- "
          f"{cross_s['xi_minus_peak']:.3e} of row peak (gate {gate_m:.3e}; "
          f"JAX {gap['xi_minus_row_peak']:.3e}; worst bin "
          f"{cross_s['xi_minus']:.3e}, JAX {gap['xi_minus_worst_bin']:.3e})",
          flush=True)
    print(f"[shear] kernel C, mu = 4 operator ({N_COSMO}, {j_hi4 - j_lo4}) x "
          f"({a_np4.shape[0]}, {j_hi4 - j_lo4}) | f64 rel_to_peak="
          f"{c_mu4['f64']:.3e} (gate 1e-12) | f32 vs plain rel_to_peak="
          f"{c_mu4['plain']:.3e} (gate 1e-6) | f32 vs exact rel_to_peak="
          f"{c_mu4['exact']:.3e} (gate 1e-7) | deterministic={c_mu4['same']}"
          f" | kernel B on the kappa-kappa C_ell rows {tuple(cl_kk.shape)} "
          f"@ mu = 4 operator {tuple(op_mu4.shape)} | f64 rel_to_row_peak="
          f"{b_mu4['f64']:.3e} (gate 1e-12) | f32 vs plain max rel="
          f"{b_mu4['plain']:.3e} (gate 2e-5) | f32 vs exact max rel="
          f"{b_mu4['exact']:.3e}, torch.matmul f32 {b_mu4['lib_exact']:.3e} "
          f"(gate 2x) | deterministic={b_mu4['same']}", flush=True)
    for route, q in shear.items():
        if q["launches"] != want_s[route] or q["grad_launches"] != (
                want_s[route], want_s[route]):
            fail(f"shear {route} launches: forward {q['launches']}, "
                 f"forward+backward {q['grad_launches']}; want "
                 f"{want_s[route]} each")
        if not (q["finite"] and q["finite_grad"]):
            fail(f"shear {route}: outputs or gradient not finite")
        for name, val, gate in (("vs f64 plain", gated(q["vs_plain"]), 1e-4),
                                ("vs JAX", gated(q["vs_jax"]), 1e-4),
                                ("f64 kernels vs plain", gated(q["k64"]),
                                 1e-12),
                                ("f64 plain vs JAX", gated(q["plain_vs_jax"]),
                                 1e-10)):
            if not val <= gate:
                fail(f"shear {route} {name}: {val} (gate {gate})")
    if not (cross_s["xi_plus"] < gate_p and cross_s["xi_minus_peak"] < gate_m):
        fail(f"shear table vs lattice route in float64: {cross_s}")
    if not (c_mu4["f64"] <= 1e-12 and c_mu4["plain"] <= 1e-6
            and c_mu4["exact"] <= 1e-7 and c_mu4["same"]):
        fail(f"df_contract on the mu = 4 operator: {c_mu4}")
    if not (b_mu4["f64"] <= 1e-12 and b_mu4["plain"] <= 2e-5
            and b_mu4["exact"] <= 2.0 * b_mu4["lib_exact"] and b_mu4["same"]):
        fail(f"hankel_matmul on the mu = 4 operator: {b_mu4}")

    lap("12")

    # -- 13. the tomographic 3x2pt cell (DES Y3-like) ----------------------
    import dataclasses

    ref_tm = json.loads((REPO / "tests" / "data"
                         / "torch_tomo_reference.json").read_text())
    cell, rtm = ref_tm["cell"], ref_tm["default_grid"]
    idx_tm = np.asarray(rtm["indices"])
    if rtm["n_cosmo"] != N_COSMO or not np.allclose(rtm["omega_m0"],
                                                    oms[idx_tm]):
        fail("tomographic reference file does not match this run's "
             "cosmologies")
    # The float64 rows: phase 5's 8 checked cosmologies and the 3 of the
    # reference file.
    meas_tm = sorted(set(check.tolist()) | set(idx_tm.tolist()))
    pos_chk = [meas_tm.index(i) for i in check]
    pos_ref = [meas_tm.index(i) for i in idx_tm]
    n_th = DEFAULT_GRID.n_theta
    keys_tm = ("w_theta", "gamma_t", "xi_plus", "xi_minus")

    def tomo_of(dtype):
        return tomo_cell(ref_tm, device=dev, dtype=dtype)

    def tomo_host(out, rows=None):
        sel = slice(None) if rows is None else rows
        return {k: out[k].double().cpu().numpy()[sel]
                for k in keys_tm + ("n_g",)}

    def tomo_err(got, ref):
        """{key: error}: for w, gamma_t and xi+ the worst bin over the rows
        that keep one sign over theta, and for xi- and any row that
        changes sign the worst error relative to the row's peak; n_g by
        its worst element."""
        e = {"n_g": worst_bin(got["n_g"], ref["n_g"])}
        for k in keys_tm:
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            peak = np.abs(g - r).max(-1) / np.abs(r).max(-1)
            bins = np.abs(g / r - 1.0).max(-1)
            one_sign = ((r > 0).all(-1) | (r < 0).all(-1)) & (
                k != "xi_minus")
            e[k] = float(np.where(one_sign, bins, peak).max())
            e[f"{k} row peak"] = float(peak.max())
        return e

    def gated_tm(e):
        """The gated figures of tomo_err (row-peak ones are reported)."""
        return max(v for k, v in e.items() if not k.endswith("row peak"))

    pipe_tm, nu_tm = tomo_of(f32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    with torch.no_grad():
        out_tm = pipe_tm(batch, nu_tm)
    torch.cuda.synchronize()
    launches_tm = counts()[0]
    peak_tm = torch.cuda.max_memory_allocated() / 1e9
    got_tm = tomo_host(out_tm)
    vec_shape = tuple(out_tm["vector"].shape)
    finite_tm = (all(bool(np.all(np.isfinite(v))) for v in got_tm.values())
                 and bool(torch.isfinite(out_tm["vector"]).all()))
    shape_tm = (got_tm["w_theta"].shape == (N_COSMO, 5, n_th)
                and got_tm["gamma_t"].shape == (N_COSMO, 20, n_th)
                and got_tm["xi_plus"].shape == (N_COSMO, 10, n_th)
                and got_tm["n_g"].shape == (N_COSMO, 5)
                and vec_shape == (N_COSMO, 45 * n_th))
    sign_rows = {k: int((~((np.asarray(rtm[k]) > 0).all(-1)
                           | (np.asarray(rtm[k]) < 0).all(-1))).sum())
                 for k in keys_tm}
    del out_tm
    pipe_tm64, nu_tm64 = tomo_of(f64)
    batch_tm64 = setup(f64, meas_tm)[0]
    with plain_path():
        plain_tm = tomo_host(pipe_tm64(batch_tm64, nu_tm64))
    kern_tm = tomo_host(pipe_tm64(batch_tm64, nu_tm64))
    ref_tm_out = {k: np.asarray(rtm[k]) for k in keys_tm + ("n_g",)}
    err_tm = {
        "vs_plain": tomo_err({k: v[check] for k, v in got_tm.items()},
                             {k: v[pos_chk] for k, v in plain_tm.items()}),
        "vs_jax": tomo_err({k: v[idx_tm] for k, v in got_tm.items()},
                           ref_tm_out),
        "k64": tomo_err(kern_tm, plain_tm),
        "plain_vs_jax": tomo_err({k: v[pos_ref] for k, v in
                                  plain_tm.items()}, ref_tm_out)}
    with torch.no_grad():
        wall_tm = median_wall(lambda: pipe_tm(batch, nu_tm))

    want_tm = {"halo_contract": 1, "df_contract": 3, "hankel_matmul": 0}
    print(f"[tomo] DES Y3-like 3x2pt cell (5 lens x 4 source bins, 45 "
          f"probes + 30 magnification rows = 65 convolution rows; per-bin "
          f"HODs, z_pivot {cell['z_pivot']}, nuisance point of seed "
          f"{ref_tm['seed']}), DEFAULT_GRID, B={N_COSMO}, float32 | forward "
          f"launches {launches_tm} | finite={finite_tm} shape_ok={shape_tm} "
          f"(vector {vec_shape}) | rows changing sign over theta in the JAX "
          f"values {sign_rows} (held to their row peak) | vs card f64 plain "
          f"path ({len(check)} cosmologies): "
          + ", ".join(f"{k} {v:.3e}" for k, v in err_tm["vs_plain"].items())
          + " (gate 1e-4 on all but the row-peak figures, which are "
          "reported) | vs JAX f64 (3 cosmologies): "
          + ", ".join(f"{k} {v:.3e}" for k, v in err_tm["vs_jax"].items())
          + f" (gate 1e-4) | f64 kernels vs plain "
          f"{gated_tm(err_tm['k64']):.3e} (gate 1e-12) | f64 plain vs "
          f"JAX {gated_tm(err_tm['plain_vs_jax']):.3e} (gate 1e-10) | "
          f"forward wall median of 3 = {wall_tm * 1e3:.1f} ms "
          f"({wall_tm / N_COSMO * 1e3:.3f} ms/cosmology), peak device "
          f"memory {peak_tm:.2f} GB", flush=True)
    if launches_tm != want_tm:
        fail(f"tomographic forward launches {launches_tm}; want {want_tm}")
    if not (finite_tm and shape_tm):
        fail("tomographic outputs not finite, or of the wrong shape")
    for name, val, gate in (
            ("float32 vs float64 plain path", gated_tm(err_tm["vs_plain"]),
             1e-4),
            ("float32 vs JAX float64", gated_tm(err_tm["vs_jax"]), 1e-4),
            ("float64 kernels vs plain path", gated_tm(err_tm["k64"]), 1e-12),
            ("float64 plain path vs JAX", gated_tm(err_tm["plain_vs_jax"]),
             1e-10)):
        if not val <= gate:
            fail(f"tomographic {name}: {val} (gate {gate})")

    # Kernels A and A' over the cell's folded rows: B x 5 = 2560, row 5 b
    # + i = cosmology b with lens bin i's galaxy pack, as the forward
    # launches them (TomographicPipeline.contraction_rows).
    def tomo_nodes(pipe_, batch_):
        launches_ = pipe_.contraction_rows(batch_)
        if len(launches_) != 1:
            fail(f"tomographic kernel A inputs: {len(launches_)} launches")
        return (t.contiguous() for t in launches_[0])

    mat_tm32, gal_tm32 = tomo_nodes(pipe_tm, batch)
    mat_tm64, gal_tm64 = tomo_nodes(pipe_tm64, batch_tm64)
    # 8 float64 rows: checked cosmology c with lens bin c mod 5.
    sel = torch.tensor([pos_chk[c] * 5 + c % 5 for c in range(len(check))],
                       device=dev)
    mat_tm64, gal_tm64 = mat_tm64[sel].contiguous(), gal_tm64[sel].contiguous()
    rows_tm = mat_tm32.shape[0]
    # A and A' are held to their plain versions on the same 8 rows in
    # float32 as in float64 (all 2560 rows until PR 8: the plain versions
    # over them cost tens of seconds); their times cover all rows.
    sel32 = torch.tensor([int(check[c]) * 5 + c % 5
                          for c in range(len(check))], device=dev)
    mat_tc32, gal_tc32 = (mat_tm32[sel32].contiguous(),
                          gal_tm32[sel32].contiguous())
    a_tm = check_a(k32, mat_tc32, gal_tc32, k64, mat_tm64, gal_tm64, cheb32,
                   cheb64)
    ms_a_tm = events_ms(lambda: hc.halo_contract(k32, mat_tm32, gal_tm32,
                                                 cheb32), 20)
    bound_a_tm = bound_a_of(k32, mat_tm32, gal_tm32)
    profiled["halo_contract tomographic"] = (
        lambda: hc.halo_contract(k32, mat_tm32, gal_tm32, cheb32), None, 5)
    # The share of A's operations there that repeat bin 0's mass pack
    # (h_m and pp_mm of rows 5 b + 1..4, thrown away; A' then sums five
    # equal mat gradients), by the operation count of the bound.
    flops_tm = halo_contract_flops(k32, mat_tm32, gal_tm32, hc._lens(f32),
                                   hc.n_moments(f32))
    flops_tm_mat = halo_contract_flops(k32, mat_tm32, gal_tm32[:, :0],
                                       hc._lens(f32), hc.n_moments(f32))
    bwd_tm = check_a_bwd(k32, mat_tc32, gal_tc32, k64, mat_tm64, gal_tm64,
                         35)
    ga_tm = seeded((rows_tm, hc.N_OUT, k32.numel()), 36, f32)
    ms_abwd_tm = events_ms(lambda: hc.halo_contract_bwd(
        k32, mat_tm32, gal_tm32, cheb32, ga_tm), 20)
    bound_abwd_tm = bound_abwd_of(k32, mat_tm32, gal_tm32, ga_tm)
    profiled["halo_contract_bwd tomographic"] = (
        lambda: hc.halo_contract_bwd(k32, mat_tm32, gal_tm32, cheb32, ga_tm),
        None, 5)
    if not (a_tm["f64"] <= 1e-12 and a_tm["f32"] <= 2e-6
            and a_tm["f32"] <= 1.5 * a_tm["plain32"] and a_tm["same"]):
        fail(f"halo_contract at the tomographic rows: {a_tm}")
    if not (bwd_tm["f64"] <= 1e-12 and bwd_tm["f32"] <= 2e-5
            and bwd_tm["f32"] <= 1.5 * bwd_tm["plain32"]
            and bwd_tm["same"]):
        fail(f"halo_contract_bwd at the tomographic rows: {bwd_tm}")
    del mat_tm64, gal_tm64

    # Kernel C at the cell's row counts: the forward's own convolution
    # rows (float32 inputs, float64 sums) of each operator.
    with torch.no_grad():
        cos_c, _nu_c, models_c, rows_c, _sp = pipe_tm.probe_rows(batch,
                                                                  nu_tm)
        ops_tm = [pipe_tm.operator(i) for i in range(len(pipe_tm.mus))]
        jl_tm = min(o[0] for o in ops_tm)
        jh_tm = max(o[1] for o in ops_tm)
        g_rows = limber_fft._lattice_g_rows(
            cos_c, [(wa, wb) for wa, wb, _p, _s in rows_c], pipe_tm.st,
            models_c[0].mass.growth)
        p_rows = torch.stack([p for _a, _b, p, _s in rows_c], dim=1)
        conv_tm = limber_fft._conv_direct_rows64(p_rows, g_rows, jl_tm,
                                                 jh_tm)
        del cos_c, models_c, g_rows, p_rows
    c_tm, cb_tm = {}, {}
    for i, mu in enumerate(pipe_tm.mus):
        rl = [r for r, row in enumerate(rows_c) if i in row[3]]
        lo, hi = ops_tm[i][0], ops_tm[i][1]
        c64_i = conv_tm[:, rl, lo - jl_tm:hi - jl_tm].reshape(
            -1, hi - lo).contiguous()
        a_np_i = limber_fft.wtheta_lattice_operator(pipe_tm.theta_key,
                                                    DEFAULT_GRID, mu)[2]
        q = check_c(c64_i, a_np_i)
        c32_i = c64_i.to(f32)
        c32_i64 = c32_i.double()
        a64_i = torch.tensor(a_np_i, device=dev)
        hi_i, lo_i = (torch.tensor(x, device=dev)
                      for x in df32.split_operator(a_np_i))
        ms_i, lib_i = in_turns_ms(
            lambda c=c32_i, h=hi_i, l=lo_i: df32.df_contract(c, h, l),
            lambda c=c32_i64, a=a64_i: c @ a.T)
        m_i, n_i, t_i = c32_i.shape[0], c32_i.shape[1], hi_i.shape[0]
        q.update(rows=m_i, n=n_i, ms=ms_i, lib_ms=lib_i, bound=bound(
            2.0 * m_i * n_i * t_i, 4 * (m_i * n_i + 2 * t_i * n_i
                                        + m_i * t_i)),
            geometry=geometry(m_i, n_i, t_i))
        c_tm[mu] = q
        profiled[f"df_contract tomographic mu={mu:g}"] = (
            lambda c=c32_i, h=hi_i, l=lo_i: df32.df_contract(c, h, l),
            lambda c=c32_i64, a=a64_i: c @ a.T, 20)
        if not (q["f64"] <= 1e-12 and q["plain"] <= 1e-6
                and q["exact"] <= 1e-7 and q["same"]):
            fail(f"df_contract at the tomographic mu = {mu:g} rows: {q}")
        # C' at the same M under a seeded (M, 64) cotangent, phase 8's
        # check and gates (its products are plain matmuls: (M, n) float64
        # is 0.36 GB at M = 20480).
        g_i = seeded((m_i, t_i), 40 + i)
        qb = check_bc_bwd(df32.df_contract_bwd, g_i, (a64_i,),
                          (hi_i, lo_i), prod_c)
        g32_i = g_i.to(f32)
        g32_i64 = g32_i.double()
        ms_b, lib_b = in_turns_ms(
            lambda g=g32_i, h=hi_i, l=lo_i: df32.df_contract_bwd(g, h, l),
            lambda g=g32_i64, a=a64_i: g @ a)
        qb.update(rows=m_i, n=n_i, ms=ms_b, lib_ms=lib_b,
                  plain_ms=events_ms(
                      lambda g=g32_i, h=hi_i, l=lo_i:
                      df32.df_contract_bwd_ref(g, h, l), 20),
                  bound=bound(2.0 * m_i * n_i * t_i,
                              4 * (m_i * t_i + 2 * t_i * n_i + m_i * n_i)))
        cb_tm[mu] = qb
        profiled[f"df_contract_bwd tomographic mu={mu:g}"] = (
            lambda g=g32_i, h=hi_i, l=lo_i: df32.df_contract_bwd(g, h, l),
            lambda g=g32_i64, a=a64_i: g @ a, 20)
        if not (qb["f64"] <= 1e-12 and qb["exact"] <= 2.0 * qb["lib_exact"]
                and qb["same"]):
            fail(f"df_contract_bwd at the tomographic mu = {mu:g} rows: "
                 f"{qb}")
    del conv_tm, rows_c

    print(f"[tomo A] folded node set: B x n_lens = {N_COSMO} x 5 = "
          f"{rows_tm} rows, NK={k32.numel()} NM={mat_tm32.shape[1]} NG="
          f"{gal_tm32.shape[1]} | f64 rel_to_peak={a_tm['f64']:.3e} (8 rows, "
          f"gate 1e-12) | f32 vs plain version on the same inputs in f64: "
          f"rel_to_peak={a_tm['f32']:.3e} max_abs={a_tm['abs']:.3e} (gate "
          f"2e-6, and <= 1.5x the plain f32 version's own "
          f"{a_tm['plain32']:.3e}) | deterministic={a_tm['same']} | kernel "
          f"{ms_a_tm:.3f} ms (CUDA events, 20 calls), plain "
          f"{a_tm['plain_ms']:.1f} ms (1 call on the 8 checked rows) | bound "
          f"{bound_a_tm[0]:.4f} ms "
          f"by {bound_a_tm[1]} | the mass pack's share of the operations "
          f"{flops_tm_mat / flops_tm:.4f}, of which 4/5 repeat bin 0's: "
          f"{0.8 * flops_tm_mat / flops_tm:.4f} of A's operations",
          flush=True)
    print(f"[tomo A'] folded node set ({rows_tm} rows): f64 field_peak_rel="
          f"{bwd_tm['f64']:.3e} (8 rows, gate 1e-12) | f32 vs plain backward "
          f"on the same inputs in f64: field_peak_rel={bwd_tm['f32']:.3e} "
          f"max_abs={bwd_tm['abs']:.3e} (gate 2e-5, and <= 1.5x the plain "
          f"f32 backward's own {bwd_tm['plain32']:.3e}) | deterministic="
          f"{bwd_tm['same']} | kernel {ms_abwd_tm:.3f} ms (CUDA events, 20 "
          f"calls), plain {bwd_tm['plain_ms']:.1f} ms (1 call on the 8 "
          f"checked rows) | bound {bound_abwd_tm[0]:.4f} ms by "
          f"{bound_abwd_tm[1]}", flush=True)
    for mu, q in c_tm.items():
        print(f"[tomo C] mu = {mu:g}: ({q['rows']}, {q['n']}) rows | f64 "
              f"rel_to_peak={q['f64']:.3e} (gate 1e-12) | f32 vs "
              f"plain rel_to_peak={q['plain']:.3e} (gate 1e-6) | f32 vs "
              f"exact rel_to_peak={q['exact']:.3e} (gate 1e-7) | "
              f"deterministic={q['same']} | kernel {q['ms']:.4f} ms, f64 "
              f"torch.matmul {q['lib_ms']:.4f} ms (CUDA events, 100 calls, "
              f"in turns) | bound {q['bound'][0]:.5f} ms by "
              f"{q['bound'][1]} | plain {q['plain_ms']:.2f} ms (1 call, in "
              f"blocks of 1024 rows) | {q['geometry']}", flush=True)
    for mu, q in cb_tm.items():
        print(f"[tomo C'] mu = {mu:g}: ({q['rows']}, 64) -> ({q['rows']}, "
              f"{q['n']}) | f64 rel_to_row_peak={q['f64']:.3e} (gate 1e-12) "
              f"| f32 vs exact f64 product rel_to_peak={q['exact']:.3e} "
              f"max_abs={q['abs']:.3e}, torch.matmul f32 "
              f"{q['lib_exact']:.3e} (gate 2x) | deterministic={q['same']} "
              f"| kernel {q['ms']:.4f} ms, f64 torch.matmul "
              f"{q['lib_ms']:.4f} ms (CUDA events, 100 calls, in turns), "
              f"plain {q['plain_ms']:.4f} ms (20 calls) | bound "
              f"{q['bound'][0]:.5f} ms by {q['bound'][1]} | "
              f"{geometry(q['rows'], 64, q['n'])}", flush=True)
    lap("13")

    # -- 14. tomographic gradients and inference -------------------------
    weights_tm = seeded((N_COSMO, 45 * n_th), 34, f32)

    def grad_run_tm():
        """One torch.autograd.grad of a seeded linear functional of the
        data vector with respect to (omega_m0, sigma_8) per cosmology and
        the nuisance point's (dz_src, m, a_ia)."""
        om = torch.tensor(oms, dtype=f32, device=dev, requires_grad=True)
        s8 = torch.tensor(s8s, dtype=f32, device=dev, requires_grad=True)
        leaves = {k: getattr(nu_tm, k).clone().requires_grad_(True)
                  for k in ("dz_src", "m", "a_ia")}
        out = pipe_tm(broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                      omega_m0=om, omega_l0=1.0 - om,
                                      sigma_8=s8),
                      dataclasses.replace(nu_tm, **leaves))
        return torch.autograd.grad((out["vector"] * weights_tm).sum(),
                                   (om, s8, *leaves.values()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    g_tm = grad_run_tm()
    torch.cuda.synchronize()
    grad_launches_tm = counts()
    peak_tm_fb = torch.cuda.max_memory_allocated() / 1e9
    finite_gtm = all(bool(torch.isfinite(g).all()) for g in g_tm)
    del g_tm
    wall_tm_fb = median_wall(grad_run_tm)

    rj = rtm["jacobian"]

    def theory_tm(pipe_, nu_, dtype):
        return inference.make_theory_fn(
            pipe_, default_cosmo(device=dev, dtype=dtype),
            tuple(rj["cosmo_names"]), output="vector", nuisance0=nu_,
            nuisance_names=tuple(rj["nuisance_names"]))

    th_tm32, p0_tm32 = theory_tm(pipe_tm, nu_tm, f32)
    th_tm64, p0_tm64 = theory_tm(pipe_tm64, nu_tm64, f64)
    if not np.allclose(p0_tm64[:2].cpu().numpy(), [rj["omega_m0"],
                                                   rj["sigma_8"]]):
        fail("tomographic Jacobian reference is not at the fiducial")
    t0 = time.perf_counter()
    jac_tm32 = inference.jacobian(th_tm32, p0_tm32, chunk=512)
    torch.cuda.synchronize()
    jac_wall32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    jac_tm64 = inference.jacobian(th_tm64, p0_tm64, chunk=256)
    torch.cuda.synchronize()
    jac_wall64 = time.perf_counter() - t0
    jax_jtm = np.asarray(rj["jacobian"])

    def jac_err_tm(got, ref):
        """(max over (probe row, parameter) of the worst entry over theta
        relative to that column's peak over theta, max |got| where the
        reference column is identically 0)."""
        got = np.asarray(got, dtype=np.float64).reshape(45, n_th, -1)
        ref = np.asarray(ref, dtype=np.float64).reshape(45, n_th, -1)
        d = np.abs(got - ref).max(axis=1)
        peak = np.abs(ref).max(axis=1)
        nz = peak > 0
        return (float((d[nz] / peak[nz]).max()),
                float(d[~nz].max()) if (~nz).any() else 0.0)

    j32 = jac_tm32.cpu().numpy()
    j64 = jac_tm64.cpu().numpy()
    je_tm = {"f32_vs_f64": jac_err_tm(j32, j64),
             "f64_vs_jax": jac_err_tm(j64, jax_jtm),
             "f32_vs_jax": jac_err_tm(j32, jax_jtm)}

    # A short HMC over the Jacobian's 11 parameters: the float64 vector at
    # the fiducial as data, sigma_i = 0.05 |d_i| + 1e-3 of the probe row's
    # peak, the DES Y3 prior widths on the nuisances (1 on A_ia), and the
    # Fisher matrix with those priors as the mass.
    with torch.no_grad():
        data_tm = th_tm64(p0_tm64)[0]
    row_pk = data_tm.reshape(45, n_th).abs().amax(1, keepdim=True)
    sig_tm = 0.05 * data_tm.abs() + 1e-3 * row_pk.expand(45, n_th).reshape(-1)
    ps = cell["prior_sigma"]
    prior_sig = np.array([np.inf, np.inf] + [ps["dz_src"]] * 4
                         + [ps["m"]] * 4 + [1.0])
    like_tm = inference.GaussianLikelihood(
        th_tm32, data_tm, torch.diag(sig_tm * sig_tm),
        prior_mean=p0_tm64.cpu().numpy(), prior_sigma=prior_sig)
    jw = jac_tm64 / sig_tm[:, None]
    fisher_tm = jw.T @ jw + torch.diag(torch.tensor(
        np.where(np.isfinite(prior_sig), prior_sig ** -2.0, 0.0), dtype=f64,
        device=dev))
    gen_tm = torch.Generator(device=dev).manual_seed(ref_tm["seed"])
    z_tm = torch.randn((64, p0_tm64.numel()), generator=gen_tm, device=dev,
                       dtype=f64)
    q0_tm = p0_tm64 + torch.linalg.solve_triangular(
        torch.linalg.cholesky(fisher_tm).T, z_tm.T, upper=True).T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples_tm, accept_tm = inference.hmc(like_tm.neg_log_post, fisher_tm,
                                          q0_tm, gen_tm, n_steps=2,
                                          n_leap=5, eps=0.3)
    torch.cuda.synchronize()
    hmc_wall_tm = time.perf_counter() - t0
    acc_tm = float(accept_tm.double().mean())
    hmc_finite_tm = bool(torch.isfinite(samples_tm).all())
    print(f"[tomo grad] forward+backward (autograd.grad of a seeded linear "
          f"functional of the vector wrt (omega_m0, sigma_8) per cosmology "
          f"and (dz_src, m, a_ia)), B={N_COSMO}, float32: launches forward "
          f"{grad_launches_tm[0]}, backward {grad_launches_tm[1]} | "
          f"finite={finite_gtm} | wall median of 3 = {wall_tm_fb * 1e3:.1f} "
          f"ms | peak device memory {peak_tm_fb:.2f} GB", flush=True)
    print(f"[tomo grad] Jacobian of the vector ({data_tm.numel()} entries) "
          f"over {list(rj['cosmo_names']) + list(rj['nuisance_names'])} "
          f"({p0_tm64.numel()} parameters) at the fiducial "
          f"(inference.jacobian by replicas, f32 chunks of 512 in "
          f"{jac_wall32:.1f} s, f64 chunks of 256 in {jac_wall64:.1f} s): "
          f"f32 vs card f64 {je_tm['f32_vs_f64'][0]:.3e} of each column's "
          f"peak over theta (gate 1e-3), f64 vs JAX jacfwd "
          f"{je_tm['f64_vs_jax'][0]:.3e} (gate 1e-9), f32 vs JAX "
          f"{je_tm['f32_vs_jax'][0]:.3e}; where JAX's column is 0: f32 "
          f"{je_tm['f32_vs_jax'][1]:.1e}, f64 {je_tm['f64_vs_jax'][1]:.1e} "
          f"(gate 0)", flush=True)
    print(f"[tomo inference] hmc: 64 chains x 2 steps x 5 leapfrogs over the "
          f"{p0_tm64.numel()} parameters, eps 0.3, Fisher mass with priors: "
          f"finite={hmc_finite_tm}, mean acceptance {acc_tm:.4f} (gate > "
          f"0.5), wall {hmc_wall_tm:.2f} s", flush=True)
    if grad_launches_tm != (want_tm, want_tm):
        fail(f"tomographic forward+backward launches {grad_launches_tm}; "
             f"want {want_tm} each")
    if not finite_gtm:
        fail("tomographic gradient not finite")
    for name, (val, zero), gate in (
            ("Jacobian f32 vs f64", je_tm["f32_vs_f64"], 1e-3),
            ("Jacobian f64 vs JAX", je_tm["f64_vs_jax"], 1e-9)):
        if not (val <= gate and zero == 0.0):
            fail(f"tomographic {name}: {val} (gate {gate}), {zero} where "
                 f"the reference column is 0")
    if not (hmc_finite_tm and acc_tm > 0.5):
        fail(f"tomographic hmc: finite={hmc_finite_tm}, acceptance {acc_tm}")
    del jac_tm32, jac_tm64, samples_tm

    lap("14")

    # -- 15-19. the pipelines' options -------------------------------------
    from chomp_tpu_torch import curved

    ref_op = json.loads((REPO / "tests" / "data"
                         / "torch_options_reference.json").read_text())
    cells_op, rop = ref_op["cells"], ref_op["default_grid"]["cells"]
    keys_op = ("w_theta", "gamma_t", "xi_plus", "xi_minus", "w_gk_cmb")

    def op_host(out, rows=None):
        sel = slice(None) if rows is None else rows
        return {k: out[k].double().cpu().numpy()[sel]
                for k in keys_op + ("n_g",) if k in out}

    def op_err(got, ref):
        """{key: error}: the worst bin of each row that keeps one sign over
        theta, the worst error relative to the row's peak for the others
        and for xi-; n_g by its worst element."""
        e = {}
        for k, r in ref.items():
            g, r = np.asarray(got[k]), np.asarray(r)
            if k == "n_g":
                e[k] = worst_bin(g, r)
                continue
            peak = np.abs(g - r).max(-1) / np.abs(r).max(-1)
            one_sign = ((r > 0).all(-1) | (r < 0).all(-1)) & (
                k != "xi_minus")
            with np.errstate(divide="ignore", invalid="ignore"):
                bins = np.abs(g / r - 1.0).max(-1)
            e[k] = float(np.where(one_sign, bins, peak).max())
        return e

    def opt_pipe(name, dtype, idx=None):
        """(pipeline, forward arguments) of option cell ``name`` at ``idx``
        of its configuration's linspaces (all of them by default)."""
        cell = cells_op[name]
        kw = dict(device=dev, dtype=dtype)
        theta = ref_op["des_theta_deg"] if cell["theta"] == "des" else None
        batch_, hp_, hod_, dist_ = setup(dtype, idx, n=rop[name]["n_cosmo"])
        hp_ = dataclasses.replace(hp_, mass_fn=torch.tensor(cell["mass_fn"],
                                                            **kw))
        if cell["config"] == "tomo":
            pipe_, nu_ = tomo_cell(ref_tm, halo_params=hp_, theta_deg=theta,
                                   **cell["options"], **kw)
            return pipe_, (batch_, nu_)
        return make_pipeline(
            hp_, hod_, dist_, power_spec="power_gg", grid=DEFAULT_GRID,
            include_lensing=True, theta_deg=theta,
            z_pivot=1.0 if cell["config"] == "A" else 0.0,
            **cell["options"], **kw), (batch_,)

    def run_cell(name, fwd_bwd=False):
        """Option cell ``name`` at full width in float32: launch counts,
        finiteness and shapes, the gates' errors against the card's
        float64 plain path and the committed JAX values, forward wall and
        peak memory; with ``fwd_bwd`` one torch.autograd.grad of a seeded
        linear functional of every output (with respect to omega_m0,
        sigma_8 and, on the tomographic cell, the nuisance point's dz_src,
        m and a_ia), its launch counts, wall and peak."""
        r = rop[name]
        n = r["n_cosmo"]
        idx_r = np.asarray(r["indices"])
        chk = check if n == N_COSMO else check_x
        if not np.allclose(r["omega_m0"], np.linspace(0.24, 0.32, n)[idx_r]):
            fail(f"option cell {name}: reference cosmologies differ")
        meas = sorted(set(chk.tolist()) | set(idx_r.tolist()))
        pos_chk = [meas.index(i) for i in chk]
        pos_ref = [meas.index(i) for i in idx_r]
        t0 = time.perf_counter()
        pipe_, args = opt_pipe(name, f32)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_zero()
        with torch.no_grad():
            out = pipe_(*args)
        torch.cuda.synchronize()
        fw = counts()[0]
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = op_host(out)
        finite = all(bool(torch.isfinite(v).all()) for k, v in out.items()
                     if k != "theta_deg")
        ref_out = {k: np.asarray(v) for k, v in r["outputs"].items()
                   if k in keys_op + ("n_g",)}
        shape_ok = all(k in got and got[k].shape == (n,) + v.shape[1:]
                       for k, v in ref_out.items())
        shapes = {k: tuple(v.shape) for k, v in out.items()
                  if k in keys_op + ("vector",)}
        del out
        pipe64, args64 = opt_pipe(name, f64, meas)
        with plain_path():
            plain = op_host(pipe64(*args64))
        kern = op_host(pipe64(*args64))

        def sub(d, rows):
            return {k: v[rows] for k, v in d.items()}

        err = {"vs_plain": op_err(sub(got, chk), sub(plain, pos_chk)),
               "vs_jax": op_err(sub(got, idx_r), ref_out),
               "k64": op_err(kern, plain),
               "plain_vs_jax": op_err(sub(plain, pos_ref), ref_out)}
        with torch.no_grad():
            wall = median_wall(lambda: pipe_(*args), 1)
        q = dict(pipe=pipe_, pipe64=pipe64, args=args, args64=args64,
                 chk=chk, pos_chk=pos_chk, launches=fw, peak=peak,
                 wall=wall, err=err, finite=finite, shape_ok=shape_ok,
                 shapes=shapes, build_s=build_s, plain=plain, n=n)
        if fwd_bwd:
            n_out = sum(int(np.prod(v[1:])) for k, v in shapes.items()
                        if k in keys_op)
            weights = seeded((n, n_out), 50, f32)
            nu0 = args[1] if len(args) > 1 else None

            def grad_run():
                om = torch.tensor(np.linspace(0.24, 0.32, n), dtype=f32,
                                  device=dev, requires_grad=True)
                s8 = torch.tensor(np.linspace(0.75, 0.88, n), dtype=f32,
                                  device=dev, requires_grad=True)
                cos = broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                      omega_m0=om, omega_l0=1.0 - om,
                                      sigma_8=s8)
                leaves = ({k: getattr(nu0, k).clone().requires_grad_(True)
                           for k in ("dz_src", "m", "a_ia")}
                          if nu0 is not None else {})
                o = (pipe_(cos, dataclasses.replace(nu0, **leaves))
                     if nu0 is not None else pipe_(cos))
                vec = torch.cat([o[k].flatten(1) for k in keys_op if k in o],
                                dim=-1)
                return torch.autograd.grad((vec * weights).sum(),
                                           (om, s8, *leaves.values()))

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts_zero()
            g = grad_run()
            torch.cuda.synchronize()
            q["grad_launches"] = counts()
            q["peak_fb"] = torch.cuda.max_memory_allocated() / 1e9
            q["finite_grad"] = all(bool(torch.isfinite(x).all()) for x in g)
            del g
            q["wall_fb"] = median_wall(grad_run, 1)
        return q

    def report_cell(label, q, want):
        e = q["err"]
        print(f"[{label}] B={q['n']}, float32, DEFAULT_GRID | build "
              f"{q['build_s']:.1f} s | forward launches {q['launches']} | "
              f"finite={q['finite']} shape_ok={q['shape_ok']} {q['shapes']} "
              f"| vs card f64 plain path ({len(q['chk'])} cosmologies): "
              + ", ".join(f"{k} {v:.3e}" for k, v in e["vs_plain"].items())
              + " (gate 1e-4; worst bin, row peak for xi- and rows that "
              "change sign) | vs JAX f64 (3 cosmologies): "
              + ", ".join(f"{k} {v:.3e}" for k, v in e["vs_jax"].items())
              + f" (gate 1e-4) | f64 kernels vs plain "
              f"{max(e['k64'].values()):.3e} (gate 1e-12) | f64 plain vs JAX "
              f"{max(e['plain_vs_jax'].values()):.3e} (gate 1e-10) | forward "
              f"wall one call = {q['wall'] * 1e3:.1f} ms "
              f"({q['wall'] / q['n'] * 1e3:.3f} ms/cosmology), peak "
              f"{q['peak']:.2f} GB"
              + (f" | forward+backward launches {q['grad_launches'][0]} / "
                 f"{q['grad_launches'][1]}, finite={q['finite_grad']}, wall "
                 f"one call = {q['wall_fb'] * 1e3:.1f} ms, peak "
                 f"{q['peak_fb']:.2f} GB" if "wall_fb" in q else ""),
              flush=True)
        if q["launches"] != want:
            fail(f"{label} forward launches {q['launches']}; want {want}")
        if "grad_launches" in q and q["grad_launches"] != (want, want):
            fail(f"{label} forward+backward launches {q['grad_launches']}; "
                 f"want {want} each")
        if not (q["finite"] and q["shape_ok"] and q.get("finite_grad", True)):
            fail(f"{label}: outputs (or gradient) not finite, or of the "
                 f"wrong shape")
        for what, val, gate in (
                ("float32 vs float64 plain path", e["vs_plain"], 1e-4),
                ("float32 vs JAX float64", e["vs_jax"], 1e-4),
                ("float64 kernels vs plain path", e["k64"], 1e-12),
                ("float64 plain path vs JAX", e["plain_vs_jax"], 1e-10)):
            if not max(val.values()) <= gate:
                fail(f"{label} {what}: {val} (gate {gate})")

    def nl_check(q, label):
        """The non-Limber corrections of the float32 pipeline against the
        float64 one on the checked cosmologies, relative to the peak of
        the corrected row (float64 plain path)."""
        pipe_, pipe64 = q["pipe"], q["pipe64"]
        b32 = setup(f32, q["chk"], n=q["n"])[0]
        nu_args = q["args"][1:]
        with torch.no_grad():
            t32 = pipe_.nonlimber_terms(b32, *nu_args)
            t64 = pipe64.nonlimber_terms(*q["args64"])
        worst = 0.0
        for key in t32:
            a = t32[key].cpu().numpy()
            b = t64[key].cpu().numpy()[q["pos_chk"]]
            peak = np.abs(q["plain"][key][q["pos_chk"]]).max(-1)
            worst = max(worst, float((np.abs(a - b).max(-1) / peak).max()))
        size = float(max((np.abs(t64[k].cpu().numpy()[q["pos_chk"]]).max(-1)
                          / np.abs(q["plain"][k][q["pos_chk"]]).max(-1)
                          ).max() for k in t64))
        print(f"[{label} non-Limber] float32 corrections vs float64 "
              f"({len(q['chk'])} cosmologies): {worst:.3e} of the corrected "
              f"row's peak (gate 1e-6); the corrections reach {size:.3e} of "
              f"it (the einsums and the correction matmul run in float64 in "
              f"both; the float32 pipeline's transfers are complex64 FFTs)",
              flush=True)
        if not worst <= 1e-6:
            fail(f"{label} non-Limber float32 corrections: {worst}")
        return worst, size

    def a_on(q, label, rows=None):
        """Kernel A at the cell's node arrays (phase 2's gates), its time
        (20 calls) and bound; ``rows``: (float32 rows, float64 rows) of the
        folded tomographic set, checked on those rows only."""
        pipe_, pipe64 = q["pipe"], q["pipe64"]
        if rows is None:
            cos_a, model_a = pipe_.halo_model(q["args"][0])
            m32, g32_ = halo.contraction_nodes(cos_a, pipe_.halo_params,
                                               model_a)
            cos_a, model_a = pipe64.halo_model(q["args64"][0])
            m64, g64_ = (t[q["pos_chk"]].contiguous() for t in
                         halo.contraction_nodes(cos_a, pipe64.halo_params,
                                                model_a))
            mc32, gc32 = m32, g32_
        else:
            (m32, g32_), = pipe_.contraction_rows(q["args"][0])
            (m64, g64_), = pipe64.contraction_rows(q["args64"][0])
            m64, g64_ = (t[rows[1]].contiguous() for t in (m64, g64_))
            mc32, gc32 = (t[rows[0]].contiguous() for t in (m32, g32_))
        m32, g32_ = m32.contiguous(), g32_.contiguous()
        res = check_a(k32, mc32, gc32, k64, m64, g64_, cheb32, cheb64)
        res["ms"] = events_ms(lambda: hc.halo_contract(k32, m32, g32_,
                                                       cheb32), 20)
        res["bound"] = bound_a_of(k32, m32, g32_)
        res["rows"] = m32.shape[0]
        profiled[f"halo_contract {label}"] = (
            lambda: hc.halo_contract(k32, m32, g32_, cheb32), None, 5)
        if not (res["f64"] <= 1e-12 and res["f32"] <= 2e-6
                and res["f32"] <= 1.5 * res["plain32"] and res["same"]):
            fail(f"halo_contract at the {label} nodes: {res}")
        if rows is not None:
            res["bwd"] = check_a_bwd(k32, mc32, gc32, k64, m64, g64_, 51)
            ga = seeded((m32.shape[0], hc.N_OUT, k32.numel()), 52, f32)
            res["bwd_ms"] = events_ms(lambda: hc.halo_contract_bwd(
                k32, m32, g32_, cheb32, ga), 10)
            res["bwd_bound"] = bound_abwd_of(k32, m32, g32_, ga)
            profiled[f"halo_contract_bwd {label}"] = (
                lambda: hc.halo_contract_bwd(k32, m32, g32_, cheb32, ga),
                None, 5)
            b = res["bwd"]
            if not (b["f64"] <= 1e-12 and b["f32"] <= 2e-5
                    and b["f32"] <= 1.5 * b["plain32"] and b["same"]):
                fail(f"halo_contract_bwd at the {label} rows: {b}")
        print(f"[{label} A] {res['rows']} rows | f64 rel_to_peak="
              f"{res['f64']:.3e} (gate 1e-12) | f32 vs plain in f64 "
              f"{res['f32']:.3e} (gate 2e-6, <= 1.5x the plain f32's "
              f"{res['plain32']:.3e}) | deterministic={res['same']} | kernel "
              f"{res['ms']:.3f} ms (CUDA events, 20 calls) | bound "
              f"{res['bound'][0]:.4f} ms by {res['bound'][1]}"
              + (f" | A' on the {len(rows[0])} checked rows: f64 "
                 f"{res['bwd']['f64']:.3e} (gate 1e-12), f32 "
                 f"{res['bwd']['f32']:.3e} (gate 2e-5, plain f32 "
                 f"{res['bwd']['plain32']:.3e}), all rows "
                 f"{res['bwd_ms']:.3f} ms (10 calls), bound "
                 f"{res['bwd_bound'][0]:.4f} ms" if rows is not None else ""),
              flush=True)
        return res

    def c_on(q, label, conv64, jl, row_ops, with_bwd):
        """Kernel C (and C') on the forward's own convolution rows of each
        operator of the cell (phase 3's and 8's gates), with times, the
        float64 torch.matmul's and bounds."""
        pipe_ = q["pipe"]
        res = []
        for i, (mu, stat) in enumerate(pipe_.specs):
            rl = [r for r, ops in enumerate(row_ops) if i in ops]
            lo, hi = pipe_.windows[i]
            c64_i = conv64[:, rl, lo - jl:hi - jl].reshape(
                -1, hi - lo).contiguous()
            a_np_i = (curved.curved_lattice_operator(
                pipe_.theta_key, DEFAULT_GRID, mu, stat=stat)[2]
                if pipe_.geometry == "curved" else
                limber_fft.wtheta_lattice_operator(pipe_.theta_key,
                                                   DEFAULT_GRID, mu)[2])
            c = check_c(c64_i, a_np_i)
            c32_i = c64_i.to(f32)
            c32_i64 = c32_i.double()
            a64_i = torch.tensor(a_np_i, device=dev)
            hi_i, lo_i = (torch.tensor(x, device=dev)
                          for x in df32.split_operator(a_np_i))
            c["ms"], c["lib_ms"] = in_turns_ms(
                lambda c_=c32_i, h=hi_i, l_=lo_i: df32.df_contract(c_, h, l_),
                lambda c_=c32_i64, a=a64_i: c_ @ a.T, 20, 20)
            m_i, n_i, t_i = c32_i.shape[0], c32_i.shape[1], hi_i.shape[0]
            c["rows"], c["n"], c["spec"] = m_i, n_i, (mu, stat)
            c["bound"] = bound(2.0 * m_i * n_i * t_i,
                               4 * (m_i * n_i + 2 * t_i * n_i + m_i * t_i))
            c["geometry"] = geometry(m_i, n_i, t_i)
            profiled[f"df_contract {label} {mu:g} {stat}"] = (
                lambda c_=c32_i, h=hi_i, l_=lo_i: df32.df_contract(c_, h, l_),
                lambda c_=c32_i64, a=a64_i: c_ @ a.T, 20)
            if not (c["f64"] <= 1e-12 and c["plain"] <= 1e-6
                    and c["exact"] <= 1e-7 and c["same"]):
                fail(f"df_contract at the {label} ({mu:g}, {stat}) rows: {c}")
            print(f"[{label} C] ({mu:g}, {stat}): ({m_i}, {n_i}) x ({t_i}, "
                  f"{n_i}) | f64 rel_to_peak={c['f64']:.3e} (gate 1e-12) | "
                  f"f32 vs plain {c['plain']:.3e} (gate 1e-6) | f32 vs exact "
                  f"{c['exact']:.3e} (gate 1e-7) | deterministic={c['same']} "
                  f"| kernel {c['ms']:.4f} ms, f64 torch.matmul "
                  f"{c['lib_ms']:.4f} ms (CUDA events, 20 calls, in turns) | "
                  f"bound {c['bound'][0]:.5f} ms by {c['bound'][1]} | "
                  f"{c['geometry']}", flush=True)
            if with_bwd:
                g_i = seeded((m_i, t_i), 60 + i)
                b = check_bc_bwd(df32.df_contract_bwd, g_i, (a64_i,),
                                 (hi_i, lo_i), prod_c)
                g32_i = g_i.to(f32)
                g32_i64 = g32_i.double()
                b["ms"], b["lib_ms"] = in_turns_ms(
                    lambda g=g32_i, h=hi_i, l_=lo_i:
                    df32.df_contract_bwd(g, h, l_),
                    lambda g=g32_i64, a=a64_i: g @ a, 20, 20)
                b["bound"] = bound(2.0 * m_i * n_i * t_i,
                                   4 * (m_i * t_i + 2 * t_i * n_i
                                        + m_i * n_i))
                profiled[f"df_contract_bwd {label} {mu:g} {stat}"] = (
                    lambda g=g32_i, h=hi_i, l_=lo_i:
                    df32.df_contract_bwd(g, h, l_),
                    lambda g=g32_i64, a=a64_i: g @ a, 20)
                c["bwd"] = b
                if not (b["f64"] <= 1e-12
                        and b["exact"] <= 2.0 * b["lib_exact"] and b["same"]):
                    fail(f"df_contract_bwd at the {label} ({mu:g}, {stat}) "
                         f"rows: {b}")
                print(f"[{label} C'] ({mu:g}, {stat}): ({m_i}, {t_i}) -> "
                      f"({m_i}, {n_i}) | f64 rel_to_row_peak={b['f64']:.3e} "
                      f"(gate 1e-12) | f32 vs exact {b['exact']:.3e}, "
                      f"torch.matmul f32 {b['lib_exact']:.3e} (gate 2x) | "
                      f"deterministic={b['same']} | kernel {b['ms']:.4f} ms, "
                      f"f64 torch.matmul {b['lib_ms']:.4f} ms | bound "
                      f"{b['bound'][0]:.5f} ms by {b['bound'][1]}",
                      flush=True)
            res.append(c)
        return res

    def conv_of(q):
        """The float64 convolution sums of the separable lattice cell's probe
        rows over its operators' windows: (conv, j_lo, row operators)."""
        pipe_ = q["pipe"]
        with torch.no_grad():
            cos_c, model_c = pipe_.halo_model(q["args"][0])
            p_all = pipe_._separable_spectra(cos_c, model_c)[0]
            lat = limber_fft.LatticeState(cos_c, pipe_.st,
                                          model_c.mass.growth)
            g_r = lat.g_rows([(wa, wb) for wa, wb, _k, _s in pipe_.probes])
            p_r = torch.stack([p_all[kind] for _a, _b, kind, _s
                               in pipe_.probes], dim=1)
            jl = min(w[0] for w in pipe_.windows)
            jh = max(w[1] for w in pipe_.windows)
            conv = limber_fft._conv_direct_rows64(p_r, g_r, jl, jh)
        ops = [[pipe_.specs.index(spec) for spec, _key in s]
               for *_p, s in pipe_.probes]
        return conv, jl, ops

    want_c3 = {"halo_contract": 1, "df_contract": 3, "hankel_matmul": 0}
    want_c4 = {"halo_contract": 1, "df_contract": 4, "hankel_matmul": 0}

    # -- 15. flat 3x2pt + kappa_CMB with the options on ------------------
    q15 = run_cell("flat_options", fwd_bwd=True)
    report_cell("options flat", q15, want_c3)
    nl15 = nl_check(q15, "options flat")
    a15 = a_on(q15, "options flat (BAO)")
    r15 = rop["flat_options"]
    n_th15 = DEFAULT_GRID.n_theta
    out_keys15 = [k for k in keys_op if k in q15["shapes"]]
    th32, _ = inference.make_theory_fn(
        q15["pipe"], default_cosmo(device=dev, dtype=f32), output=out_keys15)
    th64, _ = inference.make_theory_fn(
        q15["pipe64"], default_cosmo(device=dev, dtype=f64),
        output=out_keys15)
    p15 = np.stack([r15["omega_m0"], r15["sigma_8"]], axis=1)
    t0 = time.perf_counter()
    j15_32 = inference.jacobian(th32, torch.tensor(p15, dtype=f32, device=dev),
                                chunk=480).cpu().numpy()
    j15_64 = inference.jacobian(th64, torch.tensor(p15, dtype=f64, device=dev),
                                chunk=240).cpu().numpy()
    jac_wall15 = time.perf_counter() - t0

    def jac_err_k(got, ref, n_k):
        got = np.asarray(got, dtype=np.float64)
        ref = np.asarray(ref, dtype=np.float64)
        m, n, p = ref.shape
        d = np.abs(got - ref).reshape(m, n_k, n // n_k, p).max(axis=2)
        return float(np.max(d / np.abs(ref).reshape(m, n_k, n // n_k,
                                                    p).max(axis=2)))

    jax_j15 = np.asarray(r15["jacobian"])
    je15 = {"f32_vs_f64": jac_err_k(j15_32, j15_64, len(out_keys15)),
            "f64_vs_jax": jac_err_k(j15_64, jax_j15, len(out_keys15)),
            "f32_vs_jax": jac_err_k(j15_32, jax_j15, len(out_keys15))}
    print(f"[options flat] Jacobian of ({', '.join(out_keys15)}) over "
          f"(omega_m0, sigma_8) at the 3 reference cosmologies "
          f"(inference.jacobian, {jac_wall15:.1f} s): f32 vs card f64 "
          f"{je15['f32_vs_f64']:.3e} (gate 1e-3 of each column's peak over "
          f"theta), f64 vs JAX jacfwd {je15['f64_vs_jax']:.3e} (gate 1e-9), "
          f"f32 vs JAX {je15['f32_vs_jax']:.3e} (gate 1e-3)", flush=True)
    if not (je15["f32_vs_f64"] <= 1e-3 and je15["f64_vs_jax"] <= 1e-9
            and je15["f32_vs_jax"] <= 1e-3):
        fail(f"options flat Jacobian: {je15}")
    del th32, th64
    lap("15")

    # -- 16. curved sky, Tinker, linear mm legs --------------------------
    q16 = run_cell("curved", fwd_bwd=True)
    report_cell("options curved", q16, want_c4)
    a16 = a_on(q16, "options curved (Tinker)")
    conv16, jl16, ops16 = conv_of(q16)
    c16 = c_on(q16, "options curved", conv16, jl16, ops16, with_bwd=False)
    del conv16
    lap("16")

    # -- 17. exact-z with the options -------------------------------------
    q17 = run_cell("exact_z")
    report_cell("options exact-z", q17, want_c4)
    lap("17")

    # -- 18. the table route with BAO and Tinker -------------------------
    q18 = run_cell("table")
    report_cell("options table", q18, {"halo_contract": 1,
                                       "df_contract": 0, "hankel_matmul": 4})
    pipe18 = q18["pipe"]
    with torch.no_grad():
        cos18, model18 = pipe18.halo_model(q18["args"][0])
        tabs18 = projection.power_tables_halo(cos18, pipe18.halo_params,
                                              model18, pipe18.kinds,
                                              pipe18.st)
        cl18 = projection.limber_cl(cos18, pipe18.win_g, pipe18.win_g,
                                    pipe18.ells, tabs18["power_gg"],
                                    pipe18.st).contiguous()
    b18 = check_b(cl18, pipe18.op0_t)
    b18["ms"], b18["lib_ms"] = in_turns_ms(
        lambda: hm.hankel_matmul(cl18, pipe18.op0_t),
        lambda: prod_b(cl18, pipe18.op0_t.T))
    profiled["hankel_matmul options table"] = (
        lambda: hm.hankel_matmul(cl18, pipe18.op0_t),
        lambda: prod_b(cl18, pipe18.op0_t.T), 20)
    r_b, n_b, t_b = cl18.shape[0], cl18.shape[1], pipe18.op0_t.shape[1]
    b18["bound"] = bound(2.0 * r_b * n_b * t_b,
                         4 * (r_b * n_b + n_b * t_b + r_b * t_b))
    print(f"[options table B] C_ell gg rows ({r_b}, {n_b}) @ ({n_b}, {t_b}) "
          f"| f64 rel_to_row_peak={b18['f64']:.3e} (gate 1e-12) | f32 vs "
          f"plain max rel={b18['plain']:.3e} (gate 2e-5) | f32 vs exact "
          f"{b18['exact']:.3e}, torch.matmul f32 {b18['lib_exact']:.3e} "
          f"(gate 2x) | deterministic={b18['same']} | kernel "
          f"{b18['ms']:.4f} ms, f32 torch.matmul {b18['lib_ms']:.4f} ms "
          f"(CUDA events, 100 calls, in turns) | bound "
          f"{b18['bound'][0]:.5f} ms by {b18['bound'][1]}", flush=True)
    if not (b18["f64"] <= 1e-12 and b18["plain"] <= 2e-5
            and b18["exact"] <= 2.0 * b18["lib_exact"] and b18["same"]):
        fail(f"hankel_matmul on the options table rows: {b18}")
    del cos18, model18, tabs18
    lap("18")

    # -- 19. the tomographic cell with the options -------------------------
    q19 = run_cell("tomographic", fwd_bwd=True)
    report_cell("options tomographic", q19, want_c4)
    nl19 = nl_check(q19, "options tomographic")
    rows19 = ([int(c) * 5 + j % 5 for j, c in enumerate(q19["chk"])],
              [p * 5 + j % 5 for j, p in enumerate(q19["pos_chk"])])
    a19 = a_on(q19, "options tomographic", rows=rows19)
    pipe19 = q19["pipe"]
    with torch.no_grad():
        cos19, _nu19, models19, rows_c19, _sp = pipe19.probe_rows(
            *q19["args"])
        lat19 = pipe19.lattice(cos19, models19)
        jl19 = min(w[0] for w in pipe19.windows)
        jh19 = max(w[1] for w in pipe19.windows)
        conv19 = limber_fft._conv_direct_rows64(
            torch.stack([p for _a, _b, p, _s in rows_c19], dim=1),
            lat19.g_rows([(wa, wb) for wa, wb, _p, _s in rows_c19]),
            jl19, jh19)
        del cos19, _nu19, models19, lat19, _sp
    c19 = c_on(q19, "options tomographic", conv19, jl19,
               [r[3] for r in rows_c19], with_bwd=True)
    del conv19, rows_c19
    lap("19")

    # -- 20. exact-z tomography: the DES Y3-like cell ----------------------
    # Phases 13-14's layout without the nuisances (exact-z refuses them),
    # exact_z_anchors = 6, flat, at configuration B's batch: the 384
    # anchor rows' mass tables and five galaxy packs, kernel A once over
    # B x J x 5 = 1920 folded rows, one 35-row J-channel convolution, C x3.
    ref_xt = json.loads((REPO / "tests" / "data"
                         / "torch_exactz_tomo_reference.json").read_text())
    rxt = ref_xt["chip_tomo"]
    j_xt = rxt["exact_z_anchors"]
    idx_xt = np.asarray(rxt["indices"])
    if (rxt["n_cosmo"] != n_x or ref_xt["cell"] != cell
            or not np.allclose(rxt["omega_m0"],
                               np.linspace(0.24, 0.32, n_x)[idx_xt])):
        fail("exact-z tomography reference file does not match this run's "
             "cell or cosmologies")
    meas_xt = sorted(set(check_x.tolist()) | set(idx_xt.tolist()))
    pos_chk_xt = [meas_xt.index(i) for i in check_x]
    pos_ref_xt = [meas_xt.index(i) for i in idx_xt]

    def sub(d, rows):
        return {k: v[rows] for k, v in d.items()}

    def tomo_x_of(dtype, **options):
        return tomo_cell(ref_tm, device=dev, dtype=dtype, nuisance=False,
                         exact_z_anchors=j_xt, **options)[0]

    def counted_forward(pipe_, *args_):
        """(outputs, forward launches, peak GB) of one no-grad forward,
        the counts zeroed just before and read just after."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_zero()
        with torch.no_grad():
            o = pipe_(*args_)
        torch.cuda.synchronize()
        return o, counts()[0], torch.cuda.max_memory_allocated() / 1e9

    pipe_xt = tomo_x_of(f32)
    batch_xt = setup(f32, n=n_x)[0]
    out_xt, launches_xt, peak_xt = counted_forward(pipe_xt, batch_xt)
    got_xt = tomo_host(out_xt)
    finite_xt = (all(bool(np.all(np.isfinite(v))) for v in got_xt.values())
                 and bool(torch.isfinite(out_xt["vector"]).all()))
    shape_xt = (got_xt["w_theta"].shape == (n_x, 5, n_th)
                and got_xt["gamma_t"].shape == (n_x, 20, n_th)
                and got_xt["xi_plus"].shape == (n_x, 10, n_th)
                and got_xt["n_g"].shape == (n_x, 5)
                and tuple(out_xt["vector"].shape) == (n_x, 45 * n_th))
    del out_xt
    pipe_xt64 = tomo_x_of(f64)
    batch_xt64 = setup(f64, meas_xt, n=n_x)[0]
    with plain_path():
        plain_xt = tomo_host(pipe_xt64(batch_xt64))
    kern_xt = tomo_host(pipe_xt64(batch_xt64))
    ref_xt_out = {k: np.asarray(rxt["outputs"][k]) for k in keys_tm + ("n_g",)}
    err_xt = {
        "vs_plain": tomo_err(sub(got_xt, check_x), sub(plain_xt, pos_chk_xt)),
        "vs_jax": tomo_err(sub(got_xt, idx_xt), ref_xt_out),
        "k64": tomo_err(kern_xt, plain_xt),
        "plain_vs_jax": tomo_err(sub(plain_xt, pos_ref_xt), ref_xt_out)}

    # Kernels A and A' over the 1920 folded anchor rows, row (b J + j) 5 +
    # i = cosmology b at anchor j with lens bin i's galaxy pack, as the
    # forward launches them; checked on 8 rows (cosmology c of the check
    # set at anchor c mod J with lens bin c mod 5), timed over all.
    (mat_xt32, gal_xt32), = pipe_xt.contraction_rows(batch_xt)
    (mat_xt64, gal_xt64), = pipe_xt64.contraction_rows(batch_xt64)

    def xt_row(b_, c):
        return (b_ * j_xt + c % j_xt) * 5 + c % 5

    sel32 = torch.tensor([xt_row(int(check_x[c]), c)
                          for c in range(len(check_x))], device=dev)
    sel64 = torch.tensor([xt_row(pos_chk_xt[c], c)
                          for c in range(len(check_x))], device=dev)
    mat_xtc32, gal_xtc32 = (t[sel32].contiguous() for t in (mat_xt32,
                                                           gal_xt32))
    mat_xt64, gal_xt64 = (t[sel64].contiguous() for t in (mat_xt64,
                                                         gal_xt64))
    mat_xt32, gal_xt32 = mat_xt32.contiguous(), gal_xt32.contiguous()
    rows_xt = mat_xt32.shape[0]
    a_xt = check_a(k32, mat_xtc32, gal_xtc32, k64, mat_xt64, gal_xt64,
                   cheb32, cheb64)
    ms_a_xt = events_ms(lambda: hc.halo_contract(k32, mat_xt32, gal_xt32,
                                                 cheb32), 20)
    bound_a_xt = bound_a_of(k32, mat_xt32, gal_xt32)
    profiled["halo_contract exact-z tomographic"] = (
        lambda: hc.halo_contract(k32, mat_xt32, gal_xt32, cheb32), None, 5)
    bwd_xt = check_a_bwd(k32, mat_xtc32, gal_xtc32, k64, mat_xt64, gal_xt64,
                         70)
    ga_xt = seeded((rows_xt, hc.N_OUT, k32.numel()), 71, f32)
    ms_abwd_xt = events_ms(lambda: hc.halo_contract_bwd(
        k32, mat_xt32, gal_xt32, cheb32, ga_xt), 20)
    bound_abwd_xt = bound_abwd_of(k32, mat_xt32, gal_xt32, ga_xt)
    profiled["halo_contract_bwd exact-z tomographic"] = (
        lambda: hc.halo_contract_bwd(k32, mat_xt32, gal_xt32, cheb32, ga_xt),
        None, 5)
    del mat_xt64, gal_xt64, mat_xtc32, gal_xtc32
    if not (a_xt["f64"] <= 1e-12 and a_xt["f32"] <= 2e-6
            and a_xt["f32"] <= 1.5 * a_xt["plain32"] and a_xt["same"]):
        fail(f"halo_contract at the exact-z tomographic rows: {a_xt}")
    if not (bwd_xt["f64"] <= 1e-12 and bwd_xt["f32"] <= 2e-5
            and bwd_xt["f32"] <= 1.5 * bwd_xt["plain32"]
            and bwd_xt["same"]):
        fail(f"halo_contract_bwd at the exact-z tomographic rows: {bwd_xt}")

    # Kernel C (and C') on the forward's own J-channel convolution rows of
    # each operator (float32 anchors and weights, float64 sums).
    with torch.no_grad():
        cos_c, _nu_c, _m_c, rows_c, sp_c = pipe_xt.probe_rows(batch_xt)
        jl_xt = min(w[0] for w in pipe_xt.windows)
        jh_xt = max(w[1] for w in pipe_xt.windows)
        g_j = limber_fft.exact_z_g_rows(
            cos_c, sp_c[-1], [(wa, wb) for wa, wb, _p, _s in rows_c],
            pipe_xt.st)
        p_j = torch.stack([p for _a, _b, p, _s in rows_c], dim=1)
        b_, r_, jj_, n_chi_ = g_j.shape
        conv_xt = limber_fft._conv_direct_rows64(
            p_j.reshape(b_, r_ * jj_, -1), g_j.reshape(b_, r_ * jj_, n_chi_),
            jl_xt, jh_xt).reshape(b_, r_, jj_, -1).sum(2)
        ops_xt = [r[3] for r in rows_c]
        del cos_c, _nu_c, _m_c, rows_c, sp_c, g_j, p_j
    c_xt = c_on({"pipe": pipe_xt}, "exact-z tomographic", conv_xt, jl_xt,
                ops_xt, with_bwd=True)
    del conv_xt

    # Walls, forward+backward, peak memory (launch counts zeroed just
    # before and read just after).
    with torch.no_grad():
        wall_xt = median_wall(lambda: pipe_xt(batch_xt), 1)
    weights_xt = seeded((n_x, 45 * n_th), 72, f32)

    def grad_run_xt():
        om = torch.tensor(np.linspace(0.24, 0.32, n_x), dtype=f32,
                          device=dev, requires_grad=True)
        s8 = torch.tensor(np.linspace(0.75, 0.88, n_x), dtype=f32,
                          device=dev, requires_grad=True)
        out = pipe_xt(broadcast_cosmo(default_cosmo(device=dev, dtype=f32),
                                      omega_m0=om, omega_l0=1.0 - om,
                                      sigma_8=s8))
        return torch.autograd.grad((out["vector"] * weights_xt).sum(),
                                   (om, s8))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    g_xt = grad_run_xt()
    torch.cuda.synchronize()
    grad_launches_xt = counts()
    peak_xt_fb = torch.cuda.max_memory_allocated() / 1e9
    finite_gxt = all(bool(torch.isfinite(g).all()) for g in g_xt)
    del g_xt
    wall_xt_fb = median_wall(grad_run_xt, 1)

    # The Jacobian over (omega_m0, sigma_8) at the middle reference
    # cosmology, float32 against float64 on the card: the 180 entries at
    # theta bins 0, 16, 32, 48 of each of the 45 probe rows (a replica a
    # data entry: the whole vector's 2880 would take 16x as long).
    sel_vec = torch.arange(0, 45 * n_th, 16, device=dev)
    th32, _ = inference.make_theory_fn(
        pipe_xt, default_cosmo(device=dev, dtype=f32), output="vector")
    th64, _ = inference.make_theory_fn(
        pipe_xt64, default_cosmo(device=dev, dtype=f64), output="vector")
    p_xt = [[rxt["omega_m0"][1], rxt["sigma_8"][1]]]
    t0 = time.perf_counter()
    jxt32 = inference.jacobian(lambda p: th32(p)[:, sel_vec],
                               torch.tensor(p_xt, dtype=f32, device=dev),
                               chunk=60).cpu().numpy()
    jxt64 = inference.jacobian(lambda p: th64(p)[:, sel_vec],
                               torch.tensor(p_xt, dtype=f64, device=dev),
                               chunk=60).cpu().numpy()
    jac_wall_xt = time.perf_counter() - t0
    je_xt = jac_err_k(jxt32, jxt64, 45)
    del th32, th64

    want_xt = {"halo_contract": 1, "df_contract": 3, "hankel_matmul": 0}
    print(f"[exact-z tomo] DES Y3-like cell (5 lens x 4 source bins, per-bin "
          f"HODs, no nuisances), exact_z_anchors={j_xt} on [1e-3, "
          f"{pipe_xt.z_hi_anchor:g}], flat, DEFAULT_GRID, B={n_x}, float32 | "
          f"forward launches {launches_xt} | finite={finite_xt} shape_ok="
          f"{shape_xt} | vs card f64 plain path ({len(check_x)} "
          f"cosmologies): " + ", ".join(
              f"{k} {v:.3e}" for k, v in err_xt["vs_plain"].items())
          + " (gate 1e-4 on all but the row-peak figures) | vs JAX f64 (3 "
          "cosmologies): " + ", ".join(
              f"{k} {v:.3e}" for k, v in err_xt["vs_jax"].items())
          + f" (gate 1e-4) | f64 kernels vs plain "
          f"{gated_tm(err_xt['k64']):.3e} (gate 1e-12) | f64 plain vs JAX "
          f"{gated_tm(err_xt['plain_vs_jax']):.3e} (gate 1e-10) | forward "
          f"wall one call = {wall_xt * 1e3:.1f} ms "
          f"({wall_xt / n_x * 1e3:.3f} ms/cosmology), peak {peak_xt:.2f} GB "
          f"| forward+backward launches {grad_launches_xt[0]} / "
          f"{grad_launches_xt[1]}, finite={finite_gxt}, wall one call = "
          f"{wall_xt_fb * 1e3:.1f} ms, peak {peak_xt_fb:.2f} GB | Jacobian "
          f"(180 entries x 2, {jac_wall_xt:.1f} s): f32 vs card f64 "
          f"{je_xt:.3e} (gate 1e-3 of each probe row's column peak)",
          flush=True)
    print(f"[exact-z tomo A] {rows_xt} folded anchor rows | f64 rel_to_peak="
          f"{a_xt['f64']:.3e} (8 rows, gate 1e-12) | f32 vs plain in f64 "
          f"{a_xt['f32']:.3e} (gate 2e-6, <= 1.5x the plain f32's "
          f"{a_xt['plain32']:.3e}) | deterministic={a_xt['same']} | kernel "
          f"{ms_a_xt:.3f} ms (CUDA events, 20 calls), plain "
          f"{a_xt['plain_ms']:.1f} ms (8 rows, 1 call) | bound "
          f"{bound_a_xt[0]:.4f} ms by {bound_a_xt[1]} | A': f64 "
          f"{bwd_xt['f64']:.3e} (gate 1e-12), f32 {bwd_xt['f32']:.3e} (gate "
          f"2e-5, plain f32 {bwd_xt['plain32']:.3e}), deterministic="
          f"{bwd_xt['same']}, kernel {ms_abwd_xt:.3f} ms (20 calls), plain "
          f"{bwd_xt['plain_ms']:.1f} ms (8 rows), bound "
          f"{bound_abwd_xt[0]:.4f} ms by {bound_abwd_xt[1]}", flush=True)
    if launches_xt != want_xt:
        fail(f"exact-z tomographic forward launches {launches_xt}; want "
             f"{want_xt}")
    if grad_launches_xt != (want_xt, want_xt):
        fail(f"exact-z tomographic forward+backward launches "
             f"{grad_launches_xt}; want {want_xt} each")
    if not (finite_xt and shape_xt and finite_gxt):
        fail("exact-z tomographic outputs or gradient not finite, or of the "
             "wrong shape")
    for name, val, gate in (
            ("float32 vs float64 plain path", gated_tm(err_xt["vs_plain"]),
             1e-4),
            ("float32 vs JAX float64", gated_tm(err_xt["vs_jax"]), 1e-4),
            ("float64 kernels vs plain path", gated_tm(err_xt["k64"]), 1e-12),
            ("float64 plain path vs JAX", gated_tm(err_xt["plain_vs_jax"]),
             1e-10),
            ("Jacobian float32 vs float64", je_xt, 1e-3)):
        if not val <= gate:
            fail(f"exact-z tomographic {name}: {val} (gate {gate})")
    lap("20")

    # -- 21. exact-z tomography curved, with the options -----------------
    opts_xc = dict(theta_deg=ref_op["des_theta_deg"], geometry="curved",
                   matter_power="halofit", with_bao=True,
                   include_cmb_lensing=True, nonlimber_ell_switch=60,
                   nonlimber_rsd=True)
    pipe_xc = tomo_x_of(f32, **opts_xc)
    out_xc, launches_xc, peak_xc = counted_forward(pipe_xc, batch_xt)
    got_xc = op_host(out_xc)
    finite_xc = all(bool(torch.isfinite(v).all()) for k, v in out_xc.items()
                    if k != "theta_deg")
    shapes_xc = {k: tuple(v.shape) for k, v in out_xc.items()
                 if k in keys_op + ("vector",)}
    del out_xc
    pipe_xc64 = tomo_x_of(f64, **opts_xc)
    batch_xc64 = setup(f64, check_x, n=n_x)[0]
    with plain_path():
        plain_xc = op_host(pipe_xc64(batch_xc64))
    kern_xc = op_host(pipe_xc64(batch_xc64))
    err_xc = {"vs_plain": op_err(sub(got_xc, check_x), plain_xc),
              "k64": op_err(kern_xc, plain_xc)}
    with torch.no_grad():
        wall_xc = median_wall(lambda: pipe_xc(batch_xt), 1)
    want_xc = {"halo_contract": 2, "df_contract": 4, "hankel_matmul": 0}
    print(f"[exact-z tomo curved] the cell of phase 20 curved at the 20 DES "
          f"theta, halofit at the {n_x * j_xt} anchor rows, BAO, kappa_CMB, "
          f"non-Limber ell < 60 with RSD (its pivot launch), B={n_x}, "
          f"float32 | forward launches {launches_xc} | finite={finite_xc} "
          f"{shapes_xc} | vs card f64 plain path ({len(check_x)} "
          f"cosmologies): " + ", ".join(
              f"{k} {v:.3e}" for k, v in err_xc["vs_plain"].items())
          + f" (gate 1e-4) | f64 kernels vs plain "
          f"{max(err_xc['k64'].values()):.3e} (gate 1e-12) | forward wall "
          f"one call = {wall_xc * 1e3:.1f} ms ({wall_xc / n_x * 1e3:.3f} "
          f"ms/cosmology), peak {peak_xc:.2f} GB", flush=True)
    if launches_xc != want_xc:
        fail(f"exact-z tomographic curved forward launches {launches_xc}; "
             f"want {want_xc}")
    if not (finite_xc and shapes_xc.get("w_gk_cmb") == (n_x, 5, 20)):
        fail("exact-z tomographic curved outputs not finite, or of the "
             "wrong shape")
    for name, val, gate in (("float32 vs float64 plain path",
                             err_xc["vs_plain"], 1e-4),
                            ("float64 kernels vs plain path", err_xc["k64"],
                             1e-12)):
        if not max(val.values()) <= gate:
            fail(f"exact-z tomographic curved {name}: {val} (gate {gate})")
    del plain_xc, kern_xc, pipe_xc64
    lap("21")

    # -- 22. the Gauss-Legendre exact-z C_ell and the FFT convolution -----
    # Configuration A's window, 64 cosmologies x n_z = 32 GL nodes = 2048
    # halo-model rows, each at its own k = (ell + 1/2) / chi_j: kernel A
    # once, with a k row per row; its gradient through grad_k.
    rgl = ref_xt["chip_gl"]
    ells_gl, n_z_gl = np.asarray(rgl["ells"]), rgl["n_z"]
    idx_gl = np.asarray(rgl["indices"])
    if (rgl["n_cosmo"] != n_x
            or not np.allclose(rgl["omega_m0"],
                               np.linspace(0.24, 0.32, n_x)[idx_gl])):
        fail("GL exact-z reference does not match this run's cosmologies")

    def gl_of(dtype, idx=None):
        batch_, hp_, hod_, dist_ = setup(dtype, idx, n=n_x)
        st_ = Statics(DEFAULT_GRID, device=dev, dtype=dtype)
        return st_, batch_, hp_, hod_, projection.WindowGalaxy(dist_)

    def gl_cl(gl, batch_=None):
        st_, b_, hp_, hod_, win_ = gl
        return projection.limber_cl_exact_z(
            b_ if batch_ is None else batch_, hp_, hod_, win_, win_, ells_gl,
            st_, "power_gg", n_z=n_z_gl)

    def gl_nodes(gl):
        """(k rows, mat, gal) of the GL route's kernel A launch."""
        st_, b_, hp_, hod_, win_ = gl
        b_ = b_.batched()
        lo, hi = projection._limits(win_, win_, torch.minimum)
        x_, _w = st_.gl_unit(n_z_gl)
        z_ = (lo + (hi - lo) * x_).expand(b_.batch, n_z_gl)
        chi_ = background.comoving_distance(b_, z_, st_, DEFAULT_GRID.n_dist)
        rows_ = limber_fft._repeat_rows(b_, b_.batch, n_z_gl)
        model_ = halo.build_halo_model(rows_, hp_, hod_, z_.reshape(-1), st_)
        mat_, gal_ = halo.contraction_nodes(rows_, hp_, model_)
        k_ = ((torch.as_tensor(ells_gl, device=dev, dtype=st_.dtype)
               + 0.5) / chi_[..., None]).reshape(b_.batch * n_z_gl, -1)
        return k_.contiguous(), mat_, gal_

    gl32 = gl_of(f32)
    cl_gl32, launches_gl, peak_gl = counted_forward(gl_cl, gl32)
    finite_gl = bool(torch.isfinite(cl_gl32).all())
    shape_gl = tuple(cl_gl32.shape) == (n_x, len(ells_gl))
    cl_gl32 = cl_gl32.double().cpu().numpy()
    with torch.no_grad():
        wall_gl = median_wall(lambda: gl_cl(gl32), 1)
    weights_gl = seeded((n_x, len(ells_gl)), 80, f32)

    def grad_run_gl():
        om = torch.tensor(np.linspace(0.24, 0.32, n_x), dtype=f32,
                          device=dev, requires_grad=True)
        s8 = torch.tensor(np.linspace(0.75, 0.88, n_x), dtype=f32,
                          device=dev, requires_grad=True)
        cl = gl_cl(gl32, broadcast_cosmo(
            default_cosmo(device=dev, dtype=f32), omega_m0=om,
            omega_l0=1.0 - om, sigma_8=s8))
        return torch.autograd.grad((cl * weights_gl).sum(), (om, s8))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    g_gl = grad_run_gl()
    torch.cuda.synchronize()
    grad_launches_gl = counts()
    peak_gl_fb = torch.cuda.max_memory_allocated() / 1e9
    finite_ggl = all(bool(torch.isfinite(g).all()) for g in g_gl)
    del g_gl
    wall_gl_fb = median_wall(grad_run_gl, 1)

    gl64 = gl_of(f64)
    cl_gl64 = gl_cl(gl64).cpu().numpy()
    with plain_path():
        cl_gl64p = gl_cl(gl64).cpu().numpy()
    st64g, b64g, hp64g, hod64g, win64g = gl64
    cl_lat64 = limber_fft.limber_cl_fft_exact_z(
        b64g, hp64g, hod64g, win64g, win64g, ells_gl, st64g, "power_gg",
        n_z_anchor=rgl["lattice_j"]).cpu().numpy()
    # The anchored lattice against the GL route: within 1e-4 over the
    # ells of the JAX package's slow test (<= 1000), and over all within
    # 2x the JAX package's own gap between its two routes here (both
    # routes' quadratures part at ell > ~1500: committed with the JAX
    # values).
    lo_ells = ells_gl <= 1000.0
    err_gl = {"f32_vs_f64": worst_bin(cl_gl32, cl_gl64),
              "k64_vs_plain": worst_bin(cl_gl64, cl_gl64p),
              "f64_vs_jax": worst_bin(cl_gl64[idx_gl], rgl["cl"]),
              "lattice_vs_jax": worst_bin(cl_lat64[idx_gl], rgl["lattice"]),
              "lattice_vs_gl_lo": worst_bin(cl_lat64[:, lo_ells],
                                            cl_gl64[:, lo_ells]),
              "lattice_vs_gl": worst_bin(cl_lat64, cl_gl64)}
    gap_gl = rgl["jax_lattice_vs_gl_worst"]
    lat_gl_rows = np.abs(cl_lat64 / cl_gl64 - 1.0).max(-1)

    # Kernel A with a k row per row, and A' with grad_k, at the route's
    # 2048 rows: checked on 8 rows (checked cosmology c at GL node 4c).
    k_gl32, mat_gl32, gal_gl32 = gl_nodes(gl32)
    k_gl64, mat_gl64, gal_gl64 = gl_nodes(gl_of(f64, check_x))
    sel64 = torch.tensor([c * n_z_gl + 4 * c for c in range(len(check_x))],
                         device=dev)
    sel32 = torch.tensor([int(check_x[c]) * n_z_gl + 4 * c
                          for c in range(len(check_x))], device=dev)
    k_gl64, mat_gl64, gal_gl64 = (t[sel64].contiguous() for t in
                                  (k_gl64, mat_gl64, gal_gl64))
    rows_gl = mat_gl32.shape[0]
    a_gl = check_a(k_gl32, mat_gl32, gal_gl32, k_gl64, mat_gl64, gal_gl64,
                   cheb32, cheb64)
    a_gl["rows"] = [torch.equal(
        hc.halo_contract(k_gl32, mat_gl32, gal_gl32, cheb32)[r],
        hc.halo_contract(k_gl32[r].contiguous(), mat_gl32[r:r + 1],
                         gal_gl32[r:r + 1], cheb32)[0])
        for r in sel32.tolist()]
    ms_a_gl, plain_ms_a_gl = in_turns_ms(
        lambda: hc.halo_contract(k_gl32, mat_gl32, gal_gl32, cheb32),
        lambda: hc.halo_contract_ref(k_gl32, mat_gl32, gal_gl32), 100, 5)
    bound_a_gl = bound_a_of(k_gl32, mat_gl32, gal_gl32)
    profiled["halo_contract per-row k"] = (
        lambda: hc.halo_contract(k_gl32, mat_gl32, gal_gl32, cheb32), None,
        20)
    bwd_gl = check_a_bwd(k_gl32, mat_gl32, gal_gl32, k_gl64, mat_gl64,
                         gal_gl64, 81, grad_k=True)
    ga_gl = seeded((rows_gl, hc.N_OUT, len(ells_gl)), 82, f32)
    ms_abwd_gl, plain_ms_abwd_gl = in_turns_ms(
        lambda: hc.halo_contract_bwd(k_gl32, mat_gl32, gal_gl32, cheb32,
                                     ga_gl, grad_k=True),
        lambda: hc.halo_contract_bwd_ref(k_gl32, mat_gl32, gal_gl32, cheb32,
                                         ga_gl, grad_k=True), 100, 5)
    ms_abwd_gl_nok = events_ms(lambda: hc.halo_contract_bwd(
        k_gl32, mat_gl32, gal_gl32, cheb32, ga_gl))
    bound_abwd_gl = bound_abwd_of(k_gl32, mat_gl32, gal_gl32, ga_gl,
                                  grad_k=True)
    profiled["halo_contract_bwd per-row k grad_k"] = (
        lambda: hc.halo_contract_bwd(k_gl32, mat_gl32, gal_gl32, cheb32,
                                     ga_gl, grad_k=True), None, 20)
    geo_gl = hc.bwd_launch_report(mat_gl32.shape[1], gal_gl32.shape[1],
                                  len(ells_gl), f32, with_grad_k=True)
    geo_gl_mirror = tiles.bwd_geometry(rows_gl, mat_gl32.shape[1],
                                       gal_gl32.shape[1], len(ells_gl), 4,
                                       with_grad_k=True)
    geo_gl_ok = (geo_gl["kt"] == geo_gl_mirror.kt
                 and geo_gl["units"] == geo_gl_mirror.grid[0]
                 and geo_gl["dyn_smem"] == geo_gl_mirror.dyn_smem
                 and geo_gl["static_smem"] == geo_gl_mirror.static_smem)
    mix_gl, same_gl, cx_max_gl = branch_mix(k_gl32, mat_gl32, gal_gl32)

    # The whitened FFT convolution against the direct route: the linear P
    # on the k lattice of the 64 cosmologies, configuration A's window.
    _st, b32g, _hp, _hod, win32g = gl32
    p_lin64 = limber_fft.p_lattice_linear(b64g, st64g)
    fft64 = limber_fft.limber_cl_fft(b64g, win64g, win64g, ells_gl, p_lin64,
                                     st64g, conv_method="fft")
    dir64 = limber_fft.limber_cl_fft(b64g, win64g, win64g, ells_gl, p_lin64,
                                     st64g)
    fft32 = limber_fft.limber_cl_fft(b32g, win32g, win32g, ells_gl,
                                     p_lin64.float(), gl32[0],
                                     conv_method="fft")
    err_fft = {"f64_fft_vs_direct": max_rel(fft64, dir64),
               "f32_fft_vs_f64": max_rel(fft32.double(), fft64)}
    p_lin32 = p_lin64.float()
    ms_fft, ms_direct = in_turns_ms(
        lambda: limber_fft.limber_cl_fft(b32g, win32g, win32g, ells_gl,
                                         p_lin32, gl32[0],
                                         conv_method="fft"),
        lambda: limber_fft.limber_cl_fft(b32g, win32g, win32g, ells_gl,
                                         p_lin32, gl32[0]), 20, 20)
    del cl_lat64, fft64, dir64, fft32, p_lin64, p_lin32

    want_gl = {"halo_contract": 1, "df_contract": 0, "hankel_matmul": 0}
    print(f"[GL exact-z] projection.limber_cl_exact_z, power_gg, "
          f"configuration A's window, B={n_x} x n_z={n_z_gl} = {rows_gl} "
          f"halo-model rows, {len(ells_gl)} ells 10..3000, float32 | forward "
          f"launches {launches_gl} | finite={finite_gl} shape_ok={shape_gl} "
          f"| f32 vs card f64 worst bin {err_gl['f32_vs_f64']:.3e} (gate "
          f"1e-4) | f64 kernels vs plain {err_gl['k64_vs_plain']:.3e} (gate "
          f"1e-12) | f64 vs JAX (3 cosmologies) {err_gl['f64_vs_jax']:.3e} "
          f"(gate 1e-10) | lattice exact-z (J=8), f64, vs JAX's "
          f"{err_gl['lattice_vs_jax']:.3e} (gate 1e-10), vs GL on all {n_x} "
          f"cosmologies: ell <= 1000 {err_gl['lattice_vs_gl_lo']:.3e} (gate "
          f"1e-4), all ells {err_gl['lattice_vs_gl']:.3e} (gate 2x the JAX "
          f"package's own {gap_gl:.3e}; median over cosmologies "
          f"{np.median(lat_gl_rows):.3e}) | forward "
          f"wall one call = {wall_gl * 1e3:.1f} ms, peak {peak_gl:.2f} GB "
          f"| forward+backward launches {grad_launches_gl[0]} / "
          f"{grad_launches_gl[1]}, finite={finite_ggl}, wall one call = "
          f"{wall_gl_fb * 1e3:.1f} ms, peak {peak_gl_fb:.2f} GB", flush=True)
    print(f"[GL exact-z A] k row per row: ({rows_gl}, {len(ells_gl)}) k, "
          f"NM={mat_gl32.shape[1]} NG={gal_gl32.shape[1]} | f64 rel_to_peak="
          f"{a_gl['f64']:.3e} (8 rows, gate 1e-12) | f32 vs plain in f64 "
          f"{a_gl['f32']:.3e} (gate 2e-6, <= 1.5x the plain f32's "
          f"{a_gl['plain32']:.3e}) | deterministic={a_gl['same']} | a row's "
          f"launch with its k shared equals its row, bit for bit: "
          f"{all(a_gl['rows'])} | kernel {ms_a_gl:.4f} ms, plain "
          f"{plain_ms_a_gl:.3f} ms (CUDA events, 100 / 5 calls, in turns) | "
          f"bound {bound_a_gl[0]:.5f} ms by {bound_a_gl[1]} | branch mix: "
          + ", ".join(f"{n} {v:.4f}" for n, v in mix_gl.items())
          + f" | galaxy nodes with one profile {same_gl:.3f}", flush=True)
    print(f"[GL exact-z A'] with grad_k: f64 field_peak_rel="
          f"{bwd_gl['f64']:.3e} (8 rows, gate 1e-12; grad_k one field) | f32 "
          f"vs plain backward in f64 {bwd_gl['f32']:.3e} (gate 2e-5, <= 1.5x "
          f"the plain f32's {bwd_gl['plain32']:.3e}) | deterministic="
          f"{bwd_gl['same']} | kernel {ms_abwd_gl:.4f} ms ({ms_abwd_gl_nok:.4f}"
          f" ms without grad_k), plain {plain_ms_abwd_gl:.3f} ms (CUDA "
          f"events, in turns) | bound {bound_abwd_gl[0]:.5f} ms by "
          f"{bound_abwd_gl[1]} | launch geometry {geo_gl} (ops/tiles.py "
          f"mirror {'agrees' if geo_gl_ok else 'DIFFERS'})", flush=True)
    print(f"[FFT convolution] limber_cl_fft(conv_method='fft') on the linear "
          f"P lattice, B={n_x}, {len(ells_gl)} ells: f64 vs the direct route "
          f"{err_fft['f64_fft_vs_direct']:.3e} (gate 1e-10) | f32 (float64 "
          f"transforms, rounded once) vs f64 {err_fft['f32_fft_vs_f64']:.3e} "
          f"| f32 fft {ms_fft:.3f} ms, direct {ms_direct:.3f} ms a call "
          f"(CUDA events, 20 calls, in turns)", flush=True)
    if launches_gl != want_gl:
        fail(f"GL exact-z forward launches {launches_gl}; want {want_gl}")
    if grad_launches_gl != (want_gl, want_gl):
        fail(f"GL exact-z forward+backward launches {grad_launches_gl}; want "
             f"{want_gl} each")
    if not (finite_gl and shape_gl and finite_ggl):
        fail("GL exact-z C_ell or its gradient not finite, or of the wrong "
             "shape")
    if not (a_gl["f64"] <= 1e-12 and a_gl["f32"] <= 2e-6
            and a_gl["f32"] <= 1.5 * a_gl["plain32"] and a_gl["same"]
            and all(a_gl["rows"])):
        fail(f"halo_contract with a k row per row: {a_gl}")
    if not (bwd_gl["f64"] <= 1e-12 and bwd_gl["f32"] <= 2e-5
            and bwd_gl["f32"] <= 1.5 * bwd_gl["plain32"] and bwd_gl["same"]):
        fail(f"halo_contract_bwd with grad_k: {bwd_gl}")
    if not geo_gl_ok:
        fail(f"halo_contract_bwd grad_k geometry {geo_gl} differs from "
             f"ops/tiles.py's {geo_gl_mirror}")
    for name, val, gate in (
            ("float32 vs float64", err_gl["f32_vs_f64"], 1e-4),
            ("float64 kernels vs plain path", err_gl["k64_vs_plain"], 1e-12),
            ("float64 vs JAX", err_gl["f64_vs_jax"], 1e-10),
            ("lattice exact-z vs JAX", err_gl["lattice_vs_jax"], 1e-10),
            ("lattice exact-z vs GL, ell <= 1000", err_gl["lattice_vs_gl_lo"],
             1e-4),
            ("lattice exact-z vs GL", err_gl["lattice_vs_gl"],
             2.0 * gap_gl),
            ("FFT convolution float64 vs direct",
             err_fft["f64_fft_vs_direct"], 1e-10)):
        if not val <= gate:
            fail(f"GL exact-z {name}: {val} (gate {gate})")
    lap("22")

    # -- 23-26. HOD families, the prior corners, inference, the emulator --
    late = phases_23_26(
        oms=oms, s8s=s8s, check=check, k32=k32, k64=k64, cheb32=cheb32,
        cheb64=cheb64, pipe_a32=pipe, pipe_a64=pipe64, profiled=profiled,
        lap=lap)

    # -- 27-28. the flat-sky covariance stack --------------------------------
    cov_late = phases_27_28(lap=lap)
    late["paths"].update(cov_late["paths"])

    # -- 29-31. curved sky, exact z, kappa_CMB --------------------------------
    cov_more = phases_29_31(lap=lap, tomo_raw=cov_late["tomo_raw"])
    late["paths"].update(cov_more["paths"])
    cov_busy(cov_late["busy"] + cov_more["busy"])
    lap("27-31 device busy")

    # -- device time of each kernel and its library call ----------------
    dtimes = {}
    for name, (kernel, library, reps) in profiled.items():
        dtimes[name] = (device_ms(kernel, reps),
                     device_ms(library, reps) if library else None)
        print(f"[device time] {name}: kernel {fmt_ms(dtimes[name][0])}"
              + (f", library {fmt_ms(dtimes[name][1])}" if library else "")
              + f" per call (torch.profiler kernel records over {reps} "
              f"calls)", flush=True)

    # The device's busy share of one forward+backward per route.
    runs = {route: (lambda p=pipe_r: grad_run(p),
                    grad_info[route]["fwd_bwd_wall"] * 1e3)
            for route, (pipe_r, _) in pipes.items()}
    runs["exact-z"] = (grad_run_x, wall_x_fb * 1e3)
    runs["tomographic"] = (grad_run_tm, wall_tm_fb * 1e3)
    runs["exact-z tomographic"] = (grad_run_xt, wall_xt_fb * 1e3, n_x)
    runs["GL exact-z"] = (grad_run_gl, wall_gl_fb * 1e3, n_x)

    def fwd_tm():
        with torch.no_grad():
            pipe_tm(batch, nu_tm)

    def fwd_of(q):
        def run():
            with torch.no_grad():
                q["pipe"](*q["args"])
        return run

    def fwd_nograd(fn, *args_):
        def run():
            with torch.no_grad():
                fn(*args_)
        return run

    runs_op = [(f"{k} forward", (fwd_of(q), q["wall"] * 1e3, q["n"]))
               for k, q in (("options flat", q15), ("options curved", q16),
                            ("options exact-z", q17), ("options table", q18),
                            ("options tomographic", q19))]
    runs_op += [
        ("exact-z tomographic forward", (fwd_nograd(pipe_xt, batch_xt),
                                         wall_xt * 1e3, n_x)),
        ("exact-z tomographic curved forward",
         (fwd_nograd(pipe_xc, batch_xt), wall_xc * 1e3, n_x)),
        ("GL exact-z forward", (fwd_nograd(gl_cl, gl32), wall_gl * 1e3,
                                n_x))]
    runs_op += [(label, (fn, wall_b, n_b))
                for label, fn, wall_b, n_b in late["busy"]]
    for route, (run, wall_fb, *n_r) in [*runs.items(),
                                        ("tomographic forward",
                                         (fwd_tm, wall_tm * 1e3)),
                                        *runs_op]:
        # Every run here has run before (its walls): no warm-up call.
        busy = busy_ms(run, warm=False)
        what = "" if route.endswith("forward") else " forward+backward"
        n_r = n_r[0] if n_r else (n_x if route == "exact-z" else N_COSMO)
        print(f"[device time] {route}{what}, B={n_r}: "
              f"device busy {fmt_ms(busy)} of a {wall_fb:.1f} ms wall"
              + (f" ({busy / wall_fb:.1%} busy)" if busy else ""),
              flush=True)

    lap("device times")
    q_op = {"options_flat": q15, "options_curved": q16,
            "options_exact_z": q17, "options_table": q18,
            "options_tomographic": q19}
    paths = {"lattice": launches, "table": launches_t,
             "exact_z": launches_x, "shear_lattice": shear["lattice"][
                 "launches"], "shear_table": shear["table"]["launches"],
             "tomographic": launches_tm,
             **{k: q["launches"] for k, q in q_op.items()},
             "exact_z_tomographic": launches_xt,
             "exact_z_tomographic_curved": launches_xc,
             "gl_exact_z": launches_gl}
    bwd_of = dict(grad_launches, exact_z=grad_launches_x,
                  shear_lattice=shear["lattice"]["grad_launches"],
                  shear_table=shear["table"]["grad_launches"],
                  tomographic=grad_launches_tm,
                  exact_z_tomographic=grad_launches_xt,
                  gl_exact_z=grad_launches_gl,
                  **{k: q["grad_launches"] for k, q in q_op.items()
                     if "grad_launches" in q})
    bwd_paths = {route: {f"{n}_bwd": c for n, c in bw.items()}
                 for route, (_fw, bw) in bwd_of.items()}
    paths.update(late["paths"])
    bwd_paths.update(late["bwd_paths"])

    def c_key(label, c):
        return f"df_contract {label} {c['spec'][0]:g} {c['spec'][1]}"

    def record(name, source, replaces, err, ms, plain_ms, bnd, library_ms,
               dev, library_dev, paths=paths):
        by_path = {p: c[name] for p, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, "device_ms": dev,
                "library_device_ms": library_dev}

    kernels = [
        record("halo_contract", "chomp_tpu_torch/csrc/halo_contract.cu",
               "chomp_tpu/ops/halo_pallas.py:77", abs_a32, ms_a, plain_ms_a,
               bound_a, None, *dtimes["halo_contract"])
        | {"feedback_ms": ms_a_fb,
           "feedback_device_ms": dtimes["halo_contract feedback"][0],
           "feedback_bound_ms": bound_a_fb[0],
           "table_k_device_ms": dtimes["halo_contract table k"][0],
           "table_k_bound_ms": bound_a_tab[0],
           "exact_z_rows": rows_x, "exact_z_ms": ms_a_x,
           "exact_z_six_launches_ms": ms_a_x6,
           "exact_z_plain_ms": a_x["plain_ms"],
           "exact_z_device_ms": dtimes["halo_contract exact-z"][0],
           "exact_z_bound_ms": bound_a_x[0],
           "tomographic_rows": rows_tm, "tomographic_ms": ms_a_tm,
           "tomographic_plain_ms": a_tm["plain_ms"],
           "tomographic_device_ms": dtimes["halo_contract tomographic"][0],
           "tomographic_bound_ms": bound_a_tm[0],
           "tomographic_repeated_mat_share": 0.8 * flops_tm_mat / flops_tm,
           "options": {
               label: {"rows": a["rows"], "ms": a["ms"],
                       "plain_ms": a["plain_ms"],
                       "device_ms": dtimes[f"halo_contract {label}"][0],
                       "bound_ms": a["bound"][0], "bound_by": a["bound"][1]}
               for label, a in (("options flat (BAO)", a15),
                                ("options curved (Tinker)", a16),
                                ("options tomographic", a19))},
           "exact_z_tomographic": {
               "rows": rows_xt, "ms": ms_a_xt, "plain_ms": a_xt["plain_ms"],
               "plain_rows": len(check_x),
               "device_ms": dtimes["halo_contract exact-z tomographic"][0],
               "bound_ms": bound_a_xt[0], "bound_by": bound_a_xt[1]},
           "per_row_k": {
               "rows": rows_gl, "nk": len(ells_gl), "ms": ms_a_gl,
               "plain_ms": plain_ms_a_gl,
               "device_ms": dtimes["halo_contract per-row k"][0],
               "bound_ms": bound_a_gl[0], "bound_by": bound_a_gl[1],
               "max_abs_err": a_gl["abs"]},
           "ng320": {
               k: v for k, v in late["kernels"]["ng320"].items()
               if not k.startswith("bwd_")}
           | {"device_ms": dtimes["halo_contract NG=320"][0]},
           "mixed_fold": [
               {k: v for k, v in q.items() if not k.startswith("bwd_")}
               | {"device_ms": dtimes[
                   f"halo_contract mixed NG={q['ng']}"][0]}
               for q in late["kernels"]["mixed_fold"]],
           "covariance_anchor_rows": cov_more["anchor_rows"]},
        record("df_contract", "chomp_tpu_torch/csrc/df_contract.cu",
               "chomp_tpu/ops/df32.py:94", main_c["abs"], ms_c, plain_ms_c,
               bound_c, lib_ms_c, *dtimes["df_contract"])
        | {"tomographic": [
            {"mu": mu, "rows": q["rows"], "max_abs_err": q["abs"],
             "ms": q["ms"], "plain_ms": q["plain_ms"],
             "library_ms": q["lib_ms"],
             "device_ms": dtimes[f"df_contract tomographic mu={mu:g}"][0],
             "library_device_ms": dtimes[
                 f"df_contract tomographic mu={mu:g}"][1],
             "bound_ms": q["bound"][0], "bound_by": q["bound"][1]}
            for mu, q in c_tm.items()],
           "options_curved": [
            {"spec": list(c["spec"]), "rows": c["rows"], "width": c["n"],
             "max_abs_err": c["abs"], "ms": c["ms"],
             "plain_ms": c["plain_ms"], "library_ms": c["lib_ms"],
             "device_ms": dtimes[c_key("options curved", c)][0],
             "library_device_ms": dtimes[c_key("options curved", c)][1],
             "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
            for c in c16],
           "options_tomographic": [
            {"spec": list(c["spec"]), "rows": c["rows"], "width": c["n"],
             "max_abs_err": c["abs"], "ms": c["ms"],
             "plain_ms": c["plain_ms"], "library_ms": c["lib_ms"],
             "device_ms": dtimes[c_key("options tomographic", c)][0],
             "library_device_ms": dtimes[c_key("options tomographic", c)][1],
             "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
            for c in c19],
           "exact_z_tomographic": [
            {"spec": list(c["spec"]), "rows": c["rows"], "width": c["n"],
             "max_abs_err": c["abs"], "ms": c["ms"],
             "plain_ms": c["plain_ms"], "library_ms": c["lib_ms"],
             "device_ms": dtimes[c_key("exact-z tomographic", c)][0],
             "library_device_ms": dtimes[c_key("exact-z tomographic", c)][1],
             "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
            for c in c_xt]},
        record("hankel_matmul", "chomp_tpu_torch/csrc/hankel_matmul.cu",
               "chomp_tpu/ops/fftlog_pallas.py:47", main_b["abs"], ms_b,
               plain_ms_b, bound_b, lib_ms_b, *dtimes["hankel_matmul"])
        | {"options_table": {"rows": cl18.shape[0], "max_abs_err": b18["abs"],
                             "ms": b18["ms"], "library_ms": b18["lib_ms"],
                             "device_ms": dtimes[
                                 "hankel_matmul options table"][0],
                             "library_device_ms": dtimes[
                                 "hankel_matmul options table"][1],
                             "bound_ms": b18["bound"][0],
                             "bound_by": b18["bound"][1]}},
        record("halo_contract_bwd", "chomp_tpu_torch/csrc/halo_contract.cu",
               "chomp_tpu/ops/halo_pallas.py:77 (the forward's site); "
               "autodiff; no backward kernel in the JAX package",
               bwd_a["main"]["abs"], ms_abwd, plain_ms_abwd, bound_abwd,
               None, *dtimes["halo_contract_bwd"], paths=bwd_paths)
        | {"feedback_ms": ms_abwd_fb,
           "feedback_device_ms": dtimes["halo_contract_bwd feedback"][0],
           "feedback_bound_ms": bound_abwd_fb[0],
           "table_k_ms": ms_abwd_tab,
           "table_k_device_ms": dtimes["halo_contract_bwd table k"][0],
           "table_k_bound_ms": bound_abwd_tab[0], "geometry": geo_main,
           "exact_z_ms": ms_abwd_x, "exact_z_plain_ms": bwd_x["plain_ms"],
           "exact_z_device_ms": dtimes["halo_contract_bwd exact-z"][0],
           "exact_z_bound_ms": bound_abwd_x[0],
           "tomographic_rows": rows_tm, "tomographic_ms": ms_abwd_tm,
           "tomographic_plain_ms": bwd_tm["plain_ms"],
           "tomographic_device_ms": dtimes[
               "halo_contract_bwd tomographic"][0],
           "tomographic_bound_ms": bound_abwd_tm[0],
           "options_tomographic_rows": a19["rows"],
           "options_tomographic_ms": a19["bwd_ms"],
           "options_tomographic_device_ms": dtimes[
               "halo_contract_bwd options tomographic"][0],
           "options_tomographic_bound_ms": a19["bwd_bound"][0],
           "exact_z_tomographic": {
               "rows": rows_xt, "ms": ms_abwd_xt,
               "plain_ms": bwd_xt["plain_ms"], "plain_rows": len(check_x),
               "device_ms": dtimes["halo_contract_bwd exact-z tomographic"][0],
               "bound_ms": bound_abwd_xt[0], "bound_by": bound_abwd_xt[1]},
           "per_row_k_grad_k": {
               "rows": rows_gl, "nk": len(ells_gl), "ms": ms_abwd_gl,
               "ms_without_grad_k": ms_abwd_gl_nok,
               "plain_ms": plain_ms_abwd_gl,
               "device_ms": dtimes["halo_contract_bwd per-row k grad_k"][0],
               "bound_ms": bound_abwd_gl[0], "bound_by": bound_abwd_gl[1],
               "max_abs_err": bwd_gl["abs"], "geometry": geo_gl},
           "ng320": {
               k.removeprefix("bwd_"): v
               for k, v in late["kernels"]["ng320"].items()
               if k.startswith("bwd_") or k in ("rows", "ng")}
           | {"device_ms": dtimes["halo_contract_bwd NG=320"][0]},
           "mixed_fold": [
               {k.removeprefix("bwd_"): v for k, v in q.items()
                if k.startswith("bwd_") or k in ("rows", "ng")}
               | {"device_ms": dtimes[
                   f"halo_contract_bwd mixed NG={q['ng']}"][0]}
               for q in late["kernels"]["mixed_fold"]]},
        record("df_contract_bwd", "chomp_tpu_torch/csrc/df_contract.cu",
               "chomp_tpu/ops/df32.py:94 (the forward's site); autodiff; "
               "no backward kernel in the JAX package",
               checks_bc[("df_contract_bwd", (N_COSMO, 64, j_hi - j_lo))][
                   "abs"], ms_cbwd, plain_ms_cbwd, bound_cbwd, lib_ms_cbwd,
               *dtimes["df_contract_bwd"], paths=bwd_paths)
        | {"tomographic": [
            {"mu": mu, "rows": q["rows"], "max_abs_err": q["abs"],
             "ms": q["ms"], "plain_ms": q["plain_ms"],
             "library_ms": q["lib_ms"],
             "device_ms": dtimes[f"df_contract_bwd tomographic mu={mu:g}"][0],
             "library_device_ms": dtimes[
                 f"df_contract_bwd tomographic mu={mu:g}"][1],
             "bound_ms": q["bound"][0], "bound_by": q["bound"][1]}
            for mu, q in cb_tm.items()],
           "options_tomographic": [
            {"spec": list(c["spec"]), "rows": c["rows"], "width": c["n"],
             "max_abs_err": c["bwd"]["abs"], "ms": c["bwd"]["ms"],
             "library_ms": c["bwd"]["lib_ms"],
             "device_ms": dtimes[c_key("options tomographic", c).replace(
                 "df_contract", "df_contract_bwd", 1)][0],
             "library_device_ms": dtimes[c_key(
                 "options tomographic", c).replace(
                     "df_contract", "df_contract_bwd", 1)][1],
             "bound_ms": c["bwd"]["bound"][0],
             "bound_by": c["bwd"]["bound"][1]} for c in c19],
           "exact_z_tomographic": [
            {"spec": list(c["spec"]), "rows": c["rows"], "width": c["n"],
             "max_abs_err": c["bwd"]["abs"], "ms": c["bwd"]["ms"],
             "library_ms": c["bwd"]["lib_ms"],
             "device_ms": dtimes[c_key("exact-z tomographic", c).replace(
                 "df_contract", "df_contract_bwd", 1)][0],
             "library_device_ms": dtimes[c_key(
                 "exact-z tomographic", c).replace(
                     "df_contract", "df_contract_bwd", 1)][1],
             "bound_ms": c["bwd"]["bound"][0],
             "bound_by": c["bwd"]["bound"][1]} for c in c_xt]},
        record("hankel_matmul_bwd", "chomp_tpu_torch/csrc/hankel_matmul.cu",
               "chomp_tpu/ops/fftlog_pallas.py:47 (the forward's site); "
               "autodiff; no backward kernel in the JAX package",
               checks_bc[("hankel_matmul_bwd", (N_COSMO, 64, 1024))]["abs"],
               ms_bbwd, plain_ms_bbwd, bound_bbwd, lib_ms_bbwd,
               *dtimes["hankel_matmul_bwd"], paths=bwd_paths),
    ]
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

// halo_contract: the fused NFW-profile mass contraction of the halo model.
//
// Replaces the JAX package's ops/halo_pallas.py::fused_contractions (Pallas body
// _contract_kernel) and the contraction block of the JAX package's halo.py::powers
// (two_halo_integrals + one_halo_integrals, halo.py:202-248), carrying the
// halo.powers math: the matter profile (with its c_scale / k_scale feedback
// hooks folded into the node radius and concentration) at every node, and
// the NFW galaxy profile at the galaxy-pack nodes, so pp_gm multiplies the
// matter y by the galaxy y instead of squaring one of them.
//
//   N(x, c) = g(x) + sin(cx) fm((1+c)x) - cos(cx) g((1+c)x),  x = k r_s
//   h_m   = sum_mat N_m wa         pp_mm = sum_mat N_m^2 wb
//   h_g   = sum_gal N_g a_hg       pp_gg = sum_gal N_g a_gg + N_g^2 b_gg
//   pp_gm = sum_gal N_m a_gm + N_m N_g b_gm
// (1/mu(c), the quadrature weight and the Scranton p=1 / p=2 select are
// folded into the per-node, per-cosmology weights by the caller.)
//
// What bounds it on the card: arithmetic.  The contraction is ~12 flops a
// (k, node) pair against ~100 or more for the profile, and the inputs are a
// few KB per cosmology with 5 outputs per k, so memory traffic is
// negligible; wgmma and TMA have nothing to do here.  At the main path's
// shape (3542 or 4096 k, 256 mass + 256 galaxy nodes) the profile is
// evaluated ~1.4e9 times a batch of 512, over arguments that span
// x = 1e-8..1e6 and c x up to 1.1e8.  What the design does about it:
//
// 1. Small-argument route.  For b = (1+c)x <= 4 the transform is the
//    convergent moment series  N = sum_n (-1)^n x^2n M_n(c) / (2n+1)!,
//    M_n(c) = int_0^c t^(2n+1) / (1+t)^2 dt,  M_0 = mu(c)
//    (from mu(c) y = int_0^c t/(1+t)^2 sinc(x t) dt).  The coefficients
//    depend only on the node, so each block computes them in float64 once
//    per staged node (recurrence below) and rounds them to the kernel's
//    type; a pair then costs MOMENTS FMAs in x^2.  Truncation at b <= 4 is
//    below 4^(2N)/(2N+1)!: 16 terms in float64 (2e-18 of mu(c)), 10 in
//    float32 (2e-8).  48% of the main path's profile evaluations on the
//    lattice k and 65% on the table route's k take this route, in place
//    of three Si/Ci series, three logs and four sincos.
// 2. Beyond it b > 4, so f - 1/x and g at b come from one reciprocal and
//    one pass over both Chebyshev tables (or the asymptotic series), the
//    aux_fg shape of the JAX package's special.py; the Si/Ci power series
//    runs only for g(x) at x <= 4.
// 3. A galaxy node whose matter and galaxy parameters coincide (no
//    feedback hooks: c_scale = 1, k_scale exponent 0) evaluates the
//    profile once; the test is on the staged node, uniform across the block.
// 4. sin, cos of c x in float32: the argument is reduced in double
//    (q = rint(cx 2/pi), two Cody-Waite FMA steps with pi/2 split into two
//    doubles, exact to ~1e-16 for |cx| < 2^27) and the float polynomials
//    run on the reduced argument, so the library's Payne-Hanek slow path
//    (taken above |cx| = 105615, 15% of pairs) is never reached below 2^27;
//    above it the library sincosf runs.  No fast math on any path.
// 5. Weights are staged in shared memory as double once per block; the
//    Chebyshev interval maps multiply by precomputed reciprocals; one
//    reciprocal per evaluation (1/b, and 1/x from it); the moment
//    recurrence multiplies by constant reciprocals, no division.
//
// Layout: one block per (128-k tile, cosmology); each thread owns one k and
// loops over the nodes (the k row is shared, k_stride 0, or the row's own,
// k_stride NK: the Gauss-Legendre exact-z C_ell evaluates each projection
// node at its own k = (l + 1/2) / chi), staged through shared memory in tiles of 64 (every
// thread reads the same node: a broadcast), accumulating its five outputs
// in double registers.  No atomics, so the result is deterministic.  The
// Chebyshev tables live in __constant__ memory, copied there on the launch
// stream before each launch; the table lengths, series terms and moment
// counts are compile-time constants per type (the float32 trimming of the
// JAX package's special.py), checked against the caller's.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int BLOCK = 128;
constexpr int TILE = 64;
constexpr int MAT_F = 4;  // rs, c, wa (h_m), wb (pp_mm)
constexpr int GAL_F = 9;  // rs_m, c_m, rs_g, c_g, a_hg, a_gg, b_gg, a_gm, b_gm
constexpr int N_OUT = 5;  // h_m, h_g, pp_mm, pp_gg, pp_gm
constexpr int N_W = 5;    // weights per staged node
static_assert(BLOCK == 2 * TILE, "two threads stage each galaxy node");

// Packed table layout (chomp_tpu_torch/ops/halo_contract.py builds it).
constexpr int OFF_AFM = 0, OFF_AG = 32, OFF_BFM = 64, OFF_BG = 96;
constexpr int OFF_SI = 128, OFF_CI = 144, OFF_FMA = 160, OFF_GA = 168;
constexpr int N_PACK = 176;

constexpr double HALF_PI = 1.5707963267948966;
constexpr double EULER_GAMMA = 0.5772156649015329;
constexpr double SMALL_B = 4.0;  // moment-series route for (1+c)x <= 4
// Chebyshev intervals in u = 1/x: A [1/16, 1/4], B [1/64, 1/16]; the map
// to [-1, 1] is u * 2/(hi-lo) - (hi+lo)/(hi-lo).
constexpr double A_SCALE = 2.0 / 0.1875, A_SHIFT = 0.3125 / 0.1875;
constexpr double B_SCALE = 2.0 / 0.046875, B_SHIFT = 0.078125 / 0.046875;

__constant__ double c_tab_d[N_PACK];
__constant__ float c_tab_f[N_PACK];

// Terms kept per type (ops/halo_contract.py::_lens and n_moments).
template <typename T> struct Lens;
template <> struct Lens<float> {
  static constexpr int afm = 9, ag = 10, bfm = 6, bg = 7, series = 10,
                       g_asym = 4, moments = 10, stride = 12;
};
template <> struct Lens<double> {
  static constexpr int afm = 29, ag = 29, bfm = 29, bg = 29, series = 16,
                       g_asym = 7, moments = 16, stride = 16;
};

template <typename T> __device__ __forceinline__ T tab(int i);
template <> __device__ __forceinline__ float tab<float>(int i) { return c_tab_f[i]; }
template <> __device__ __forceinline__ double tab<double>(int i) { return c_tab_d[i]; }

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float rcp_(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_(double x) { return __drcp_rn(x); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }

// sin, cos of a possibly large float argument without the slow path (4.
// above).  pi/2 = PIO2_HI + PIO2_LO to ~1e-33; the float polynomials are
// the minimax fits of sin and cos on [-pi/4, pi/4] (Cephes sinf/cosf).
__device__ __forceinline__ void sincos_big(float a, float* s, float* c) {
  if (!(fabsf(a) < 134217728.0f)) {  // 2^27, or not finite
    sincosf(a, s, c);
    return;
  }
  constexpr double TWO_OVER_PI = 0.63661977236758134;
  constexpr double PIO2_HI = 1.5707963267948966;
  constexpr double PIO2_LO = 6.123233995736766e-17;
  constexpr double ROUND = 6755399441055744.0;  // 1.5 * 2^52
  const double d = (double)a;
  const double t = fma(d, TWO_OVER_PI, ROUND);  // q in t's low bits
  const int quad = __double2loint(t);
  const double q = t - ROUND;
  const float r = (float)fma(-q, PIO2_LO, fma(-q, PIO2_HI, d));
  const float z = r * r;
  const float sp = fmaf(fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                             -1.6666654611e-1f), z * r, r);
  const float cp = fmaf(fmaf(fmaf(2.443315711809948e-5f, z,
                                  -1.388731625493765e-3f), z,
                             4.166664568298827e-2f), z * z,
                        fmaf(-0.5f, z, 1.0f));
  const float ss = (quad & 1) ? cp : sp;
  const float cc = (quad & 1) ? sp : cp;
  *s = (quad & 2) ? -ss : ss;
  *c = ((quad + 1) & 2) ? -cc : cc;
}
__device__ __forceinline__ void sincos_big(double a, double* s, double* c) {
  sincos(a, s, c);
}

// Chebyshev series of table `off` (N terms) at t in [-1, 1] (Clenshaw).
template <typename T, int N>
__device__ __forceinline__ T cheb(int off, T t) {
  const T t2 = t + t;
  T b1 = T(0), b2 = T(0);
#pragma unroll
  for (int k = N - 1; k >= 1; --k) {
    const T nb = fma(t2, b1, tab<T>(off + k) - b2);
    b2 = b1;
    b1 = nb;
  }
  return fma(t, b1, tab<T>(off) - b2);
}

// Si(x) and Ci(x) from their power series (x <= 4).
template <typename T>
__device__ __forceinline__ void sici_series(T x, T& si, T& ci) {
  using L = Lens<T>;
  const T t = x * x;
  si = T(0);
  ci = T(0);
#pragma unroll
  for (int k = L::series - 1; k >= 0; --k) {
    si = fma(si, t, tab<T>(OFF_SI + k));
    if (k >= 1) ci = fma(ci, t, tab<T>(OFF_CI + k));
  }
  si = si * x;
  ci = fma(ci, t, T(EULER_GAMMA)) + log_(x);
}

// g(x), full range (Si = pi/2 - f cos - g sin, Ci = f sin - g cos);
// u = 1/x, read for x > 4.
template <typename T>
__device__ T aux_g(T x, T u) {
  using L = Lens<T>;
  if (x <= T(4)) {
    T si, ci;
    sici_series(x, si, ci);
    T s, c;
    sincos_(x, &s, &c);
    return (T(HALF_PI) - si) * s - ci * c;
  }
  if (x <= T(16))
    return cheb<T, L::ag>(OFF_AG, fma(u, T(A_SCALE), -T(A_SHIFT))) * u * u;
  if (x <= T(64))
    return cheb<T, L::bg>(OFF_BG, fma(u, T(B_SCALE), -T(B_SHIFT))) * u * u;
  const T w = u * u;
  T g = T(0);
#pragma unroll
  for (int k = L::g_asym - 1; k >= 0; --k) g = fma(g, w, tab<T>(OFF_GA + k));
  return g * w;
}

// f(b) - 1/b and g(b) together for b > 4 (u = 1/b): one branch.
template <typename T>
__device__ __forceinline__ void aux_fg_large(T b, T u, T& fm, T& g) {
  using L = Lens<T>;
  if (b <= T(64)) {
    if (b <= T(16)) {
      const T t = fma(u, T(A_SCALE), -T(A_SHIFT));
      fm = cheb<T, L::afm>(OFF_AFM, t);
      g = cheb<T, L::ag>(OFF_AG, t);
    } else {
      const T t = fma(u, T(B_SCALE), -T(B_SHIFT));
      fm = cheb<T, L::bfm>(OFF_BFM, t);
      g = cheb<T, L::bg>(OFF_BG, t);
    }
    fm = fm * u;
    g = g * u * u;
    return;
  }
  const T w = u * u;
  T f = T(0);
#pragma unroll
  for (int k = 6; k >= 1; --k) f = fma(f, w, tab<T>(OFF_FMA + k));
  fm = f * w * u;
  T gg = T(0);
#pragma unroll
  for (int k = L::g_asym - 1; k >= 0; --k) gg = fma(gg, w, tab<T>(OFF_GA + k));
  g = gg * w;
}

// f(x) - 1/x and g(x), full range (the backward's fm(x)); u = 1/x.
template <typename T>
__device__ __forceinline__ void aux_fg(T x, T u, T& fm, T& g) {
  if (x <= T(4)) {
    T si, ci, s, c;
    sici_series(x, si, ci);
    sincos_(x, &s, &c);
    fm = (T(HALF_PI) - si) * c + ci * s - u;
    g = (T(HALF_PI) - si) * s - ci * c;
    return;
  }
  aux_fg_large(x, u, fm, g);
}

// A staged profile: radius, concentration, 1 + c, and its moment-series
// coefficients a_n = (-1)^n M_n(c) / (2n+1)!.
template <typename T>
struct alignas(16) Profile {
  T rs, c, c1, pad;
  T a[Lens<T>::stride];
};

// Stage one profile: the moments by I_m = c^(m-1)/(m-1) - 2 I_(m-1) -
// I_(m-2), I_0 = c/(1+c), I_1 = mu(c), M_n = I_(2n+1), in float64
// (ops/halo_contract.py::moment_coeffs is the same recurrence).
template <typename T>
__device__ void stage_profile(Profile<T>& p, T rs, T c) {
  p.rs = rs;
  p.c = c;
  p.c1 = T(1) + c;
  const double cd = (double)c;
  double i2 = cd / (1.0 + cd);
  double i1 = log1p(cd) - i2;
  double pw = cd, inv_fact = 1.0;
  p.a[0] = (T)i1;
  // Unrolled, so 1/(m-1) and 1/((2n)(2n+1)) fold to constants.
#pragma unroll
  for (int n = 1; n < Lens<T>::moments; ++n) {
#pragma unroll
    for (int m = 2 * n; m <= 2 * n + 1; ++m) {
      const double im = pw * (1.0 / (m - 1)) - 2.0 * i1 - i2;
      pw *= cd;
      i2 = i1;
      i1 = im;
    }
    inv_fact *= 1.0 / ((double)(2 * n) * (double)(2 * n + 1));
    p.a[n] = (T)((n & 1 ? -i1 : i1) * inv_fact);
  }
#pragma unroll
  for (int n = Lens<T>::moments; n < Lens<T>::stride; ++n) p.a[n] = T(0);
}

// mu(c) y(k, M) at x = k r_s.
template <typename T>
__device__ __forceinline__ T profile_n(T kk, const Profile<T>& p) {
  const T x = kk * p.rs;
  const T b = p.c1 * x;
  if (b <= T(SMALL_B)) {
    const T x2 = x * x;
    T n = p.a[Lens<T>::moments - 1];
#pragma unroll
    for (int j = Lens<T>::moments - 2; j >= 0; --j) n = fma(n, x2, p.a[j]);
    return n;
  }
  // One reciprocal: 1/x = (1+c)/b, within 1.5 ulp.
  T s, co, fm, g;
  sincos_big(p.c * x, &s, &co);
  const T u = rcp_(b);
  aux_fg_large(b, u, fm, g);
  return aux_g(x, p.c1 * u) + s * fm - co * g;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
halo_contract_kernel(const T* __restrict__ k, int k_stride, int nk,
                     const T* __restrict__ mat, int nm,
                     const T* __restrict__ gal, int ng,
                     T* __restrict__ out) {
  __shared__ Profile<T> s_p[2][TILE];  // [0] matter, [1] galaxy profile
  __shared__ double s_w[TILE][N_W];
  __shared__ bool s_same[TILE];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * BLOCK + tid;
  const bool live = i < nk;
  const T kk = live ? k[(size_t)b * k_stride + i] : T(1);
  double h_m = 0.0, h_g = 0.0, pp_mm = 0.0, pp_gg = 0.0, pp_gm = 0.0;

  const T* mb = mat + (size_t)b * nm * MAT_F;
  for (int base = 0; base < nm; base += TILE) {
    const int cnt = min(TILE, nm - base);
    __syncthreads();
    if (tid < cnt) {
      const T* q = mb + (size_t)(base + tid) * MAT_F;
      stage_profile(s_p[0][tid], q[0], q[1]);
      s_w[tid][0] = (double)q[2];
      s_w[tid][1] = (double)q[3];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const double n = (double)profile_n<T>(kk, s_p[0][j]);
        h_m = fma(n, s_w[j][0], h_m);
        pp_mm = fma(n * n, s_w[j][1], pp_mm);
      }
    }
  }

  const T* gb = gal + (size_t)b * ng * GAL_F;
  for (int base = 0; base < ng; base += TILE) {
    const int cnt = min(TILE, ng - base);
    __syncthreads();
    // Threads [0, TILE) stage the matter profile and the weights of node
    // tid, threads [TILE, 2 TILE) the galaxy profile of node tid - TILE.
    const int jn = tid % TILE;
    if (jn < cnt) {
      const T* q = gb + (size_t)(base + jn) * GAL_F;
      const bool same = q[0] == q[2] && q[1] == q[3];
      if (tid < TILE) {
        stage_profile(s_p[0][jn], q[0], q[1]);
        s_same[jn] = same;
        for (int f = 0; f < N_W; ++f) s_w[jn][f] = (double)q[4 + f];
      } else if (!same) {
        stage_profile(s_p[1][jn], q[2], q[3]);
      }
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const double n_m = (double)profile_n<T>(kk, s_p[0][j]);
        const double n_g =
            s_same[j] ? n_m : (double)profile_n<T>(kk, s_p[1][j]);
        const double* w = s_w[j];
        h_g = fma(n_g, w[0], h_g);
        pp_gg = fma(n_g, fma(n_g, w[2], w[1]), pp_gg);
        pp_gm = fma(n_m, fma(n_g, w[4], w[3]), pp_gm);
      }
    }
  }

  if (live) {
    T* ob = out + (size_t)b * N_OUT * nk + i;
    ob[0 * (size_t)nk] = (T)h_m;
    ob[1 * (size_t)nk] = (T)h_g;
    ob[2 * (size_t)nk] = (T)pp_mm;
    ob[3 * (size_t)nk] = (T)pp_gg;
    ob[4 * (size_t)nk] = (T)pp_gm;
  }
}

// ---------------------------------------------------------------------------
// Backward, kernel A'.  Given the output's cotangent G (B, 5, NK), the
// gradients of the node arrays.  It replaces autodiff of the JAX package's
// ops/halo_pallas.py::fused_contractions (chomp_tpu/ops/halo_pallas.py:77),
// which has no backward kernel: XLA differentiates its path.  With
// N(x, c) = int_0^c sin(xt) / (x (1+t)^2) dt, f' = -g, g' = f - 1/x:
//   dN/dc = sin(cx) / (x (1+c)^2) = sin(cx) / (b (1+c)),   b = (1+c) x,
//   dN/dx = fm(x) - cos(cx) fm(b) - sin(cx) g(b) + sin(cx) / (x b),
// and on the small-argument route b <= 4 three series in x^2 with
// per-node coefficients (ProfileB).  Per mat node (rs, c, wa, wb), S =
// G_hm wa + 2 G_mm wb N:  d wa = sum_k G_hm N,  d wb = sum_k G_mm N^2,
// d rs = sum_k S k dN/dx,  d c = sum_k S dN/dc.  Per gal node, S_g = G_hg
// a_hg + G_gg (a_gg + 2 b_gg N_g) + G_gm b_gm N_m and S_m = G_gm (a_gm +
// b_gm N_g) play S's part for the galaxy and the matter profile; a node
// whose two profiles coincide evaluates one, and both fields still get
// their own gradient.
//
// What bounds it on the card: arithmetic, as the forward.  Each (k,
// profile) costs ~50 counted operations on the moment route and ~70-150
// beyond it (a sincos or two, a log, two Chebyshev passes; each counted
// as chip_smoke.halo_contract_bwd_flops counts it), against a few KB of
// node arrays and the cotangent, read once from device memory.  What A' adds
// on top of the forward, and what the design does about each:
//
// 1. Layout (the forward's): one warp evaluates one node at a time and its
//    lanes take consecutive k, so the 32 lanes share a route except where
//    k crosses a route boundary (a thread per node put 32 nodes, on mixed
//    routes, into one warp-step).  A block is one cosmology and one work
//    unit of UNIT_M mat and UNIT_G gal nodes (BWD_WARPS warps, each two
//    of either kind, so every warp and every block carries the same mix
//    and no wave is left with only gal nodes); the units' profiles are
//    staged once in shared memory (ProfileB, read as broadcasts, out of
//    the registers).  The cosmology's k and cotangent rows are staged in
//    tiles of kt k (all of it when it fits; bwd_geometry).  Each lane sums
//    its k in k order; at the end of a node's tile a fixed __shfl_xor
//    butterfly reduces each field and lane 0 adds it to the node's double
//    total in shared memory, in tile order: no atomics, two launches agree
//    bit for bit.
// 2. Convert once: the cotangent is staged in the contraction type W
//    (float in the float kernel), so no (k, node) pair converts it; the
//    per-k products are formed in W and summed in runs of RUN k per lane
//    (Run), each run added to the double total once: a float -> double
//    conversion per field and run instead of three to six per (k, node)
//    and ~8-18 FP64 operations.  A gal node whose two profiles coincide
//    reuses the matter profile's values (a warp-uniform branch, compiled
//    apart).
// 3. The moment route's dN/dc = c sinc(cx) / (1+c)^2 is a series in x^2
//    (|cx| < 4 there), with coefficients staged per node: no sincosf and
//    no reciprocal on 48-65% of the main path's evaluations.
// 4. Registers: with the profiles and weights in shared memory, ptxas
//    gives the float kernel 80 registers under __launch_bounds__(BWD_BLOCK)
//    (no resident-block request) with a small spill (28 B stored, 68 B
//    loaded), so three 70 KB blocks (24 warps) share an SM.  Asking for
//    three blocks gives the same 80 registers and runs slower; asking for
//    two removes the spill at 107 registers but leaves 16 warps an SM and
//    runs ~20% slower (PERF.md, the ablation).  chip_smoke.py's phase 8
//    prints ptxas' lines.
// 5. grad_k (the Gauss-Legendre exact-z C_ell, whose k = (l + 1/2) / chi
//    moves with the cosmology): d out / d k_i = r_s dN/dx at the node, so
//    grad_k[r, i] = sum over nodes of S r_s dN/dx (S_m r_s,m dN_m/dx + S_g
//    r_s,g dN_g/dx at a gal node), the dN/dx that d rs already needs.  It
//    is a sum across the warps and blocks that hold the nodes, for each k:
//    each lane adds its k's terms, in node order, to its warp's row of a
//    double buffer in shared memory (one lane a k, so no race); at the end
//    of a k tile the block sums its warps' rows in warp order into its
//    work unit's row of a double scratch (R, units, NK) in device memory,
//    and a second kernel sums the units in unit order.  No atomics: two
//    launches agree bit for bit.  The buffer takes BWD_WARPS doubles of
//    each k's share of the tile bytes (smaller k tiles); a launch that
//    does not ask for grad_k runs the kernel compiled without it.

constexpr int BWD_BLOCK = 256;
constexpr int BWD_WARPS = BWD_BLOCK / 32;
constexpr int UNIT_M = 16;  // mat nodes of a work unit (block)
constexpr int UNIT_G = 16;  // gal nodes of a work unit
constexpr int RUN = 16;     // k per lane summed in W before the double total
static_assert(UNIT_M % BWD_WARPS == 0 && UNIT_G % BWD_WARPS == 0,
              "every warp takes as many nodes of each kind");

// Per kernel type: the contraction type W and the dynamic shared memory
// a k tile may take.
template <typename T> struct BwdShape;
template <> struct BwdShape<float> {
  using W = float;
  static constexpr int tile_bytes = 61440;
};
template <> struct BwdShape<double> {
  using W = double;
  static constexpr int tile_bytes = 73728;
};

// A staged backward profile: radius, concentration, 1 + c, 1/(1+c), and
// the small-argument series in x^2:  N = sum_n a_n x^2n,  dN/dx / x =
// sum_n d_n x^2n (d_n = 2(n+1) a_(n+1)),  dN/dc = sum_n e_n x^2n with
// e_n = (-1)^n c^(2n+1) / ((2n+1)! (1+c)^2).
template <typename T>
struct alignas(16) ProfileB {
  T rs, c, c1, inv_c1;
  T a[Lens<T>::moments];
  T d[Lens<T>::moments];
  T e[Lens<T>::moments];
};

// The moment recurrence of stage_profile, and e_n by e_n = -c^2 e_(n-1) /
// ((2n)(2n+1)), in float64 (ops/halo_contract.py::moment_coeffs and
// dc_coeffs are the same recurrences).
template <typename T>
__device__ void stage_profile_b(ProfileB<T>& p, T rs, T c) {
  constexpr int M = Lens<T>::moments;
  p.rs = rs;
  p.c = c;
  p.c1 = T(1) + c;
  const double cd = (double)c, c1d = 1.0 + cd;
  p.inv_c1 = (T)(1.0 / c1d);
  double i2 = cd / c1d;
  double i1 = log1p(cd) - i2;
  double pw = cd, inv_fact = 1.0;
  double e = cd / (c1d * c1d);
  const double mc2 = -cd * cd;
  p.a[0] = (T)i1;
  p.e[0] = (T)e;
#pragma unroll
  for (int n = 1; n < M; ++n) {
#pragma unroll
    for (int m = 2 * n; m <= 2 * n + 1; ++m) {
      const double im = pw * (1.0 / (m - 1)) - 2.0 * i1 - i2;
      pw *= cd;
      i2 = i1;
      i1 = im;
    }
    const double step = 1.0 / ((double)(2 * n) * (double)(2 * n + 1));
    inv_fact *= step;
    const double an = (n & 1 ? -i1 : i1) * inv_fact;
    p.a[n] = (T)an;
    p.d[n - 1] = (T)((2 * n) * an);
    e = e * mc2 * step;
    p.e[n] = (T)e;
  }
  p.d[M - 1] = T(0);
}

// N, dN/dx and dN/dc at x = k r_s.
template <typename T>
__device__ __forceinline__ void profile_nd(T kk, const ProfileB<T>& p, T& n,
                                           T& dx, T& dc) {
  constexpr int M = Lens<T>::moments;
  const T x = kk * p.rs;
  const T b = p.c1 * x;
  if (b <= T(SMALL_B)) {
    const T x2 = x * x;
    n = p.a[M - 1];
    T d = p.d[M - 2];
    T e = p.e[M - 1];
#pragma unroll
    for (int j = M - 2; j >= 0; --j) {
      n = fma(n, x2, p.a[j]);
      e = fma(e, x2, p.e[j]);
      if (j >= 1) d = fma(d, x2, p.d[j - 1]);
    }
    dx = d * x;
    dc = e;
    return;
  }
  T s, co, fm, g, fmx, gx;
  sincos_big(p.c * x, &s, &co);
  const T u = rcp_(b);
  aux_fg_large(b, u, fm, g);
  const T ux = p.c1 * u;  // 1/x
  aux_fg(x, ux, fmx, gx);
  n = gx + s * fm - co * g;
  dx = fmx - co * fm - s * g + s * ux * u;
  dc = s * u * p.inv_c1;
}

// One field's sum over a run of k in W, taken into the double total.
template <typename W>
struct Run {
  W s = W(0);
  __device__ __forceinline__ void add(W a, W b) { s = fma(a, b, s); }
  __device__ __forceinline__ double take() {
    const double v = (double)s;
    s = W(0);
    return v;
  }
};

// Sums each field over the warp's lanes (a fixed butterfly) and adds it
// to the node's total; lane 0 writes.
template <int F>
__device__ __forceinline__ void warp_fold(const double (&acc)[F], int lane,
                                          double* total) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    double v = acc[f];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) total[f] += v;
  }
}

// A mat node over one staged tile: acc rs, c, wa, wb; G rows 0 h_m, 2
// pp_mm; w = (wa, 2 wb).  GK: adds S r_s dN/dx to the warp's grad_k row.
template <typename T, typename W, bool GK>
__device__ __forceinline__ void mat_node(const ProfileB<T>& p, const W* w,
                                         const T* s_k, const W* s_g, int kt,
                                         int cnt, int lane, double* total,
                                         double* gk) {
  const W w0 = w[0], w1 = w[1];
  const W* g_hm = s_g;
  const W* g_mm = s_g + 2 * kt;
  double acc[MAT_F] = {0.0, 0.0, 0.0, 0.0};
  for (int i0 = lane; i0 < cnt; i0 += 32 * RUN) {
    Run<W> q[MAT_F];
    const int end = min(cnt, i0 + 32 * RUN);
    for (int i = i0; i < end; i += 32) {
      const T kk = s_k[i];
      T n, dx, dc;
      profile_nd(kk, p, n, dx, dc);
      const T kdx = kk * dx;
      const W nw = (W)n, gh = g_hm[i], gm = g_mm[i];
      const W sv = fma(gm * w1, nw, gh * w0);
      if (GK) gk[i] += (double)sv * ((double)dx * (double)p.rs);
      q[0].add(sv, (W)kdx);
      q[1].add(sv, (W)dc);
      q[2].add(gh, nw);
      q[3].add(gm * nw, nw);
    }
#pragma unroll
    for (int f = 0; f < MAT_F; ++f) acc[f] += q[f].take();
  }
  warp_fold(acc, lane, total);
}

// A gal node over one staged tile: acc rs_m, c_m, rs_g, c_g, a_hg, a_gg,
// b_gg, a_gm, b_gm; G rows 1 h_g, 3 pp_gg, 4 pp_gm; w = (a_hg, a_gg,
// 2 b_gg, a_gm, b_gm).  SAME: the two profiles coincide (pg unread).
// GK: adds S_m r_s,m dN_m/dx + S_g r_s,g dN_g/dx to the warp's grad_k row.
template <typename T, typename W, bool SAME, bool GK>
__device__ __forceinline__ void gal_node(const ProfileB<T>& pm,
                                         const ProfileB<T>& pg, const W* w,
                                         const T* s_k, const W* s_g, int kt,
                                         int cnt, int lane, double* total,
                                         double* gk) {
  const W w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  const W* g_hg = s_g + kt;
  const W* g_gg = s_g + 3 * kt;
  const W* g_gm = s_g + 4 * kt;
  double acc[GAL_F];
#pragma unroll
  for (int f = 0; f < GAL_F; ++f) acc[f] = 0.0;
  for (int i0 = lane; i0 < cnt; i0 += 32 * RUN) {
    Run<W> q[GAL_F];
    const int end = min(cnt, i0 + 32 * RUN);
    for (int i = i0; i < end; i += 32) {
      const T kk = s_k[i];
      T n_m, dx_m, dc_m;
      profile_nd(kk, pm, n_m, dx_m, dc_m);
      const T kdx_m = kk * dx_m;
      const W nm = (W)n_m, kdxm = (W)kdx_m, dcm = (W)dc_m;
      W ng = nm, kdxg = kdxm, dcg = dcm;
      T dx_g = dx_m;
      if (!SAME) {
        T n_g, dc_g;
        profile_nd(kk, pg, n_g, dx_g, dc_g);
        const T kdx_g = kk * dx_g;
        ng = (W)n_g;
        kdxg = (W)kdx_g;
        dcg = (W)dc_g;
      }
      const W gh = g_hg[i], gg = g_gg[i], gm = g_gm[i];
      const W sg = fma(gm * w4, nm, fma(gg, fma(w2, ng, w1), gh * w0));
      const W sm = gm * fma(w4, ng, w3);
      if (GK)
        gk[i] += (double)sm * ((double)dx_m * (double)pm.rs) +
                 (double)sg * ((double)dx_g * (double)pg.rs);
      q[0].add(sm, kdxm);
      q[1].add(sm, dcm);
      q[2].add(sg, kdxg);
      q[3].add(sg, dcg);
      q[4].add(gh, ng);
      q[5].add(gg, ng);
      q[6].add(gg * ng, ng);
      q[7].add(gm, nm);
      q[8].add(gm * nm, ng);
    }
#pragma unroll
    for (int f = 0; f < GAL_F; ++f) acc[f] += q[f].take();
  }
  warp_fold(acc, lane, total);
}

template <typename T, bool GK>
__global__ void __launch_bounds__(BWD_BLOCK)
halo_contract_bwd_kernel(const T* __restrict__ k, int k_stride, int nk,
                         const T* __restrict__ mat, int nm,
                         const T* __restrict__ gal, int ng,
                         const T* __restrict__ grad, T* __restrict__ gmat,
                         T* __restrict__ ggal, int kt,
                         double* __restrict__ gk_part) {
  using W = typename BwdShape<T>::W;
  __shared__ ProfileB<T> s_pm[UNIT_M];
  __shared__ ProfileB<T> s_pg[2][UNIT_G];  // [0] matter, [1] galaxy profile
  __shared__ W s_wm[UNIT_M][2];
  __shared__ W s_wg[UNIT_G][N_W];
  __shared__ bool s_same[UNIT_G];
  __shared__ double s_tot[UNIT_M * MAT_F + UNIT_G * GAL_F];
  extern __shared__ __align__(16) unsigned char s_dyn[];
  W* s_g = reinterpret_cast<W*>(s_dyn);              // [N_OUT][kt]
  T* s_k = reinterpret_cast<T*>(s_g + N_OUT * kt);   // [kt]
  double* s_gk = reinterpret_cast<double*>(s_k + kt); // GK: [BWD_WARPS][kt]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * UNIT_M, g0 = blockIdx.x * UNIT_G;
  const int cm = max(0, min(UNIT_M, nm - m0));
  const int cg = max(0, min(UNIT_G, ng - g0));
  double* tot_m = s_tot;
  double* tot_g = s_tot + UNIT_M * MAT_F;

  // Stage the unit: warp 0 the mat nodes, warp 1 the gal nodes' matter
  // profiles and weights, warp 2 their galaxy profiles.
  for (int s = tid; s < UNIT_M * MAT_F + UNIT_G * GAL_F; s += BWD_BLOCK)
    s_tot[s] = 0.0;
  if (tid < cm) {
    const T* q = mat + ((size_t)b * nm + m0 + tid) * MAT_F;
    stage_profile_b(s_pm[tid], q[0], q[1]);
    s_wm[tid][0] = (W)q[2];
    s_wm[tid][1] = W(2) * (W)q[3];
  } else if (tid >= 32 && tid < 32 + cg) {
    const int j = tid - 32;
    const T* q = gal + ((size_t)b * ng + g0 + j) * GAL_F;
    s_same[j] = q[0] == q[2] && q[1] == q[3];
    stage_profile_b(s_pg[0][j], q[0], q[1]);
    s_wg[j][0] = (W)q[4];
    s_wg[j][1] = (W)q[5];
    s_wg[j][2] = W(2) * (W)q[6];
    s_wg[j][3] = (W)q[7];
    s_wg[j][4] = (W)q[8];
  } else if (tid >= 64 && tid < 64 + cg) {
    const T* q = gal + ((size_t)b * ng + g0 + tid - 64) * GAL_F;
    stage_profile_b(s_pg[1][tid - 64], q[2], q[3]);
  }

  const T* gb = grad + (size_t)b * N_OUT * nk;
  const T* kb = k + (size_t)b * k_stride;
  double* gk_w = s_gk + warp * kt;
  for (int t0 = 0; t0 < nk; t0 += kt) {
    const int cnt = min(kt, nk - t0);
    __syncthreads();
    for (int i = tid; i < cnt; i += BWD_BLOCK) {
      s_k[i] = kb[t0 + i];
#pragma unroll
      for (int o = 0; o < N_OUT; ++o)
        s_g[o * kt + i] = (W)gb[(size_t)o * nk + t0 + i];
      if (GK)
        for (int w = 0; w < BWD_WARPS; ++w) s_gk[w * kt + i] = 0.0;
    }
    __syncthreads();
    for (int j = warp; j < cm; j += BWD_WARPS)
      mat_node<T, W, GK>(s_pm[j], s_wm[j], s_k, s_g, kt, cnt, lane,
                         tot_m + j * MAT_F, gk_w);
    for (int j = warp; j < cg; j += BWD_WARPS) {
      if (s_same[j])
        gal_node<T, W, true, GK>(s_pg[0][j], s_pg[0][j], s_wg[j], s_k, s_g,
                                 kt, cnt, lane, tot_g + j * GAL_F, gk_w);
      else
        gal_node<T, W, false, GK>(s_pg[0][j], s_pg[1][j], s_wg[j], s_k, s_g,
                                  kt, cnt, lane, tot_g + j * GAL_F, gk_w);
    }
    if (GK) {
      // The unit's share of grad_k for this tile: its warps in order.
      __syncthreads();
      double* out = gk_part + ((size_t)b * gridDim.x + blockIdx.x) * nk + t0;
      for (int i = tid; i < cnt; i += BWD_BLOCK) {
        double s = 0.0;
        for (int w = 0; w < BWD_WARPS; ++w) s += s_gk[w * kt + i];
        out[i] = s;
      }
    }
  }
  __syncthreads();
  T* om = gmat + ((size_t)b * nm + m0) * MAT_F;
  for (int s = tid; s < cm * MAT_F; s += BWD_BLOCK) om[s] = (T)tot_m[s];
  T* og = ggal + ((size_t)b * ng + g0) * GAL_F;
  for (int s = tid; s < cg * GAL_F; s += BWD_BLOCK) og[s] = (T)tot_g[s];
}

// grad_k: the units' partial sums (R, units, NK), summed in unit order.
template <typename T>
__global__ void grad_k_sum_kernel(const double* __restrict__ part,
                                  int units, int nk, int total,
                                  T* __restrict__ gk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int b = t / nk, i = t - b * nk;
  const double* p = part + (size_t)b * units * nk + i;
  double s = 0.0;
  for (int u = 0; u < units; ++u) s += p[(size_t)u * nk];
  gk[t] = (T)s;
}

// The backward's launch geometry (ops/tiles.py::bwd_geometry mirrors it):
// one block per (work unit, cosmology); k tiles of kt, a multiple of 32,
// as large as BwdShape::tile_bytes of staged k and cotangent (and, with
// grad_k, the warps' double rows) allow.
struct BwdGeometry {
  int units, kt, tiles, dyn_smem;
};

template <typename T>
BwdGeometry bwd_geometry(int nm, int ng, int nk, bool gk) {
  using W = typename BwdShape<T>::W;
  const int per_k = (int)(N_OUT * sizeof(W) + sizeof(T) +
                          (gk ? BWD_WARPS * sizeof(double) : 0));
  const int kt_max = BwdShape<T>::tile_bytes / per_k / 32 * 32;
  const int units =
      std::max((nm + UNIT_M - 1) / UNIT_M, (ng + UNIT_G - 1) / UNIT_G);
  const int kt = std::max(32, std::min(kt_max, (nk + 31) / 32 * 32));
  return {units, kt, (nk + kt - 1) / kt, kt * per_k};
}

// Checks the caller's term counts and copies the tables to constant
// memory on the launch stream.
template <typename T, typename Sym>
cudaError_t prepare(const Sym& table_symbol, const void* tables,
                    const int* lens, cudaStream_t s) {
  using L = Lens<T>;
  const int want[6] = {L::afm, L::ag, L::bfm, L::bg, L::series, L::g_asym};
  for (int j = 0; j < 6; ++j)
    if (lens[j] != want[j]) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbolAsync(table_symbol, tables, N_PACK * sizeof(T), 0,
                                 cudaMemcpyDeviceToDevice, s);
}

template <typename T, typename Sym>
int launch(const Sym& table_symbol, const void* tables, const void* k,
           int k_stride, int nk, const void* mat, int nm, const void* gal,
           int ng, void* out, int batch, const int* lens, cudaStream_t s) {
  const cudaError_t err = prepare<T>(table_symbol, tables, lens, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nk + BLOCK - 1) / BLOCK, batch);
  halo_contract_kernel<T><<<grid, BLOCK, 0, s>>>(
      (const T*)k, k_stride, nk, (const T*)mat, nm, (const T*)gal, ng,
      (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool GK>
cudaError_t launch_bwd_kernel(const BwdGeometry& g, const void* k,
                              int k_stride, int nk, const void* mat, int nm,
                              const void* gal, int ng, const void* grad,
                              void* gmat, void* ggal, int batch,
                              void* gk_part, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      halo_contract_bwd_kernel<T, GK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, g.dyn_smem);
  if (err != cudaSuccess) return err;
  halo_contract_bwd_kernel<T, GK><<<dim3(g.units, batch), BWD_BLOCK,
                                    g.dyn_smem, s>>>(
      (const T*)k, k_stride, nk, (const T*)mat, nm, (const T*)gal, ng,
      (const T*)grad, (T*)gmat, (T*)ggal, g.kt, (double*)gk_part);
  return cudaGetLastError();
}

// gk_part (batch, units, nk) double scratch and gk (batch, nk): both null,
// or both given for grad_k.
template <typename T, typename Sym>
int launch_bwd(const Sym& table_symbol, const void* tables, const void* k,
               int k_stride, int nk, const void* mat, int nm,
               const void* gal, int ng, const void* grad, void* gmat,
               void* ggal, void* gk_part, void* gk, int batch,
               const int* lens, cudaStream_t s) {
  cudaError_t err = prepare<T>(table_symbol, tables, lens, s);
  if (err != cudaSuccess) return (int)err;
  const bool with_gk = gk != nullptr;
  if (with_gk != (gk_part != nullptr)) return (int)cudaErrorInvalidValue;
  const BwdGeometry g = bwd_geometry<T>(nm, ng, nk, with_gk);
  if (!with_gk)
    return (int)launch_bwd_kernel<T, false>(g, k, k_stride, nk, mat, nm, gal,
                                            ng, grad, gmat, ggal, batch,
                                            nullptr, s);
  err = launch_bwd_kernel<T, true>(g, k, k_stride, nk, mat, nm, gal, ng, grad,
                                   gmat, ggal, batch, gk_part, s);
  if (err != cudaSuccess) return (int)err;
  const int total = batch * nk;
  grad_k_sum_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      (const double*)gk_part, g.units, nk, total, (T*)gk);
  return (int)cudaGetLastError();
}

// out: units, block, unit_m, unit_g, kt, tiles, dynamic shared memory,
// static shared memory, registers, local (spill) bytes, resident blocks
// per SM.
template <typename T, bool GK>
int bwd_report(int nm, int ng, int nk, int* out) {
  const BwdGeometry g = bwd_geometry<T>(nm, ng, nk, GK);
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, halo_contract_bwd_kernel<T, GK>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(halo_contract_bwd_kernel<T, GK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g.dyn_smem);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, halo_contract_bwd_kernel<T, GK>, BWD_BLOCK, g.dyn_smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[11] = {g.units, BWD_BLOCK, UNIT_M, UNIT_G, g.kt, g.tiles,
                        g.dyn_smem, (int)attr.sharedSizeBytes, attr.numRegs,
                        (int)attr.localSizeBytes, resident};
  for (int j = 0; j < 11; ++j) out[j] = vals[j];
  return 0;
}

}  // namespace

// k_stride: 0 when every row shares k (NK,), NK for a k row per cosmology
// row (B, NK).
extern "C" int halo_contract_launch(int device, int is_double, const void* k,
                                    int k_stride, int nk, const void* mat,
                                    int nm, const void* gal, int ng,
                                    void* out, int batch, const void* tables,
                                    int afm, int ag, int bfm, int bg,
                                    int series, int g_asym, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int lens[6] = {afm, ag, bfm, bg, series, g_asym};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double>(c_tab_d, tables, k, k_stride, nk, mat, nm, gal, ng,
                          out, batch, lens, s);
  return launch<float>(c_tab_f, tables, k, k_stride, nk, mat, nm, gal, ng,
                       out, batch, lens, s);
}

extern "C" int halo_contract_bwd_launch(int device, int is_double,
                                        const void* k, int k_stride, int nk,
                                        const void* mat, int nm,
                                        const void* gal, int ng,
                                        const void* grad, void* gmat,
                                        void* ggal, void* gk_part, void* gk,
                                        int batch, const void* tables,
                                        int afm, int ag, int bfm, int bg,
                                        int series, int g_asym,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int lens[6] = {afm, ag, bfm, bg, series, g_asym};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch_bwd<double>(c_tab_d, tables, k, k_stride, nk, mat, nm, gal,
                              ng, grad, gmat, ggal, gk_part, gk, batch, lens,
                              s);
  return launch_bwd<float>(c_tab_f, tables, k, k_stride, nk, mat, nm, gal, ng,
                           grad, gmat, ggal, gk_part, gk, batch, lens, s);
}

extern "C" int halo_contract_bwd_geometry(int device, int is_double, int nm,
                                          int ng, int nk, int with_gk,
                                          int* out) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (is_double)
    return with_gk ? bwd_report<double, true>(nm, ng, nk, out)
                   : bwd_report<double, false>(nm, ng, nk, out);
  return with_gk ? bwd_report<float, true>(nm, ng, nk, out)
                 : bwd_report<float, false>(nm, ng, nk, out);
}

extern "C" const char* halo_contract_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// What bounds it on the card: arithmetic.  Each (k, node) pair costs three
// auxiliary-function evaluations (series, Chebyshev or asymptotic branch)
// and one sincos whose argument c k r_s reaches ~1e7 at the top of the
// lattice, so the accurate (Payne-Hanek) range reduction is taken: no fast
// math anywhere.  The node arrays are a few KB per cosmology and the output
// is 5 numbers per k, so memory traffic is negligible.
//
// Simple design: one block per (128-k tile, cosmology); each thread owns one
// k and loops over every node, staged through shared memory in tiles of 128,
// accumulating its five outputs in double registers.  No atomics, so the
// result is deterministic.  The Chebyshev tables live in __constant__ memory
// (every thread of a warp reads the same coefficient: a broadcast), copied
// there on the launch stream before each launch; the float instantiation
// carries the float32 trimming of the JAX package's special.py (trimmed table
// lengths, 10 series terms, 4 asymptotic g terms) through `Lens`.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;
constexpr int TILE = 128;
constexpr int MAT_F = 4;  // rs, c, wa (h_m), wb (pp_mm)
constexpr int GAL_F = 9;  // rs_m, c_m, rs_g, c_g, a_hg, a_gg, b_gg, a_gm, b_gm
constexpr int N_OUT = 5;  // h_m, h_g, pp_mm, pp_gg, pp_gm

// Packed table layout (chomp_tpu_torch/ops/halo_contract.py builds it).
constexpr int OFF_AFM = 0, OFF_AG = 32, OFF_BFM = 64, OFF_BG = 96;
constexpr int OFF_SI = 128, OFF_CI = 144, OFF_FMA = 160, OFF_GA = 168;
constexpr int N_PACK = 176;

constexpr double HALF_PI = 1.5707963267948966;
constexpr double EULER_GAMMA = 0.5772156649015329;

__constant__ double c_tab_d[N_PACK];
__constant__ float c_tab_f[N_PACK];

struct Lens {
  int afm, ag, bfm, bg;  // Chebyshev terms kept per table
  int series;            // Si/Ci power-series terms
  int g_asym;            // asymptotic g terms
};

template <typename T> __device__ __forceinline__ T tab(int i);
template <> __device__ __forceinline__ float tab<float>(int i) { return c_tab_f[i]; }
template <> __device__ __forceinline__ double tab<double>(int i) { return c_tab_d[i]; }

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ T cheb_on(int off, int n, T lo, T hi, T t) {
  const T x = (T(2) * t - (hi + lo)) / (hi - lo);
  T b1 = T(0), b2 = T(0);
  for (int k = n - 1; k >= 1; --k) {
    const T nb = T(2) * x * b1 - b2 + tab<T>(off + k);
    b2 = b1;
    b1 = nb;
  }
  return x * b1 - b2 + tab<T>(off);
}

template <typename T>
__device__ void sici_series(T x, int n, T& si, T& ci) {
  const T t = x * x;
  si = T(0);
  ci = T(0);
  for (int k = n - 1; k >= 0; --k) {
    si = si * t + tab<T>(OFF_SI + k);
    if (k >= 1) ci = ci * t + tab<T>(OFF_CI + k);
  }
  si = si * x;
  ci = ci * t + T(EULER_GAMMA) + log_(x);
}

// g(x): Si = pi/2 - f cos - g sin, Ci = f sin - g cos.
template <typename T>
__device__ T aux_g(T x, const Lens& L) {
  if (x <= T(4)) {
    T si, ci, s, c;
    sici_series(x, L.series, si, ci);
    sincos_(x, &s, &c);
    return (T(HALF_PI) - si) * s - ci * c;
  }
  const T u = T(1) / x;
  if (x <= T(16)) return cheb_on<T>(OFF_AG, L.ag, T(0.0625), T(0.25), u) * u * u;
  if (x <= T(64)) return cheb_on<T>(OFF_BG, L.bg, T(0.015625), T(0.0625), u) * u * u;
  const T w = T(1) / (x * x);
  T g = T(0);
  for (int k = L.g_asym - 1; k >= 0; --k) g = g * w + tab<T>(OFF_GA + k);
  return g * w;
}

// f(x) - 1/x, cancellation-free at large x.
template <typename T>
__device__ T aux_fm(T x, const Lens& L) {
  if (x <= T(4)) {
    T si, ci, s, c;
    sici_series(x, L.series, si, ci);
    sincos_(x, &s, &c);
    return ((T(HALF_PI) - si) * c + ci * s) - T(1) / x;
  }
  const T u = T(1) / x;
  if (x <= T(16)) return cheb_on<T>(OFF_AFM, L.afm, T(0.0625), T(0.25), u) * u;
  if (x <= T(64)) return cheb_on<T>(OFF_BFM, L.bfm, T(0.015625), T(0.0625), u) * u;
  const T w = T(1) / (x * x);
  T fm = T(0);
  for (int k = 6; k >= 1; --k) fm = fm * w + tab<T>(OFF_FMA + k);
  return fm * w / x;
}

// mu(c) y(k, M) at x = k r_s.
template <typename T>
__device__ __forceinline__ T profile_n(T x, T c, const Lens& L) {
  const T b = (T(1) + c) * x;
  const T cx = c * x;
  T s, co;
  sincos_(cx, &s, &co);
  return aux_g(x, L) + s * aux_fm(b, L) - co * aux_g(b, L);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
halo_contract_kernel(const T* __restrict__ k, int nk,
                     const T* __restrict__ mat, int nm,
                     const T* __restrict__ gal, int ng,
                     T* __restrict__ out, Lens L) {
  __shared__ T s_mat[TILE * MAT_F];
  __shared__ T s_gal[TILE * GAL_F];
  const int b = blockIdx.y;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < nk;
  const T kk = live ? k[i] : T(1);
  double h_m = 0.0, h_g = 0.0, pp_mm = 0.0, pp_gg = 0.0, pp_gm = 0.0;

  const T* mb = mat + (size_t)b * nm * MAT_F;
  for (int base = 0; base < nm; base += TILE) {
    const int cnt = min(TILE, nm - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt * MAT_F; j += BLOCK)
      s_mat[j] = mb[(size_t)base * MAT_F + j];
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const T* p = s_mat + j * MAT_F;
        const double n = (double)profile_n<T>(kk * p[0], p[1], L);
        h_m += n * (double)p[2];
        pp_mm += n * n * (double)p[3];
      }
    }
  }

  const T* gb = gal + (size_t)b * ng * GAL_F;
  for (int base = 0; base < ng; base += TILE) {
    const int cnt = min(TILE, ng - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt * GAL_F; j += BLOCK)
      s_gal[j] = gb[(size_t)base * GAL_F + j];
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const T* p = s_gal + j * GAL_F;
        const double n_m = (double)profile_n<T>(kk * p[0], p[1], L);
        const double n_g = (double)profile_n<T>(kk * p[2], p[3], L);
        h_g += n_g * (double)p[4];
        pp_gg += n_g * (double)p[5] + n_g * n_g * (double)p[6];
        pp_gm += n_m * (double)p[7] + n_m * n_g * (double)p[8];
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

template <typename T, typename Sym>
int launch(const Sym& table_symbol, const void* tables, const void* k, int nk,
           const void* mat, int nm, const void* gal, int ng, void* out,
           int batch, Lens L, cudaStream_t s) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      table_symbol, tables, N_PACK * sizeof(T), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nk + BLOCK - 1) / BLOCK, batch);
  halo_contract_kernel<T><<<grid, BLOCK, 0, s>>>(
      (const T*)k, nk, (const T*)mat, nm, (const T*)gal, ng, (T*)out, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int halo_contract_launch(int device, int is_double, const void* k,
                                    int nk, const void* mat, int nm,
                                    const void* gal, int ng, void* out,
                                    int batch, const void* tables, int afm,
                                    int ag, int bfm, int bg, int series,
                                    int g_asym, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Lens L{afm, ag, bfm, bg, series, g_asym};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double>(c_tab_d, tables, k, nk, mat, nm, gal, ng, out, batch,
                          L, s);
  return launch<float>(c_tab_f, tables, k, nk, mat, nm, gal, ng, out, batch, L,
                       s);
}

extern "C" const char* halo_contract_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

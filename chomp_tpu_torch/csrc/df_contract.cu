// df_contract: out[r, t] = sum_n c[r, n] A[t, n] with two-float accumulation.
//
// Replaces the JAX package's ops/df32.py::df_contract (df32.py:94-116), the last op
// of the w(theta) / gamma_t pipeline: the lattice convolution output c
// (strictly positive) against the static float64 lattice -> Hankel -> theta
// bins operator A, whose rows oscillate through sign so that the summands
// are ~100x the result.  A float32 sum would lose ~eps x that amplification;
// the two-float ("double-single") sum keeps ~2^-48.  The float64 operator
// is split once by the caller into float32 hi + lo.
//
// What bounds it on the card: a (B, 2220) x (2220, 64) contraction is
// ~1e8 two-float flops at B = 512 (each product is an FMA two_prod, each
// addition a 6-flop two_sum); the operator (0.6 MB in hi + lo) and c stay
// in L2, so this is a small latency-bound op, not a bandwidth one.
//
// Simple design: one warp per output (r, t).  Each lane walks n with stride
// 32, forms p = fl(c a_hi) and its exact error fmaf(c, a_hi, -p), adds the
// c a_lo representation term, and accumulates (p, e) into a two-float
// running sum; then a warp-shuffle tree of two-float additions.  Products
// use __fmul_rn and sums __fadd_rn / __fsub_rn: those intrinsics are never
// contracted into an FMA, so nvcc's default --fmad=true cannot break the
// error-free transforms (no Dekker split is needed at all).  No fast math.
// The double instantiation is a plain float64 sum (df32.py:102-104).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// Knuth two_sum: s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (h1, l1) += (h2, l2), as df32._df_add.
__device__ __forceinline__ void df_add(float& h1, float& l1, float h2, float l2) {
  float s, e;
  two_sum(h1, h2, s, e);
  h1 = s;
  l1 = __fadd_rn(e, __fadd_rn(l1, l2));
}

__global__ void __launch_bounds__(WARPS * 32)
df_contract_f32(const float* __restrict__ c, const float* __restrict__ a_hi,
                const float* __restrict__ a_lo, float* __restrict__ out,
                int rows, int n, int t) {
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= rows * t) return;  // uniform across the warp
  const int r = warp / t, o = warp % t;
  const float* cr = c + (size_t)r * n;
  const float* ah = a_hi + (size_t)o * n;
  const float* al = a_lo + (size_t)o * n;
  float sh = 0.0f, sl = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float cv = cr[j];
    const float av = ah[j];
    const float p = __fmul_rn(cv, av);
    float e = fmaf(cv, av, -p);  // exact: p + e == cv * av
    e = fmaf(cv, al[j], e);      // operator representation term
    df_add(sh, sl, p, e);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oh = __shfl_down_sync(FULL, sh, off);
    const float ol = __shfl_down_sync(FULL, sl, off);
    df_add(sh, sl, oh, ol);
  }
  if (lane == 0) out[(size_t)r * t + o] = __fadd_rn(sh, sl);
}

__global__ void __launch_bounds__(WARPS * 32)
df_contract_f64(const double* __restrict__ c, const double* __restrict__ a,
                double* __restrict__ out, int rows, int n, int t) {
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= rows * t) return;
  const int r = warp / t, o = warp % t;
  const double* cr = c + (size_t)r * n;
  const double* ar = a + (size_t)o * n;
  double s = 0.0;
  for (int j = lane; j < n; j += 32) s += cr[j] * ar[j];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (lane == 0) out[(size_t)r * t + o] = s;
}

}  // namespace

extern "C" int df_contract_launch(int device, int is_double, const void* c,
                                  const void* a_hi, const void* a_lo,
                                  void* out, int rows, int n, int t,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long warps = (long long)rows * t;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  if (is_double)
    df_contract_f64<<<blocks, WARPS * 32, 0, s>>>(
        (const double*)c, (const double*)a_hi, (double*)out, rows, n, t);
  else
    df_contract_f32<<<blocks, WARPS * 32, 0, s>>>(
        (const float*)c, (const float*)a_hi, (const float*)a_lo, (float*)out,
        rows, n, t);
  return (int)cudaGetLastError();
}

extern "C" const char* df_contract_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

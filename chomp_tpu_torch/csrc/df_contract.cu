// df_contract: out (R, T) = c (R, n) @ (a_hi + a_lo)^T, A laid out (T, n).
//
// Replaces the JAX package's ops/df32.py::df_contract (df32.py:94-116), the
// last op of the w(theta) / gamma_t lattice pipeline: the lattice
// convolution output c (strictly positive) against the static float64
// lattice -> Hankel -> theta bins operator A, whose rows oscillate through
// sign so that the summands are ~100x the result.  The caller splits A once
// into float32 hi + lo (df32.split_operator).
//
// Numerics: the TPU has no float64, so the JAX package carries every term
// as a two-float pair (~2^-48, ~11 FP32 instructions a term).  The H100 has
// FP64 tensor cores at the rate of its FP32 CUDA cores, so here a term is
// one f64 fused multiply-add in a DMMA tile (dmma_tile.cuh, BOp::NK_SPLIT):
// the fragment value (double)a_hi + (double)a_lo is exact, each product is
// rounded to 2^-53, the sum is a float64 sum and the result is rounded once
// to float32.  Fixed order (fragments, then ranks 0..S-1): deterministic.
// float64 c takes the float64 operator and no lo part (BOp::NK).
//
// What bounds it on the card: the function is c @ A^T exact to float32
// output, 2 flops a term: at the main path's shape (R = 512, n = 2220,
// T = 64, twice per lattice-route forward) 2 R n T = 145.5 MFLOP, 2.17 us at
// 67 TFLOP/s, against 4 (R n + 2 T n + R T) = 5.81 MB, 1.74 us at
// 3.35 TB/s: bound by operations at 2.17 us, with a launch of a few us on
// top.  32 x 64 output tiles (16 of them) split along n over clusters of
// S = 8 CTAs (~280 deep each) give 128 CTAs for 132 SMs, each staging its
// slice of c and of both operator parts once in shared memory (the old
// one-warp-per-output design read its rows from cache once per output);
// the geometry comes from ops/tiles.py::split_k.
//
// The backward (df_contract_bwd_launch) is grad_c (R, n) = G (R, T) @
// (a_hi + a_lo) at depth T = 64: the same tile with A read as (T, n) rows
// and hi + lo summed exactly in the fragment (dmma::BOp::KN_SPLIT; plain
// KN in float64).  At R = 512 its 16 x 35 tiles fill the card, so
// split_k leaves it unsplit.  The JAX package has no backward kernel: XLA
// differentiates its two-float arithmetic.

#include "dmma_tile.cuh"

namespace {

__global__ void __launch_bounds__(dmma::THREADS)
df_contract_f32(const float* c, const float* a_hi, const float* a_lo,
                float* out, int rows, int n, int t, int kc, int vec_c,
                int vec_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dmma::splitk_tile<float, dmma::BOp::NK_SPLIT>(
      smem, c, a_hi, a_lo, out, rows, n, t, kc, vec_c != 0, vec_a != 0);
}

__global__ void __launch_bounds__(dmma::THREADS)
df_contract_f64(const double* c, const double* a, double* out, int rows,
                int n, int t, int kc, int vec_c, int vec_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dmma::splitk_tile<double, dmma::BOp::NK>(smem, c, a, nullptr, out, rows, n,
                                           t, kc, vec_c != 0, vec_a != 0);
}

// The backward: grad_c (R, n) = G (R, T) @ (a_hi + a_lo), A read as (T, n)
// rows, T the contraction (dmma::BOp::KN_SPLIT; float64: BOp::KN).
__global__ void __launch_bounds__(dmma::THREADS)
df_contract_bwd_f32(const float* g, const float* a_hi, const float* a_lo,
                    float* out, int rows, int n, int t, int kc, int vec_g,
                    int vec_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dmma::splitk_tile<float, dmma::BOp::KN_SPLIT>(
      smem, g, a_hi, a_lo, out, rows, n, t, kc, vec_g != 0, vec_a != 0);
}

__global__ void __launch_bounds__(dmma::THREADS)
df_contract_bwd_f64(const double* g, const double* a, double* out, int rows,
                    int n, int t, int kc, int vec_g, int vec_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dmma::splitk_tile<double, dmma::BOp::KN>(smem, g, a, nullptr, out, rows, n,
                                           t, kc, vec_g != 0, vec_a != 0);
}

}  // namespace

extern "C" int df_contract_launch(int device, int is_double, const void* c,
                                  const void* a_hi, const void* a_lo,
                                  void* out, int rows, int n, int t,
                                  int cluster, int tiles_n, int tiles_m,
                                  int kc, int vec_c, int vec_a,
                                  void* stream) {
  const cudaError_t err = dmma::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  static unsigned smem_set[2] = {0, 0};
  if (is_double)
    return (int)dmma::launch(
        df_contract_f64, dmma::Geo<double, dmma::BOp::NK>::SMEM_BYTES,
        &smem_set[1], device, cluster, tiles_n, tiles_m, s, (const double*)c,
        (const double*)a_hi, (double*)out, rows, n, t, kc, vec_c, vec_a);
  return (int)dmma::launch(
      df_contract_f32, dmma::Geo<float, dmma::BOp::NK_SPLIT>::SMEM_BYTES,
      &smem_set[0], device, cluster, tiles_n, tiles_m, s, (const float*)c,
      (const float*)a_hi, (const float*)a_lo, (float*)out, rows, n, t, kc,
      vec_c, vec_a);
}

// grad_c (rows, t) = grad (rows, n) @ (a_hi + a_lo), A (n, t): the
// backward (n = T is the contraction, t = the operator's width).
extern "C" int df_contract_bwd_launch(int device, int is_double,
                                      const void* grad, const void* a_hi,
                                      const void* a_lo, void* out, int rows,
                                      int n, int t, int cluster, int tiles_n,
                                      int tiles_m, int kc, int vec_g,
                                      int vec_a, void* stream) {
  const cudaError_t err = dmma::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  static unsigned smem_set[2] = {0, 0};
  if (is_double)
    return (int)dmma::launch(
        df_contract_bwd_f64, dmma::Geo<double, dmma::BOp::KN>::SMEM_BYTES,
        &smem_set[1], device, cluster, tiles_n, tiles_m, s,
        (const double*)grad, (const double*)a_hi, (double*)out, rows, n, t,
        kc, vec_g, vec_a);
  return (int)dmma::launch(
      df_contract_bwd_f32, dmma::Geo<float, dmma::BOp::KN_SPLIT>::SMEM_BYTES,
      &smem_set[0], device, cluster, tiles_n, tiles_m, s, (const float*)grad,
      (const float*)a_hi, (const float*)a_lo, (float*)out, rows, n, t, kc,
      vec_g, vec_a);
}

extern "C" int df_contract_bwd_smem_bytes(int is_double) {
  return is_double ? dmma::Geo<double, dmma::BOp::KN>::SMEM_BYTES
                   : dmma::Geo<float, dmma::BOp::KN_SPLIT>::SMEM_BYTES;
}

extern "C" int df_contract_smem_bytes(int is_double) {
  return is_double ? dmma::Geo<double, dmma::BOp::NK>::SMEM_BYTES
                   : dmma::Geo<float, dmma::BOp::NK_SPLIT>::SMEM_BYTES;
}

extern "C" const char* df_contract_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

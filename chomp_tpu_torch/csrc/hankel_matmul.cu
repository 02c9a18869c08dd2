// hankel_matmul: out (R, T) = cl (R, N) @ op_t (N, T), float32 or float64.
//
// Replaces the JAX package's ops/fftlog_pallas.py::hankel_matmul_pallas
// (fftlog_pallas.py:47, pallas_call l.68, body _matmul_kernel l.30-39): the
// FFTLog Hankel transform and the theta binning composed offline into one
// dense operator, applied to a batch of C_ell rows on the method="table"
// route (correlation.wtheta_from_cl_fused, engine="pallas").  The public
// layout is the JAX one: C_ell rows times the TRANSPOSED operator
// (n_ell, n_theta), so the operator is B in (K, T) rows (dmma::BOp::KN).
//
// Numerics: the operator's rows oscillate in sign and cancel (~20-1000x),
// so TF32 (10-bit mantissa, ~1e-3 here) and a 3xTF32 split are out.  The
// products run on the FP64 tensor cores (dmma_tile.cuh): a product of two
// float32 values is exact in double and the sum is a float64 sum, so the
// float32 output is the exactly rounded result up to ~1e-16 of the summed
// magnitudes, where FP32 FMAs or cuBLAS's float32 product give ~1e-6.  The
// sum runs in a fixed order (fragments, then ranks 0..S-1): deterministic.
// The double instantiation is the reference mode.
//
// What bounds it on the card: at the main path's shape (R = 512
// cosmologies, N = n_ell = 1024, T = n_theta = 64, twice per table-route
// forward) it does 2 R N T = 67 MFLOP, 1.00 us at the H100's 67 TFLOP/s
// (FP64 tensor cores and FP32 CUDA cores alike), and moves
// 4 (R N + N T + R T) = 2.5 MB, 0.74 us at 3.35 TB/s.  A launch costs a few
// us, so ~5-10 us is the realistic floor.  The design fills the card
// instead of a few SMs: 32 x 64 output tiles (16 of them) split along N over
// clusters of S = 8 CTAs (128 deep each) give 128 CTAs for 132 SMs; the
// geometry comes from ops/tiles.py::split_k.
//
// The backward (hankel_matmul_bwd_launch) is grad_cl (R, N) = G (R, T) @
// op_t^T at depth K = T = 64: the same tile with op_t read as (N, K) rows
// (dmma::BOp::NK), products exact in double as in the forward.  At R =
// 512 its 16 x 16 tiles already fill the card, so split_k leaves it
// unsplit (clusters of 1).  No TPU counterpart: the JAX package
// differentiates through XLA.

#include "dmma_tile.cuh"

namespace {

// out = a @ b with b in the layout OP: the forward is cl (R, N) @ op_t
// (N, T), op_t in (K, T) rows (BOp::KN); the backward is grad_cl (R, N) =
// G (R, T) @ op_t^T, op_t read as (N, K) rows (BOp::NK), K = T.
template <typename T, dmma::BOp OP>
__global__ void __launch_bounds__(dmma::THREADS)
hankel_matmul_kernel(const T* a, const T* b, T* out, int rows, int n, int t,
                     int kc, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  dmma::splitk_tile<T, OP>(smem, a, b, nullptr, out, rows, n, t, kc,
                           vec_a != 0, vec_b != 0);
}

template <typename T, dmma::BOp OP>
int launch(int device, const void* a, const void* b, void* out, int rows,
           int n, int t, int cluster, int tiles_n, int tiles_m, int kc,
           int vec_a, int vec_b, cudaStream_t s) {
  static unsigned smem_set = 0;
  return (int)dmma::launch(
      hankel_matmul_kernel<T, OP>, dmma::Geo<T, OP>::SMEM_BYTES, &smem_set,
      device, cluster, tiles_n, tiles_m, s, (const T*)a, (const T*)b,
      (T*)out, rows, n, t, kc, vec_a, vec_b);
}

}  // namespace

extern "C" int hankel_matmul_launch(int device, int is_double, const void* cl,
                                    const void* op_t, void* out, int rows,
                                    int n, int t, int cluster, int tiles_n,
                                    int tiles_m, int kc, int vec_cl,
                                    int vec_op, void* stream) {
  const cudaError_t err = dmma::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double, dmma::BOp::KN>(device, cl, op_t, out, rows, n, t,
                                         cluster, tiles_n, tiles_m, kc,
                                         vec_cl, vec_op, s);
  return launch<float, dmma::BOp::KN>(device, cl, op_t, out, rows, n, t,
                                      cluster, tiles_n, tiles_m, kc, vec_cl,
                                      vec_op, s);
}

// grad_cl (rows, t) = grad (rows, n) @ op_t^T, op_t (t, n): the backward
// (n = n_theta is the contraction, t = n_ell the output columns).
extern "C" int hankel_matmul_bwd_launch(int device, int is_double,
                                        const void* grad, const void* op_t,
                                        void* out, int rows, int n, int t,
                                        int cluster, int tiles_n, int tiles_m,
                                        int kc, int vec_g, int vec_op,
                                        void* stream) {
  const cudaError_t err = dmma::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return launch<double, dmma::BOp::NK>(device, grad, op_t, out, rows, n, t,
                                         cluster, tiles_n, tiles_m, kc,
                                         vec_g, vec_op, s);
  return launch<float, dmma::BOp::NK>(device, grad, op_t, out, rows, n, t,
                                      cluster, tiles_n, tiles_m, kc, vec_g,
                                      vec_op, s);
}

extern "C" int hankel_matmul_smem_bytes(int is_double) {
  return is_double ? dmma::Geo<double, dmma::BOp::KN>::SMEM_BYTES
                   : dmma::Geo<float, dmma::BOp::KN>::SMEM_BYTES;
}

extern "C" int hankel_matmul_bwd_smem_bytes(int is_double) {
  return is_double ? dmma::Geo<double, dmma::BOp::NK>::SMEM_BYTES
                   : dmma::Geo<float, dmma::BOp::NK>::SMEM_BYTES;
}

extern "C" const char* hankel_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

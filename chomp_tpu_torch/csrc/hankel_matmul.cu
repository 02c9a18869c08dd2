// hankel_matmul: out (R, T) = cl (R, N) @ op_t (N, T), float32 or float64.
//
// Replaces the JAX package's ops/fftlog_pallas.py::hankel_matmul_pallas
// (fftlog_pallas.py:47, Pallas body _matmul_kernel l.30-39): the FFTLog
// Hankel transform and the theta binning composed offline into one dense
// operator, applied to a batch of C_ell rows on the method="table" route
// (correlation.wtheta_from_cl_fused, engine="pallas").  The public layout is
// the JAX one: C_ell rows times the TRANSPOSED operator (n_ell, n_theta).
//
// Numerics: the operator's rows oscillate in sign and cancel (~20-100x), so
// the products run as FP32 FMAs on the CUDA cores, never on the TF32 tensor
// cores (10-bit mantissa, ~1e-3 here) nor bf16 (~1e-2).  Each output is
// summed in a fixed order (blocked: a fresh partial sum per 32-deep tile of
// N, added to the running total after the tile), so the result is
// deterministic and its rounding grows like sqrt(32) + sqrt(N / 32) rather
// than sqrt(N).  The double instantiation is the reference mode.
//
// What bounds it on the card: at the main path's shape (R = 512 cosmologies,
// N = n_ell = 1024, T = n_theta = 64) it does 2 R N T = 67 MFLOP (1.0 us at
// the H100's 67 TFLOP/s FP32) and moves 4 (R N + N T + R T) = 2.5 MB (0.74 us
// at 3.35 TB/s): a sub-microsecond bound, so the launch dominates.
//
// Simple design: one block of 16 x 16 threads per 64 x 64 output tile; the
// block walks N in tiles of 32, staging the cl tile (transposed) and the
// operator tile in shared memory; each thread keeps a 4 x 4 register
// micro-tile at rows ty + 16 i and columns tx + 16 j (conflict-free shared
// reads).  Ragged edges of R, T and N are masked (zero-filled tiles).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // depth of one shared-memory tile
constexpr int TD = 16;   // threads per block side
constexpr int TM = BM / TD;
constexpr int TN = BN / TD;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(TD * TD)
hankel_matmul_kernel(const T* __restrict__ cl, const T* __restrict__ op_t,
                     T* __restrict__ out, int rows, int n, int t) {
  __shared__ T s_cl[BK][BM + 1];  // transposed: s_cl[k][row]
  __shared__ T s_op[BK][BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TD + tx;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < n; k0 += BK) {
    // cl tile: 64 rows x 32 depth, read along the row (coalesced).
    for (int idx = tid; idx < BM * BK; idx += TD * TD) {
      const int r = idx / BK, k = idx % BK;
      const int gr = r0 + r, gk = k0 + k;
      s_cl[k][r] = (gr < rows && gk < n) ? cl[(size_t)gr * n + gk] : T(0);
    }
    // Operator tile: 32 depth x 64 columns (coalesced).
    for (int idx = tid; idx < BK * BN; idx += TD * TD) {
      const int k = idx / BN, c = idx % BN;
      const int gk = k0 + k, gc = c0 + c;
      s_op[k][c] = (gk < n && gc < t) ? op_t[(size_t)gk * t + gc] : T(0);
    }
    __syncthreads();

    T part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = T(0);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s_cl[k][ty + TD * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s_op[k][tx + TD * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fma_(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty + TD * i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = c0 + tx + TD * j;
      if (gc < t) out[(size_t)gr * t + gc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* cl, const void* op_t, void* out, int rows, int n, int t,
           cudaStream_t s) {
  const dim3 block(TD, TD);
  const dim3 grid((t + BN - 1) / BN, (rows + BM - 1) / BM);
  hankel_matmul_kernel<T><<<grid, block, 0, s>>>(
      (const T*)cl, (const T*)op_t, (T*)out, rows, n, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hankel_matmul_launch(int device, int is_double, const void* cl,
                                    const void* op_t, void* out, int rows,
                                    int n, int t, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) return launch<double>(cl, op_t, out, rows, n, t, s);
  return launch<float>(cl, op_t, out, rows, n, t, s);
}

extern "C" const char* hankel_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

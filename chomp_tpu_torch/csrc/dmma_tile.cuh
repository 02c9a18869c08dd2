// dmma_tile.cuh: the split-K f64 tensor-core tile shared by kernels B
// (hankel_matmul.cu) and C (df_contract.cu).
//
//   out (R, T) = A (R, K) @ B, B given as (K, T) rows (BOp::KN: kernel B,
//   and C's backward in float64), as (T, K) rows (BOp::NK: kernel C in
//   float64, B's backward), or as two float32 arrays hi + lo whose sum is
//   the operand, in (T, K) rows (BOp::NK_SPLIT: kernel C) or in (K, T)
//   rows (BOp::KN_SPLIT: C's backward).
//
// Grid (S, ceil(T / BN), ceil(R / BM)) launched as thread-block clusters of
// (S, 1, 1): the S CTAs of a cluster share one BM x BN output tile and split
// K between them, rank r taking [r kc, min((r + 1) kc, K)).  The caller
// (ops/tiles.py::split_k) chooses S, kc and the grid; this code obeys them.
//
// Per CTA (8 warps, each a 16 x 16 sub-tile = two m16n8k8 fragments):
// * Staging: BK-deep slices of both operands (128 bytes of each row) go to
//   shared memory by cp.async into a ring of STAGES = 2 slices (double
//   buffering: the next slice is in flight during the current slice's
//   MMAs; deeper rings measured no faster on the H100).  16-byte copies
//   where rows and pointers are 16-byte aligned (the caller says so:
//   vec_a / vec_b), else one copy per element; rows, columns and depth
//   beyond the edges are zero-filled by the copy's source size.  Row
//   strides are padded so that the fragment reads hit distinct banks.
//   TMA is not used: the tiles are tens of KB with ragged edges.  The
//   copies, not the MMAs, set the pace of the K loop (PERF.md).
// * MMA: mma.sync.aligned.m16n8k8.row.col.f64 (CUTLASS's
//   SM90_16x8x8_F64F64F64F64_TN: A (g, t), (g+8, t), (g, t+4), (g+8, t+4);
//   B (t, g), (t+4, g); C (g, 2t..2t+1), (g+8, 2t..2t+1), with g = lane / 4
//   and t = lane % 4).  Shared memory holds float32 data; a warp converts
//   each value to double as it builds its fragment, exactly (and hi + lo is
//   exact in double: the two parts span fewer than 53 bits).  A product of
//   two float32 values is exact in double; every sum is a float64 sum.
//   wgmma has no f64 form, and the m8n8k4 shape runs at half the rate of
//   the m16n8k* shapes on the H100.
// * Cluster reduction: rank q of S adds up rows [first_row(q),
//   first_row(q + 1)) of the tile.  Each CTA stores each row of its f64
//   partial tile into slot `rank` of the reduction buffer of the rank that
//   owns the row (distributed shared memory, cluster.map_shared_rank; the
//   buffer lies beyond the ring, so a fast rank need not wait for a slow
//   one); one cluster.sync(); each rank then adds the S partials of its
//   rows in rank order 0..S-1 from its own shared memory, rounds once to
//   the output type and stores.  A relaxed cluster arrive at the start,
//   waited on before the first remote store, makes sure every CTA of the
//   cluster has started.  No atomics, no workspace, no second launch: the
//   same bits on every run.
// The float64 instantiation is the same path without the conversion.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dmma {

namespace cg = cooperative_groups;

constexpr int BM = 32;  // output rows per tile (ops/tiles.py BM)
constexpr int BN = 64;  // output columns per tile (ops/tiles.py BN)
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int STAGES = 2;  // slices in the shared-memory ring
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 16: one m16 fragment
constexpr int WN = BN / WARPS_N;
constexpr int NF = WN / 8;   // n8 fragments per warp
constexpr int MAX_CLUSTER = 8;

// Rows of the tile that rank q of S reduces: [first_row(q), first_row(q+1)).
__host__ __device__ constexpr int first_row(int q, int S) {
  return (q * BM + S - 1) / S;
}
// The reduction buffer after the ring: S partial slices of at most
// ceil(BM / S) rows each, for any S <= MAX_CLUSTER.
__host__ __device__ constexpr int red_doubles() {
  int most = 0;
  for (int S = 1; S <= MAX_CLUSTER; ++S) {
    const int d = S * ((BM + S - 1) / S) * BN;
    most = d > most ? d : most;
  }
  return most;
}
constexpr int RED_BYTES = red_doubles() * (int)sizeof(double);

enum class BOp { KN, NK, NK_SPLIT, KN_SPLIT };

template <typename T, BOp OP>
struct Geo {
  static constexpr int BK = 128 / sizeof(T);  // depth of one stage
  // Row strides (elements) of rows along K and along T (KN), padded so
  // that the fragment reads of mma_stage hit distinct banks.
  static constexpr int LDK = BK + 8;
  static constexpr int LDN = BN + (sizeof(T) == 4 ? 4 : 2);
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr bool ROWS_K = OP == BOp::KN || OP == BOp::KN_SPLIT;
  static constexpr int PART = ROWS_K ? BK * LDN : BN * LDK;  // one operand
  static constexpr int B_ELEMS =
      OP == BOp::NK_SPLIT || OP == BOp::KN_SPLIT ? 2 * PART : PART;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int STAGE_BYTES = STAGES * STAGE * (int)sizeof(T);
  static constexpr int SMEM_BYTES = STAGE_BYTES + RED_BYTES;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; bytes < 16 copies that many and zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_elem(void* s, const void* g,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "n"(N), "r"(bytes)
               : "memory");
}

// The two halves of a cluster barrier (no memory ordering): arrive at the
// start, wait before the first access to another CTA's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16x8x8(double (&c)[4],
                                          const double (&a)[4],
                                          const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// Exact: every float32 value is a double.
__device__ __forceinline__ double to_f64(float x) { return (double)x; }
__device__ __forceinline__ double to_f64(double x) { return x; }

// Copies the R x C tile at (r0, c0) of a row-major array (row stride ld)
// into shared memory (row stride LDS); elements at rows >= r_lim or
// columns >= c_lim are zero.
template <typename T, int R, int C, int LDS>
__device__ __forceinline__ void stage_tile(T* s, const T* g, int ld, int r0,
                                           int c0, int r_lim, int c_lim,
                                           bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = C / V;
    for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * V;
      const int gr = r0 + r, gc = c0 + c;
      int left = gr < r_lim ? c_lim - gc : 0;
      left = left < 0 ? 0 : (left > V ? V : left);
      cp_async16(s + r * LDS + c, left ? g + (size_t)gr * ld + gc : g,
                 left * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_lim && gc < c_lim;
      cp_async_elem<sizeof(T)>(s + r * LDS + c,
                               ok ? g + (size_t)gr * ld + gc : g,
                               ok ? (int)sizeof(T) : 0);
    }
  }
}

// The MMAs of one staged slice: acc[j] is this warp's fragment at rows
// wm..wm+15 and columns wn+8j..wn+8j+7 of the tile.  Within each 8-deep
// step, the fragment's k slots t and t+4 take the adjacent columns 2t and
// 2t+1 of both operands (one paired load where K is the contiguous axis);
// the same permutation on both sides leaves the product unchanged.
template <typename T, BOp OP>
__device__ __forceinline__ void mma_stage(const T* sa, const T* sb,
                                          double (&acc)[NF][4], int wm,
                                          int wn, int g, int t) {
  using G = Geo<T, OP>;
  using T2 = typename Pair<T>::type;
#pragma unroll
  for (int kk = 0; kk < G::BK; kk += 8) {
    const T* pa = sa + (wm + g) * G::LDK + kk + 2 * t;
    const T2 a0 = *reinterpret_cast<const T2*>(pa);
    const T2 a1 = *reinterpret_cast<const T2*>(pa + 8 * G::LDK);
    const double a[4] = {to_f64(a0.x), to_f64(a1.x), to_f64(a0.y),
                         to_f64(a1.y)};
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int col = wn + 8 * j + g;
      double b[2];
      if constexpr (G::ROWS_K) {
        b[0] = to_f64(sb[(kk + 2 * t) * G::LDN + col]);
        b[1] = to_f64(sb[(kk + 2 * t + 1) * G::LDN + col]);
        if constexpr (OP == BOp::KN_SPLIT) {
          const T* lo = sb + G::PART;
          b[0] += to_f64(lo[(kk + 2 * t) * G::LDN + col]);
          b[1] += to_f64(lo[(kk + 2 * t + 1) * G::LDN + col]);
        }
      } else {
        const T* pb = sb + col * G::LDK + kk + 2 * t;
        const T2 h = *reinterpret_cast<const T2*>(pb);
        b[0] = to_f64(h.x);
        b[1] = to_f64(h.y);
        if constexpr (OP == BOp::NK_SPLIT) {
          const T2 l = *reinterpret_cast<const T2*>(pb + G::PART);
          b[0] += to_f64(l.x);
          b[1] += to_f64(l.y);
        }
      }
      mma16x8x8(acc[j], a, b);
    }
  }
}

// One CTA of the cluster: its K range of the tile (blockIdx.y, blockIdx.z),
// then its share of the rank-ordered reduction.  smem holds
// Geo<T, OP>::SMEM_BYTES, 16-byte aligned.
template <typename T, BOp OP>
__device__ __forceinline__ void splitk_tile(unsigned char* smem,
                                            const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            const T* __restrict__ b_lo,
                                            T* __restrict__ out, int rows,
                                            int n, int t, int kc, bool vec_a,
                                            bool vec_b) {
  using G = Geo<T, OP>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = (int)cluster.num_blocks();
  const int r0 = blockIdx.z * BM, c0 = blockIdx.y * BN;
  const int k0 = min(n, rank * kc), k1 = min(n, k0 + kc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  T* const ring = reinterpret_cast<T*>(smem);
  cluster_arrive();

  auto load = [&](int slice) {
    T* s = ring + (slice % STAGES) * G::STAGE;
    const int kb = k0 + slice * G::BK;
    stage_tile<T, BM, G::BK, G::LDK>(s, a, n, r0, kb, rows, k1, vec_a);
    T* sb = s + G::A_ELEMS;
    if constexpr (G::ROWS_K) {
      stage_tile<T, G::BK, BN, G::LDN>(sb, b, t, kb, c0, k1, t, vec_b);
      if constexpr (OP == BOp::KN_SPLIT)
        stage_tile<T, G::BK, BN, G::LDN>(sb + G::PART, b_lo, t, kb, c0, k1,
                                         t, vec_b);
    } else {
      stage_tile<T, BN, G::BK, G::LDK>(sb, b, n, c0, kb, t, k1, vec_b);
      if constexpr (OP == BOp::NK_SPLIT)
        stage_tile<T, BN, G::BK, G::LDK>(sb + G::PART, b_lo, n, c0, kb, t,
                                         k1, vec_b);
    }
  };

  double acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;

  // The ring: STAGES - 1 slices in flight ahead of the one being used.
  const int nst = (k1 - k0 + G::BK - 1) / G::BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();  // slice s has landed
    __syncthreads();        // ... for every thread; slice s - 1 is used up
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const T* cur = ring + (s % STAGES) * G::STAGE;
    mma_stage<T, OP>(cur, cur + G::A_ELEMS, acc, wm, wn, g, tq);
  }
  cp_wait<0>();

  // Push each partial row to the rank that reduces it, into slot `rank` of
  // that rank's reduction buffer (outside its ring, so the pushes need not
  // wait for slower ranks), then one cluster barrier.
  double* const red = reinterpret_cast<double*>(smem + G::STAGE_BYTES);
  const int slot_rows = (BM + S - 1) / S;
  cluster_wait();  // every CTA of the cluster has started
#pragma unroll
  for (int j = 0; j < NF; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + g + 8 * h, col = wn + 8 * j + 2 * tq;
      const int q = row * S / BM;
      double* dst = cluster.map_shared_rank(red, q) +
                    (rank * slot_rows + row - first_row(q, S)) * BN + col;
      *reinterpret_cast<double2*>(dst) =
          make_double2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  cluster.sync();
  const int f0 = first_row(rank, S), f1 = first_row(rank + 1, S);
  for (int e = threadIdx.x; e < (f1 - f0) * BN; e += THREADS) {
    const int lr = e / BN, c = e % BN;
    double sum = red[lr * BN + c];
    for (int q = 1; q < S; ++q) sum += red[(q * slot_rows + lr) * BN + c];
    const int gr = r0 + f0 + lr, gc = c0 + c;
    if (gr < rows && gc < t) out[(size_t)gr * t + gc] = static_cast<T>(sum);
  }
}

// Makes device current (a no-op when it already is).
inline cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// Launches kernel on grid (cluster, tiles_n, tiles_m) in clusters of
// (cluster, 1, 1) with smem_bytes of dynamic shared memory; returns the
// launch's error code.  *smem_set (one bit per device below 32) records
// where the kernel was already allowed that much shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem_bytes, unsigned* smem_set,
                   int device, int cluster, int tiles_n, int tiles_m,
                   cudaStream_t stream, Args... args) {
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (!(*smem_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    *smem_set |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles_n, tiles_m);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace dmma

// block_spmm: out = semiring(F[S,K] @ A[K,N]) * col_mask[N], fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/block_spmm.py::block_spmm (body
// _spmm_kernel): one frontier hop of the MV4PG executor over a dense
// label-masked adjacency.  "count" gives walk counts, exact while every
// partial sum stays below 2^24; "bool" clamps the sum to min(acc, 1).
//
// Types.  F is read as int32, uint8 (a bool frontier) or fp32, A as int32 or
// fp32, each in its own type and cast to fp32 in registers: the casts the
// TPU wrapper ran as separate passes are fused into the tile loads.  The
// output is fp32, int32 or uint8.  An integer output is the fp32 sum
// converted exactly: every value below 2^24 is an integer in fp32, so count
// mode writes int32 walk counts directly.  Accumulation is IEEE fp32 FMA on
// the CUDA cores; TF32 (10-bit mantissa) would break exact counts.
//
// Bound at the workload shape (FinBench, S = src_block = 256,
// K = N = node_cap = 27,264): 2*S*K*N = 3.8e11 FLOP against 2.97 GB of int32
// A read once.  At 67 TFLOP/s fp32 and 3.35 TB/s that is 5.7 ms of
// arithmetic and 0.89 ms of memory traffic: the kernel is bound by the fp32
// CUDA-core rate, not by memory.
//
// Design (simple first).  Each 256-thread block owns a 128 x 128 output
// tile and walks K in 8-deep slabs staged through two shared-memory
// buffers, so one barrier per slab suffices: after multiplying the current
// buffer a thread loads the next slab and stores it into the other buffer.
// Each thread keeps an 8 x 8 register micro-tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise from tx), which it reads from
// shared memory as four 16-byte vectors per k: every operand feeds 8 FMAs,
// and the split halves keep a quarter-warp's vector reads on distinct
// banks.  Occupancy decides the speed here: __launch_bounds__(256, 2) caps
// registers at 128 so two blocks share an SM, and each hides the other's
// global loads and barriers (one block per SM ran about as slowly as an
// unbuffered tile).  Holding the next slab in registers across the FMAs
// would add 8 more registers and more spills under that cap, so the loads
// come after the FMAs.  The TPU's sequential k grid becomes the slab loop
// inside the block.  Ragged edges are masked in the loads (zero fill) and
// in the store, so no operand is padded or copied.  The semiring clamp and
// the column mask are applied once, after the last slab.  wgmma, TMA and
// the exact int8 tensor-core route for bool mode are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows (sources) per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 8;        // K slab depth
constexpr int TM = 8;        // rows per thread
constexpr int TN = 8;        // columns per thread
constexpr int THREADS = 256;
constexpr int F_LOADS = BM * BK / THREADS;   // 4
constexpr int A_LOADS = BK * BN / THREADS;   // 4
// F slab is stored transposed ([k][m]); the +4 pad spreads the transposing
// store over all 32 banks and keeps rows 16-byte aligned.
constexpr int FS_LD = BM + 4;

enum DType { DT_INT32 = 0, DT_UINT8 = 1, DT_FLOAT32 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ int32_t from_f32<int32_t>(float v) {
  return static_cast<int32_t>(v);
}
template <> __device__ __forceinline__ uint8_t from_f32<uint8_t>(float v) {
  return static_cast<uint8_t>(v);
}

// Row (or column) of micro-tile index i in 0..7 for lane t in 0..15.
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4 ? 0 : 64 - 4) + t * 4 + i;
}

// Global -> registers for the slab starting at k0 (zero outside bounds).
template <typename TF, typename TA>
__device__ __forceinline__ void load_slab(
    const TF* __restrict__ F, const TA* __restrict__ A, int S, int K, int N,
    int row0, int col0, int k0, int tid, float (&f_reg)[F_LOADS],
    float (&a_reg)[A_LOADS]) {
#pragma unroll
  for (int r = 0; r < F_LOADS; ++r) {
    const int e = tid + r * THREADS;
    const int gm = row0 + e / BK, gk = k0 + e % BK;
    f_reg[r] = (gm < S && gk < K)
                   ? to_f32(F[static_cast<long long>(gm) * K + gk]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < A_LOADS; ++r) {
    const int e = tid + r * THREADS;
    const int gk = k0 + e / BN, gn = col0 + e % BN;
    a_reg[r] = (gk < K && gn < N)
                   ? to_f32(A[static_cast<long long>(gk) * N + gn]) : 0.f;
  }
}

// Registers -> one shared-memory buffer (F transposed: Fs[k][m]).
__device__ __forceinline__ void store_slab(
    float (*Fs)[FS_LD], float (*As)[BN], int tid,
    const float (&f_reg)[F_LOADS], const float (&a_reg)[A_LOADS]) {
#pragma unroll
  for (int r = 0; r < F_LOADS; ++r) {
    const int e = tid + r * THREADS;
    Fs[e % BK][e / BK] = f_reg[r];
  }
#pragma unroll
  for (int r = 0; r < A_LOADS; ++r) {
    const int e = tid + r * THREADS;
    As[e / BN][e % BN] = a_reg[r];
  }
}

template <typename TF, typename TA, typename TO>
__global__ void __launch_bounds__(THREADS, 2)
spmm_kernel(const TF* __restrict__ F, const TA* __restrict__ A,
            const float* __restrict__ col_mask, TO* __restrict__ out,
            int S, int K, int N, int bool_mode) {
  __shared__ __align__(16) float Fs[2][BK][FS_LD];
  __shared__ __align__(16) float As[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;             // column lane
  const int ty = tid / 16;             // row lane
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float f_reg[F_LOADS];
  float a_reg[A_LOADS];
  load_slab(F, A, S, K, N, row0, col0, 0, tid, f_reg, a_reg);
  store_slab(Fs[0], As[0], tid, f_reg, a_reg);
  __syncthreads();

  const int n_slabs = (K + BK - 1) / BK;
  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 f0 = *reinterpret_cast<const float4*>(&Fs[buf][k][ty * 4]);
      const float4 f1 =
          *reinterpret_cast<const float4*>(&Fs[buf][k][64 + ty * 4]);
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][tx * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + tx * 4]);
      const float fa[TM] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      const float ab[TN] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(fa[i], ab[j], acc[i][j]);
    }
    if (s + 1 < n_slabs) {
      // the other buffer was last read before the previous barrier
      load_slab(F, A, S, K, N, row0, col0, (s + 1) * BK, tid, f_reg, a_reg);
      store_slab(Fs[buf ^ 1], As[buf ^ 1], tid, f_reg, a_reg);
    }
    __syncthreads();
  }

  // Epilogue: semiring clamp, column mask, exact conversion, masked store.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = col0 + tile_index(tx, j);
    if (gn >= N) continue;
    const float cm = col_mask ? col_mask[gn] : 1.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = row0 + tile_index(ty, i);
      if (gm >= S) continue;
      float v = acc[i][j];
      if (bool_mode) v = fminf(v, 1.f);
      out[static_cast<long long>(gm) * N + gn] = from_f32<TO>(v * cm);
    }
  }
}

template <typename TF, typename TA, typename TO>
void launch_typed(const void* F, const void* A, const float* mask, void* out,
                  int S, int K, int N, int bool_mode, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM);
  spmm_kernel<TF, TA, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TF*>(F), static_cast<const TA*>(A), mask,
      static_cast<TO*>(out), S, K, N, bool_mode);
}

template <typename TF, typename TA>
int launch_out(const void* F, const void* A, const float* mask, void* out,
               int o_dt, int S, int K, int N, int bool_mode,
               cudaStream_t stream) {
  switch (o_dt) {
    case DT_FLOAT32:
      launch_typed<TF, TA, float>(F, A, mask, out, S, K, N, bool_mode, stream);
      return 0;
    case DT_INT32:
      launch_typed<TF, TA, int32_t>(F, A, mask, out, S, K, N, bool_mode, stream);
      return 0;
    case DT_UINT8:
      launch_typed<TF, TA, uint8_t>(F, A, mask, out, S, K, N, bool_mode, stream);
      return 0;
  }
  return -1;
}

template <typename TF>
int launch_a(const void* F, const void* A, int a_dt, const float* mask,
             void* out, int o_dt, int S, int K, int N, int bool_mode,
             cudaStream_t stream) {
  switch (a_dt) {
    case DT_INT32:
      return launch_out<TF, int32_t>(F, A, mask, out, o_dt, S, K, N, bool_mode, stream);
    case DT_FLOAT32:
      return launch_out<TF, float>(F, A, mask, out, o_dt, S, K, N, bool_mode, stream);
  }
  return -1;
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns the
// cudaGetLastError() code of the launch, or -1 for an unsupported type code.
extern "C" int block_spmm_launch(const void* F, int f_dt, const void* A,
                                 int a_dt, const void* col_mask, void* out,
                                 int o_dt, int S, int K, int N, int bool_mode,
                                 void* stream) {
  if (S == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mask = static_cast<const float*>(col_mask);
  int rc = -1;
  switch (f_dt) {
    case DT_INT32:
      rc = launch_a<int32_t>(F, A, a_dt, mask, out, o_dt, S, K, N, bool_mode, st);
      break;
    case DT_UINT8:
      rc = launch_a<uint8_t>(F, A, a_dt, mask, out, o_dt, S, K, N, bool_mode, st);
      break;
    case DT_FLOAT32:
      rc = launch_a<float>(F, A, a_dt, mask, out, o_dt, S, K, N, bool_mode, st);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

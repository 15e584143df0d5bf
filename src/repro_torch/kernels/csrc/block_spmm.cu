// block_spmm: out = semiring(F[S,K] @ A[K,N]) * col_mask[N].
//
// Replaces the TPU kernel repro/kernels/block_spmm.py::block_spmm (body
// _spmm_kernel): one frontier hop of the MV4PG executor over a dense
// label-masked adjacency.  "count" gives walk counts; "bool" clamps the sum
// to min(acc, 1).  The output is fp32, int32 or uint8 (a 0/1 frontier),
// written directly; ragged edges are masked in the loads and the store, so
// no operand is padded or copied.  The semiring clamp and the column mask
// are applied once, after the last K slab.
//
// Bound at the workload shape (FinBench, S = src_block = 256,
// K = N = node_cap = 27,264, int32 operands): the main path's operands are
// integers, which the u8 tensor cores multiply exactly with int32
// accumulation at 1,979 TOPS, so 2*S*K*N = 3.8e11 operations take 0.19 ms
// while the 2.97 GB of int32 A (plus 28 MB each of F and out) take 0.90 ms
// at 3.35 TB/s: the kernel is bound by the bytes of A.
//
// Two routes, chosen by the operands' dtypes (ops.py counts each):
//
// Integer operands (F int32 or uint8/bool, A int32) -> spmm_u8_kernel, on
//   the u8 tensor cores, exact.  A 256-thread block owns 128 output columns
//   and two 128-row tiles, so that the workload's 256 frontier rows read
//   each slab of A once; its 8 warps (2 x 4) own 64 x 32 of each row tile.  The block walks K in slabs of 64 (two
//   mma.m16n8k32 depths).  A ring of four raw slabs in shared memory is
//   filled by cp.async (16-byte chunks; element copies where a row is not
//   aligned), so three slabs are in flight while one is converted: F as
//   u8, A as int32 in its own type.  Conversion stores A transposed, as u8
//   ([n][k], each thread transposing a 4 x 4 block by byte permutes),
//   because mma .row.col wants B K-major and ldmatrix.trans does not serve
//   8-bit operands.  Rows are XOR-swizzled in 16-byte chunks so that
//   neither the conversion nor ldmatrix reads a bank twice.  Accumulation
//   is mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32.
//
//   An int32 F is first copied to u8 by to_u8_kernel (28 MB read, 7 MB
//   written at the workload shape): the 213 column blocks then re-read 7 MB
//   of F from L2 instead of 28 MB each.
//
//   Exactness, per slab, without a host sync.  A bool hop is always in
//   range (F is 0/1, A is clamped to 1 by the executor).  A walk count or a
//   view multiplicity can exceed 255.  So to_u8_kernel flags every 128-row
//   tile and slab of F that holds a value outside 0..255, the conversion
//   tests every value of A, and the conversion's barrier is
//   __syncthreads_or of those tests.  A slab that fails runs on the CUDA
//   cores instead: int32 multiply-adds into the same accumulator
//   fragments, with the caller's int32 (or uint8) values re-read from
//   global (or L2).  The sum is exact wherever it fits int32, so this route
//   is exact wherever the fp32 route is (below 2^24).  Each such slab adds
//   one to a device counter (slow_slabs) that the caller reads when it
//   chooses; the launch itself never syncs.
//
// fp32 operands (either operand float32) -> spmm_kernel, the first port's
//   v3 kernel, unchanged: IEEE fp32 FMA on the CUDA cores (TF32's 10-bit
//   mantissa would break exact counts), 128 x 128 tiles, 8-deep slabs in
//   two buffers, 8 x 8 register micro-tiles read as 16-byte vectors,
//   __launch_bounds__(256, 2).
//
// wgmma with TMA, and storing cached adjacencies as uint8 (a quarter of
// the bytes of A), are later work.

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


// ---------------------------------------------------------------------------
// The u8 tensor-core route for integer operands
// ---------------------------------------------------------------------------

namespace u8 {

constexpr int BM = 128;          // output rows of a row tile
constexpr int RT = 2;            // row tiles per block: 256 frontier rows
                                 // read each slab of A once
constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // K slab: two mma.m16n8k32 depths
constexpr int THREADS = 256;     // 8 warps, 2 (rows) x 4 (columns)
constexpr int STAGES = 4;        // raw slabs in the cp.async ring
constexpr int A_TILE = BN * BK;  // bytes of the u8 A^T slab

// Shared memory: a ring of STAGES raw slabs as loaded (F [RT*BM][BK] u8,
// A [BK][BN] int32), then the u8 slabs the tensor cores read (F swizzled,
// A transposed and swizzled).
struct Smem {
  static constexpr int F_RAW = RT * BM * BK;
  static constexpr int A_RAW = BK * BN * 4;
  static constexpr int STAGE = F_RAW + A_RAW;
  static constexpr int BYTES = STAGES * STAGE + F_RAW + A_TILE;
};

// Byte offset of 16-byte chunk c (0..3) of row r in a [rows][64] u8 slab.
// XOR-ing the chunk with bits 1-2 of the row puts the 8 rows that one
// ldmatrix phase reads on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

// Byte offset of 16-byte chunk c (0..31) of row k in a raw [64][128] int32
// A slab.  The XOR with bits 2-4 of k puts the rows 4kg + r that the 8
// threads of a conversion phase read on 8 distinct bank groups.
__device__ __forceinline__ int a_raw_off(int k, int c) {
  return k * (BN * 4) + ((c ^ ((k >> 2) & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x32] b[32x8], u8 in, int32 accumulate (exact)
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool out_of_u8(int x) {
  return static_cast<unsigned>(x) > 255u;
}

// The low bytes of x, y, z, w as one word (x lowest).
__device__ __forceinline__ unsigned pack4(int x, int y, int z, int w) {
  return __byte_perm(__byte_perm(x, y, 0x0040), __byte_perm(z, w, 0x0040),
                     0x5410);
}

template <typename TO> __device__ __forceinline__ TO from_int(int v);
template <> __device__ __forceinline__ float from_int<float>(int v) {
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ int32_t from_int<int32_t>(int v) {
  return v;
}
template <> __device__ __forceinline__ uint8_t from_int<uint8_t>(int v) {
  return static_cast<uint8_t>(v);
}

// int32 F [S, K] -> u8 F8 [S, K], and for each 128-row tile and K slab of
// 64 a flag: does the region hold a value outside 0..255?  One block per
// (row tile, slab); ``vec``: K % 4 == 0 and F 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
to_u8_kernel(const int32_t* __restrict__ F, uint8_t* __restrict__ F8,
             int* __restrict__ flags, int S, int K, int vec) {
  const int w = threadIdx.x & 15, fr = threadIdx.x >> 4;
  const int k = blockIdx.y * BK + 4 * w;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = blockIdx.x * BM + fr + 16 * i;
    if (r >= S) break;
    const long long at = static_cast<long long>(r) * K + k;
    if (vec && k < K) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(F + at));
      bad |= out_of_u8(v.x) | out_of_u8(v.y) | out_of_u8(v.z) |
             out_of_u8(v.w);
      *reinterpret_cast<unsigned*>(F8 + at) = pack4(v.x, v.y, v.z, v.w);
    } else if (!vec) {
      for (int j = 0; j < 4 && k + j < K; ++j) {
        const int x = F[at + j];
        bad |= out_of_u8(x);
        F8[at + j] = static_cast<uint8_t>(x);
      }
    }
  }
  bad = __syncthreads_or(bad) != 0;
  if (threadIdx.x == 0) flags[blockIdx.x * gridDim.y + blockIdx.y] = bad;
}

struct Ctx {
  int S, K, N, row0, col0, tid, warp_m, warp_n, lane, n_slabs;
  bool vec_f, vec_a, f_u8;
};

// Copy one 16-byte chunk of a row (elements col.. of ``limit``), as
// cp.async when the row is aligned (``vec``: a chunk lies wholly in or out
// of range) or element by element otherwise; zeros out of range.
template <typename T>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const T* row,
                                           int col, int limit, bool row_ok,
                                           bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const bool ok = row_ok && col < limit;
    cp_async16(dst, ok ? row + col : row, ok);
    return;
  }
  T* d = reinterpret_cast<T*>(dst);
#pragma unroll
  for (int e = 0; e < E; ++e)
    d[e] = row_ok && col + e < limit ? row[col + e] : T(0);
}

// Start loading the slab at k0 into ring stage ``raw``.
__device__ __forceinline__ void fetch_slab(const uint8_t* __restrict__ F8,
                                           const int32_t* __restrict__ A,
                                           const Ctx& c, int k0,
                                           uint8_t* raw) {
#pragma unroll
  for (int i = 0; i < RT * BM * BK / 16 / THREADS; ++i) {
    const int ch = c.tid + i * THREADS;
    const int r = ch >> 2, cc = ch & 3;
    const int gm = c.row0 + r;
    copy_chunk(raw + r * BK + cc * 16,
               F8 + static_cast<long long>(gm < c.S ? gm : 0) * c.K,
               k0 + cc * 16, c.K, gm < c.S, c.vec_f);
  }
  uint8_t* a_raw = raw + Smem::F_RAW;
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
    const int ch = c.tid + i * THREADS;
    const int k = ch / (BN / 4), cc = ch % (BN / 4);
    const int gk = k0 + k;
    copy_chunk(a_raw + a_raw_off(k, cc),
               A + static_cast<long long>(gk < c.K ? gk : 0) * c.N,
               c.col0 + cc * 4, c.N, gk < c.K, c.vec_a);
  }
}

// Ring stage -> u8 slabs: F chunks swizzled; A transposed to [n][k], each
// thread a 4k x 4n block by byte permutes.  Returns whether any value of
// the block's slab lies outside 0..255 (``f_bad``: F's, from the
// pre-pass).  The __syncthreads_or is the conversion's barrier.
__device__ __forceinline__ bool convert_slab(const uint8_t* raw, uint8_t* Fs,
                                             uint8_t* As, const Ctx& c,
                                             bool f_bad) {
#pragma unroll
  for (int i = 0; i < RT * BM * BK / 16 / THREADS; ++i) {
    const int ch = c.tid + i * THREADS;
    const int r = ch >> 2, cc = ch & 3;
    *reinterpret_cast<int4*>(Fs + swz(r, cc)) =
        *reinterpret_cast<const int4*>(raw + r * BK + cc * 16);
  }
  bool bad = f_bad;
  const uint8_t* a_raw = raw + Smem::F_RAW;
  const int kg = c.tid & 15;
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
    const int n4 = (c.tid >> 4) + 16 * i;    // columns 4n4..4n4+3
    int4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = *reinterpret_cast<const int4*>(a_raw + a_raw_off(4 * kg + r, n4));
      bad |= out_of_u8(a[r].x) | out_of_u8(a[r].y) | out_of_u8(a[r].z) |
             out_of_u8(a[r].w);
    }
    const int n = 4 * n4, at = (kg & 3) * 4;
    *reinterpret_cast<unsigned*>(As + swz(n, kg >> 2) + at) =
        pack4(a[0].x, a[1].x, a[2].x, a[3].x);
    *reinterpret_cast<unsigned*>(As + swz(n + 1, kg >> 2) + at) =
        pack4(a[0].y, a[1].y, a[2].y, a[3].y);
    *reinterpret_cast<unsigned*>(As + swz(n + 2, kg >> 2) + at) =
        pack4(a[0].z, a[1].z, a[2].z, a[3].z);
    *reinterpret_cast<unsigned*>(As + swz(n + 3, kg >> 2) + at) =
        pack4(a[0].w, a[1].w, a[2].w, a[3].w);
  }
  return __syncthreads_or(bad) != 0;
}

// The tensor cores on one u8 slab: the warp's 64 x 32 tile of each row
// tile, two 32-deep steps.
__device__ __forceinline__ void mma_slab(const uint8_t* Fs, const uint8_t* As,
                                         const Ctx& c,
                                         int (&acc)[RT][4][4][4]) {
  const int l = c.lane;
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    unsigned b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned r[4];
      ldsm_x4(r, As + swz(c.warp_n * 32 + np * 16 + (l >> 4) * 8 + (l & 7),
                          kk * 2 + ((l >> 3) & 1)));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], Fs + swz(t * BM + c.warp_m * 64 + mt * 16 + (l & 15),
                                kk * 2 + (l >> 4)));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_u8(acc[t][mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
}

// The CUDA cores on a slab with a value outside 0..255: int32 multiply-adds
// of the caller's operands, re-read from global, into the same fragments.
__device__ __forceinline__ void slow_slab(const void* __restrict__ F,
                                          const int32_t* __restrict__ A,
                                          const Ctx& c, int k0,
                                          int (&acc)[RT][4][4][4]) {
  const int g = c.lane >> 2, tq = c.lane & 3;
  const int k_end = min(k0 + BK, c.K);
  for (int k = k0; k < k_end; ++k) {
    int av[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gn = c.col0 + c.warp_n * 32 + nt * 8 + 2 * tq + j;
        av[nt][j] = gn < c.N ? A[static_cast<long long>(k) * c.N + gn] : 0;
      }
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = c.row0 + t * BM + c.warp_m * 64 + mt * 16 + g + 8 * h;
          int f = 0;
          if (gm < c.S) {
            const long long at = static_cast<long long>(gm) * c.K + k;
            f = c.f_u8 ? static_cast<const uint8_t*>(F)[at]
                       : static_cast<const int32_t*>(F)[at];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[t][mt][nt][2 * h + j] += f * av[nt][j];
        }
  }
}

// F8: F as u8 (the caller's bool/uint8 F, or the pre-pass's copy of an
// int32 F); F: the caller's F, for the CUDA-core slabs; f_flags: the
// pre-pass's flags, or null for a uint8 F.
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
spmm_u8_kernel(const uint8_t* __restrict__ F8, const void* __restrict__ F,
               int f_u8, const int* __restrict__ f_flags,
               const int32_t* __restrict__ A,
               const float* __restrict__ col_mask, TO* __restrict__ out,
               int S, int K, int N, int bool_mode, int vec_f, int vec_a,
               unsigned long long* __restrict__ slow_slabs) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Fs = smem + STAGES * Smem::STAGE;   // u8 slabs
  uint8_t* As = Fs + Smem::F_RAW;

  Ctx c;
  c.S = S; c.K = K; c.N = N;
  c.row0 = blockIdx.x * RT * BM;
  c.col0 = blockIdx.y * BN;
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp_m = (c.tid >> 5) >> 2;
  c.warp_n = (c.tid >> 5) & 3;
  c.n_slabs = (K + BK - 1) / BK;
  c.vec_f = vec_f != 0;
  c.vec_a = vec_a != 0;
  c.f_u8 = f_u8 != 0;

  int acc[RT][4][4][4];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < c.n_slabs)
      fetch_slab(F8, A, c, s * BK, smem + s * Smem::STAGE);
    cp_async_commit();
  }
  for (int s = 0; s < c.n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of slab s landed
    __syncthreads();               // everyone's; slab s-1 is fully consumed
    const int next = s + STAGES - 1;
    if (next < c.n_slabs)
      fetch_slab(F8, A, c, next * BK,
                     smem + (next % STAGES) * Smem::STAGE);
    cp_async_commit();
    bool f_bad = false;
    if (f_flags) {
#pragma unroll
      for (int t = 0; t < RT; ++t)
        if (c.row0 + t * BM < S)
          f_bad |= f_flags[(blockIdx.x * RT + t) * c.n_slabs + s] != 0;
    }
    const bool bad = convert_slab(
        smem + (s % STAGES) * Smem::STAGE, Fs, As, c, f_bad);
    if (!bad) {
      mma_slab(Fs, As, c, acc);
    } else {
      slow_slab(F, A, c, s * BK, acc);
      if (c.tid == 0) atomicAdd(slow_slabs, 1ull);
    }
  }
  cp_async_wait<0>();

  // Epilogue: semiring clamp, column mask, conversion, masked store.
  const int g = c.lane >> 2, tq = c.lane & 3;
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = c.row0 + t * BM + c.warp_m * 64 + mt * 16 + g + 8 * h;
        if (gm >= S) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int gn = c.col0 + c.warp_n * 32 + nt * 8 + 2 * tq + j;
            if (gn >= N) continue;
            int v = acc[t][mt][nt][2 * h + j];
            if (bool_mode) v = min(v, 1);
            out[static_cast<long long>(gm) * N + gn] =
                col_mask ? from_f32<TO>(static_cast<float>(v) * col_mask[gn])
                         : from_int<TO>(v);
          }
      }
}

struct Args {
  const uint8_t* F8;
  const void* F;
  int f_u8;
  const int* f_flags;
  const int32_t* A;
  const float* mask;
  void* out;
  int S, K, N, bool_mode, vec_f, vec_a;
  unsigned long long* slow;
};

template <typename TO>
int launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = Smem::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_u8_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + RT * BM - 1) / (RT * BM), (a.N + BN - 1) / BN);
  spmm_u8_kernel<TO><<<grid, THREADS, bytes, st>>>(
      a.F8, a.F, a.f_u8, a.f_flags, a.A, a.mask, static_cast<TO*>(a.out),
      a.S, a.K, a.N, a.bool_mode, a.vec_f, a.vec_a, a.slow);
  return 0;
}

int launch_out(const Args& a, int o_dt, cudaStream_t st) {
  switch (o_dt) {
    case DT_FLOAT32:
      return launch<float>(a, st);
    case DT_INT32:
      return launch<int32_t>(a, st);
    case DT_UINT8:
      return launch<uint8_t>(a, st);
  }
  return -1;
}

}  // namespace u8

}  // namespace

// C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns the cudaGetLastError() code of the launch, or -1 for an
// unsupported type code.

// Integer operands: F int32 or uint8 (f_dt), A int32.  An int32 F is
// first converted to u8 into ``f8`` ([S, K] bytes) with one range flag per
// 128-row tile and 64-deep K slab in ``flags`` (int32, ceil(S/128) *
// ceil(K/64)).  ``slow_slabs`` is a device uint64 that gains one for each
// (block, slab) that ran on the CUDA cores because a value lay outside
// 0..255.
extern "C" int block_spmm_u8_launch(const void* F, int f_dt, const void* A,
                                    const void* col_mask, void* out,
                                    int o_dt, int S, int K, int N,
                                    int bool_mode, void* f8, void* flags,
                                    void* slow_slabs, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (!slow_slabs) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u8::Args a;
  a.F = F;
  a.A = static_cast<const int32_t*>(A);
  a.mask = static_cast<const float*>(col_mask);
  a.out = out;
  a.S = S;
  a.K = K;
  a.N = N;
  a.bool_mode = bool_mode;
  a.slow = static_cast<unsigned long long*>(slow_slabs);
  if (f_dt == DT_INT32) {
    if (!f8 || !flags) return -1;
    if (K > 0) {
      const dim3 grid((S + u8::BM - 1) / u8::BM, (K + u8::BK - 1) / u8::BK);
      u8::to_u8_kernel<<<grid, u8::THREADS, 0, st>>>(
          static_cast<const int32_t*>(F), static_cast<uint8_t*>(f8),
          static_cast<int*>(flags), S, K,
          K % 4 == 0 && reinterpret_cast<uintptr_t>(F) % 16 == 0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    a.F8 = static_cast<const uint8_t*>(f8);
    a.f_u8 = 0;
    a.f_flags = static_cast<const int*>(flags);
  } else if (f_dt == DT_UINT8) {
    a.F8 = static_cast<const uint8_t*>(F);
    a.f_u8 = 1;
    a.f_flags = nullptr;
  } else {
    return -1;
  }
  a.vec_f = K % 16 == 0 && reinterpret_cast<uintptr_t>(a.F8) % 16 == 0;
  a.vec_a = N % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int rc = u8::launch_out(a, o_dt, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// A float32 operand (F int32, uint8 or float32; A int32 or float32, not
// both integer): the fp32 CUDA-core kernel.
extern "C" int block_spmm_fp32_launch(const void* F, int f_dt, const void* A,
                                      int a_dt, const void* col_mask,
                                      void* out, int o_dt, int S, int K,
                                      int N, int bool_mode, void* stream) {
  if (f_dt != DT_FLOAT32 && a_dt != DT_FLOAT32) return -1;
  if (S == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mask = static_cast<const float*>(col_mask);
  int rc = -1;
  switch (f_dt) {
    case DT_INT32:
      rc = launch_out<int32_t, float>(F, A, mask, out, o_dt, S, K, N,
                                      bool_mode, st);
      break;
    case DT_UINT8:
      rc = launch_out<uint8_t, float>(F, A, mask, out, o_dt, S, K, N,
                                      bool_mode, st);
      break;
    case DT_FLOAT32:
      rc = launch_a<float>(F, A, a_dt, mask, out, o_dt, S, K, N, bool_mode, st);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

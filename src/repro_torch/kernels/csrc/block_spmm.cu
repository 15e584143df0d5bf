// block_spmm: out = semiring(F[S,K] @ A[K,N]) * col_mask[N].
//
// Replaces the TPU kernel repro/kernels/block_spmm.py::block_spmm (body
// _spmm_kernel): one frontier hop of the MV4PG executor over a dense
// label-masked adjacency.  "count" gives walk counts; "bool" clamps the sum
// to min(acc, 1).  The output is fp32, int32 or uint8 (a 0/1 frontier),
// written directly, or by a second kernel that adds the fp32 route's
// partial sums over ranges of K; ragged edges are masked in the loads and
// the stores, so no operand is padded or copied.  The semiring clamp and
// the column mask are applied once, after the full sum.
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
//   The slab map: a block walks only the slabs of A that hold a non-zero.
//   A tile is one 64-row slab of A by one column block of 128 columns.
//   spmm_slab_map_kernel reads A once (one block a tile) and marks each
//   tile that holds a non-zero; spmm_slab_list_kernel (one block a column
//   block) writes that column block's live slabs in ascending order into a
//   fixed-shape int16 list [n_colblocks, n_slabs], the rest -1, with an
//   int32 count a column block.  The shapes are fixed, so no count comes
//   back to the host.  A cached adjacency carries its map (ops.py builds it
//   once beside the tensor); an A without one gets one built in the same
//   call, so there is one walk: a dense A lists every slab.  The cp.async
//   ring prefetches slab list[i + STAGES - 1]; F's range flags and the
//   CUDA-core route are indexed by the slab's own number.  A column block
//   with no live slab writes its zeros through the same epilogue.  Skipping
//   an all-zero slab of A adds nothing to any sum, so the integer results
//   are those of the dense walk, bit for bit.  A FinBench adjacency at
//   node_cap 30,720 holds 0.7-3.8% live tiles.
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
// fp32 operands (either operand float32) -> f32::spmm_fp32_kernel, IEEE fp32
//   FMA on the CUDA cores.  TF32 or bf16 tensor cores would round the
//   operands to 10 or 7 mantissa bits and break exact counts; an
//   error-free split over the tensor cores is later work.  Bound at SAGE's
//   aggregation over ROOT_POST (F the dense adjacency, S = K = 13,440,
//   A = h with N = 128): 2*S*K*N = 46.2 GFLOP take 0.690 ms at the 67
//   TFLOP/s fp32 peak, while the 722 MB of F (plus 6.9 MB each of A and
//   out) take 0.220 ms at 3.35 TB/s: the route is bound by operations.
//   So every SM must be busy and nearly every issued instruction an FMA:
//   - Split-K.  With N = 128 the 128 x 128 output tiles are few (105 at
//     ROOT_POST, 16 at KNOWS2's 2,048 nodes) against 132 SMs, so the
//     host's planner (ops.spmm_fp32_plan) cuts K into n_split ranges of
//     whole 32-deep slabs, shared evenly (the first n_slabs % n_split one
//     slab longer), and blockIdx.z picks the range: 105 x 5 blocks fill
//     four waves of 132 at ROOT_POST (99.4%), 16 x 8 one wave at KNOWS2.
//     Each split writes its raw fp32 sums into a partial [S, N] of a
//     workspace the caller allocates; spmm_fp32_finish_kernel then adds
//     the partials in split order (the same bits on every launch: no
//     float atomics) and applies the epilogue once.  With one split the
//     kernel applies it itself.
//   - An asynchronous ring.  Six stages of a 32-deep slab (F [128][32]
//     and A [32][128] in their own types, 34 KB for fp32 F) are filled by
//     cp.async in 16-byte chunks, five slabs in flight while one is
//     multiplied.  A slab inside S, N and the split, with 16-byte aligned
//     rows, takes 8 copies a thread from pointers that advance a slab at a
//     time; a slab at an edge is masked chunk by chunk, and copied element
//     by element where a row is not aligned (K % 4 != 0, N % 4 != 0).
//     Integer F or A is converted to fp32 as it is read from shared memory.
//   - 8 x 8 register micro-tiles.  A thread owns rows ty*4 + {0..3, 64..67}
//     and columns tx*4 + {0..3, 64..67}; per 4 K it reads 8 rows of F as
//     16-byte vectors along K and 2 x 4 16-byte vectors of A, for 256
//     FMAs.  F rows are padded to 144 bytes so that the two rows a warp
//     reads at once (4 apart) lie on other banks.
//   One block of 256 threads an SM: the ring's 204 KB of shared memory and
//   up to 255 registers a thread.  Capped at 128 registers for two blocks
//   an SM, the compiler spills inside the slab loop, which costs more than
//   the second block's warps hide.  The semiring clamp, the column mask and
//   the conversion to the output type come once, after the full sum; K = 0
//   writes zeros.
//
// wgmma with TMA, and storing cached adjacencies as uint8 (a quarter of
// the bytes of A), are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_INT32 = 0, DT_UINT8 = 1, DT_FLOAT32 = 2 };

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

// ---------------------------------------------------------------------------
// The fp32 route
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128;        // output rows of a block
constexpr int BN = 128;        // output columns of a block
constexpr int BK = 32;         // K slab
constexpr int TM = 8;          // rows a thread
constexpr int TN = 8;          // columns a thread
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int STAGES = 6;      // slabs in the cp.async ring
constexpr int A_ROW = BN * 4;  // bytes of a row of the A slab
constexpr int FINISH_THREADS = 256;

// Bytes of a row of the F slab in F's own type, padded by 16 bytes.
template <typename TF> __host__ __device__ constexpr int f_row() {
  return BK * static_cast<int>(sizeof(TF)) + 16;
}
template <typename TF> __host__ __device__ constexpr int stage_bytes() {
  return BM * f_row<TF>() + BK * A_ROW;
}
template <typename TF> __host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<TF>();
}

// Row (or column) of micro-tile index i in 0..7 for lane t in 0..15.
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4 ? 0 : 64 - 4) + t * 4 + i;
}

// Four consecutive values from shared memory as fp32.
template <typename T>
__device__ __forceinline__ void ld4(const uint8_t* p, float* v);
template <>
__device__ __forceinline__ void ld4<float>(const uint8_t* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
template <>
__device__ __forceinline__ void ld4<int32_t>(const uint8_t* p, float* v) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  v[0] = static_cast<float>(x.x); v[1] = static_cast<float>(x.y);
  v[2] = static_cast<float>(x.z); v[3] = static_cast<float>(x.w);
}
template <>
__device__ __forceinline__ void ld4<uint8_t>(const uint8_t* p, float* v) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int b = 0; b < 4; ++b) v[b] = static_cast<float>((x >> (8 * b)) & 0xffu);
}

// Four consecutive outputs at p (16-byte aligned for 4-byte types).
template <typename T>
__device__ __forceinline__ void st4(T* p, const float* v);
template <> __device__ __forceinline__ void st4<float>(float* p,
                                                        const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void st4<int32_t>(int32_t* p,
                                                          const float* v) {
  *reinterpret_cast<int4*>(p) =
      make_int4(from_f32<int32_t>(v[0]), from_f32<int32_t>(v[1]),
                from_f32<int32_t>(v[2]), from_f32<int32_t>(v[3]));
}
template <> __device__ __forceinline__ void st4<uint8_t>(uint8_t* p,
                                                          const float* v) {
  *reinterpret_cast<unsigned*>(p) =
      static_cast<unsigned>(from_f32<uint8_t>(v[0])) |
      static_cast<unsigned>(from_f32<uint8_t>(v[1])) << 8 |
      static_cast<unsigned>(from_f32<uint8_t>(v[2])) << 16 |
      static_cast<unsigned>(from_f32<uint8_t>(v[3])) << 24;
}

// The epilogue of one output: semiring clamp, then the column mask.
__device__ __forceinline__ float finish(float v, float cm, int bool_mode) {
  return (bool_mode ? fminf(v, 1.f) : v) * cm;
}

// Four outputs of row gm from column gn on: one vector store where
// ``vec`` (N % 4 == 0, aligned) and all four lie inside N, else one by one.
template <typename TO>
__device__ __forceinline__ void store4(TO* __restrict__ out, long long gm,
                                       int gn, int N, float* v, bool vec) {
  TO* p = out + gm * N + gn;
  if (vec && gn + 3 < N) {
    st4<TO>(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (gn + e < N) p[e] = from_f32<TO>(v[e]);
}

struct Tile {
  int S, K, N, row0, col0, k_end;
  bool vec_f, vec_a;
};

// Start loading a slab at an edge (past S, N, K or the split, or with rows
// not 16-byte aligned) into ring stage ``stage``: F [BM][BK] in rows of
// f_row bytes, then A [BK][BN], each in its own type, masked chunk by chunk.
template <typename TF, typename TA>
__device__ __forceinline__ void fetch_edge(const TF* __restrict__ F,
                                           const TA* __restrict__ A,
                                           const Tile& t, int k0,
                                           uint8_t* stage, int tid) {
  constexpr int FE = 16 / sizeof(TF);           // elements of F a chunk
  constexpr int F_CHUNKS = BK / FE;             // chunks of an F row
#pragma unroll
  for (int i = 0; i < BM * F_CHUNKS / THREADS; ++i) {
    const int ch = tid + i * THREADS;
    const int r = ch / F_CHUNKS, cc = ch % F_CHUNKS;
    const int gm = t.row0 + r;
    copy_chunk(stage + r * f_row<TF>() + cc * 16,
               F + static_cast<long long>(gm < t.S ? gm : 0) * t.K,
               k0 + cc * FE, t.k_end, gm < t.S, t.vec_f);
  }
  uint8_t* as = stage + BM * f_row<TF>();
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
    const int ch = tid + i * THREADS;
    const int k = ch / (BN / 4), cc = ch % (BN / 4);
    const int gk = k0 + k;
    copy_chunk(as + k * A_ROW + cc * 16,
               A + static_cast<long long>(gk < t.k_end ? gk : 0) * t.N,
               t.col0 + cc * 4, t.N, gk < t.k_end, t.vec_a);
  }
}

// A thread's sources and destinations of a slab's 16-byte copies, for the
// slabs that lie inside the split while the block's rows and columns lie
// inside S and N and every row is 16-byte aligned (``fast``): F chunk i of
// row tid / F_CHUNKS + i * F_ROWS, A chunk i of row tid / 32 + 8 * i.  The
// sources advance one slab a fetch.
template <typename TF, typename TA>
struct Stream {
  static constexpr int FE = 16 / sizeof(TF);
  static constexpr int F_CHUNKS = BK / FE;      // chunks of an F row
  static constexpr int F_ROWS = THREADS / F_CHUNKS;
  const TF* f;
  const TA* a;
  long long f_step, a_step;      // elements between a thread's chunks
  int f_dst, a_dst;              // bytes into a stage
  bool fast;

  __device__ __forceinline__ Stream(const TF* F, const TA* A, const Tile& t,
                                    int k_begin, int tid) {
    f = F + static_cast<long long>(t.row0 + tid / F_CHUNKS) * t.K + k_begin +
        tid % F_CHUNKS * FE;
    a = A + static_cast<long long>(k_begin + tid / 32) * t.N + t.col0 +
        tid % 32 * 4;
    f_step = static_cast<long long>(F_ROWS) * t.K;
    a_step = 8LL * t.N;
    f_dst = tid / F_CHUNKS * f_row<TF>() + tid % F_CHUNKS * 16;
    a_dst = BM * f_row<TF>() + tid / 32 * A_ROW + tid % 32 * 16;
    fast = t.vec_f && t.vec_a && t.row0 + BM <= t.S && t.col0 + BN <= t.N;
  }
};

// Start loading the slab at k0 (the next one of ``st``) into ring stage
// ``stage``.
template <typename TF, typename TA>
__device__ __forceinline__ void fetch(const TF* __restrict__ F,
                                      const TA* __restrict__ A, const Tile& t,
                                      Stream<TF, TA>& st, int k0,
                                      uint8_t* stage, int tid) {
  if (st.fast && k0 + BK <= t.k_end) {
#pragma unroll
    for (int i = 0; i < BM / Stream<TF, TA>::F_ROWS; ++i)
      cp_async16(stage + st.f_dst + i * Stream<TF, TA>::F_ROWS * f_row<TF>(),
                 st.f + i * st.f_step, true);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      cp_async16(stage + st.a_dst + i * 8 * A_ROW, st.a + i * st.a_step,
                 true);
  } else {
    fetch_edge(F, A, t, k0, stage, tid);
  }
  st.f += BK;
  st.a += static_cast<long long>(BK) * t.N;
}

// The FMAs of one slab: per 4 K, 8 rows of F and 8 columns of A a K.
template <typename TF, typename TA>
__device__ __forceinline__ void fma_slab(const uint8_t* stage, int tx, int ty,
                                         float (&acc)[TM][TN]) {
  const uint8_t* fs = stage;
  const uint8_t* as = stage + BM * f_row<TF>();
#pragma unroll
  for (int kg = 0; kg < BK; kg += 4) {
    float f[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      ld4<TF>(fs + tile_index(ty, i) * f_row<TF>() + kg * sizeof(TF), f[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint8_t* ar = as + (kg + kk) * A_ROW;
      float a[TN];
      ld4<TA>(ar + tx * 16, a);
      ld4<TA>(ar + 64 * 4 + tx * 16, a + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(f[i][kk], a[j], acc[i][j]);
    }
  }
}

// One block: output tile (blockIdx.x, blockIdx.y) over split blockIdx.z of
// gridDim.z.  ``partial`` null: write the finished outputs; else write the
// raw sums into partial[blockIdx.z] ([S, N] fp32).  ``vec_o``: N % 4 == 0
// and the written array aligned for 4-element stores.
template <typename TF, typename TA, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
spmm_fp32_kernel(const TF* __restrict__ F, const TA* __restrict__ A,
                 const float* __restrict__ col_mask, TO* __restrict__ out,
                 float* __restrict__ partial, int S, int K, int N,
                 int bool_mode, int vec_f, int vec_a, int vec_o) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int STAGE = stage_bytes<TF>();
  const int tid = threadIdx.x;
  const int tx = tid % 16;             // column lane
  const int ty = tid / 16;             // row lane

  // this split's slabs: K's slabs shared evenly, the first ones longer
  const int n_all = (K + BK - 1) / BK;
  const int z = blockIdx.z, nz = gridDim.z;
  const int base = n_all / nz, rem = n_all % nz;
  const int n = base + (z < rem ? 1 : 0);
  const int k_begin = (z * base + min(z, rem)) * BK;

  Tile t;
  t.S = S; t.K = K; t.N = N;
  t.row0 = blockIdx.x * BM;
  t.col0 = blockIdx.y * BN;
  t.k_end = min(k_begin + n * BK, K);
  t.vec_f = vec_f != 0;
  t.vec_a = vec_a != 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Stream<TF, TA> st(F, A, t, k_begin, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) fetch(F, A, t, st, k_begin + s * BK, smem + s * STAGE, tid);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of slab s landed
    __syncthreads();               // everyone's; slab s-1 is fully consumed
    const int next = s + STAGES - 1;
    if (next < n)
      fetch(F, A, t, st, k_begin + next * BK, smem + (next % STAGES) * STAGE,
            tid);
    cp_async_commit();
    fma_slab<TF, TA>(smem + (s % STAGES) * STAGE, tx, ty, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = t.row0 + tile_index(ty, i);
    if (gm >= S) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = t.col0 + h * 64 + tx * 4;
      if (gn >= N) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][h * 4 + e];
      if (partial) {
        store4(partial + static_cast<long long>(z) * S * N, gm, gn, N, v,
               vec_o != 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = finish(v[e], col_mask && gn + e < N ? col_mask[gn + e] : 1.f,
                        bool_mode);
        store4(out, gm, gn, N, v, vec_o != 0);
      }
    }
  }
}

// out = epilogue(sum of the n_split partials, in split order).  A thread
// takes four consecutive outputs; ``vec``: N % 4 == 0 and partial and out
// aligned, so the four share a row and move as vectors.
template <typename TO>
__global__ void __launch_bounds__(FINISH_THREADS)
spmm_fp32_finish_kernel(const float* __restrict__ partial, int n_split,
                        const float* __restrict__ col_mask,
                        TO* __restrict__ out, int S, int N, int bool_mode,
                        int vec) {
  const long long total = static_cast<long long>(S) * N;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * FINISH_THREADS + threadIdx.x) * 4;
  if (e0 >= total) return;
  if (vec) {
    float4 s = *reinterpret_cast<const float4*>(partial + e0);
#pragma unroll 4
    for (int j = 1; j < n_split; ++j) {
      const float4 p =
          *reinterpret_cast<const float4*>(partial + j * total + e0);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    const int gn = static_cast<int>(e0 % N);
    float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = finish(v[e], col_mask ? col_mask[gn + e] : 1.f, bool_mode);
    st4<TO>(out + e0, v);
    return;
  }
  const long long e1 = e0 + 4 < total ? e0 + 4 : total;
  for (long long e = e0; e < e1; ++e) {
    float s = partial[e];
#pragma unroll 4
    for (int j = 1; j < n_split; ++j) s += partial[j * total + e];
    const int gn = static_cast<int>(e % N);
    out[e] = from_f32<TO>(finish(s, col_mask ? col_mask[gn] : 1.f,
                                 bool_mode));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Lets the kernel use its ring (above 48 KB of shared memory).
template <typename TF, typename TA, typename TO>
cudaError_t set_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_fp32_kernel<TF, TA, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<TF>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(spmm_fp32_kernel<TF, TA, TO>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct Args {
  const void* F;
  const void* A;
  const float* mask;
  void* out;
  float* partial;
  int S, K, N, bool_mode, n_split;
};

template <typename TF, typename TA, typename TO>
int launch(const Args& a, cudaStream_t st) {
  cudaError_t err = set_smem<TF, TA, TO>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const TF* F = static_cast<const TF*>(a.F);
  TO* out = static_cast<TO*>(a.out);
  const int vec_f = (sizeof(TF) == 1 ? a.K % 16 : a.K % 4) == 0 &&
                    aligned16(F);
  const int vec_a = a.N % 4 == 0 && aligned16(a.A);
  const bool split = a.n_split > 1;
  const int vec_o = a.N % 4 == 0 &&
      (split ? aligned16(a.partial)
             : reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0);
  const dim3 grid((a.S + BM - 1) / BM, (a.N + BN - 1) / BN, a.n_split);
  spmm_fp32_kernel<TF, TA, TO><<<grid, THREADS, smem_bytes<TF>(), st>>>(
      F, static_cast<const TA*>(a.A), a.mask, out,
      split ? a.partial : nullptr, a.S, a.K, a.N, a.bool_mode, vec_f, vec_a,
      vec_o);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const long long quads = (static_cast<long long>(a.S) * a.N + 3) / 4;
  const int vec = a.N % 4 == 0 && aligned16(a.partial) &&
                  reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0;
  spmm_fp32_finish_kernel<TO>
      <<<static_cast<unsigned>((quads + FINISH_THREADS - 1) / FINISH_THREADS),
         FINISH_THREADS, 0, st>>>(a.partial, a.n_split, a.mask, out, a.S,
                                  a.N, a.bool_mode, vec);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the kernel for these types.
template <typename TF, typename TA, typename TO>
int blocks_per_sm(int* blocks) {
  cudaError_t err = set_smem<TF, TA, TO>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, spmm_fp32_kernel<TF, TA, TO>, THREADS, smem_bytes<TF>());
  return static_cast<int>(err);
}

template <typename T> struct Type { using type = T; };

// Calls fn(Type<TF>, Type<TA>, Type<TO>) for the dtype codes: F float32
// with A float32 or int32, or F int32 or uint8 with A float32; out float32,
// int32 or uint8.  -1 for any other combination.
template <typename TF, typename TA, typename Fn>
int with_out(int o_dt, Fn&& fn) {
  switch (o_dt) {
    case DT_FLOAT32: return fn(Type<TF>(), Type<TA>(), Type<float>());
    case DT_INT32: return fn(Type<TF>(), Type<TA>(), Type<int32_t>());
    case DT_UINT8: return fn(Type<TF>(), Type<TA>(), Type<uint8_t>());
  }
  return -1;
}

template <typename Fn>
int with_types(int f_dt, int a_dt, int o_dt, Fn&& fn) {
  if (f_dt == DT_FLOAT32 && a_dt == DT_FLOAT32)
    return with_out<float, float>(o_dt, fn);
  if (f_dt == DT_FLOAT32 && a_dt == DT_INT32)
    return with_out<float, int32_t>(o_dt, fn);
  if (f_dt == DT_INT32 && a_dt == DT_FLOAT32)
    return with_out<int32_t, float>(o_dt, fn);
  if (f_dt == DT_UINT8 && a_dt == DT_FLOAT32)
    return with_out<uint8_t, float>(o_dt, fn);
  return -1;
}

}  // namespace f32


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

// One block a tile (blockIdx.x the slab, blockIdx.y the column block):
// live[cb * n_slabs + slab] = does A's tile hold a non-zero?  ``vec``:
// N % 4 == 0 and A 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
spmm_slab_map_kernel(const int32_t* __restrict__ A,
                     uint8_t* __restrict__ live, int K, int N, int vec) {
  const int cc = threadIdx.x & 31, r0 = threadIdx.x >> 5;
  const int gn = blockIdx.y * BN + 4 * cc;
  bool nz = false;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const int gk = blockIdx.x * BK + r0 + 8 * i;
    if (gk >= K) break;
    const int32_t* row = A + static_cast<long long>(gk) * N;
    if (vec) {
      if (gn < N) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(row + gn));
        nz |= (v.x | v.y | v.z | v.w) != 0;
      }
    } else {
      for (int j = 0; j < 4 && gn + j < N; ++j) nz |= row[gn + j] != 0;
    }
  }
  nz = __syncthreads_or(nz) != 0;
  if (threadIdx.x == 0)
    live[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = nz;
}

// One block a column block: its live slabs in ascending order into
// list[cb][0 .. count), -1 after them, and count[cb].  Each round of 256
// slabs ranks the live ones by warp ballots and a scan of the 8 warps'
// totals.
__global__ void __launch_bounds__(THREADS)
spmm_slab_list_kernel(const uint8_t* __restrict__ live,
                      int16_t* __restrict__ list, int* __restrict__ count,
                      int n_slabs) {
  __shared__ int warp_total[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* mine = live + static_cast<long long>(blockIdx.x) * n_slabs;
  int16_t* out = list + static_cast<long long>(blockIdx.x) * n_slabs;
  int total = 0;
  for (int base = 0; base < n_slabs; base += THREADS) {
    const int s = base + threadIdx.x;
    const bool on = s < n_slabs && mine[s] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = total, round = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? warp_total[w] : 0;
      round += warp_total[w];
    }
    if (on)
      out[before + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<int16_t>(s);
    total += round;
    __syncthreads();           // warp_total is rewritten by the next round
  }
  for (int i = total + threadIdx.x; i < n_slabs; i += THREADS) out[i] = -1;
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

struct Ctx {
  int S, K, N, row0, col0, tid, warp_m, warp_n, lane, n_slabs;
  bool vec_f, vec_a, f_u8;
};

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
// pre-pass's flags, or null for a uint8 F; slab_list, slab_count: the slab
// map, whose list the block walks.
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
spmm_u8_kernel(const uint8_t* __restrict__ F8, const void* __restrict__ F,
               int f_u8, const int* __restrict__ f_flags,
               const int32_t* __restrict__ A,
               const int16_t* __restrict__ slab_list,
               const int* __restrict__ slab_count,
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

  // this column block's live slabs: list[0 .. n), ascending
  const int16_t* list =
      slab_list + static_cast<long long>(blockIdx.y) * c.n_slabs;
  const int n = slab_count[blockIdx.y];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n)
      fetch_slab(F8, A, c, __ldg(list + s) * BK, smem + s * Smem::STAGE);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of slab s landed
    __syncthreads();               // everyone's; slab s-1 is fully consumed
    const int next = s + STAGES - 1;
    if (next < n)
      fetch_slab(F8, A, c, __ldg(list + next) * BK,
                 smem + (next % STAGES) * Smem::STAGE);
    cp_async_commit();
    const int ks = __ldg(list + s);   // the slab's own number
    bool f_bad = false;
    if (f_flags) {
#pragma unroll
      for (int t = 0; t < RT; ++t)
        if (c.row0 + t * BM < S)
          f_bad |= f_flags[(blockIdx.x * RT + t) * c.n_slabs + ks] != 0;
    }
    const bool bad = convert_slab(
        smem + (s % STAGES) * Smem::STAGE, Fs, As, c, f_bad);
    if (!bad) {
      mma_slab(Fs, As, c, acc);
    } else {
      slow_slab(F, A, c, ks * BK, acc);
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
  const int16_t* slab_list;
  const int* slab_count;
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
      a.F8, a.F, a.f_u8, a.f_flags, a.A, a.slab_list, a.slab_count, a.mask,
      static_cast<TO*>(a.out),
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

// The slab map of an int32 A [K, N]: ``live`` is a workspace of
// ceil(N/128) * ceil(K/64) bytes, ``slab_list`` int16 [ceil(N/128),
// ceil(K/64)] and ``slab_count`` int32 [ceil(N/128)] (see the header).
extern "C" int block_spmm_slab_map_launch(const void* A, int K, int N,
                                          void* live, void* slab_list,
                                          void* slab_count, void* stream) {
  if (N == 0) return 0;
  if (!slab_count || (K > 0 && (!live || !slab_list))) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_slabs = (K + u8::BK - 1) / u8::BK;
  const int n_cb = (N + u8::BN - 1) / u8::BN;
  if (n_slabs > 32767 || n_cb > 65535) return -1;
  if (K > 0) {
    u8::spmm_slab_map_kernel<<<dim3(n_slabs, n_cb), u8::THREADS, 0, st>>>(
        static_cast<const int32_t*>(A), static_cast<uint8_t*>(live), K, N,
        N % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  u8::spmm_slab_list_kernel<<<n_cb, u8::THREADS, 0, st>>>(
      static_cast<const uint8_t*>(live), static_cast<int16_t*>(slab_list),
      static_cast<int*>(slab_count), n_slabs);
  return static_cast<int>(cudaGetLastError());
}

// Integer operands: F int32 or uint8 (f_dt), A int32 with its slab map
// (``slab_list``, ``slab_count``: block_spmm_slab_map_launch's).  An int32 F
// is first converted to u8 into ``f8`` ([S, K] bytes) with one range flag
// per 128-row tile and 64-deep K slab in ``flags`` (int32, ceil(S/128) *
// ceil(K/64)).  ``slow_slabs`` is a device uint64 that gains one for each
// (block, slab) that ran on the CUDA cores because a value lay outside
// 0..255.
extern "C" int block_spmm_u8_launch(const void* F, int f_dt, const void* A,
                                    const void* slab_list,
                                    const void* slab_count,
                                    const void* col_mask, void* out,
                                    int o_dt, int S, int K, int N,
                                    int bool_mode, void* f8, void* flags,
                                    void* slow_slabs, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (!slow_slabs || !slab_count || (K > 0 && !slab_list)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u8::Args a;
  a.F = F;
  a.A = static_cast<const int32_t*>(A);
  a.slab_list = static_cast<const int16_t*>(slab_list);
  a.slab_count = static_cast<const int*>(slab_count);
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
// both integer): the fp32 CUDA-core kernel over ``n_split`` ranges of K.
// With n_split > 1, ``partial`` is an fp32 workspace of n_split * S * N
// elements that must outlive the launch on ``stream``.
extern "C" int block_spmm_fp32_launch(const void* F, int f_dt, const void* A,
                                      int a_dt, const void* col_mask,
                                      void* out, int o_dt, int S, int K,
                                      int N, int bool_mode, int n_split,
                                      void* partial, void* stream) {
  if (f_dt != DT_FLOAT32 && a_dt != DT_FLOAT32) return -1;
  if (n_split < 1 || n_split > 65535 || (n_split > 1 && !partial)) return -1;
  if (S == 0 || N == 0) return 0;
  f32::Args a;
  a.F = F;
  a.A = A;
  a.mask = static_cast<const float*>(col_mask);
  a.out = out;
  a.partial = static_cast<float*>(partial);
  a.S = S;
  a.K = K;
  a.N = N;
  a.bool_mode = bool_mode;
  a.n_split = n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32::with_types(f_dt, a_dt, o_dt, [&](auto f, auto x, auto o) {
    return f32::launch<typename decltype(f)::type, typename decltype(x)::type,
                       typename decltype(o)::type>(a, st);
  });
}

// Blocks of the fp32 kernel for these dtype codes that one SM holds at
// once, into ``*blocks``; returns the CUDA error code, or -1 for
// unsupported codes.
extern "C" int block_spmm_fp32_blocks_per_sm(int f_dt, int a_dt, int o_dt,
                                             int* blocks) {
  return f32::with_types(f_dt, a_dt, o_dt, [&](auto f, auto x, auto o) {
    return f32::blocks_per_sm<typename decltype(f)::type,
                              typename decltype(x)::type,
                              typename decltype(o)::type>(blocks);
  });
}

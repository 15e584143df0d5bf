// flash_attention: forward attention with an online softmax,
//   O = softmax(Q K^T / sqrt(D) + causal mask) V,
// for q[B, Hq, Sq, D] and k, v[B, Hkv, Sk, D], Hq a multiple of Hkv.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  Its semantics are kept by both routes below: the
// running max m, the running denominator l and the accumulator are fp32;
// the scores are scaled after the dot product; a causally masked score is
// -1e30, with the diagonal shifted by Sk - Sq so that one kernel serves
// prefill and chunked decode; kv tiles wholly above that diagonal are
// skipped; a row whose l is 0 divides by 1; the output is written in the
// input type.  Query head h reads KV head h / (Hq / Hkv) by index (the TPU
// wrapper repeated K and V in memory first).  Keys past Sk and query rows
// past Sq are masked here, so neither length has to be a multiple of a tile.
//
// Bound.  4 * D FLOP per visible (query, key) pair against q, k, v and o
// moved once: at the model shapes (S = 4096, D = 128 or 256) the work is
// bound by operations, on the bf16 tensor cores (989 TFLOP/s) or the fp32
// CUDA cores (67 TFLOP/s); a chunked decode (Sq = 128) in bf16 is bound by
// the bytes of K and V.
//
// Two routes, chosen by the caller's dtype (ops.py counts each).  Both
// split a block's kv tiles over several blocks when the query blocks are
// too few to fill the card (decode): the caller (ops.attention_splits)
// cuts them into n_split chunks of tiles_per_split tiles, each chunk writes
// its unnormalised fp32 accumulator and its rows' m and l to a workspace,
// and merge_kernel combines the chunks by log-sum-exp, in chunk order, into
// the output type.  A chunk that sees no key of a row leaves m = -1e30 and
// l = 0 for it, which the merge weighs by 0.
//
// bf16 -> the tensor-core kernel (flash_tc_kernel), FlashAttention-2 shaped.
//   One 128-thread block owns one (batch, query head, 64-row query tile);
//   each of its 4 warps owns 16 query rows.  K and V tiles (64 keys, 32 at
//   D = 256) are double-buffered in shared memory by cp.async, rows padded
//   by 16 bytes so that ldmatrix reads no bank twice.  S = Q K^T runs as
//   mma.m16n8k16 bf16 -> fp32 (Q fragments held in registers for D <= 128,
//   re-read from shared memory at D = 256, where 128 fp32 accumulators a
//   thread leave no room).  The online softmax runs in registers: a row
//   lives in the 4 lanes of a quad, reduced by two shuffles; exp is expf.
//   P V reuses the score fragments as the A operand; V comes through
//   ldmatrix.trans.
//
//   Why P is split.  The reference multiplies fp32 p by fp32 v, and the
//   port holds a bf16 output to one bf16 step of its plain version.
//   Rounding p to bf16 (8 bits) before the product pushes some outputs of
//   a 4096-key decode past that step (70 of 65,536 in the port's CPU test
//   of these numerics).  So P is split into Ph = bf16(P) and
//   Pl = bf16(P - Ph), and the kernel accumulates Ph V + Pl V: p keeps
//   about 16 bits and v is exact in bf16.  This costs 1.5x the tensor-core
//   work of plain FlashAttention-2.
//
// fp32 -> the CUDA-core kernel (f32::flash_fp32_kernel).  Every product and
//   sum is IEEE fp32 FMA (__fmaf_rn, expf, no fast math), so fp32 inputs
//   keep fp32 accuracy, which TF32 tensor cores would not.  It is bound by
//   the 67 TFLOP/s of the CUDA cores, so every SM must be busy and nearly
//   every issued instruction an FMA:
//   - Split over keys.  At a decode (Sq = 128: 48 blocks of 64 rows for
//     starcoder2-3b) or a short sequence the query blocks leave most SMs
//     idle, so the chunks above fill the card: the caller plans as many
//     as fit one wave of the SM count times this kernel's occupancy
//     (flash_attention_fp32_blocks_per_sm), since a partial second wave
//     costs as much as the first.
//   - An asynchronous ring.  Q is staged once; K and V go into separate
//     row-major buffers of two stages each, rows padded by 16 bytes, filled
//     by 16-byte cp.async.  The next tile's K is in flight from the top of
//     a tile and its V from the middle, each a commit group of its own, so
//     the copies overlap Q K^T, the softmax and P V; two barriers a tile.
//   - 4 x 4 register micro-tiles read by LDS.128 without bank conflicts.
//     Thread (rg, tx) owns query rows rg + 16i (i < 4) and keys tx + 8j
//     (j < 4) of a 32-key tile (128 threads, 8 key lanes a row group).
//     Per 4 d it reads its 4 Q rows (4 consecutive rows a warp, one
//     address each per bank group) and its 4 K rows (8 consecutive rows,
//     D + 4 floats apart, so a warp's 8 addresses meet 8 bank groups) as
//     16-byte vectors for 64 FMAs.  P goes to a tile Pt[key][row] that
//     the writing warp alone reads; P V reads 4 rows of Pt and D/32
//     vectors of V per key for D/2 FMAs, into 4 x D/8 accumulators.  A
//     row's max is reduced over its 8 lanes each tile; l stays a per-lane
//     partial until the end.  At D = 256, 4 x 32 accumulators would not
//     fit beside the scores, so 256 threads take 16 key lanes (2 keys a
//     thread, 4 x 16 accumulators).
//   - Occupancy.  64 x 32 tiles keep 110 KB of shared memory a block at
//     D = 128 (Q 33.8 KB, two K and two V stages 67.6 KB, Pt 8.7 KB), so
//     two blocks share an SM; D = 256 takes 208 KB, one block; D = 64
//     61 KB, three.
//   At starcoder2-3b's prefill this reaches half the fp32 peak on an H100:
//   about four issued instructions in five are FMAs (the rest shared
//   loads, the softmax, copies and barriers), and the 8 warps an SM leave
//   the rest of the gap as stalls.
//
// Both kernels visit query tiles from the last to the first, so under a
// causal mask the longest blocks start first.  wgmma, TMA, one block
// serving all query heads of a KV head, and an error-free split of fp32
// over the tensor cores (3xTF32) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int THREADS = 128;    // 4 warps
constexpr int MERGE_THREADS = 64;
constexpr float MASKED = -1e30f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 64 : 32;    // keys per kv tile
  static constexpr int LDS = D + 8;    // bf16 per shared row: +16 bytes puts
                                       // 8 rows of an ldmatrix on 8 banks
  static constexpr bool Q_REGS = D <= 128;
  static constexpr int SMEM_BYTES = (BQ + 4 * BK) * LDS * 2;   // Q, 2 K, 2 V
};

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x - hi, y - hi): hi + lo keeps about
// 16 bits of each
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// Stage rows [row0, row0 + ROWS) of a [n_rows, D] bf16 matrix into a
// [ROWS][LDS] shared tile; rows past n_rows are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int row0,
                                          int n_rows, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CPR, cc = c % CPR;
    const bool ok = row0 + r < n_rows;
    const bf16* src = g + static_cast<long long>(ok ? row0 + r : 0) * D + cc * 8;
    cp_async16(sm + r * Cfg<D>::LDS + cc * 8, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ ws_o, float* __restrict__ ws_m,
                float* __restrict__ ws_l, int Hq, int Hkv, int Sq, int Sk,
                int causal, float scale, int n_split, int tiles_per_split) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, LDS = C::LDS;
  constexpr int NT_S = BK / 8;    // 8-key score tiles of a warp
  constexpr int NT_O = D / 8;     // 8-column output tiles of a warp
  constexpr int KD = D / 16;      // 16-deep steps of Q K^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LDS]
  bf16* Ks = Qs + BQ * LDS;                       // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                   // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = h / (Hq / Hkv);
  const int offset = Sk - Sq;
  const long long bh = static_cast<long long>(b) * Hq + h;
  const bf16* qg = q + bh * Sq * D;
  const bf16* kg = k + (static_cast<long long>(b) * Hkv + hk) * Sk * D;
  const bf16* vg = v + (static_cast<long long>(b) * Hkv + hk) * Sk * D;
  const int qw = q0 + warp * 16;                  // first row of this warp
  const int qi[2] = {qw + g, qw + g + 8};         // this thread's two rows

  // kv tiles up to the one holding the last key the last real row may see,
  // then this block's chunk of them
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1 + offset) / BK + 1);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};
  unsigned qf[C::Q_REGS ? KD : 1][4];

  if (t_begin < t_end) {
    load_tile<D, BQ>(Qs, qg, q0, Sq, tid);
    load_tile<D, BK>(Ks, kg, t_begin * BK, Sk, tid);
    load_tile<D, BK>(Vs, vg, t_begin * BK, Sk, tid);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile t has landed; tile t-1's buffer is free
    if (t + 1 < t_end) {
      load_tile<D, BK>(Ks + (buf ^ 1) * BK * LDS, kg, (t + 1) * BK, Sk, tid);
      load_tile<D, BK>(Vs + (buf ^ 1) * BK * LDS, vg, (t + 1) * BK, Sk, tid);
      cp_async_commit();
    }
    const bf16* Kb = Ks + buf * BK * LDS;
    const bf16* Vb = Vs + buf * BK * LDS;
    if constexpr (C::Q_REGS) {
      if (t == t_begin) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                              (lane >> 4) * 8);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                       (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < NT_S / 2; ++j) {
        unsigned bk[4];
        ldsm_x4(bk, Kb + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // scale and mask; s[j][e] is row qi[e >> 1], key k0 + 8j + 2tq + (e & 1)
    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw + offset);
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          const bool seen =
              key < Sk && (!causal || key <= qi[e >> 1] + offset);
          x = seen ? x : MASKED;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // online softmax: a row's 16 or 8 values a thread lie in one quad
    float alpha[2], m_use[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      // a row that has seen no key yet keeps p = 0 (a chunk of a split)
      m_use[r] = m_new == MASKED ? 0.f : m_new;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += Ph V + Pl V, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        unsigned bv[4];
        ldsm_x4_trans(bv, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LDS + n * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * n], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * n + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * n + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // epilogue: the normalised bf16 rows, or this chunk's partials
  const long long rows = static_cast<long long>(gridDim.z / n_split) * Hq * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= Sq) continue;
    const long long row = bh * Sq + qi[r];
    if (n_split == 1) {
      const float safe = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + row * D + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[n][2 * r] / safe,
                                  acc[n][2 * r + 1] / safe);
    } else {
      const long long prow = split * rows + row;
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        *reinterpret_cast<float2*>(ws_o + prow * D + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (tq == 0) {
        ws_m[prow] = m_run[r];
        ws_l[prow] = l_run[r];
      }
    }
  }
}

__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// One block per output row: o = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = exp(m_s - max_s m_s), over the chunks in order (two launches give
// the same bits), stored as T: cast to bf16, or as it is for fp32.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_m,
             const float* __restrict__ ws_l, T* __restrict__ o,
             long long rows, int n_split, int D) {
  const long long row = blockIdx.x;
  float m = MASKED;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ws_m[s * rows + row]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s)
    l += expf(ws_m[s * rows + row] - m) * ws_l[s * rows + row];
  const float safe = l == 0.f ? 1.f : l;
  for (int d = threadIdx.x; d < D; d += MERGE_THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += expf(ws_m[s * rows + row] - m) * ws_o[(s * rows + row) * D + d];
    store_out(o + row * D + d, a / safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* ws_o,
           float* ws_ml, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
           int n_split, int tiles_per_split, cudaStream_t st) {
  constexpr int bytes = Cfg<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  float* ws_m = ws_ml;
  float* ws_l = ws_ml ? ws_ml + n_split * rows : nullptr;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B * n_split);
  flash_tc_kernel<D><<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), ws_o, ws_m, ws_l,
      Hq, Hkv, Sq, Sk, causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))), n_split,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  merge_kernel<bf16><<<static_cast<unsigned>(rows), MERGE_THREADS, 0, st>>>(
      ws_o, ws_m, ws_l, static_cast<bf16*>(o), rows, n_split, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace f32 {

constexpr int BQ = 64;          // query rows a block
constexpr int BK = 32;          // keys a kv tile
constexpr int RG = 16;          // row groups: group r owns rows r + 16i, i < 4
constexpr int TM = BQ / RG;     // rows a thread
static_assert(TM == 4, "a thread's rows move as one float4 of Pt");
constexpr int LDP = BQ + 4;     // floats of a row of Pt
constexpr float MASKED = -1e30f;

template <int D>
struct Cfg {
  // key lanes a row group: 8 (128 threads, 4 keys a thread) for D <= 128,
  // 16 (256 threads, 2 keys) at D = 256, where 4 x 32 accumulators a thread
  // would not fit beside the scores
  static constexpr int KL = D <= 128 ? 8 : 16;
  static constexpr int THREADS = RG * KL;
  static constexpr int TN = BK / KL;            // keys a thread
  static constexpr int NG = D / (4 * KL);       // 4-column groups a thread
  static constexpr int LD = D + 4;              // floats of a Q, K or V row
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int TILE_FLOATS = BK * LD;
  // Q, K[2], V[2], Pt
  static constexpr int SMEM_BYTES =
      (Q_FLOATS + 4 * TILE_FLOATS + BK * LDP) * static_cast<int>(sizeof(float));
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : D == 128 ? 2 : 1;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max and sum over the KL lanes that share a query row.
template <int KL>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = KL / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int KL>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = KL / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Start copying rows [row0, row0 + ROWS) of a [n_rows, D] fp32 matrix into
// a [ROWS][LD] shared tile, 16 bytes a copy; rows past n_rows are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* sm, const float* g, int row0,
                                          int n_rows, int tid) {
  constexpr int CPR = D / 4;    // 16-byte chunks a row
  constexpr int THREADS = Cfg<D>::THREADS;
  static_assert(ROWS * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CPR, cc = c % CPR;
    const bool ok = row0 + r < n_rows;
    const float* src =
        g + static_cast<long long>(ok ? row0 + r : 0) * D + cc * 4;
    tc::cp_async16(sm + r * Cfg<D>::LD + cc * 4, src, ok);
  }
}

// One block: query tile blockIdx.x (from the last), head blockIdx.y, batch
// and chunk blockIdx.z.  Thread (rg, tx) owns rows rg + 16i (i < 4), keys
// tx + KL j (j < TN) of each tile, and output columns g * 4 KL + 4 tx + e.
// With n_split == 1 it writes the normalised rows, else its chunk's acc, m
// and l to the workspace.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ ws_o, float* __restrict__ ws_m,
                  float* __restrict__ ws_l, int Hq, int Hkv, int Sq, int Sk,
                  int causal, float scale, int n_split, int tiles_per_split) {
  using C = Cfg<D>;
  constexpr int KL = C::KL, TN = C::TN, NG = C::NG, LD = C::LD;
  constexpr int TILE = C::TILE_FLOATS;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* Ks = Qs + C::Q_FLOATS;       // [2][BK][LD]
  float* Vs = Ks + 2 * TILE;          // [2][BK][LD]
  float* Pt = Vs + 2 * TILE;          // [BK][LDP]: Pt[c][4 rg + i] = p of
                                      // row rg + 16i, key c

  const int tid = threadIdx.x;
  const int tx = tid % KL;
  const int rg = tid / KL;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = h / (Hq / Hkv);
  const int offset = Sk - Sq;
  const long long bh = static_cast<long long>(b) * Hq + h;
  const float* qg = q + bh * Sq * D;
  const float* kg = k + (static_cast<long long>(b) * Hkv + hk) * Sk * D;
  const float* vg = v + (static_cast<long long>(b) * Hkv + hk) * Sk * D;

  // kv tiles up to the one holding the last key the last real row may see,
  // then this block's chunk of them
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1 + offset) / BK + 1);
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float acc[TM][4 * NG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  float m_run[TM], l_part[TM];     // l_part: this lane's share of l
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = MASKED;
    l_part[i] = 0.f;
  }

  if (t_begin < t_end) {
    load_rows<D, BQ>(Qs, qg, q0, Sq, tid);
    load_rows<D, BK>(Ks, kg, t_begin * BK, Sk, tid);
    tc::cp_async_commit();
    load_rows<D, BK>(Vs, vg, t_begin * BK, Sk, tid);
    tc::cp_async_commit();
  }
  const float* qr = Qs + rg * LD;
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const float* Kb = Ks + buf * TILE;
    const float* Vb = Vs + buf * TILE;
    cp_async_wait<1>();   // this thread's copies of K_t (and Q) landed
    __syncthreads();      // everyone's; tile t-1 is consumed, so the other
                          // stage is free
    if (t + 1 < t_end)
      load_rows<D, BK>(Ks + (buf ^ 1) * TILE, kg, (t + 1) * BK, Sk, tid);
    tc::cp_async_commit();

    // S = Q K^T for rows rg + 16i and keys tx + KL j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    const float* kr = Kb + tx * LD;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qr + i * RG * LD + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        c[j] = *reinterpret_cast<const float4*>(kr + j * KL * LD + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = __fmaf_rn(a[i].x, c[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].y, c[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].z, c[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].w, c[j].w, s[i][j]);
        }
    }

    // scale, mask (only where the tile crosses Sk or the block's causal
    // diagonal) and the online softmax update, in registers
    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + offset);
    float alpha[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + rg + RG * i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int key = k0 + tx + KL * j;
          x = key < Sk && (!causal || key <= qi + offset) ? x : MASKED;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], row_max<KL>(mx));
      alpha[i] = expf(m_run[i] - m_new);
      // a row that has seen no key yet keeps p = 0 (a chunk of a split)
      const float m_use = m_new == MASKED ? 0.f : m_new;
      m_run[i] = m_new;
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        lsum += s[i][j];
      }
      l_part[i] = l_part[i] * alpha[i] + lsum;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + KL * j) * LDP + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_async_wait<1>();   // this thread's copies of V_t landed
    __syncthreads();      // everyone's, and Pt is written
    if (t + 1 < t_end)
      load_rows<D, BK>(Vs + (buf ^ 1) * TILE, vg, (t + 1) * BK, Sk, tid);
    tc::cp_async_commit();

    // O = alpha O + P V
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha[i];
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * LDP + rg * 4);
      const float p[TM] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vb + c * LD + g * 4 * KL + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][g * 4 + 0] = __fmaf_rn(p[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = __fmaf_rn(p[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = __fmaf_rn(p[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = __fmaf_rn(p[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
  tc::cp_async_wait_all();

  // epilogue: the normalised rows, or this chunk's partials
  float l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) l[i] = row_sum<KL>(l_part[i]);
  const long long rows = static_cast<long long>(gridDim.z / n_split) * Hq * Sq;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + rg + RG * i;
    if (qi >= Sq) continue;
    const long long row = bh * Sq + qi;
    float* dst = n_split == 1 ? o + row * D : ws_o + (split * rows + row) * D;
    // a chunk's partials are stored raw (x / 1 is x)
    const float den = n_split == 1 && l[i] != 0.f ? l[i] : 1.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(dst + g * 4 * KL + tx * 4) =
          make_float4(acc[i][g * 4] / den, acc[i][g * 4 + 1] / den,
                      acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den);
    if (n_split > 1 && tx == 0) {
      ws_m[split * rows + row] = m_run[i];
      ws_l[split * rows + row] = l[i];
    }
  }
}

// Lets the kernel use its tiles (above 48 KB of shared memory), with the
// largest shared-memory carveout so that two blocks fit an SM at D = 128.
template <int D>
cudaError_t set_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_fp32_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* ws_o,
           float* ws_ml, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
           int n_split, int tiles_per_split, cudaStream_t st) {
  cudaError_t err = set_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  float* ws_m = ws_ml;
  float* ws_l = ws_ml ? ws_ml + n_split * rows : nullptr;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B * n_split);
  flash_fp32_kernel<D><<<grid, Cfg<D>::THREADS, Cfg<D>::SMEM_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), ws_o, ws_m, ws_l,
      Hq, Hkv, Sq, Sk, causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))), n_split,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  tc::merge_kernel<float>
      <<<static_cast<unsigned>(rows), tc::MERGE_THREADS, 0, st>>>(
          ws_o, ws_m, ws_l, static_cast<float*>(o), rows, n_split, D);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the kernel at head_dim D.
template <int D>
int blocks_per_sm(int* blocks) {
  cudaError_t err = set_smem<D>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_fp32_kernel<D>, Cfg<D>::THREADS, Cfg<D>::SMEM_BYTES);
  return static_cast<int>(err);
}

}  // namespace f32

}  // namespace

// C entry points (bound with ctypes).  Each launch entry launches on
// ``stream`` and returns the cudaGetLastError() code of its launches, or -1
// for an unsupported head_dim, head grouping, split or alignment, or
// Sk < Sq.  With n_split > 1, ws_o holds n_split * B * Hq * Sq * D floats
// and ws_ml 2 * n_split * B * Hq * Sq (m, then l); each of the n_split
// chunks covers tiles_per_split kv tiles of the route's keys a tile.

static bool bad_split(int Hq, int Hkv, int Sq, int Sk, int n_split,
                      int tiles_per_split, const void* ws_o,
                      const void* ws_ml) {
  return Hkv <= 0 || Hq % Hkv != 0 || Sk < Sq || n_split < 1 ||
         tiles_per_split < 1 || (n_split > 1 && (!ws_o || !ws_ml));
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// fp32 q, k, v and o (16-byte aligned): the CUDA-core kernel, 32 keys a
// kv tile at every head_dim.
extern "C" int flash_attention_fp32_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* ws_o, void* ws_ml, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int D, int causal, int n_split,
                                           int tiles_per_split,
                                           void* stream) {
  if (bad_split(Hq, Hkv, Sq, Sk, n_split, tiles_per_split, ws_o, ws_ml) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (n_split > 1 && !aligned16(ws_o)))
    return -1;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  switch (D) {
    case 64:
      return f32::launch<64>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk, causal,
                             n_split, tiles_per_split, st);
    case 128:
      return f32::launch<128>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk,
                              causal, n_split, tiles_per_split, st);
    case 256:
      return f32::launch<256>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk,
                              causal, n_split, tiles_per_split, st);
  }
  return -1;
}

// Blocks of the fp32 kernel at head_dim D that one SM of the current device
// holds at once (the CUDA occupancy calculator), for the caller's split
// planner.  Returns a CUDA error code, or -1 for an unsupported D.
extern "C" int flash_attention_fp32_blocks_per_sm(int D, int* blocks) {
  switch (D) {
    case 64: return f32::blocks_per_sm<64>(blocks);
    case 128: return f32::blocks_per_sm<128>(blocks);
    case 256: return f32::blocks_per_sm<256>(blocks);
  }
  return -1;
}

// bf16 q, k, v and o (16-byte aligned): the tensor-core kernel, 64 keys a
// kv tile (32 at D = 256).
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* ws_o, void* ws_ml, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int D, int causal, int n_split,
                                           int tiles_per_split,
                                           void* stream) {
  if (bad_split(Hq, Hkv, Sq, Sk, n_split, tiles_per_split, ws_o, ws_ml))
    return -1;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk, causal,
                            n_split, tiles_per_split, st);
    case 128:
      return tc::launch<128>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk, causal,
                             n_split, tiles_per_split, st);
    case 256:
      return tc::launch<256>(q, k, v, o, wo, wml, B, Hq, Hkv, Sq, Sk, causal,
                             n_split, tiles_per_split, st);
  }
  return -1;
}

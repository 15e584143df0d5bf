// segment_agg: fused PNA aggregators (mean, max, min, std) over bucketed
// neighbour messages msg[N, W, D] with slot validity valid[N, W].
//
// Replaces the TPU kernel repro/kernels/segment_agg.py::segment_multi_agg
// (body _agg_kernel).  Over the valid slots of row n, for every column d:
//   mean = sum / max(cnt, 1)
//   max, min (sentinels -3.4e38 / 3.4e38)
//   std  = sqrt(max(sum_sq / max(cnt, 1) - mean^2, 0) + eps)
// the reference's formula, not Welford, so that both round alike; a row
// with no valid slot gives 0 in all four outputs.  Sums ascend in w, the
// square is rounded before it is added, and mean^2 is subtracted with one
// rounding (an FMA), as the reference's compiled expression takes it.  A
// NaN of a valid slot reaches all four outputs, as jnp.max / jnp.min
// propagate it (fmaxf / fminf would drop it).  An invalid slot is never
// read.  The reference multiplies one by 0, so a NaN or inf there would
// reach its mean and std but not these: invalid slots must hold finite
// values, as bucketize_messages leaves them (zeros).
//
// Types.  msg is read as fp32 or bf16 and cast to fp32 in registers; valid
// is read as bytes (a bool or uint8 tensor).  The four outputs are fp32.
//
// Bound.  No data is reused: the kernel is bound by memory.  It must read
// the N·W validity bytes and the D values of each valid slot, and write
// 4·N·D floats.  At the SNB shape (N = 15,860, W = 45, D = 75 from 44,698
// edges) 6.3% of the slots are valid: 33.2 MB in fp32 (13 MB of messages
// out of the 214 MB bucketed tensor, 19 MB of outputs), 0.0099 ms at 3.35
// TB/s.  At ten times that graph (N = 158,600, W = 53) it is 332 MB, 6.6
// times the 50 MB L2, and 0.0992 ms.
//
// Design.  One warp owns one row; a block of 8 warps takes 8 rows, and a
// ragged last block lets its spare warps return.
//   * Validity once per warp: for each 32-slot chunk of the row, lane l
//     reads byte w0 + l (one coalesced load), __ballot_sync makes the
//     chunk's mask, __popc counts it, and the warp walks its set bits with
//     __ffs.  Every lane takes the same slots, so nothing diverges, and a
//     row costs ceil(W / 32) validity loads plus its valid slots.  The next
//     chunk's byte is loaded before the current chunk is walked.
//   * Columns across lanes: lane l owns columns l, l + 32, ... (C of them,
//     a template parameter chosen from D; at D = 75, C = 3 and 75 of 96
//     lane-columns are busy).  Wider rows split into column chunks of 128
//     on the grid's second axis, each walking the row's validity again
//     (from L2).
//   * Bytes in flight: with few valid slots a row, the rows in flight feed
//     the memory, and registers decide how many fit, so the kernel keeps
//     them low (one row per warp, no persistent state).  The loads of up
//     to GROUP = 4 valid slots are issued before any is folded, into raw
//     registers that are widened to fp32 only at the fold: widening bf16
//     right after its load lets the compiler reuse one register and wait
//     for each load in turn.  Slots are folded in ascending w.  Offsets
//     within a row are 32-bit (the launcher refuses W·D >= 2^31), so an
//     address costs one wide multiply-add.
//
// Times on an H100, and the variants that were not kept: PERF.md,
// section 6, PR 14.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // rows a block holds at a time
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 4;                // valid slots loaded before a fold
constexpr int MAX_COLS = 4;             // columns a lane owns, at most
constexpr unsigned FULL = 0xffffffffu;

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// One value of a message row: loaded raw (``load``), so that every load of
// a group is in flight before the first is widened to fp32 (``widen``;
// bf16 widens exactly, by a shift)
template <typename T>
struct Msg;

template <>
struct Msg<float> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float widen(Raw r) { return r; }
};

template <>
struct Msg<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float widen(Raw r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
agg_kernel(const T* __restrict__ msg, const uint8_t* __restrict__ valid,
           float* __restrict__ mean_out, float* __restrict__ max_out,
           float* __restrict__ min_out, float* __restrict__ std_out, int N,
           int W, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                   // the whole warp: n is the warp's
  // this lane's first column; its column j lies 32 * j columns later
  const int col = blockIdx.y * (32 * C) + lane;
  bool live[C];
#pragma unroll
  for (int j = 0; j < C; ++j) live[j] = col + 32 * j < D;

  const uint8_t* vrow = valid + static_cast<long long>(n) * W;
  const T* mrow = msg + static_cast<long long>(n) * W * D + col;
  uint8_t vb = lane < W ? __ldg(vrow + lane) : 0;
  float sum[C], sq[C], mx[C], mn[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    sum[j] = 0.f;
    sq[j] = 0.f;
    mx[j] = -3.4e38f;
    mn[j] = 3.4e38f;
  }
  int cnt = 0;
  for (int w0 = 0; w0 < W; w0 += 32) {
    unsigned mask = __ballot_sync(FULL, vb != 0);
    const int w1 = w0 + 32 + lane;
    vb = w1 < W ? __ldg(vrow + w1) : 0;    // the row's next chunk
    cnt += __popc(mask);
    while (mask) {
      // offsets in the row of the next GROUP valid slots, in ascending w
      int off[GROUP];
      bool has[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        has[g] = mask != 0;
        off[g] = has[g] ? (w0 + __ffs(mask) - 1) * D : 0;
        mask &= mask - 1;
      }
      typename Msg<T>::Raw raw[GROUP][C];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          if (has[g] && live[j]) {
            raw[g][j] = Msg<T>::load(mrow + off[g] + 32 * j);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (!has[g]) break;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          if (!live[j]) continue;
          const float x = Msg<T>::widen(raw[g][j]);
          sum[j] += x;
          sq[j] += __fmul_rn(x, x);          // rounded product, as m * m
          mx[j] = (x > mx[j] || x != x) ? x : mx[j];
          mn[j] = (x < mn[j] || x != x) ? x : mn[j];
        }
      }
    }
  }

  const long long out = static_cast<long long>(n) * D + col;
  const float safe = static_cast<float>(cnt);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (!live[j]) continue;
    float o_mean = 0.f, o_max = 0.f, o_min = 0.f, o_std = 0.f;
    if (cnt > 0) {
      o_mean = sum[j] / safe;
      const float meansq = sq[j] / safe;
      // meansq - mean^2 with one rounding; the clamp at 0 keeps a NaN
      float var = __fmaf_rn(-o_mean, o_mean, meansq);
      var = (var > 0.f || var != var) ? var : 0.f;
      o_std = sqrtf(var + eps);
      o_max = mx[j];
      o_min = mn[j];
    }
    const long long at = out + 32 * j;
    mean_out[at] = o_mean;
    max_out[at] = o_max;
    min_out[at] = o_min;
    std_out[at] = o_std;
  }
}

template <typename T, int C>
int run(const void* msg, const uint8_t* valid, float* const* o, int N, int W,
        int D, float eps, cudaStream_t st) {
  const int chunks = (D + 32 * C - 1) / (32 * C);
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + WARPS - 1) / WARPS),
                  static_cast<unsigned>(chunks));
  agg_kernel<T, C><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(msg), valid, o[0], o[1], o[2], o[3], N, W, D,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* msg, const uint8_t* valid, float* const* o, int N,
             int W, int D, float eps, cudaStream_t st) {
  switch ((D + 31) / 32) {
    case 1:
      return run<T, 1>(msg, valid, o, N, W, D, eps, st);
    case 2:
      return run<T, 2>(msg, valid, o, N, W, D, eps, st);
    case 3:
      return run<T, 3>(msg, valid, o, N, W, D, eps, st);
    default:
      return run<T, MAX_COLS>(msg, valid, o, N, W, D, eps, st);
  }
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns the
// cudaGetLastError() code of the launch, or -1 for an unsupported type code.
extern "C" int segment_agg_launch(const void* msg, int msg_dt,
                                  const void* valid, void* mean_out,
                                  void* max_out, void* min_out, void* std_out,
                                  int N, int W, int D, float eps,
                                  void* stream) {
  if (N == 0 || D == 0) return 0;
  if (static_cast<long long>(W) * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);   // offsets in a row
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* const o[4] = {static_cast<float*>(mean_out),
                       static_cast<float*>(max_out),
                       static_cast<float*>(min_out),
                       static_cast<float*>(std_out)};
  switch (msg_dt) {
    case DT_FLOAT32:
      return dispatch<float>(msg, v, o, N, W, D, eps, st);
    case DT_BFLOAT16:
      return dispatch<__nv_bfloat16>(msg, v, o, N, W, D, eps, st);
    default:
      return -1;
  }
}

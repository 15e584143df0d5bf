// segment_agg: fused PNA aggregators (mean, max, min, std) over bucketed
// neighbour messages msg[N, W, D] with slot validity valid[N, W].
//
// Replaces the TPU kernel repro/kernels/segment_agg.py::segment_multi_agg
// (body _agg_kernel).  Over the valid slots of row n, for every column d:
//   mean = sum / max(cnt, 1)
//   max, min (sentinels -3.4e38 / 3.4e38)
//   std  = sqrt(max(sum_sq / max(cnt, 1) - mean^2, 0) + eps)
// the reference's formula, not Welford, so that both round alike; a row
// with no valid slot gives 0 in all four outputs.
//
// Types.  msg is read as fp32 or bf16 and cast to fp32 in registers; valid
// is read as bytes (a bool or uint8 tensor).  The four outputs are fp32.
//
// Bound.  No data is reused: the kernel is bound by memory.  It reads the
// valid bytes and the msg rows of valid slots only (the reference
// multiplies an invalid slot by 0, so no output depends on finite
// padding), and writes 4 * N * D floats.  At the SNB shape (N = 15,860,
// W = 45, D = 75 from 44,698 edges) 6.3% of the slots are valid, so the
// kernel reads about 13 MB of fp32 messages out of the 214 MB bucketed
// tensor, and writes 19 MB.
//
// Design (simple first).  One thread owns one (row, column) pair and walks
// the W slots of its row, accumulating sum, sum of squares, max and min in
// fp32 registers: one pass over msg.  Threads are numbered row-major over
// (n, d), so a warp reads consecutive columns of one slot (coalesced, at
// most two rows per warp) and skips a slot together when it is invalid.
// Ragged N and D are handled by the flat index, so nothing is padded (the
// TPU wrapper padded N to 8 and D to 128 with a copy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
agg_kernel(const T* __restrict__ msg, const uint8_t* __restrict__ valid,
           float* __restrict__ mean_out, float* __restrict__ max_out,
           float* __restrict__ min_out, float* __restrict__ std_out, int N,
           int W, int D, float eps) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(N) * D) return;
  const int n = static_cast<int>(idx / D);
  const int d = static_cast<int>(idx % D);
  const uint8_t* vrow = valid + static_cast<long long>(n) * W;
  const T* mrow = msg + static_cast<long long>(n) * W * D + d;

  float sum = 0.f, sq = 0.f, mx = -3.4e38f, mn = 3.4e38f;
  int cnt = 0;
  for (int w = 0; w < W; ++w) {
    if (!vrow[w]) continue;
    const float x = to_f32(mrow[static_cast<long long>(w) * D]);
    sum += x;
    sq += __fmul_rn(x, x);   // rounded product, as the reference's m * m
    mx = fmaxf(mx, x);
    mn = fminf(mn, x);
    ++cnt;
  }
  float o_mean = 0.f, o_max = 0.f, o_min = 0.f, o_std = 0.f;
  if (cnt > 0) {
    const float safe = static_cast<float>(cnt);
    o_mean = sum / safe;
    const float meansq = sq / safe;
    // meansq - mean^2 with one rounding (the reference's compiled form):
    // where the variance is near 0 that residual decides the std
    o_std = sqrtf(fmaxf(__fmaf_rn(-o_mean, o_mean, meansq), 0.f) + eps);
    o_max = mx;
    o_min = mn;
  }
  mean_out[idx] = o_mean;
  max_out[idx] = o_max;
  min_out[idx] = o_min;
  std_out[idx] = o_std;
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns the
// cudaGetLastError() code of the launch, or -1 for an unsupported type code.
extern "C" int segment_agg_launch(const void* msg, int msg_dt,
                                  const void* valid, void* mean_out,
                                  void* max_out, void* min_out, void* std_out,
                                  int N, int W, int D, float eps,
                                  void* stream) {
  const long long total = static_cast<long long>(N) * D;
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o[4] = {static_cast<float*>(mean_out), static_cast<float*>(max_out),
                 static_cast<float*>(min_out), static_cast<float*>(std_out)};
  switch (msg_dt) {
    case DT_FLOAT32:
      agg_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(msg), v, o[0], o[1], o[2], o[3], N, W, D,
          eps);
      break;
    case DT_BFLOAT16:
      agg_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(msg), v, o[0], o[1], o[2], o[3],
          N, W, D, eps);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

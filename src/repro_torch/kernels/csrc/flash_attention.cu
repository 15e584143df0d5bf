// flash_attention: forward attention with an online softmax,
//   O = softmax(Q K^T / sqrt(D) + causal mask) V,
// for q[B, Hq, Sq, D] and k, v[B, Hkv, Sk, D], Hq a multiple of Hkv.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  Its semantics are kept: the running max m, the
// running denominator l and the accumulator are fp32; the scores are scaled
// after the dot product; a causally masked score is -1e30, with the
// diagonal shifted by Sk - Sq so that one kernel serves prefill and chunked
// decode; kv tiles wholly above that diagonal are skipped; a row whose l is
// 0 divides by 1; the output is written in the input type.  Query head h
// reads KV head h / (Hq / Hkv) by index (the TPU wrapper repeated K and V
// in memory first).  Keys past Sk and query rows past Sq are masked here,
// so neither length has to be a multiple of the tile.
//
// Types.  q, k and v are read as fp32 or bf16 and cast to fp32 as they are
// staged in shared memory; every product and sum is IEEE fp32 on the CUDA
// cores (expf, no fast math), so fp32 inputs keep fp32 accuracy.
//
// Bound.  4 * D FLOP per visible (query, key) pair against q, k, v and o
// moved once: at the model shapes (S = 4096, D = 128 or 256) the kernel is
// bound by operations, on the bf16 tensor cores (989 TFLOP/s) for a bf16
// caller.  This first version runs on the fp32 CUDA cores (67 TFLOP/s), so
// it is at least 15x over that bound by design; wgmma, TMA and a split over
// keys for short query blocks are later work.
//
// Design (simple first).  One 256-thread block owns one (batch, query head,
// 64-row query tile).  The query tile is staged once, transposed, in shared
// memory; each 64-key tile of K is staged transposed and then replaced by
// the same tile of V, so shared memory holds Qt[D][68], one K/V buffer and
// Pt[64][68] (156 KB at D = 256, 87 KB at D = 128, two blocks per SM).
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: it
// computes the 4 x 4 scores of keys 4tx..4tx+3 from 16-byte shared reads,
// reduces the row max and sum across the 16 lanes of its row with warp
// shuffles (the 16 lanes of a row are one half-warp), keeps m and l of its
// rows in registers, and accumulates the 4 x D/16 output columns
// 64c + 4tx + {0..3} from Pt and V.  Tiles of query rows run from the last
// to the first, so under a causal mask the longest blocks start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int LDT = 68;       // leading dim of the transposed tiles: 16-byte
                              // rows, and a transposing store 4-way at most
constexpr float MASKED = -1e30f;

enum DType { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// Max and sum over the 16 lanes that share a query row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr int smem_floats() {
  return 2 * D * LDT + BK * LDT;   // Qt, the K/V buffer, Pt
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 128 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Sk, int causal, float scale) {
  static_assert(D % 64 == 0 && D <= 256, "head_dim must be 64, 128 or 256");
  static_assert(D * LDT >= BK * D, "the K/V buffer must hold a V tile");
  constexpr int NC = D / 16;   // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // [D][LDT]: Qt[d][r] = q[q0 + r][d]
  float* KV = smem + D * LDT;     // Kt[D][LDT], then V[BK][D]
  float* Pt = KV + D * LDT;       // [BK][LDT]: Pt[c][r] = p[r][c]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = Sk - Sq;

  const T* qg = q + ((static_cast<long long>(b) * Hq + h) * Sq) * D;
  const T* kg = k + ((static_cast<long long>(b) * Hkv + hk) * Sk) * D;
  const T* vg = v + ((static_cast<long long>(b) * Hkv + hk) * Sk) * D;
  T* og = o + ((static_cast<long long>(b) * Hq + h) * Sq) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qt[d * LDT + r] =
        q0 + r < Sq ? to_f32(qg[static_cast<long long>(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // kv tiles up to the one holding the last key the last real row may see
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      KV[d * LDT + c] =
          k0 + c < Sk ? to_f32(kg[static_cast<long long>(k0 + c) * D + d]) : 0.f;
    }
    __syncthreads();   // Qt (first tile) and Kt are staged

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&KV[d * LDT + tx * 4]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float kc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qa[i], kc[j], s[i][j]);
    }
    __syncthreads();   // every thread is done with Kt: the buffer takes V

    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      KV[c * D + d] =
          k0 + c < Sk ? to_f32(vg[static_cast<long long>(k0 + c) * D + d]) : 0.f;
    }

    // scale, mask and the online softmax update, all in registers
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mloc = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool seen = !causal || kj <= qi + offset;
        s[i][j] = seen ? s[i][j] * scale : MASKED;
        if (kj < Sk) mloc = fmaxf(mloc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mloc));
      alpha[i] = expf(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const float p = kj < Sk ? expf(s[i][j] - m_new) : 0.f;
        Pt[(tx * 4 + j) * LDT + ty * 4 + i] = p;
        lsum += p;
      }
      l[i] = l[i] * alpha[i] + row_sum(lsum);
      m[i] = m_new;
    }
    __syncthreads();   // V and Pt are staged

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * LDT + ty * 4]);
      const float p[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&KV[c * D + g * 64 + tx * 4]);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = __fmaf_rn(p[i], vc[j], acc[i][g * 4 + j]);
      }
    }
    __syncthreads();   // V and Pt are read: the next tile may overwrite them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < NC / 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        og[static_cast<long long>(qi) * D + g * 64 + tx * 4 + j] =
            from_f32<T>(acc[i][g * 4 + j] / safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, cudaStream_t st) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, int causal,
             cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, st);
  }
  return -1;
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns the
// cudaGetLastError() code of the launch, or -1 for an unsupported type code,
// head_dim or head grouping, or Sk < Sq.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dt, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D,
                                      int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < Sq) return -1;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_FLOAT32:
      return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, st);
    case DT_BFLOAT16:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                     causal, st);
  }
  return -1;
}

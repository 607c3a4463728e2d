// Latent (MLA) single-token decode attention for Hopper (sm_90a), in the
// absorbed form of DeepSeek-V3.
//
// Replaces no TPU kernel: the JAX package has no latent attention. Added for
// the DeepSeek-V3 backbone (models/mla_moe.py), whose cache holds one row of
// R + P values a position, shared by every head: the normalised latent c (R
// = kv_lora_rank, 512) and the rotated key k_pe (P = qk_rope_head_dim, 64).
// K1 (decode_attention.cu) assumes per-head K and V of equal width and
// cannot read it.
//
// For one row b and head h of layer `layer` of the cache (L, B, T, R + P),
// with the absorbed query q[b, h] = [W_UK,h^T q_nope | q_pe] (R + P, bf16):
//   s_t = (q . cache[t]) * scale + bias[b, t]        (f32 sums, q and the
//                                                      cache read as bf16)
//   p   = softmax(s)                                  (f32)
//   out[b, h] = sum_t p_t * cache[t, :R]              (f32 sums, bf16 out)
// The caller applies W_UV,h to `out` (ops/mla.py). The f32 softmax is not
// rounded to bf16 before P.C: the plain version (`mla_decode_plain`) is the
// same arithmetic in another summation order.
//
// Bound: bytes. A call reads one layer of the cache at the rows' lengths,
// B * T * (R + P) * 2 bytes (8 rows of 280 keys: 2.58 MB, 0.77 us at 3.35
// TB/s), against 4 * B * H * T * (R + P) flops (0.04 GFLOP), far below the
// tensor cores' line.
//
// Design: the cache length is split over blocks as K1 splits it. Block (s, b)
// takes keys [s * per, (s + 1) * per) of row b for ALL H heads, so each
// cached row is read from device memory once for the 16 heads:
//   (a) mla_split: the H absorbed queries are held in shared memory as f32;
//       one warp a key reads the row with 16-byte loads and forms the H
//       scores (warp-shuffle sums); then per head the local max m, the sum
//       l of exp(s - m), and the unnormalised partial P.C over the range
//       (thread = 8 columns x H / 4 heads, reading the rows again from L2).
//       m, l and the partial row go to scratch.
//   (b) mla_combine: block (b, h) sums the S partials in the order
//       s = 0..S-1 with the weights exp(m_s - M) / L, and writes bf16.
// Two launches a call (the wrapper counts one). The scratch, B * S * H *
// (R + 2) floats, comes from the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 16;
constexpr int kMaxW = 576;     // R + P
constexpr int kMaxR = 512;
constexpr int kMaxPer = 128;   // keys a block

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
mla_split(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
          const float* __restrict__ bias, float* __restrict__ scratch, int B, int T, int H,
          int R, int P, int layer, int per, int S, float scale) {
  __shared__ __align__(16) float qs[kMaxH * kMaxW];
  __shared__ float sc[kMaxH * kMaxPer];
  const int s = blockIdx.x, b = blockIdx.y;
  const int W = R + P;
  const int t0 = s * per;
  const int n = min(per, T - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < H * W; i += kThreads)
    qs[i] = __bfloat162float(q[(size_t)b * H * W + i]);
  __syncthreads();

  const __nv_bfloat16* rows = cache + (((size_t)layer * B + b) * T + t0) * W;
  const int nv = W / 8;  // 16-byte vectors a row
  for (int j = warp; j < n; j += kWarps) {
    float acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
    for (int v = lane; v < nv; v += 32) {
      float k[8];
      load8(rows + (size_t)j * W + v * 8, k);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h < H) {
          const float4 a = *reinterpret_cast<const float4*>(qs + h * W + v * 8);
          const float4 c = *reinterpret_cast<const float4*>(qs + h * W + v * 8 + 4);
          acc[h] += a.x * k[0] + a.y * k[1] + a.z * k[2] + a.w * k[3] +
                    c.x * k[4] + c.y * k[5] + c.z * k[6] + c.w * k[7];
        }
      }
    }
    const float bt = bias[(size_t)b * T + t0 + j];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h < H) {
        const float tot = warp_sum(acc[h]);
        if (lane == 0) sc[h * kMaxPer + j] = tot * scale + bt;
      }
    }
  }
  __syncthreads();

  // per head: local max and sum; the scores become exp(s - m)
  float* part = scratch + ((size_t)b * S + s) * H * (R + 2);
  for (int h = warp; h < H; h += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[h * kMaxPer + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = __expf(sc[h * kMaxPer + j] - m);
      sc[h * kMaxPer + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part[h * (R + 2)] = m;
      part[h * (R + 2) + 1] = l;
    }
  }
  __syncthreads();

  // partial P.C: thread = 8 columns of c for heads hg, hg + 4, ...
  const int groups = R / 8;
  const int cg = threadIdx.x % 64, hg = threadIdx.x / 64;
  if (cg < groups) {
    float acc[kMaxH / 4][8];
#pragma unroll
    for (int i = 0; i < kMaxH / 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int j = 0; j < n; ++j) {
      float c[8];
      load8(rows + (size_t)j * W + cg * 8, c);
#pragma unroll
      for (int i = 0; i < kMaxH / 4; ++i) {
        const int h = hg + 4 * i;
        if (h < H) {
          const float p = sc[h * kMaxPer + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] += p * c[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxH / 4; ++i) {
      const int h = hg + 4 * i;
      if (h < H) {
        float* o = part + h * (R + 2) + 2 + cg * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = acc[i][e];
      }
    }
  }
}

__global__ void __launch_bounds__(128)
mla_combine(const float* __restrict__ scratch, __nv_bfloat16* __restrict__ out, int H, int R,
            int S) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s)
    M = fmaxf(M, scratch[(((size_t)b * S + s) * H + h) * (R + 2)]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* p = scratch + (((size_t)b * S + s) * H + h) * (R + 2);
    L += p[1] * __expf(p[0] - M);
  }
  const float inv = 1.f / L;
  for (int c = threadIdx.x; c < R; c += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = scratch + (((size_t)b * S + s) * H + h) * (R + 2);
      o += __expf(p[0] - M) * p[2 + c];
    }
    out[(size_t)bh * R + c] = __float2bfloat16_rn(o * inv);
  }
}

}  // namespace

// Scratch bytes of a call: B * S * H * (R + 2) floats.
extern "C" size_t genvc_mla_decode_scratch_bytes(int B, int H, int R, int S) {
  return (size_t)B * S * H * (R + 2) * sizeof(float);
}

// out (B, H, R) bf16 = softmax(q . cache[layer, b]^T * scale + bias) . cache[layer, b, :, :R].
// q (B, H, R + P) bf16 contiguous; cache (L, B, T, R + P) bf16 contiguous,
// 16-byte aligned; bias (B, T) f32; scratch from the size above for S =
// ceil(T / per). H <= 16, R and P multiples of 8, R <= 512, R + P <= 576,
// 1 <= per <= 128. Two launches on `stream`; returns cudaGetLastError() of
// the second (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int genvc_mla_decode(const void* q, const void* cache, const float* bias, void* out,
                                float* scratch, int L, int B, int T, int H, int R, int P,
                                int layer, int per, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxH || R <= 0 || R % 8 || R > kMaxR || P < 0 ||
      P % 8 || R + P > kMaxW || layer < 0 || layer >= L || per < 1 || per > kMaxPer ||
      ((uintptr_t)cache & 15))
    return (int)cudaErrorInvalidValue;
  const int S = (T + per - 1) / per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_split<<<dim3(S, B), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache), bias,
      scratch, B, T, H, R, P, layer, per, S, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_combine<<<B * H, 128, 0, st>>>(scratch, static_cast<__nv_bfloat16*>(out), H, R, S);
  return (int)cudaGetLastError();
}

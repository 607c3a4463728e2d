// Single-token cached decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels genvc_tpu/ops/decode_attention.py
// `decode_attention_layer` (body `_decode_attn_layer_kernel`),
// `decode_attention` (body `_decode_attn_kernel`, run here with L = 1) and
// `decode_attention_update_layer` (body `_decode_attn_update_kernel`: the
// same attention after writing each row's new K/V at its own position, the
// per-row decode step of a serving pool).
//
// For one (row b, head h) of layer `layer` of the stacked cache
// (L, B, H, T, hd):   out = softmax(q . K^T / sqrt(hd) + bias) . V
//   * q is rounded to bf16; K and V are read at their storage type (bf16 or
//     e4m3) and widened in registers (e4m3 through the hardware cvt of
//     __nv_cvt_fp8x2_to_halfraw2 — exact, e4m3 fits in half);
//   * logits accumulate in f32, are scaled by 1/sqrt(hd), then the bias is
//     added; the softmax runs in f32;
//   * probabilities are rounded to bf16 before P.V, which accumulates in f32;
//   * the output takes q's type (bf16 or f32).
// The layer is read at an offset into the full stacked cache; no slice is
// copied.
//
// Bound: bytes. Per launch the kernel must read K and V of one layer,
// 2 * B * H * T * hd * sizeof(cache) bytes (1.57 MB at B=1, H=4, T=384,
// hd=256, bf16: 0.47 us at 3.35 TB/s); its arithmetic is 4 * B*H*T*hd flops,
// far below the tensor-core line. The update variant adds one (H, hd) row of
// K and V written per (row, head): 2 * B * H * hd elements, against the same
// full-layer read. Design: one block of 256 threads per
// (row, head); every K/V row is read once with 16-byte (bf16) or 8-byte (e4m3)
// vector loads, one warp per key row for q.K, then all threads split the
// (T, hd) block by 8-wide column chunks and key-row groups for P.V. At the
// streaming shape (B*H = 4 blocks on 132 SMs) the card is mostly idle:
// splitting T across blocks with a combine pass (flash-decoding) is the next
// step, left to a later change.
//
// Update variant (decode_attention_update_layer): block (b, h) rounds the
// new K and V rows to the cache type (bf16 round-to-nearest-even, or e4m3
// with the rounding and overflow rule of torch's float8_e4m3fn conversion),
// stores them once at row pos[b] of its own (T, hd) block (dropped when
// pos[b] is outside [0, T): an idle pool slot runs past the cache end), and
// keeps their widened values in shared memory. The attention never reads row
// pos[b] back from global memory (the __ldg path is not coherent with a store
// of the same kernel): at t == pos[b] it takes the shared copy, i.e. the value
// as stored. Everything else is the attention above, in the same order, so the
// result equals the cache write followed by decode_attention_layer bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // cache elements per vector load
constexpr int kMaxHd = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// torch's float -> float8_e4m3fn conversion (round to nearest even; an
// overflow saturates to 448 or becomes NaN, as `satfinite` says: torch
// versions differ, the wrapper passes its own torch's rule). Returns the bits.
__device__ __forceinline__ uint8_t e4m3_bits(float f, int satfinite) {
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t r;
  if (bits >= (1087u << 20)) {              // |f| >= 480, inf or NaN
    r = (bits > 0x7F800000u || !satfinite) ? 0x7Fu : 0x7Eu;
  } else if (bits < (121u << 23)) {         // below 2^-6: subnormal
    const float denorm = __uint_as_float(141u << 23);
    r = __float_as_uint(__fadd_rn(__uint_as_float(bits), denorm)) - (141u << 23);
  } else {
    const uint32_t odd = (bits >> 20) & 1u;
    bits += ((uint32_t)(7 - 127) << 23) + 0x7FFFFu;
    bits += odd;
    r = (bits >> 20) & 0xFFu;
    if (r == 0x7Fu && satfinite) r = 0x7Eu;
  }
  return (uint8_t)(r | (sign >> 24));
}

// round a value to the cache type; returns the stored element and, through
// `widened`, its value as the loaders below widen it
__device__ __forceinline__ __nv_bfloat16 to_cache(float x, __nv_bfloat16*,
                                                  int, float* widened) {
  const __nv_bfloat16 r = __float2bfloat16(x);
  *widened = __bfloat162float(r);
  return r;
}
__device__ __forceinline__ __nv_fp8_e4m3 to_cache(float x, __nv_fp8_e4m3*,
                                                  int satfinite, float* widened) {
  __nv_fp8_e4m3 r;
  r.__x = e4m3_bits(x, satfinite);
  *widened = __half2float(__half(__nv_cvt_fp8_to_halfraw(r.__x, __NV_E4M3)));
  return r;
}

// 8 bf16 cache values (one 16-byte load) -> f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 e4m3 cache values (one 8-byte load) -> f32 via the native fp8x2 convert
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_fp8x2_storage_t* pairs =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3);
    const float2 f = __half22float2(__half2(hr));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Shared memory: q (hd) | probabilities (T) | reduction scratch (kWarps) |
// per-group P.V partial sums (groups * hd, at most kThreads * kVec) | with
// the update, the new K and V rows as stored (2 * hd).
size_t smem_bytes(int T, int hd, bool update) {
  return sizeof(float) * (size_t(hd) + size_t(T) + kWarps + size_t(kThreads) * kVec +
                          (update ? 2 * size_t(hd) : 0));
}

// q, k_new, v_new: row b, head h at b * qkv_stride + h * hd (strided views
// of the fused projection). kUpdate = false is decode_attention_layer.
template <typename QT, typename CT, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const QT* __restrict__ q, const QT* __restrict__ k_new,
                   const QT* __restrict__ v_new, CT* __restrict__ cache_k,
                   CT* __restrict__ cache_v, const float* __restrict__ bias,
                   const void* __restrict__ pos, int pos_i64, int satfinite,
                   QT* __restrict__ out, int H, int T, int hd, float scale,
                   long long layer_offset, long long qkv_stride) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* p_s = q_s + hd;
  float* red = p_s + T;
  float* acc = red + kWarps;
  float* kn_s = acc + kThreads * kVec;  // update only: new rows as stored
  float* vn_s = kn_s + hd;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = hd / kVec;  // 8-wide column chunks, <= 32
  const long long base = layer_offset + (long long)bh * T * hd;
  const CT* K = cache_k + base;
  const CT* V = cache_v + base;
  const float* brow = bias + (long long)b * T;
  const long long qrow = (long long)b * qkv_stride + (long long)h * hd;

  // the row this block writes; -1 (no write, no substitution) past the cache
  long long row_pos = -1;
  if (kUpdate) {
    row_pos = pos_i64 ? static_cast<const long long*>(pos)[b]
                      : (long long)static_cast<const int*>(pos)[b];
    if (row_pos < 0 || row_pos >= T) row_pos = -1;
  }

  for (int d = tid; d < hd; d += kThreads) {
    q_s[d] = bf16_round(to_float(q[qrow + d]));
    if (kUpdate) {
      const CT kc = to_cache(to_float(k_new[qrow + d]), (CT*)nullptr, satfinite, &kn_s[d]);
      const CT vc = to_cache(to_float(v_new[qrow + d]), (CT*)nullptr, satfinite, &vn_s[d]);
      if (row_pos >= 0) {
        cache_k[base + row_pos * hd + d] = kc;
        cache_v[base + row_pos * hd + d] = vc;
      }
    }
  }
  __syncthreads();

  // q . K^T: one warp per key row, lane `lane` owns columns [8*lane, 8*lane+8)
  float qv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] = lane < chunks ? q_s[lane * kVec + i] : 0.f;
  for (int t = warp; t < T; t += kWarps) {
    float s = 0.f;
    if (lane < chunks) {
      float kv[kVec];
      if (kUpdate && t == row_pos) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kv[i] = kn_s[lane * kVec + i];
      } else {
        load8(K + (long long)t * hd + lane * kVec, kv);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) s = fmaf(qv[i], kv[i], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) p_s[t] = s * scale + brow[t];
  }
  __syncthreads();

  // softmax in f32; probabilities rounded to bf16
  float m = -INFINITY;
  for (int t = tid; t < T; t += kThreads) m = fmaxf(m, p_s[t]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int t = tid; t < T; t += kThreads) {
    const float e = expf(p_s[t] - m);
    p_s[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int t = tid; t < T; t += kThreads) p_s[t] = bf16_round(p_s[t] / sum);
  __syncthreads();

  // P . V: thread (g, c) sums key rows g, g + groups, ... of column chunk c
  const int groups = kThreads / chunks;
  const int c = tid % chunks;
  const int g = tid / chunks;
  if (g < groups) {
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = 0.f;
    for (int t = g; t < T; t += groups) {
      const float p = p_s[t];
      float vv[kVec];
      if (kUpdate && t == row_pos) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) vv[i] = vn_s[c * kVec + i];
      } else {
        load8(V + (long long)t * hd + c * kVec, vv);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = fmaf(p, vv[i], o[i]);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g * hd + c * kVec + i] = o[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    float r = 0.f;
    for (int gg = 0; gg < groups; ++gg) r += acc[gg * hd + d];
    store(out + (long long)bh * hd + d, r);
  }
}

template <typename QT, typename CT, bool kUpdate>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* ck,
                   void* cv, const void* bias, const void* pos, int pos_i64,
                   int satfinite, void* out, int B, int H, int T, int hd,
                   long long layer_offset, long long qkv_stride, cudaStream_t stream) {
  const size_t smem = smem_bytes(T, hd, kUpdate);
  auto kernel = decode_attn_kernel<QT, CT, kUpdate>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_new),
      static_cast<const QT*>(v_new), static_cast<CT*>(ck), static_cast<CT*>(cv),
      static_cast<const float*>(bias), pos, pos_i64, satfinite, static_cast<QT*>(out),
      H, T, hd, 1.0f / sqrtf((float)hd), layer_offset, qkv_stride);
  return cudaGetLastError();
}

template <bool kUpdate>
int dispatch(const void* q, const void* k_new, const void* v_new, const void* ck,
             const void* cv, const void* bias, const void* pos, int pos_i64,
             int satfinite, void* out, int L, int B, int H, int T, int hd, int layer,
             long long qkv_stride, int q_bf16, int cache_fp8, void* stream) {
  if (hd <= 0 || hd % kVec != 0 || hd > kMaxHd || T <= 0 || layer < 0 ||
      layer >= L || B <= 0 || H <= 0 || qkv_stride < (long long)H * hd)
    return (int)cudaErrorInvalidValue;
  const long long offset = (long long)layer * B * H * T * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* k = const_cast<void*>(ck);
  void* v = const_cast<void*>(cv);
  cudaError_t err;
  if (q_bf16) {
    err = cache_fp8
        ? launch<__nv_bfloat16, __nv_fp8_e4m3, kUpdate>(q, k_new, v_new, k, v, bias, pos, pos_i64, satfinite, out, B, H, T, hd, offset, qkv_stride, s)
        : launch<__nv_bfloat16, __nv_bfloat16, kUpdate>(q, k_new, v_new, k, v, bias, pos, pos_i64, satfinite, out, B, H, T, hd, offset, qkv_stride, s);
  } else {
    err = cache_fp8
        ? launch<float, __nv_fp8_e4m3, kUpdate>(q, k_new, v_new, k, v, bias, pos, pos_i64, satfinite, out, B, H, T, hd, offset, qkv_stride, s)
        : launch<float, __nv_bfloat16, kUpdate>(q, k_new, v_new, k, v, bias, pos, pos_i64, satfinite, out, B, H, T, hd, offset, qkv_stride, s);
  }
  return (int)err;
}

}  // namespace

// q (B, H, hd) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1); caches (L, B, H, T, hd)
// bf16 (cache_fp8 = 0) or e4m3 (cache_fp8 = 1), contiguous and 16-byte
// aligned; bias (B, T) f32; out (B, H, hd) in q's type. Returns a cudaError_t.
extern "C" int genvc_decode_attention_layer(
    const void* q, const void* cache_k, const void* cache_v, const void* bias,
    void* out, int L, int B, int H, int T, int hd, int layer, int q_bf16,
    int cache_fp8, void* stream) {
  return dispatch<false>(q, nullptr, nullptr, cache_k, cache_v, bias, nullptr, 0, 0,
                         out, L, B, H, T, hd, layer, (long long)H * hd, q_bf16,
                         cache_fp8, stream);
}

// decode_attention_update_layer: as above, after writing k_new / v_new (q's
// type) at row pos[b] (int32, or int64 when pos_i64) of layer `layer`, in
// place; rows with pos[b] outside [0, T) are not written. q, k_new, v_new
// have rows qkv_stride elements apart, heads hd apart. satfinite: an e4m3
// overflow saturates (1) or becomes NaN (0). The bias marks pos[b] valid.
extern "C" int genvc_decode_attention_update_layer(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, const void* bias, const void* pos, void* out, int L, int B,
    int H, int T, int hd, int layer, long long qkv_stride, int q_bf16,
    int cache_fp8, int pos_i64, int satfinite, void* stream) {
  return dispatch<true>(q, k_new, v_new, cache_k, cache_v, bias, pos, pos_i64,
                        satfinite, out, L, B, H, T, hd, layer, qkv_stride, q_bf16,
                        cache_fp8, stream);
}

extern "C" size_t genvc_decode_attention_smem_bytes(int T, int hd) {
  return smem_bytes(T, hd, false);
}

extern "C" size_t genvc_decode_attention_update_smem_bytes(int T, int hd) {
  return smem_bytes(T, hd, true);
}

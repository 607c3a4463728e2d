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
//     __nv_cvt_fp8x2_to_halfraw2 — exact, e4m3 fits in half — except the
//     codes 0x7F / 0xFF, which read as +480 / -480: the value the JAX
//     package's kernels give them through their bit-field upcast
//     `_f8e4m3_bits_to_bf16`, where the hardware gives NaN);
//   * logits accumulate in f32, are scaled by 1/sqrt(hd), then the bias is
//     added; the softmax runs in f32;
//   * probabilities are normalised by the row's global max and sum, then
//     rounded to bf16 before P.V, which accumulates in f32;
//   * the output takes q's type (bf16 or f32).
// The layer is read at an offset into the full stacked cache; no slice is
// copied.
//
// Bound: bytes. Per launch the kernel must read K and V of one layer,
// 2 * B * H * T * hd * sizeof(cache) bytes (1.57 MB at B=1, H=4, T=384,
// hd=256, bf16: 0.47 us at 3.35 TB/s); its arithmetic is 4 * B*H*T*hd flops,
// far below the tensor-core line.
//
// Design (K1 / K2, and K3 after its row write): the cache length is split
// across blocks. The grid is (B*H, S): block s takes keys [s * per, (s + 1)
// * per), and the wrapper picks per (at least 16) so that B*H*S is about
// four blocks per SM (S = 1 once B*H reaches that).
// The reference normalises by the global max and sum BEFORE rounding the
// probabilities to bf16, so the split runs in two launches on one stream
// (the wrapper counts one call):
//   (a) decode_split_logits: block (bh, s) writes the logits of its range
//       (scaled, bias added) and its local (m, l) to scratch;
//   (b) decode_split_pv: block (bh, s) forms the global (M, L) from the S
//       pairs, rounds p = bf16(exp(x - M) / L) over its range and writes its
//       partial P.V in f32; the last block of the (bh) group to finish (an
//       atomic ticket, reset by (a)) sums the S partials in the order
//       s = 0..S-1 and writes O. With S = 1 the block writes O itself.
// Each block reads its keys once with 16-byte (bf16) or 8-byte (e4m3) vector
// loads: one warp per key row for q.K, four rows in flight per warp, 8-wide
// column chunks times key-row groups for P.V. The split exists for the
// bytes in flight: one block per (row, head) would read 393 KB alone at
// B = 1. The scratch (logits, S (m, l) pairs, S partial rows, tickets:
// B*H*(T + S*(hd + 2) + 1) words) is allocated by the wrapper.
//
// K3 (decode_attention_update_layer) is the same two launches with the row
// write folded into (a): the block (bh, s) whose range holds pos[b] rounds
// the new K and V rows to the cache type (bf16 round-to-nearest-even, or
// e4m3 as jnp.astype(float8_e4m3fn) rounds: to the nearest even, a
// magnitude past 464 stored as 0x7F / 0xFF) and stores them at row pos[b]
// of its own (T, hd) block; a pos[b] outside [0, T) lies in no range, so
// nothing is written (an idle pool slot runs past the cache end). For the
// logit at t == pos[b] that block takes the rounded K row it holds in
// shared memory, widened as a read widens it: no launch reads back a row
// that it wrote (the __ldg path is not coherent with a store of the same
// kernel). (b) reads V at row pos[b] as stored, since (a) ran before it on
// the same stream. The result equals the cache write followed by K1, bit
// for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// float -> float8_e4m3fn bits as jnp.astype rounds (and ops/decode_attention.py
// to_e4m3): to the nearest even; a magnitude that rounds past 448 (> 464)
// becomes 0x7F, with the sign 0xFF. No saturation.
__device__ __forceinline__ uint8_t e4m3_bits(float f) {
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t r;
  if (bits >= (1087u << 20)) {              // |f| >= 480, inf or NaN
    r = 0x7Fu;
  } else if (bits < (121u << 23)) {         // below 2^-6: subnormal
    const float denorm = __uint_as_float(141u << 23);
    r = __float_as_uint(__fadd_rn(__uint_as_float(bits), denorm)) - (141u << 23);
  } else {
    const uint32_t odd = (bits >> 20) & 1u;
    bits += ((uint32_t)(7 - 127) << 23) + 0x7FFFFu;
    bits += odd;
    r = (bits >> 20) & 0xFFu;                // 0x7F for 464 < |f| < 480
  }
  return (uint8_t)(r | (sign >> 24));
}

// 0x7F / 0xFF read as +480 / -480 (the hardware cvt gives NaN for them)
__device__ __forceinline__ float e4m3_fix(uint32_t code, float widened) {
  return (code & 0x7Fu) == 0x7Fu ? ((code & 0x80u) ? -480.f : 480.f) : widened;
}

// round a value to the cache type; returns the stored element and, through
// `widened`, its value as the loaders below widen it
__device__ __forceinline__ __nv_bfloat16 to_cache(float x, __nv_bfloat16*,
                                                  float* widened) {
  const __nv_bfloat16 r = __float2bfloat16(x);
  *widened = __bfloat162float(r);
  return r;
}
__device__ __forceinline__ __nv_fp8_e4m3 to_cache(float x, __nv_fp8_e4m3*,
                                                  float* widened) {
  __nv_fp8_e4m3 r;
  r.__x = e4m3_bits(x);
  *widened = e4m3_fix(r.__x,
                      __half2float(__half(__nv_cvt_fp8_to_halfraw(r.__x, __NV_E4M3))));
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

// 8 e4m3 cache values (one 8-byte load) -> f32 via the native fp8x2 convert,
// with 0x7F / 0xFF patched to +-480 (e4m3_fix)
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_fp8x2_storage_t* pairs =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3);
    const float2 f = __half22float2(__half2(hr));
    out[2 * i] = e4m3_fix(pairs[i] & 0xFFu, f.x);
    out[2 * i + 1] = e4m3_fix(pairs[i] >> 8, f.y);
  }
}

// ---- K1 / K2: the cache length split across blocks (see the note at the top)

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kKeysInFlight = 4;  // key rows a warp loads at once in (a)
constexpr int kProbChunk = kSplitThreads;  // probabilities per round in (b), one a thread

// scratch layout, in 4-byte words: logits [BH][T] | (m, l) [BH][S][2] |
// partial P.V [BH][S][hd] | tickets [BH]
struct SplitScratch {
  float* logits;
  float* ml;
  float* partial;
  int* tickets;
};

size_t split_scratch_words(long long bh, int T, int hd, int S) {
  return (size_t)bh * ((size_t)T + (size_t)S * (2 + (size_t)hd) + 1);
}

SplitScratch carve(void* scratch, long long bh, int T, int hd, int S) {
  float* f = static_cast<float*>(scratch);
  SplitScratch r;
  r.logits = f;
  r.ml = r.logits + (size_t)bh * T;
  r.partial = r.ml + (size_t)bh * S * 2;
  r.tickets = reinterpret_cast<int*>(r.partial + (size_t)bh * S * hd);
  return r;
}

// K3's row write, folded into (a): k_new / v_new (q's type; row b, head h at
// b * q_stride + h * hd) stored at row pos[b] (int32, or int64 when pos_i64)
template <typename QT, typename CT>
struct RowWrite {
  const QT* k_new;
  const QT* v_new;
  CT* cache_k;
  CT* cache_v;
  const void* pos;
  int pos_i64;
};

// (a) logits of keys [s * per, (s + 1) * per) and their local (max, sum);
// with kWrite (K3), the block whose range holds pos[b] first stores the
// row's new K and V, and takes its K row from shared memory
template <typename QT, typename CT, bool kWrite>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_logits(const QT* __restrict__ q, const CT* __restrict__ cache_k,
                    const float* __restrict__ bias, SplitScratch scr,
                    RowWrite<QT, CT> w, int H, int T, int hd, int per, float scale,
                    long long layer_offset, long long q_stride) {
  __shared__ float q_s[kMaxHd];
  __shared__ float kn_s[kWrite ? kMaxHd : 1];  // the new K row as stored, widened
  __shared__ float m_w[kSplitWarps];
  __shared__ float l_w[kSplitWarps];
  const int bh = blockIdx.x;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = hd / kVec;
  const int t0 = s * per;
  const int t1 = min(T, t0 + per);
  const long long base = layer_offset + (long long)bh * T * hd;
  const CT* K = cache_k + base;
  const float* brow = bias + (long long)b * T;
  float* lrow = scr.logits + (long long)bh * T;
  const long long qrow = (long long)b * q_stride + (long long)h * hd;

  // the key row this block stores and substitutes (-1: none); a pos[b]
  // outside [0, T) lies in no range
  int own = -1;
  if constexpr (kWrite) {
    const long long p = w.pos_i64 ? static_cast<const long long*>(w.pos)[b]
                                  : (long long)static_cast<const int*>(w.pos)[b];
    if (p >= t0 && p < t1) own = (int)p;
  }
  if (s == 0 && tid == 0) scr.tickets[bh] = 0;  // for (b)'s ticket
  for (int d = tid; d < hd; d += kSplitThreads) {
    q_s[d] = bf16_round(to_float(q[qrow + d]));
    if constexpr (kWrite) {
      if (own >= 0) {
        float v_widened;
        w.cache_k[base + (long long)own * hd + d] =
            to_cache(to_float(w.k_new[qrow + d]), (CT*)nullptr, &kn_s[d]);
        w.cache_v[base + (long long)own * hd + d] =
            to_cache(to_float(w.v_new[qrow + d]), (CT*)nullptr, &v_widened);
      }
    }
  }
  __syncthreads();

  // q . K^T: one warp per key row, kKeysInFlight rows at a time; lane
  // `lane` owns columns [8*lane, 8*lane+8). Each warp keeps the running
  // (max, sum of exp) of its logits.
  float qv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qv[i] = lane < chunks ? q_s[lane * kVec + i] : 0.f;
  float m = -INFINITY;
  float l = 0.f;
  for (int t = t0 + warp * kKeysInFlight; t < t1; t += kSplitWarps * kKeysInFlight) {
    float x[kKeysInFlight];
#pragma unroll
    for (int u = 0; u < kKeysInFlight; ++u) {
      x[u] = 0.f;
      if (lane < chunks && t + u < t1) {
        float kv[kVec];
        if (kWrite && t + u == own) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) kv[i] = kn_s[lane * kVec + i];
        } else {
          load8(K + (long long)(t + u) * hd + lane * kVec, kv);
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) x[u] = fmaf(qv[i], kv[i], x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kKeysInFlight; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
      if (t + u < t1) {
        const float logit = x[u] * scale + brow[t + u];
        if (lane == 0) lrow[t + u] = logit;
        const float m_new = fmaxf(m, logit);
        l = l * expf(m - m_new) + expf(logit - m_new);
        m = m_new;
      }
    }
  }
  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {  // a warp without keys has m = -inf, l = 0: no term
    float big_m = m_w[0];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) big_m = fmaxf(big_m, m_w[w]);
    float big_l = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      if (l_w[w] > 0.f) big_l += l_w[w] * expf(m_w[w] - big_m);
    scr.ml[((long long)bh * S + s) * 2] = big_m;
    scr.ml[((long long)bh * S + s) * 2 + 1] = big_l;
  }
}

// (b) p over keys [s * per, (s + 1) * per) with the global (M, L), the
// partial P.V, and the fixed-order combine by the group's last block
template <typename QT, typename CT>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_pv(const CT* __restrict__ cache_v, SplitScratch scr, QT* __restrict__ out,
                int T, int hd, int per, long long layer_offset) {
  __shared__ float p_s[kProbChunk];
  __shared__ float acc[kSplitThreads * kVec];
  __shared__ float ml_s[2];
  __shared__ int last_s;
  const int bh = blockIdx.x;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int tid = threadIdx.x;
  const int t0 = s * per;
  const int t1 = min(T, t0 + per);
  const float* lrow = scr.logits + (long long)bh * T;
  const float* ml = scr.ml + (long long)bh * S * 2;
  float x = t0 + tid < t1 ? lrow[t0 + tid] : 0.f;  // loaded while (M, L) forms

  // global max and sum of the row from the S (m, l) pairs: warp 0, the same
  // fixed reduction tree in every block of the group
  if (tid < 32) {
    float M = -INFINITY;
    for (int i = tid; i < S; i += 32) M = fmaxf(M, ml[2 * i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int i = tid; i < S; i += 32) L += ml[2 * i + 1] * expf(ml[2 * i] - M);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (tid == 0) {
      ml_s[0] = M;
      ml_s[1] = L;
    }
  }
  __syncthreads();
  const float M = ml_s[0];
  const float L = ml_s[1];

  // P . V: thread (g, c) sums key rows g, g + groups, ... of column chunk c
  const int chunks = hd / kVec;
  const int groups = kSplitThreads / chunks;
  const int c = tid % chunks;
  const int g = tid / chunks;
  const CT* V = cache_v + layer_offset + (long long)bh * T * hd;
  float o[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = 0.f;
  for (int r0 = t0; r0 < t1; r0 += kProbChunk) {
    const int n = min(kProbChunk, t1 - r0);
    if (tid < n) p_s[tid] = bf16_round(expf(x - M) / L);
    __syncthreads();
    const int next = r0 + kProbChunk + tid;
    x = next < t1 ? lrow[next] : 0.f;
    if (g < groups) {
#pragma unroll 4
      for (int i = g; i < n; i += groups) {
        const float p = p_s[i];
        float vv[kVec];
        load8(V + (long long)(r0 + i) * hd + c * kVec, vv);
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = fmaf(p, vv[k], o[k]);
      }
    }
    __syncthreads();
  }
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g * hd + c * kVec + i] = o[i];
  }
  __syncthreads();
  float* part = scr.partial + ((long long)bh * S + s) * hd;
  for (int d = tid; d < hd; d += kSplitThreads) {
    float r = 0.f;
    for (int gg = 0; gg < groups; ++gg) r += acc[gg * hd + d];
    if (S == 1)
      store(out + (long long)bh * hd + d, r);
    else
      part[d] = r;
  }
  if (S == 1) return;

  // the group's last block to get here combines the S partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(scr.tickets + bh, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = scr.partial + (long long)bh * S * hd;
  for (int d = tid; d < hd; d += kSplitThreads) {
    float r = 0.f;
#pragma unroll 8
    for (int i = 0; i < S; ++i) r += __ldcg(parts + (long long)i * hd + d);
    store(out + (long long)bh * hd + d, r);
  }
}

// the two launches; `write` (K3) folds the row write into (a)
template <typename QT, typename CT>
cudaError_t launch_split(const void* q, const void* ck, const void* cv, const void* bias,
                         void* out, void* scratch, int B, int H, int T, int hd, int per,
                         long long layer_offset, long long q_stride,
                         const RowWrite<QT, CT>* write, cudaStream_t stream) {
  const int S = (T + per - 1) / per;
  const SplitScratch scr = carve(scratch, (long long)B * H, T, hd, S);
  const dim3 grid(B * H, S);
  const float scale = 1.0f / sqrtf((float)hd);
  if (write)
    decode_split_logits<QT, CT, true><<<grid, kSplitThreads, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(ck),
        static_cast<const float*>(bias), scr, *write, H, T, hd, per, scale,
        layer_offset, q_stride);
  else
    decode_split_logits<QT, CT, false><<<grid, kSplitThreads, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(ck),
        static_cast<const float*>(bias), scr, RowWrite<QT, CT>{}, H, T, hd, per, scale,
        layer_offset, q_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_split_pv<QT, CT><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const CT*>(cv), scr, static_cast<QT*>(out), T, hd, per, layer_offset);
  return cudaGetLastError();
}

// f(QT{}, CT{}) for the runtime types of q (bf16 or f32) and the cache
// (bf16 or e4m3)
template <typename F>
cudaError_t with_types(int q_bf16, int cache_fp8, F&& f) {
  if (q_bf16)
    return cache_fp8 ? f(__nv_bfloat16{}, __nv_fp8_e4m3{}) : f(__nv_bfloat16{}, __nv_bfloat16{});
  return cache_fp8 ? f(float{}, __nv_fp8_e4m3{}) : f(float{}, __nv_bfloat16{});
}

bool valid_shape(int L, int B, int H, int T, int hd, int layer, int per) {
  return hd > 0 && hd % kVec == 0 && hd <= kMaxHd && T > 0 && layer >= 0 &&
         layer < L && B > 0 && H > 0 && per > 0 && (T + per - 1) / per <= 65535;
}

}  // namespace

// q (B, H, hd) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1); caches (L, B, H, T, hd)
// bf16 (cache_fp8 = 0) or e4m3 (cache_fp8 = 1), contiguous and 16-byte
// aligned; bias (B, T) f32; out (B, H, hd) in q's type; the cache length
// split into ranges of `per` keys; scratch of
// genvc_decode_attention_scratch_bytes bytes, 16-byte aligned. Two launches.
// Returns a cudaError_t.
extern "C" int genvc_decode_attention_layer(
    const void* q, const void* cache_k, const void* cache_v, const void* bias,
    void* out, void* scratch, int L, int B, int H, int T, int hd, int layer,
    int q_bf16, int cache_fp8, int per, void* stream) {
  if (!valid_shape(L, B, H, T, hd, layer, per)) return (int)cudaErrorInvalidValue;
  const long long offset = (long long)layer * B * H * T * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_types(q_bf16, cache_fp8, [&](auto qt, auto ct) {
    using QT = decltype(qt);
    using CT = decltype(ct);
    return launch_split<QT, CT>(q, cache_k, cache_v, bias, out, scratch, B, H, T, hd,
                                per, offset, (long long)H * hd, nullptr, s);
  });
}

extern "C" size_t genvc_decode_attention_scratch_bytes(int B, int H, int T, int hd,
                                                       int per) {
  return 4 * split_scratch_words((long long)B * H, T, hd, (T + per - 1) / per);
}

// decode_attention_update_layer: write k_new / v_new (q's type) at row
// pos[b] (int32, or int64 when pos_i64) of layer `layer`, in place (rows
// with pos[b] outside [0, T) are not written), then attend with q as above.
// q, k_new, v_new have rows qkv_stride elements apart, heads hd apart. An
// e4m3 cache stores e4m3_bits (an overflow as 0x7F / 0xFF). The bias marks
// pos[b] valid. The same split, scratch and two launches as
// genvc_decode_attention_layer.
extern "C" int genvc_decode_attention_update_layer(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, const void* bias, const void* pos, void* out, void* scratch,
    int L, int B, int H, int T, int hd, int layer, long long qkv_stride, int q_bf16,
    int cache_fp8, int pos_i64, int per, void* stream) {
  if (!valid_shape(L, B, H, T, hd, layer, per) || qkv_stride < (long long)H * hd)
    return (int)cudaErrorInvalidValue;
  const long long offset = (long long)layer * B * H * T * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_types(q_bf16, cache_fp8, [&](auto qt, auto ct) {
    using QT = decltype(qt);
    using CT = decltype(ct);
    const RowWrite<QT, CT> w{static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
                             static_cast<CT*>(cache_k), static_cast<CT*>(cache_v), pos,
                             pos_i64};
    return launch_split<QT, CT>(q, cache_k, cache_v, bias, out, scratch, B, H, T, hd,
                                per, offset, qkv_stride, &w, s);
  });
}

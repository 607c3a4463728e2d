// Causal, key-masked attention forward for Hopper (sm_90a): O and the
// per-row log-sum-exp.
//
// Replaces the Pallas kernel genvc_tpu/ops/flash_attention.py
// `_pallas_attention` (body `_attn_fwd_kernel`), with its numerics:
//   * q, k and v are read at their storage type (bf16 or f32) and widened to
//     f32;
//   * s = (q . k^T) * scale in f32; where a key is invalid, or col > row under
//     `causal`, s is SET to -1e9 (not -inf, not added);
//   * m = rowmax, p = exp(s - m), l = sum p; O = (p . v) / l in f32, with no
//     rounding of p, then cast to q's type; LSE = m + log(l) in f32.
// The Pallas kernel pads T to a multiple of 128 with invalid keys and sums
// its softmax over every padded column. Those columns carry exp(-1e9 - m),
// which is 0 for any row that sees a valid key; a row that sees none gets
// m = -1e9 and a uniform mean over all padded columns. This kernel keeps
// that too: a tile holding such a row visits every key tile, and the columns
// up to the padded width that no tile visited are added to l at the end.
//
// The TPU kernel holds all of one head's K and V in VMEM; here they do not
// fit in shared memory (hd = 256, T = 756: 1.5 MB in f32), so this is an
// online-softmax kernel. One block of 256 threads per (b * H + h, 32-row
// query tile) loops over 32-row key tiles staged in shared memory as f32,
// keeps a running max, sum and rescaled accumulator per row, and skips the
// key tiles past the causal diagonal. Thread (r, g) owns query row r of the
// tile (8 threads per row): it scores keys g, g + 8, g + 16, g + 24 of each
// key tile (one float4 of q against four of K per step), and accumulates
// O columns [4g + 32c, 4g + 32c + 4) for c < hd / 32. Shared-memory rows are
// hd + 4 floats long, an odd number of float4s, so the eight rows a warp
// reads at once fall in eight different bank groups. Arithmetic is f32 FMA;
// mma.sync / wgmma tiles are later work.
//
// Bound at the main-path shape (latent pass, B = 1, H = 4, T = 308, hd = 256,
// bf16): bytes. The kernel must read q, k, v and write O, 4 * B*H*T*hd * 2
// bytes, plus LSE (4 * B*H*T) and the key mask (B*T): 2.53 MB, 0.75 us at
// 3.35 TB/s. Its arithmetic after the causal skip is about 2 * B*H*T^2*hd =
// 194 MFLOP, 0.2 us on the bf16 tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;                  // threads per query row
constexpr int kBQ = kThreads / kRowThreads;     // 32 query rows per block
constexpr int kBK = 32;                         // key rows per tile
constexpr int kKeysPerThread = kBK / kRowThreads;
constexpr int kMaxHd = 256;
constexpr int kChunks = kMaxHd / (4 * kRowThreads);  // O float4s per thread
constexpr int kPadTo = 128;                     // the Pallas kernel's padding
constexpr float kMasked = -1e9f;

// 8 values (one 16-byte load, or two for f32) -> f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows of `rows` x hd from global (row stride `st`, rows >= n_valid zero) to
// shared f32 rows of length ld
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long st,
                                      int rows, int n_valid, int hd, int ld,
                                      float* dst) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float x[8];
    if (r < n_valid) {
      load8(src + (long long)r * st + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory (floats): Q tile | K tile | V tile (rows of hd + 4) |
// probabilities (kBQ x (kBK + 1)) | key validity (kBK) | first valid key.
size_t smem_bytes(int hd) {
  const size_t ld = size_t(hd) + 4;
  return sizeof(float) * ((kBQ + 2 * kBK) * ld + kBQ * (kBK + 1) + kBK + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 T* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                 int hd, float scale, int causal, long long sb, long long sh,
                 long long st, long long ob, long long oh, long long ot) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = hd + 4;
  float* q_s = smem;
  float* k_s = q_s + kBQ * ld;
  float* v_s = k_s + kBK * ld;
  float* p_s = v_s + kBK * ld;
  float* valid_s = p_s + kBQ * (kBK + 1);
  int* first_s = reinterpret_cast<int*>(valid_s + kBK);

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;     // query row in the tile
  const int g = tid % kRowThreads;     // this thread's place in the row
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + r;
  const long long base = (long long)b * sb + (long long)h * sh;
  const uint8_t* valid_row = kv_valid + (long long)b * T_len;

  // first valid key of batch row b: under causal, rows before it see none
  if (tid == 0) *first_s = T_len;
  __syncthreads();
  if (causal) {
    int f = T_len;
    for (int t = tid; t < T_len; t += kThreads) {
      if (valid_row[t]) {
        f = t;
        break;
      }
    }
    if (f < T_len) atomicMin(first_s, f);
  }
  stage(q + base + (long long)q0 * st, st, kBQ, T_len - q0, hd, ld, q_s);
  __syncthreads();

  // keys visited: up to the tile's last row under causal, every key when a
  // row of the tile sees no valid key (see the note at the top)
  int k_end = T_len;
  if (causal && q0 >= *first_s) k_end = min(q0 + kBQ, T_len);
  const int n_tiles = (k_end + kBK - 1) / kBK;

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const float* q_row = q_s + r * ld;
  float* p_row = p_s + r * (kBK + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // every thread is done with the previous K/V tile
    stage(k + base + (long long)k0 * st, st, kBK, T_len - k0, hd, ld, k_s);
    stage(v + base + (long long)k0 * st, st, kBK, T_len - k0, hd, ld, v_s);
    for (int i = tid; i < kBK; i += kThreads)
      valid_s[i] = (k0 + i < T_len && valid_row[k0 + i]) ? 1.f : 0.f;
    __syncthreads();

    // s for keys g + 8 i of this tile
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_row + d);
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(
            k_s + (g + kRowThreads * i) * ld + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    float tile_max = kMasked;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int kk = g + kRowThreads * i;
      bool ok = valid_s[kk] != 0.f;
      if (causal) ok = ok && (k0 + kk <= row);
      s[i] = ok ? s[i] * scale : kMasked;
      tile_max = fmaxf(tile_max, s[i]);
    }
    // online softmax: m stays finite (>= -1e9), so exp(m_old - m_new) is 0
    // on the first tile and never NaN
    const float m_new = fmaxf(m_run, row_max(tile_max));
    const float alpha = expf(m_run - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      p_row[g + kRowThreads * i] = p;
      p_sum += p;
    }
    l_run = l_run * alpha + row_sum(p_sum);
    m_run = m_new;
    __syncwarp();  // the row's 8 threads share one warp

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c][0] *= alpha;
      acc[c][1] *= alpha;
      acc[c][2] *= alpha;
      acc[c][3] *= alpha;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = p_row[kk];
      const float* v_row = v_s + kk * ld;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * g + 4 * kRowThreads * c;
        if (col < hd) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + col);
          acc[c][0] = fmaf(p, vv.x, acc[c][0]);
          acc[c][1] = fmaf(p, vv.y, acc[c][1]);
          acc[c][2] = fmaf(p, vv.z, acc[c][2]);
          acc[c][3] = fmaf(p, vv.w, acc[c][3]);
        }
      }
    }
  }

  // masked padding columns no tile visited (v = 0 there): only a row that
  // saw no valid key (m = -1e9) gets a non-zero term
  const int t_pad = (T_len + kPadTo - 1) / kPadTo * kPadTo;
  l_run += (float)(t_pad - n_tiles * kBK) * expf(kMasked - m_run);
  if (row < T_len) {
    T* o_row = out + (long long)b * ob + (long long)h * oh + (long long)row * ot;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * g + 4 * kRowThreads * c;
      if (col < hd)
        store4(o_row + col, make_float4(acc[c][0] / l_run, acc[c][1] / l_run,
                                        acc[c][2] / l_run, acc[c][3] / l_run));
    }
    if (g == 0) lse[(long long)bh * T_len + row] = m_run + logf(l_run);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_valid, void* out, void* lse, int B, int H,
                   int T_len, int hd, float scale, int causal, long long sb,
                   long long sh, long long st, long long ob, long long oh,
                   long long ot, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<T*>(out), static_cast<float*>(lse), H, T_len, hd, scale,
      causal, sb, sh, st, ob, oh, ot);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, H, T, hd) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), one set of
// element strides (sb, sh, st) for all three, head dim contiguous, rows
// 16-byte aligned; kv_valid (B, T) bytes 0/1, contiguous; out (B, H, T, hd)
// in q's type with strides (ob, oh, ot); lse (B, H, T) f32, contiguous.
// Returns a cudaError_t.
extern "C" int genvc_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int B, int H, int T_len, int hd, float scale,
    int causal, int is_bf16, long long sb, long long sh, long long st,
    long long ob, long long oh, long long ot, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > kMaxHd || T_len <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_valid, out, lse, B, H, T_len,
                                      hd, scale, causal, sb, sh, st, ob, oh, ot, s);
  return (int)launch<float>(q, k, v, kv_valid, out, lse, B, H, T_len, hd,
                            scale, causal, sb, sh, st, ob, oh, ot, s);
}

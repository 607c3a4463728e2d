// LayerNorm over the last dimension for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes LayerNorm as plain jnp
// (genvc_tpu/ops/nn.py `layer_norm`) and XLA fuses it into one pass. The
// port runs eagerly, where the same arithmetic in PyTorch ops
// (ops/nn.py `layer_norm_plain`) is 12 to 14 launches a call; a decode step
// of the 30-block GPT makes 62 such calls on one row each, and its time is
// the host's time to issue launches. This kernel is one launch a call.
//
// For each row of d elements of x (rows are d apart):
//   y = (x - mean) * rsqrt(var + eps) * scale + bias
// computed in f32 as the plain version computes it: mean = sum(x) * (1/d),
// var = sum((x - mean)^2) * (1/d) (two passes over registers, not Welford),
// then (x - mean) * rstd, * scale, + bias, each step rounded as the separate
// PyTorch ops round it (no fused multiply-add there). Only the order of the
// two sums differs from the plain version. x and y are bf16 or f32 (y takes
// x's type, rounded to nearest even); scale and bias, one type, bf16 or f32,
// are read at their stored type and widened in registers. Where the caller
// asks (autograd's forward), each row's f32 mean and rstd are written too,
// for the backward.
//
// Bound: bytes, 2 * rows * d * sizeof(x) + d * 2 * sizeof(scale). At the
// decode call (1 row of 1024 bf16, bf16 parameters) that is 8 KB, about
// 2.4 ns at 3.35 TB/s:
// the launch and one warp's load latency are the whole time. At ContentVec's
// training features (24 * 500 rows of 768 f32) it is 73.7 MB, 22 us.
//
// Design: one warp per row, the row held in registers. Lane l loads the
// 16-byte vectors l, l + 32, l + 64, ... of its row (neighbouring lanes on
// neighbouring addresses), NV of them at most (NV = 1..8, a template
// argument chosen from d), so d is a multiple of 8 (bf16) or 4 (f32) up to
// 2048 (bf16) or 1024 (f32). The two sums are warp shuffles; each lane then
// stores its vectors once. Four rows (warps) a block, so that many-row calls
// fill the SMs. The kernel allocates nothing. x and y are 16-byte aligned;
// scale and bias are read a vector at a time where both are, else one
// element at a time (weights held as views of one buffer start at any
// element).
//
// RMS mode (genvc_rms_norm; added for the DeepSeek-V3 backbone's RMSNorm,
// which the JAX package does not have): y = x * rsqrt(mean(x^2) + eps) *
// scale, with no mean and no bias, in the same f32 rounding order as
// ops/nn.py `rms_norm_plain` (sum of squares, * (1/d), + eps, rsqrt; then
// x * rstd, * scale). Rows of x may lie `ld` elements apart (a slice of a
// wider projection, such as the latent part of MLA's kv_a output); y is
// written contiguous. Bound and design as above: bytes, one warp a row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // rows a block, one warp each
constexpr int kMaxVecs = 8;   // 16-byte vectors a lane holds at most

// one 16-byte vector of x: 4 f32 or 8 bf16, widened to f32
__device__ __forceinline__ void load_x(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// N (4 or 8) parameters at p, read through the read-only path (they are the
// same for every row) and widened to f32
template <int N>
__device__ __forceinline__ void load_param(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_param(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
    static_assert(N == 4, "4 or 8 parameters a vector");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// N parameters at p one element at a time, for parameters that are not
// 16-byte aligned
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <int N, typename PT>
__device__ __forceinline__ void load_param_elems(const PT* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = widen(__ldg(p + i));
}

__device__ __forceinline__ void store_y(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_y(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename XT, typename PT, int NV, bool RMS>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_rows(const XT* __restrict__ x, const PT* __restrict__ scale,
                const PT* __restrict__ bias, XT* __restrict__ y, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, long long rows, int d, long long ld, float eps,
                bool param_vec) {
  constexpr int V = 16 / sizeof(XT);  // elements a vector
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const XT* xr = x + row * ld;
  XT* yr = y + row * d;
  const float inv_d = 1.0f / (float)d;

  float v[NV][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < d) {
      load_x(xr + c, v[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += RMS ? v[i][j] * v[i][j] : v[i][j];
    }
  }
  if constexpr (RMS) {
    const float rstd = rsqrtf(__fadd_rn(warp_sum(sum) * inv_d, eps));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * V;
      if (c < d) {
        float s[V], o[V];
        if (param_vec) load_param<V>(scale + c, s);
        else load_param_elems<V>(scale + c, s);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], rstd), s[j]);
        store_y(yr + c, o);
      }
    }
    return;
  }
  const float mean = warp_sum(sum) * inv_d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * V < d) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] = __fsub_rn(v[i][j], mean);
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(warp_sum(sq) * inv_d, eps));
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < d) {
      float s[V], b[V], o[V];
      if (param_vec) {
        load_param<V>(scale + c, s);
        load_param<V>(bias + c, b);
      } else {
        load_param_elems<V>(scale + c, s);
        load_param_elems<V>(bias + c, b);
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), s[j]), b[j]);
      store_y(yr + c, o);
    }
  }
}

template <typename XT, typename PT, int NV, bool RMS>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   float* mean, float* rstd, long long rows, int d, long long ld, float eps,
                   bool param_vec, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_rows<XT, PT, NV, RMS><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const PT*>(scale),
      static_cast<const PT*>(bias), static_cast<XT*>(y), mean, rstd, rows, d, ld, eps,
      param_vec);
  return cudaGetLastError();
}

// the smallest instantiated NV that holds `vecs` vectors a lane
template <typename XT, typename PT, bool RMS>
cudaError_t launch_width(int vecs, const void* x, const void* scale, const void* bias,
                         void* y, float* mean, float* rstd, long long rows, int d,
                         long long ld, float eps, bool pv, cudaStream_t s) {
  switch (vecs) {
    case 1: return launch<XT, PT, 1, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps, pv, s);
    case 2: return launch<XT, PT, 2, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps, pv, s);
    case 3: return launch<XT, PT, 3, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps, pv, s);
    case 4: return launch<XT, PT, 4, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps, pv, s);
    case 5:
    case 6: return launch<XT, PT, 6, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps, pv, s);
    default:
      return launch<XT, PT, kMaxVecs, RMS>(x, scale, bias, y, mean, rstd, rows, d, ld, eps,
                                           pv, s);
  }
}

template <bool RMS>
int dispatch(const void* x, const void* scale, const void* bias, void* y, float* mean,
             float* rstd, long long rows, int d, long long ld, int x_bf16, int param_bf16,
             float eps, void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  const int vecs = d > 0 ? (d / vec + 31) / 32 : 0;
  const bool pv = !(((uintptr_t)scale | (uintptr_t)bias) & 15);
  if (rows < 0 || d <= 0 || d % vec || vecs > kMaxVecs || ld < d || ld % vec ||
      (((uintptr_t)x | (uintptr_t)y) & 15) ||
      ((mean == nullptr) != (rstd == nullptr)) ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return (int)(param_bf16
        ? launch_width<__nv_bfloat16, __nv_bfloat16, RMS>(vecs, x, scale, bias, y, mean, rstd,
                                                          rows, d, ld, eps, pv, s)
        : launch_width<__nv_bfloat16, float, RMS>(vecs, x, scale, bias, y, mean, rstd, rows,
                                                  d, ld, eps, pv, s));
  }
  return (int)(param_bf16
      ? launch_width<float, __nv_bfloat16, RMS>(vecs, x, scale, bias, y, mean, rstd, rows, d,
                                                ld, eps, pv, s)
      : launch_width<float, float, RMS>(vecs, x, scale, bias, y, mean, rstd, rows, d, ld, eps,
                                        pv, s));
}

}  // namespace

// y = LayerNorm(x) over rows of d elements. x, y: bf16 (x_bf16) or f32, rows
// contiguous; scale, bias: d elements, bf16 (param_bf16) or f32; mean, rstd:
// null, or `rows` f32 each for the rows' mean and rstd. x and y 16-byte
// aligned, scale and bias aligned to their element; d a multiple of 16
// bytes' worth of x's type and at most kMaxVecs vectors a lane. Launches on `stream`; returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int genvc_layer_norm(const void* x, const void* scale, const void* bias,
                                void* y, float* mean, float* rstd, long long rows, int d,
                                int x_bf16, int param_bf16, float eps, void* stream) {
  return dispatch<false>(x, scale, bias, y, mean, rstd, rows, d, d, x_bf16, param_bf16, eps,
                         stream);
}

// y = RMSNorm(x) * scale over rows of d elements, the rows of x `ld` elements
// apart (ld >= d, a multiple of the vector), y contiguous; otherwise as
// genvc_layer_norm, with no bias and no statistics written.
extern "C" int genvc_rms_norm(const void* x, const void* scale, void* y, long long rows,
                              int d, long long ld, int x_bf16, int param_bf16, float eps,
                              void* stream) {
  return dispatch<true>(x, scale, scale, y, nullptr, nullptr, rows, d, ld, x_bf16,
                        param_bf16, eps, stream);
}

// Routed experts of a DeepSeek-V3 mixture-of-experts layer for Hopper
// (sm_90a): y[m] = sum_k w[m, k] * E_idx[m, k](x[m]), each expert a SwiGLU
// E(x) = down(silu(gate x) * up x).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. Added
// for the DeepSeek-V3 backbone (models/mla_moe.py). The experts a row takes
// are device data (the router's top-k), so the kernel reads the indices
// itself: no host sync, no shape that depends on the routing, and a decode
// step stays enqueue-ahead (a CUDA graph of it stays possible).
//
// Inputs: x (M, D) bf16; idx (M, K) int32 expert ids, distinct in a row; w
// (M, K) f32 combine weights; w1 (E, 2F, D) bf16, each expert's gate rows
// then its up rows (out x in, a row per output neuron); w2 (E, D, F) bf16,
// the down rows. Numerics, as the plain version (ops/moe.py
// `moe_experts_plain`) rounds a bf16 model's ops:
//   g, u = bf16(x . gate_n), bf16(x . up_n)          (f32 sums)
//   h    = bf16(bf16(silu(g)) * u)
//   z    = bf16(h . down_n)                           (f32 sums)
//   y[m] = bf16(sum_k w[m, k] * z[m, k])              (f32, k in order)
//
// Bound: bytes. A call must read the weights of every expert that some row
// chose, once: 3 * D * F * 2 bytes an expert (17.3 MB at D 2048, F 1408).
// At a decode step of 8 rows x 6 choices about 35 of 64 experts are chosen,
// 0.61 GB a layer, 181 us at 3.35 TB/s; its 2 * 3 * D * F flops a choice
// are far below the line. A prefill of ~900 rows x 6 reads every expert but
// does 95 GFLOP: there the SIMT products bound it, not the bytes.
//
// Design: three launches, each grid (neuron tiles, E); block (tile, e)
// first scans idx for the assignments a = m * K + k that chose e (one warp,
// ballots, in order) and leaves at once if there are none, so an expert no
// row chose is never read.
//   (a) moe_gate_up: warp = one neuron n of 8: its gate and up rows held in
//       registers (16-byte loads, lane-strided), the assigned rows of x
//       staged 8 at a time in shared memory; writes h[a, n].
//   (b) moe_down: the same over the down rows, h staged; writes z[a, n].
//   (c) moe_combine: block m sums its K rows of z with the weights.
// Each expert's weights are read from device memory once a call whatever
// the number of rows that chose it. The first block of each chosen expert
// adds one to `touched` where the caller passes it (the recorder's
// `moe.experts_touched`). h (M * K, F) and z (M * K, D) are scratch from the
// wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, one neuron each
constexpr int kNeurons = kThreads / 32;
constexpr int kRows = 8;        // assigned rows staged at a time
constexpr int kMaxD = 2048;     // gate / up row: 8 vectors a lane
constexpr int kMaxF = 1536;     // down row: 6 vectors a lane

__device__ __forceinline__ void widen8(const uint4 raw, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot8(const uint4 a, const uint4 b) {
  float x[8], y[8];
  widen8(a, x);
  widen8(b, y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i] * y[i];
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The assignments of expert e, in order, into `list`; their count. Warp 0
// scans; the block waits.
__device__ int gather_rows(const int* __restrict__ idx, int n_assign, int e, int* list,
                           int* count, int* touched) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int base = 0; base < n_assign; base += 32) {
      const int a = base + lane;
      const bool hit = a < n_assign && idx[a] == e;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) list[cnt + __popc(mask & ((1u << lane) - 1u))] = a;
      cnt += __popc(mask);
    }
    if (lane == 0) {
      *count = cnt;
      if (touched != nullptr && cnt > 0 && blockIdx.x == 0) atomicAdd(touched, 1);
    }
  }
  __syncthreads();
  return *count;
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
moe_gate_up(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
            const __nv_bfloat16* __restrict__ w1, __nv_bfloat16* __restrict__ h, int* touched,
            int M, int K, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;
  uint4* xs = reinterpret_cast<uint4*>(smem);                  // kRows x D / 8
  int* list = reinterpret_cast<int*>(smem + (size_t)kRows * D * 2);
  const int e = blockIdx.y;
  const int n_rows = gather_rows(idx, M * K, e, list, &count, touched);
  if (n_rows == 0) return;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kNeurons + warp;
  const int nv = D / 8;
  uint4 g[NV], u[NV];
  if (n < F) {
    const uint4* gr = reinterpret_cast<const uint4*>(w1 + ((size_t)e * 2 * F + n) * D);
    const uint4* ur = reinterpret_cast<const uint4*>(w1 + ((size_t)e * 2 * F + F + n) * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = i * 32 + lane;
      if (v < nv) {
        g[i] = __ldg(gr + v);
        u[i] = __ldg(ur + v);
      }
    }
  }
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int nr = min(kRows, n_rows - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * nv; i += kThreads) {
      const int r = i / nv, v = i % nv;
      const int m = list[r0 + r] / K;
      xs[r * nv + v] = reinterpret_cast<const uint4*>(x + (size_t)m * D)[v];
    }
    __syncthreads();
    if (n < F) {
      for (int r = 0; r < nr; ++r) {
        float sg = 0.f, su = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = i * 32 + lane;
          if (v < nv) {
            const uint4 xv = xs[r * nv + v];
            sg += dot8(g[i], xv);
            su += dot8(u[i], xv);
          }
        }
        sg = warp_sum(sg);
        su = warp_sum(su);
        if (lane == 0) {
          const float gb = round_bf16(sg), ub = round_bf16(su);
          const float act = round_bf16(gb / (1.f + __expf(-gb)));
          h[(size_t)list[r0 + r] * F + n] = __float2bfloat16_rn(act * ub);
        }
      }
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
moe_down(const __nv_bfloat16* __restrict__ h, const int* __restrict__ idx,
         const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ z, int M, int K,
         int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;
  uint4* hs = reinterpret_cast<uint4*>(smem);                  // kRows x F / 8
  int* list = reinterpret_cast<int*>(smem + (size_t)kRows * F * 2);
  const int e = blockIdx.y;
  const int n_rows = gather_rows(idx, M * K, e, list, &count, nullptr);
  if (n_rows == 0) return;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kNeurons + warp;
  const int nv = F / 8;
  uint4 wd[NV];
  if (n < D) {
    const uint4* dr = reinterpret_cast<const uint4*>(w2 + ((size_t)e * D + n) * F);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = i * 32 + lane;
      if (v < nv) wd[i] = __ldg(dr + v);
    }
  }
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    const int nr = min(kRows, n_rows - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * nv; i += kThreads) {
      const int r = i / nv, v = i % nv;
      hs[r * nv + v] = reinterpret_cast<const uint4*>(h + (size_t)list[r0 + r] * F)[v];
    }
    __syncthreads();
    if (n < D) {
      for (int r = 0; r < nr; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = i * 32 + lane;
          if (v < nv) s += dot8(wd[i], hs[r * nv + v]);
        }
        s = warp_sum(s);
        if (lane == 0) z[(size_t)list[r0 + r] * D + n] = __float2bfloat16_rn(s);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
moe_combine(const __nv_bfloat16* __restrict__ z, const float* __restrict__ w,
            __nv_bfloat16* __restrict__ y, int K, int D) {
  const int m = blockIdx.x;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc += w[(size_t)m * K + k] * __bfloat162float(z[((size_t)m * K + k) * D + c]);
    y[(size_t)m * D + c] = __float2bfloat16_rn(acc);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// y (M, D) bf16 = the routed experts' weighted sum (see above). x (M, D),
// w1 (E, 2F, D), w2 (E, D, F) bf16 contiguous and 16-byte aligned; idx (M,
// K) int32 and w (M, K) f32 contiguous; h (M * K, F) and z (M * K, D) bf16
// scratch; touched null or one int the chosen experts are added to. D a
// multiple of 8 up to 2048, F a multiple of 8 up to 1536. Three launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for what the
// kernel does not take).
extern "C" int genvc_moe_experts(const void* x, const int* idx, const float* w, const void* w1,
                                 const void* w2, void* h, void* z, void* y, int* touched, int M,
                                 int K, int E, int D, int F, void* stream) {
  if (M <= 0 || K <= 0 || E <= 0 || D <= 0 || D % 8 || D > kMaxD || F <= 0 || F % 8 ||
      F > kMaxF || (((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)h |
                     (uintptr_t)z) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* zb = static_cast<__nv_bfloat16*>(z);
  const size_t list_bytes = (size_t)M * K * sizeof(int);

  const size_t smem_a = (size_t)kRows * D * 2 + list_bytes;
  cudaError_t err = allow_smem(moe_gate_up<kMaxD / 256>, smem_a);
  if (err != cudaSuccess) return (int)err;
  moe_gate_up<kMaxD / 256><<<dim3((F + kNeurons - 1) / kNeurons, E), kThreads, smem_a, st>>>(
      xb, idx, static_cast<const __nv_bfloat16*>(w1), hb, touched, M, K, D, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_b = (size_t)kRows * F * 2 + list_bytes;
  if ((err = allow_smem(moe_down<kMaxF / 256>, smem_b)) != cudaSuccess) return (int)err;
  moe_down<kMaxF / 256><<<dim3((D + kNeurons - 1) / kNeurons, E), kThreads, smem_b, st>>>(
      hb, idx, static_cast<const __nv_bfloat16*>(w2), zb, M, K, D, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  moe_combine<<<M, kThreads, 0, st>>>(zb, w, static_cast<__nv_bfloat16*>(y), K, D);
  return (int)cudaGetLastError();
}

// Causal, key-masked attention forward for Hopper (sm_90a): O and the
// per-row log-sum-exp.
//
// Replaces the Pallas kernel genvc_tpu/ops/flash_attention.py
// `_pallas_attention` (body `_attn_fwd_kernel`), with its numerics:
//   * s = (q . k^T) * scale in f32; where a key is invalid, or col > row under
//     `causal`, s is SET to -1e9 (not -inf, not added);
//   * m = rowmax, p = exp(s - m), l = sum p in f32; O = (p . v) / l, cast to
//     q's type; LSE = m + log(l) in f32.
// The Pallas kernel pads T to a multiple of 128 with invalid keys and sums
// its softmax over every padded column. Those columns carry exp(-1e9 - m),
// which is 0 for any row that sees a valid key; a row that sees none gets
// m = -1e9 and a uniform mean over all padded columns. Both kernels here keep
// that: a query tile holding such a row visits every key tile, and the
// columns up to the padded width that were not summed are added to l at the
// end (their v is 0).
//
// The TPU kernel holds all of one head's K and V in VMEM; here they do not
// fit in shared memory (hd = 256, T = 756: 0.77 MB in bf16), so both kernels
// run an online softmax over key tiles and skip the key tiles past the
// causal diagonal.
//
// bf16 (the model's path): tensor cores. One block of 8 warps per
// (b * H + h, 32-row query tile): 40 blocks at the latent pass (B*H = 4,
// T = 308), 192 at the training step (B*H = 32, T = 184). Q and two stages of
// 64-key K/V tiles stay bf16 in shared memory, rows padded by 16 bytes (an
// odd number of 16-byte units, so ldmatrix's eight rows hit eight bank
// groups) and zero-filled to a multiple of 16 columns; the next K/V tile is
// copied with cp.async while the current one is computed. The block's two
// 16-row query groups share each K/V tile, and the four warps of a group
// split its keys, 16 each (so a row's keys are walked four at a time): S =
// Q.K^T on mma.sync m16n8k16 with f32 accumulators, the mask and the online
// softmax on the accumulator fragments, P packed to bf16 in registers as
// the A operand of P.V (V through ldmatrix.trans), O accumulated in f32. A
// group's four (m, l, O) are combined in shared memory at the end. Measured
// against one group of 4 warps per 16-row tile (twice the blocks), two
// groups were as fast or faster at every shape tried, B = 1 included.
// One change of numerics against the Pallas body, which multiplies an
// unrounded f32 p by v: here p is rounded to bf16 (relative to the warp's
// running max) before P.V. Its error, 2^-9 of each weight, sits under the
// bf16 output's own rounding; l and LSE still come from the f32 p.
//
// f32 (small configurations and card-vs-CPU checks): f32 FMA, as exact as
// the reference allows. One block of 256 threads per (b * H + h, 32-row
// query tile) loops over 32-row key tiles staged in shared memory; thread
// (r, g) owns query row r of the tile (8 threads per row): it scores keys g,
// g + 8, g + 16, g + 24 of each key tile, and accumulates O columns
// [4g + 32c, 4g + 32c + 4) for c < hd / 32. Shared-memory rows are hd + 4
// floats long, an odd number of float4s, so the eight rows a warp reads at
// once fall in eight different bank groups.
//
// Bound at the main-path shape (latent pass, B = 1, H = 4, T = 308, hd = 256,
// bf16): bytes. The kernel must read q, k, v and write O, 4 * B*H*T*hd * 2
// bytes, plus LSE (4 * B*H*T) and the key mask (B*T): 2.53 MB, 0.75 us at
// 3.35 TB/s. Its arithmetic after the causal skip is about 2 * B*H*T^2*hd =
// 194 MFLOP, 0.2 us on the bf16 tensor cores. At that size the kernel is
// latency-bound: the last query tile walks 5 key tiles in turn.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kMaxHd = 256;
constexpr int kPadTo = 128;                     // the Pallas kernel's padding
constexpr float kMasked = -1e9f;

// ---------------------------------------------------------------- f32, SIMT

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;                  // threads per query row
constexpr int kBQ = kThreads / kRowThreads;     // 32 query rows per block
constexpr int kBK = 32;                         // key rows per tile
constexpr int kKeysPerThread = kBK / kRowThreads;
constexpr int kChunks = kMaxHd / (4 * kRowThreads);  // O float4s per thread

// 8 values (two 16-byte loads)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// rows of `rows` x hd from global (row stride `st`, rows >= n_valid zero) to
// shared rows of length ld
__device__ __forceinline__ void stage(const float* __restrict__ src, long long st,
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

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse, int H, int T_len,
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
    float* o_row = out + (long long)b * ob + (long long)h * oh + (long long)row * ot;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * g + 4 * kRowThreads * c;
      if (col < hd)
        *reinterpret_cast<float4*>(o_row + col) = make_float4(
            acc[c][0] / l_run, acc[c][1] / l_run, acc[c][2] / l_run, acc[c][3] / l_run);
    }
    if (g == 0) lse[(long long)bh * T_len + row] = m_run + logf(l_run);
  }
}

// -------------------------------------------------------- bf16, tensor cores

namespace tc {

using mma_tiles::cp_async16;
using bf16 = __nv_bfloat16;

constexpr int kSliceWarps = 4;           // warps that split a tile's keys
constexpr int kGroups = 2;               // 16-row query groups sharing each K/V tile
constexpr int kWarps = kSliceWarps * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16;                  // query rows of a group: one mma row tile
constexpr int kRows = kBQ * kGroups;     // query rows per block
constexpr int kSlice = 16;               // keys per warp per tile
constexpr int kBK = kSlice * kSliceWarps;  // keys per tile
constexpr int kStages = 2;               // K/V tiles in shared memory

__host__ __device__ constexpr int round16(int hd) { return (hd + 15) & ~15; }

// Shared memory: Q (kRows rows) | kStages x (K, V) (kBK rows each), rows of
// round16(hd) + 8 bf16 | per warp: m, l (kBQ f32 each), summed columns
// (int) | first valid key (int). After the key loop the K/V area holds the
// warps' f32 O tiles (kWarps x kBQ rows of round16(hd) + 8): the same bytes.
size_t smem_bytes(int hd) {
  const size_t ld = size_t(round16(hd)) + 8;
  return sizeof(bf16) * (kRows + 2 * kStages * kBK) * ld +
         sizeof(float) * (2 * kWarps * kBQ + kWarps + 1);
}

// kHd: the register tile's width (hd <= kHd); hd itself is a runtime value.
// Warp w takes query group w / 4 and key slice w % 4.
template <int kHd>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                     bf16* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                     int hd, float scale, int causal, long long sb, long long sh,
                     long long st, long long ob, long long oh, long long ot) {
  extern __shared__ uint4 smem_raw[];
  const int hd16 = round16(hd);
  const int ld = hd16 + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kRows * ld;  // stage i: K at kv_s + 2 i kBK ld, V kBK ld after
  float* m_s = reinterpret_cast<float*>(kv_s + 2 * kStages * kBK * ld);
  float* l_s = m_s + kWarps * kBQ;
  int* n_s = reinterpret_cast<int*>(l_s + kWarps * kBQ);
  int* first_s = n_s + kWarps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = warp / kSliceWarps;
  const int slice = warp - group * kSliceWarps;
  const int g = lane >> 2;   // accumulator rows g and g + 8
  const int t4 = lane & 3;   // accumulator columns 2 t4, 2 t4 + 1
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const int qg = q0 + group * kBQ;  // this warp's first query row
  const long long base = (long long)b * sb + (long long)h * sh;
  const uint8_t* valid_row = kv_valid + (long long)b * T_len;
  const int chunks = hd / 8;  // 16-byte pieces of a row
  // this thread's first (row, piece) of a tile copy and its stride
  const int r_first = tid / chunks;
  const int c_first = tid - r_first * chunks;
  const int r_step = kThreads / chunks;
  const int c_step = kThreads - r_step * chunks;

  // rows [r0, r0 + rows) of q, k or v into shared rows; rows >= T are zeros
  auto load_rows = [&](bf16* dst, const bf16* src, int r0, int rows) {
    src += base;
    for (int r = r_first, c = c_first; r < rows;) {
      const bool in = r0 + r < T_len;
      cp_async16(dst + r * ld + 8 * c, src + (long long)(in ? r0 + r : 0) * st + 8 * c,
                 in ? 16 : 0);
      r += r_step;
      c += c_step;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  };

  // columns [hd, hd16) of every shared row are zero (cp.async never writes
  // them): hd is a multiple of 8, so that is one 16-byte piece or none
  if (hd16 != hd)
    for (int r = tid; r < kRows + 2 * kStages * kBK; r += kThreads)
      *reinterpret_cast<uint4*>(q_s + r * ld + hd) = make_uint4(0, 0, 0, 0);
  if (tid == 0) *first_s = T_len;
  __syncthreads();
  // first valid key of batch row b: under causal, rows before it see none
  if (causal) {
    int f = T_len;
    for (int t = tid; t < T_len; t += kThreads) {
      if (valid_row[t]) {
        f = t;
        break;
      }
    }
    f = __reduce_min_sync(0xffffffffu, f);
    if (lane == 0 && f < T_len) atomicMin(first_s, f);
  }
  load_rows(q_s, q, q0, kRows);
  load_rows(kv_s, k, 0, kBK);
  load_rows(kv_s + kBK * ld, v, 0, kBK);
  mma_tiles::cp_async_commit();
  __syncthreads();

  // keys a group visits: up to its last row under causal, every key when a
  // row of the group sees no valid key (see the note at the top); the block
  // walks the tiles of its last group
  const int first = *first_s;
  int k_end = T_len;
  if (causal && qg >= first) k_end = min(qg + kBQ, T_len);
  int k_block = T_len;
  if (causal && q0 >= first) k_block = min(q0 + kRows, T_len);
  const int n_tiles = (k_block + kBK - 1) / kBK;

  float acc[kHd / 8][4];
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // m stays finite (>= -1e9): exp(m_old - m_new) is never NaN
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only; quad-summed at the end
  int n_summed = 0;
  const bf16* q_w = q_s + group * kBQ * ld;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      bf16* nxt = kv_s + ((j + 1) % kStages) * 2 * kBK * ld;
      load_rows(nxt, k, (j + 1) * kBK, kBK);
      load_rows(nxt + kBK * ld, v, (j + 1) * kBK, kBK);
      mma_tiles::cp_async_commit();
      mma_tiles::cp_async_wait<1>();
    } else {
      mma_tiles::cp_async_wait<0>();
    }
    __syncthreads();

    const int key0 = j * kBK + slice * kSlice;  // this warp's 16 keys
    if (key0 < k_end) {
      const bf16* k_t = kv_s + (j % kStages) * 2 * kBK * ld + slice * kSlice * ld;
      const bf16* v_t = k_t + kBK * ld;

      // S = Q . K^T: two n-tiles of 8 keys, hd in k-steps of 16, even and
      // odd k-steps in separate accumulators (four mma chains in flight)
      float sk[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        if (kk * 16 < hd16) {
          uint32_t a[4], bk[4];
          mma_tiles::ldmatrix_x4(a, q_w + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
          mma_tiles::ldmatrix_x4(
              bk, k_t + ((lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                      ((lane >> 3) & 1) * 8);
          mma_tiles::mma_bf16_16816(sk[kk & 1][0], a, bk[0], bk[1]);
          mma_tiles::mma_bf16_16816(sk[kk & 1][1], a, bk[2], bk[3]);
        }
      }
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = sk[0][nt][e] + sk[1][nt][e];

      // mask (SET to -1e9) and the online softmax, per accumulator row; a
      // slice of valid keys at or below every row's diagonal needs no mask
      const bool key_ok = key0 + (lane & 15) < T_len && __ldg(valid_row + key0 + (lane & 15));
      const bool open = __all_sync(0xffffffffu, key_ok) && (!causal || key0 + kSlice <= qg + 1);
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = qg + g + 8 * hr;
        float tile_max = kMasked;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const int col = key0 + 8 * nt + 2 * t4 + (e & 1);
            bool ok = open;
            if (!open) {
              ok = col < T_len && __ldg(valid_row + col);
              if (causal) ok = ok && col <= row;
            }
            s[nt][e] = ok ? s[nt][e] * scale : kMasked;
            tile_max = fmaxf(tile_max, s[nt][e]);
          }
        }
        const float m_new = fmaxf(m_run[hr], mma_tiles::quad_max(tile_max));
        alpha[hr] = expf(m_run[hr] - m_new);
        m_run[hr] = m_new;
        float p_sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[nt][e] = expf(s[nt][e] - m_new);
            p_sum += s[nt][e];
          }
        }
        l_run[hr] = l_run[hr] * alpha[hr] + p_sum;
      }

      // P (bf16) as the A operand: the accumulator layout is A's layout
      const uint32_t p[4] = {
          mma_tiles::pack_bf16x2(s[0][0], s[0][1]), mma_tiles::pack_bf16x2(s[0][2], s[0][3]),
          mma_tiles::pack_bf16x2(s[1][0], s[1][1]), mma_tiles::pack_bf16x2(s[1][2], s[1][3])};
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kHd / 8; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }
      // O += P . V: V's rows are keys, so its B fragments come transposed
#pragma unroll
      for (int nn = 0; nn < kHd / 16; ++nn) {
        if (nn * 16 < hd16) {
          uint32_t bv[4];
          mma_tiles::ldmatrix_x4_trans(bv, v_t + (lane & 15) * ld + nn * 16 + (lane >> 4) * 8);
          mma_tiles::mma_bf16_16816(acc[2 * nn], p, bv[0], bv[1]);
          mma_tiles::mma_bf16_16816(acc[2 * nn + 1], p, bv[2], bv[3]);
        }
      }
      n_summed += kSlice;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // the warps' (m, l, O) to shared memory; the K/V stages are free now
  const int ldo = hd16 + 8;
  float* o_s = reinterpret_cast<float*>(kv_s);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float l_row = mma_tiles::quad_sum(l_run[hr]);
    if (t4 == 0) {
      m_s[warp * kBQ + g + 8 * hr] = m_run[hr];
      l_s[warp * kBQ + g + 8 * hr] = l_row;
    }
  }
  if (lane == 0) n_s[warp] = n_summed;
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) {
    if (n * 8 < hd16) {
      float* o = o_s + (warp * kBQ + g) * ldo + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(o) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(o + 8 * ldo) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();

  // combine a group's warps: m = their max, l = sum of l_w exp(m_w - m)
  // plus the padded columns not summed; O = sum of O_w exp(m_w - m) / l
  const int t_pad = (T_len + kPadTo - 1) / kPadTo * kPadTo;
  for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int row = q0 + r;
    if (row >= T_len) continue;
    const int w0 = (r / kBQ) * kSliceWarps;  // the row's group's first warp
    const int rr = r % kBQ;
    float m = kMasked;
    int n_total = 0;
#pragma unroll
    for (int w = w0; w < w0 + kSliceWarps; ++w) {
      m = fmaxf(m, m_s[w * kBQ + rr]);
      n_total += n_s[w];
    }
    float f[kSliceWarps];
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kSliceWarps; ++w) {
      f[w] = expf(m_s[(w0 + w) * kBQ + rr] - m);
      l += l_s[(w0 + w) * kBQ + rr] * f[w];
    }
    l += (float)(t_pad - n_total) * expf(kMasked - m);
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kSliceWarps; ++w) {
      const float4* src = reinterpret_cast<const float4*>(o_s + ((w0 + w) * kBQ + rr) * ldo + c);
      const float4 x0 = src[0], x1 = src[1];
      o[0] += x0.x * f[w]; o[1] += x0.y * f[w]; o[2] += x0.z * f[w]; o[3] += x0.w * f[w];
      o[4] += x1.x * f[w]; o[5] += x1.y * f[w]; o[6] += x1.z * f[w]; o[7] += x1.w * f[w];
    }
    const uint4 packed = make_uint4(
        mma_tiles::pack_bf16x2(o[0] / l, o[1] / l), mma_tiles::pack_bf16x2(o[2] / l, o[3] / l),
        mma_tiles::pack_bf16x2(o[4] / l, o[5] / l), mma_tiles::pack_bf16x2(o[6] / l, o[7] / l));
    *reinterpret_cast<uint4*>(out + (long long)b * ob + (long long)h * oh +
                              (long long)row * ot + c) = packed;
    if (c == 0) lse[(long long)bh * T_len + row] = m + logf(l);
  }
}

}  // namespace tc

template <typename Elem, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads, const void* q,
                   const void* k, const void* v, const void* kv_valid, void* out,
                   void* lse, int H, int T_len, int hd, float scale, int causal,
                   long long sb, long long sh, long long st, long long ob, long long oh,
                   long long ot, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<Elem*>(out), static_cast<float*>(lse), H, T_len, hd, scale,
      causal, sb, sh, st, ob, oh, ot);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, H, T, hd) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), one set of
// element strides (sb, sh, st) for all three, head dim contiguous, rows
// 16-byte aligned; kv_valid (B, T) bytes 0/1, contiguous; out (B, H, T, hd)
// in q's type with strides (ob, oh, ot), rows 16-byte aligned; lse (B, H, T)
// f32, contiguous. Returns a cudaError_t.
extern "C" int genvc_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int B, int H, int T_len, int hd, float scale,
    int causal, int is_bf16, long long sb, long long sh, long long st,
    long long ob, long long oh, long long ot, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > kMaxHd || T_len <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch<float>(flash_fwd_kernel, smem_bytes(hd),
                              dim3((T_len + kBQ - 1) / kBQ, B * H), kThreads, q, k, v,
                              kv_valid, out, lse, H, T_len, hd, scale, causal, sb, sh,
                              st, ob, oh, ot, s);
  const dim3 grid((T_len + tc::kRows - 1) / tc::kRows, B * H);
  const size_t smem = tc::smem_bytes(hd);
  auto run = [&](auto kernel) {
    return (int)launch<__nv_bfloat16>(kernel, smem, grid, tc::kThreads, q, k, v, kv_valid,
                                      out, lse, H, T_len, hd, scale, causal, sb, sh, st, ob,
                                      oh, ot, s);
  };
  // One build takes every hd: the <256> tile's k-steps past round16(hd) are
  // skipped at run time. Every bf16 path runs hd = 256.
  return run(tc::flash_fwd_mma_kernel<256>);
}

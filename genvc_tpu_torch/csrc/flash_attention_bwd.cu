// Causal, key-masked attention backward for Hopper (sm_90a): dq (K5) and
// dk / dv (K6) from the forward's saved log-sum-exp.
//
// Replaces the Pallas kernels of genvc_tpu/ops/flash_attention.py
// `_pallas_backward`: `_attn_dq_kernel` (dq) and `_attn_dkdv_kernel` (dk, dv),
// with their numerics:
//   * q, k, v and dO are read at their storage type (bf16 or f32) and widened
//     to f32;
//   * s = (q . k^T) * scale in f32, SET to -1e9 where the key is invalid or,
//     under `causal`, col > row;
//   * p = exp(s - LSE) with the LSE the forward saved;
//   * dp = dO . v^T and ds = p * (dp - D) in f32, with D = rowsum(dO * O)
//     computed by the caller;
//   * dq = (ds . k) * scale, dk = (ds^T . q) * scale, dv = p^T . dO, summed in
//     f32 and cast to q's type.
// One change of numerics on the bf16 path (the model's), as in the forward:
// the tensor cores take p and ds as bf16, so both are rounded to bf16 (round
// to nearest even) before the second products p^T . dO, ds . k and ds^T . q;
// every sum stays f32, and s, dp, D and the LSE are unchanged. Where a K5
// query group (16 rows) or a K6 query tile (64 rows) holds a row that sees
// no valid key, ds goes in as two bf16 parts, bf16(ds) and bf16(ds -
// bf16(ds)), with a product each: such a row has p = 1 on every key, so its
// ds = dp - D is not scaled down by a softmax, and dq / dk sum T large
// terms that cancel (bf16 ds alone then misses the 1e-2 + 1e-2 |w| check
// by up to 1.2x at T = 136 - 328). The f32 path rounds nothing.
// The Pallas kernels pad T to a multiple of 128; padded keys are zero rows
// (no term in dq, their dk / dv are dropped) and padded query rows have
// dO = 0, so the padding leaves no trace beyond the LSE. A query row that
// sees no valid key has LSE = -1e9 (the forward's -1e9 + log(T_pad) rounds
// to it in f32), so p = exp(-1e9 - LSE) is 1 on EVERY key, masked or not,
// causal or not. Such rows exist only before the first valid key of a batch
// row (under causal) or in a batch row with no valid key at all; K5 visits
// every key tile for a query tile holding one, and K6 visits the query
// tiles that hold one for every key tile. Elsewhere a masked s gives p = 0
// and the tiles past the causal diagonal are skipped.
//
// bf16 (the training step's path): tensor cores, mma.sync m16n8k16 with bf16
// operands and f32 accumulators (csrc/mma_tiles.cuh). Tiles are staged bf16
// in shared memory by cp.async, rows padded by 16 bytes (an odd number of
// 16-byte units, so ldmatrix's eight rows hit eight bank groups) and
// zero-filled to a multiple of 16 columns; the next walked tile is copied
// while the current one is computed, its copies spread over the current
// tile's first k-steps so that no warp stalls on a full copy queue. The grid
// is (b * H + h, tile) with (b, h) fastest, so the blocks with the longest
// causal walks of every (b, h) start first and the short ones fill the
// second wave. hd = 256 runs an exact build whose unrolled loops carry no
// run-time guard; other hd a build that skips the k-steps and columns past
// round16(hd).
//   K5: K4's shape. One block of 8 warps per (b * H + h, 32-row query tile);
//       Q and dO of the block stay in shared memory; 64-key K / V tiles go
//       through two stages. Warp w takes 16-row query group w / 4 and 16-key
//       slice w % 4 of every tile: S = Q.K^T and dP = dO.V^T on the tensor
//       cores (K and V as the "col" operand through ldmatrix), the mask,
//       P = exp(S - LSE) and dS = P * (dP - D) on the accumulator fragments,
//       dS stored to shared memory as bf16. Then the warp adds dS.K over all
//       64 keys of the tile into its own 64 columns of the group's dQ (dS as
//       the A operand, K through ldmatrix.trans): 32 accumulator registers,
//       and each dQ element summed over the keys in one order, with no
//       partial sums to combine. LSE is known, so nothing is rescaled.
//   K6: one block of 8 warps per (b * H + h, key tile of 64, or of 32 when
//       blocks of 64 keys would leave SMs idle), walking 64-row query tiles
//       (from the diagonal down, and those holding rows with no valid key)
//       through two stages of Q, dO, LSE and D; K and V stay. Everything is
//       computed transposed, so no tile is transposed in memory. Phase 1,
//       warp w: S^T = K.Q^T and dP^T = V.dO^T for its 16 keys and its share
//       of the tile's queries (K, V as the A operand, Q, dO as "col"),
//       P^T = exp(S^T - LSE) and dS^T = P^T * (dP^T - D) with LSE and D
//       indexed by column, written to shared memory as bf16. Phase 2, warp
//       w: dV += P^T.dO and dK += dS^T.Q for its 16 keys and its share of
//       the columns (dO and Q through ldmatrix.trans). A warp owning 16 keys
//       of both dK and dV at hd = 256 would hold 256 accumulator registers a
//       thread, over the limit; the split over columns holds 128 (64-key
//       tiles) or 64, at the price of P^T and dS^T passing through shared
//       memory (as FlashAttention-2's backward keeps them). dK and dV leave
//       through shared memory as 16-byte rows. Shared memory at hd = 256:
//       231,428 bytes (64 keys) of the 232,448 a block may have, one block
//       per SM.
//   Both are separate kernels, as the Pallas backward has them: each output
//   is summed in one fixed order, with no atomics. Tried and dropped (PERF.md):
//   S and dP split between warps on 32 x 32 quadrants with P handed
//   over through shared memory, fewer ldmatrix per mma but slower (five
//   barriers a tile, and K6 at 255 registers). wgmma and TMA are later work.
//
// f32 (small configurations and card-vs-CPU checks), f32 FMA, as exact as
// the reference allows:
//   K5: one block of 256 threads per (b * H + h, 32-row query tile); Q and
//       dO tiles staged as f32 in shared memory; loops over 32-row K / V
//       tiles. Thread (r, g) (8 threads per row) scores keys g + 8 i of the
//       tile for query row r (s and dp), writes ds to shared memory, then
//       accumulates dq columns [4g + 32c, 4g + 32c + 4).
//   K6: one block per (b * H + h, 32-row key tile); K and V staged once;
//       loops over 32-row Q / dO tiles (the diagonal down, plus those
//       holding rows with no valid key). Thread (r, g) owns key row r:
//       scores query rows g + 8 i (s and dp), writes p and ds transposed to
//       shared memory, then accumulates dk and dv columns
//       [4g + 32c, 4g + 32c + 4).
// Shared-memory rows are hd + 4 floats long (an odd number of float4s), so
// the eight rows a warp reads at once fall in eight bank groups.
//
// Bound at the training step's shape (B = 8, H = 4, T = 184, hd = 256,
// bf16): bytes. Both kernels together must read q, k, v and dO and write
// dq, dk and dv (7 * B*H*T*hd * 2 bytes) plus LSE and D (2 * 4 * B*H*T)
// and the key mask: 21.1 MB, 6.3 us at 3.35 TB/s. Their arithmetic is five
// T x T x hd products per (b, h), halved by causality: 2.8 GFLOP, 2.8 us on
// the bf16 tensor cores. At these sizes the kernels are latency-bound: the
// longest block walks every tile of its row in turn, and each block pays
// its first copies and its output stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;                  // threads per row
constexpr int kTile = kThreads / kRowThreads;   // 32 rows per tile
constexpr int kPerThread = kTile / kRowThreads; // 4 scores per thread
constexpr int kMaxHd = 256;
constexpr int kChunks = kMaxHd / (4 * kRowThreads);  // float4s per thread
constexpr float kMasked = -1e9f;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// kTile rows x hd from global (row stride `st`, rows >= n_valid zero) to
// shared f32 rows of length ld
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long st,
                                      int n_valid, int hd, int ld, float* dst) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
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

// two dot products over hd of f32 rows in shared memory: a.b and c.d
__device__ __forceinline__ void dot2(const float* a, const float* b,
                                     const float* c, const float* d, int hd,
                                     float& ab, float& cd) {
  float x = 0.f, y = 0.f;
  for (int i = 0; i < hd; i += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + i);
    const float4 bv = *reinterpret_cast<const float4*>(b + i);
    const float4 cv = *reinterpret_cast<const float4*>(c + i);
    const float4 dv = *reinterpret_cast<const float4*>(d + i);
    x = fmaf(av.x, bv.x, x); x = fmaf(av.y, bv.y, x);
    x = fmaf(av.z, bv.z, x); x = fmaf(av.w, bv.w, x);
    y = fmaf(cv.x, dv.x, y); y = fmaf(cv.y, dv.y, y);
    y = fmaf(cv.z, dv.z, y); y = fmaf(cv.w, dv.w, y);
  }
  ab = x;
  cd = y;
}

// first valid key of batch row b into *first_s (T_len if none); every thread
// of the block must call it
__device__ __forceinline__ void first_valid(const uint8_t* valid_row, int T_len,
                                            int* first_s) {
  if (threadIdx.x == 0) *first_s = T_len;
  __syncthreads();
  int f = T_len;
  for (int t = threadIdx.x; t < T_len; t += kThreads) {
    if (valid_row[t]) {
      f = t;
      break;
    }
  }
  if (f < T_len) atomicMin(first_s, f);
  __syncthreads();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_valid;
  const void* g;          // dO
  const float* lse;       // (B, H, T) contiguous
  const float* dd;        // D = rowsum(dO * O), (B, H, T) contiguous
  void* dq;
  void* dk;
  void* dv;
  int H, T_len, hd, causal;
  float scale;
  long long sb, sh, st;   // q, k, v
  long long gb, gh, gt;   // dO
  long long ob, oh, ot;   // dq, dk, dv
};

// Shared memory (floats): 4 row tiles (hd + 4 wide) | 2 score tiles
// (kTile x (kTile + 1)) | 3 x kTile per-row values | one int.
size_t smem_bytes(int hd) {
  const size_t ld = size_t(hd) + 4;
  return sizeof(float) * (4 * kTile * ld + 2 * kTile * (kTile + 1) + 3 * kTile + 1);
}

// K5: dq for one (b, h, 32-row query tile)
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = a.hd + 4;
  float* q_s = smem;
  float* g_s = q_s + kTile * ld;
  float* k_s = g_s + kTile * ld;
  float* v_s = k_s + kTile * ld;
  float* ds_s = v_s + kTile * ld;
  float* valid_s = ds_s + 2 * kTile * (kTile + 1);
  int* first_s = reinterpret_cast<int*>(valid_s + 3 * kTile);

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;
  const int g = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * kTile;
  const int row = q0 + r;
  const int T_len = a.T_len;
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const long long gbase = (long long)b * a.gb + (long long)h * a.gh;
  const uint8_t* valid_row = a.kv_valid + (long long)b * T_len;

  first_valid(valid_row, T_len, first_s);
  stage(static_cast<const T*>(a.q) + base + (long long)q0 * a.st, a.st,
        T_len - q0, a.hd, ld, q_s);
  stage(static_cast<const T*>(a.g) + gbase + (long long)q0 * a.gt, a.gt,
        T_len - q0, a.hd, ld, g_s);
  const float lse = row < T_len ? a.lse[(long long)bh * T_len + row] : 0.f;
  const float dd = row < T_len ? a.dd[(long long)bh * T_len + row] : 0.f;

  // keys with p != 0: up to the tile's last row under causal, every key when
  // a row of the tile sees no valid key (see the note at the top)
  int k_end = T_len;
  if (a.causal && q0 >= *first_s) k_end = min(q0 + kTile, T_len);
  const int n_tiles = (k_end + kTile - 1) / kTile;

  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const float* q_row = q_s + r * ld;
  const float* g_row = g_s + r * ld;
  float* ds_row = ds_s + r * (kTile + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every thread is done with the previous K/V tile
    stage(static_cast<const T*>(a.k) + base + (long long)k0 * a.st, a.st,
          T_len - k0, a.hd, ld, k_s);
    stage(static_cast<const T*>(a.v) + base + (long long)k0 * a.st, a.st,
          T_len - k0, a.hd, ld, v_s);
    for (int i = tid; i < kTile; i += kThreads)
      valid_s[i] = (k0 + i < T_len && valid_row[k0 + i]) ? 1.f : 0.f;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int kk = g + kRowThreads * i;
      float s, dp;
      dot2(q_row, k_s + kk * ld, g_row, v_s + kk * ld, a.hd, s, dp);
      bool ok = valid_s[kk] != 0.f;
      if (a.causal) ok = ok && (k0 + kk <= row);
      s = ok ? s * a.scale : kMasked;
      const float p = expf(s - lse);
      ds_row[kk] = p * (dp - dd);
    }
    __syncwarp();  // the row's 8 threads share one warp

    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = ds_row[kk];
      const float* k_row = k_s + kk * ld;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * g + 4 * kRowThreads * c;
        if (col < a.hd) {
          const float4 kv = *reinterpret_cast<const float4*>(k_row + col);
          acc[c][0] = fmaf(ds, kv.x, acc[c][0]);
          acc[c][1] = fmaf(ds, kv.y, acc[c][1]);
          acc[c][2] = fmaf(ds, kv.z, acc[c][2]);
          acc[c][3] = fmaf(ds, kv.w, acc[c][3]);
        }
      }
    }
  }

  if (row < T_len) {
    T* o_row = static_cast<T*>(a.dq) + (long long)b * a.ob + (long long)h * a.oh +
               (long long)row * a.ot;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * g + 4 * kRowThreads * c;
      if (col < a.hd)
        store4(o_row + col, make_float4(acc[c][0] * a.scale, acc[c][1] * a.scale,
                                        acc[c][2] * a.scale, acc[c][3] * a.scale));
    }
  }
}

// K6: dk and dv for one (b, h, 32-row key tile)
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = a.hd + 4;
  float* k_s = smem;
  float* v_s = k_s + kTile * ld;
  float* q_s = v_s + kTile * ld;
  float* g_s = q_s + kTile * ld;
  float* p_s = g_s + kTile * ld;          // p^T: [key row][query row]
  float* ds_s = p_s + kTile * (kTile + 1);  // ds^T
  float* lse_s = ds_s + kTile * (kTile + 1);
  float* dd_s = lse_s + kTile;
  float* valid_s = dd_s + kTile;
  int* first_s = reinterpret_cast<int*>(valid_s + kTile);

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;   // key row in the tile
  const int g = tid % kRowThreads;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.x * kTile;
  const int key = k0 + r;
  const int T_len = a.T_len;
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const long long gbase = (long long)b * a.gb + (long long)h * a.gh;
  const uint8_t* valid_row = a.kv_valid + (long long)b * T_len;

  first_valid(valid_row, T_len, first_s);
  stage(static_cast<const T*>(a.k) + base + (long long)k0 * a.st, a.st,
        T_len - k0, a.hd, ld, k_s);
  stage(static_cast<const T*>(a.v) + base + (long long)k0 * a.st, a.st,
        T_len - k0, a.hd, ld, v_s);
  for (int i = tid; i < kTile; i += kThreads)
    valid_s[i] = (k0 + i < T_len && valid_row[k0 + i]) ? 1.f : 0.f;
  const int first = *first_s;

  float dk[kChunks][4], dv[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    dk[c][0] = dk[c][1] = dk[c][2] = dk[c][3] = 0.f;
    dv[c][0] = dv[c][1] = dv[c][2] = dv[c][3] = 0.f;
  }

  const float* k_row = k_s + r * ld;
  const float* v_row = v_s + r * ld;
  float* p_row = p_s + r * (kTile + 1);
  float* ds_row = ds_s + r * (kTile + 1);
  const int n_q_tiles = (T_len + kTile - 1) / kTile;
  for (int t = 0; t < n_q_tiles; ++t) {
    const int q0 = t * kTile;
    // query tiles wholly above the diagonal give p = 0 unless they hold rows
    // that see no valid key (rows before the first valid key)
    if (a.causal && q0 + kTile <= k0 && q0 >= first) continue;
    __syncthreads();  // every thread is done with the previous Q/dO tile
    stage(static_cast<const T*>(a.q) + base + (long long)q0 * a.st, a.st,
          T_len - q0, a.hd, ld, q_s);
    stage(static_cast<const T*>(a.g) + gbase + (long long)q0 * a.gt, a.gt,
          T_len - q0, a.hd, ld, g_s);
    for (int i = tid; i < kTile; i += kThreads) {
      const bool in = q0 + i < T_len;
      lse_s[i] = in ? a.lse[(long long)bh * T_len + q0 + i] : 0.f;
      dd_s[i] = in ? a.dd[(long long)bh * T_len + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int jj = g + kRowThreads * i;   // query row in the tile
      const int row = q0 + jj;
      float s, dp;
      dot2(q_s + jj * ld, k_row, g_s + jj * ld, v_row, a.hd, s, dp);
      bool ok = valid_s[r] != 0.f;
      if (a.causal) ok = ok && (key <= row);
      s = ok ? s * a.scale : kMasked;
      const float p = row < T_len ? expf(s - lse_s[jj]) : 0.f;
      p_row[jj] = p;
      ds_row[jj] = p * (dp - dd_s[jj]);
    }
    __syncwarp();  // the key row's 8 threads share one warp

    for (int jj = 0; jj < kTile; ++jj) {
      const float p = p_row[jj];
      const float ds = ds_row[jj];
      const float* q_row = q_s + jj * ld;
      const float* g_row = g_s + jj * ld;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * g + 4 * kRowThreads * c;
        if (col < a.hd) {
          const float4 gv = *reinterpret_cast<const float4*>(g_row + col);
          const float4 qv = *reinterpret_cast<const float4*>(q_row + col);
          dv[c][0] = fmaf(p, gv.x, dv[c][0]);
          dv[c][1] = fmaf(p, gv.y, dv[c][1]);
          dv[c][2] = fmaf(p, gv.z, dv[c][2]);
          dv[c][3] = fmaf(p, gv.w, dv[c][3]);
          dk[c][0] = fmaf(ds, qv.x, dk[c][0]);
          dk[c][1] = fmaf(ds, qv.y, dk[c][1]);
          dk[c][2] = fmaf(ds, qv.z, dk[c][2]);
          dk[c][3] = fmaf(ds, qv.w, dk[c][3]);
        }
      }
    }
  }

  if (key < T_len) {
    const long long off = (long long)b * a.ob + (long long)h * a.oh +
                          (long long)key * a.ot;
    T* dk_row = static_cast<T*>(a.dk) + off;
    T* dv_row = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * g + 4 * kRowThreads * c;
      if (col < a.hd) {
        store4(dk_row + col, make_float4(dk[c][0] * a.scale, dk[c][1] * a.scale,
                                         dk[c][2] * a.scale, dk[c][3] * a.scale));
        store4(dv_row + col, make_float4(dv[c][0], dv[c][1], dv[c][2], dv[c][3]));
      }
    }
  }
}

// -------------------------------------------------------- bf16, tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
using mma_tiles::cp_async16;

constexpr int kStages = 2;       // tiles in flight in shared memory
constexpr int kWarps = 8;
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kSlice = 16;       // rows of one mma tile: 16 queries or 16 keys
constexpr int kTileRows = 64;    // rows of a walked tile (K5: keys; K6: queries)

__host__ __device__ constexpr int round16(int hd) { return (hd + 15) & ~15; }

// Copies of row tiles into shared memory, spread over the threads of the
// block: 16-byte piece i of this thread is piece tid + kThreadsTc i of the
// tile (row = piece / (hd / 8)). With hd = 256 (the exact build) a 64-row
// tile is kExactPieces pieces a thread, issued one at a time between the
// products (so that no warp stalls on a full copy queue) and without a
// branch: a copy that is not wanted (`on` false) reads nothing and writes
// zeros into a stage no one reads.
constexpr int kExactPieces = kTileRows * (256 / 8) / kThreadsTc;
static_assert(kTileRows * (256 / 8) % kThreadsTc == 0, "whole pieces a thread");

struct Copier {
  int chunks;
  __device__ explicit Copier(int hd) : chunks(hd / 8) {}
  __device__ int pieces(int n_rows) const {
    return (n_rows * chunks + kThreadsTc - 1) / kThreadsTc;
  }
  // piece i of rows [r0, r0 + n_rows) of src (row stride st) into shared rows
  // of length ld; rows >= T_len are zeros. kWhole: every thread has piece i.
  template <bool kWhole = false>
  __device__ void piece(bf16* dst, const bf16* src, long long st, int r0, int n_rows,
                        int T_len, int ld, int i, bool on = true) const {
    const int idx = threadIdx.x + kThreadsTc * i;
    const int r = idx / chunks;
    if (!kWhole && r >= n_rows) return;
    const int c = idx - r * chunks;
    const bool in = on && r0 + r < T_len;
    cp_async16(dst + r * ld + 8 * c, src + (long long)(in ? r0 + r : 0) * st + 8 * c,
               in ? 16 : 0);
  }
  __device__ void rows(bf16* dst, const bf16* src, long long st, int r0, int n_rows,
                       int T_len, int ld) const {
    const int n = pieces(n_rows);
    for (int i = 0; i < n; ++i) piece(dst, src, st, r0, n_rows, T_len, ld, i);
  }
};

// first valid key of batch row b into *first_s (T_len when none); every
// thread must call it. The rows that see no valid key are those before it
// under causal, and every row when it is T_len.
__device__ __forceinline__ void first_valid_key(const uint8_t* valid_row, int T_len,
                                                int* first_s) {
  if (threadIdx.x == 0) *first_s = T_len;
  __syncthreads();
  int f = T_len;
  for (int t = threadIdx.x; t < T_len; t += kThreadsTc) {
    if (valid_row[t]) {
      f = t;
      break;
    }
  }
  f = __reduce_min_sync(0xffffffffu, f);
  if ((threadIdx.x & 31) == 0 && f < T_len) atomicMin(first_s, f);
  __syncthreads();
}

// whether rows [r0, ...) hold one that sees no valid key (p = 1 on every
// key, ds = dp - D unnormalised): there ds is carried as two bf16 parts
__device__ __forceinline__ bool holds_unseen(int r0, int first, int T_len, int causal) {
  return causal ? r0 < first : first == T_len;
}

// rows [r0, r0 + n_rows) of a [row][hd] bf16 shared tile (row length ld) to
// an output's rows (row stride st) in 16-byte pieces; rows >= T_len dropped
__device__ __forceinline__ void store_rows(bf16* dst, long long st, const bf16* src, int ld,
                                           int r0, int n_rows, int T_len, int hd) {
  const int chunks = hd / 8;
  for (int idx = threadIdx.x; idx < n_rows * chunks; idx += kThreadsTc) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    if (r0 + r < T_len)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * st + c) =
          *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// ---- K5: dq

constexpr int kDqGroups = 2;                   // 16-row query groups per block
constexpr int kDqSlices = kWarps / kDqGroups;  // warps splitting a tile's keys
constexpr int kDqRows = kSlice * kDqGroups;    // query rows per block
constexpr int kLdS = kTileRows + 8;            // dS rows: 64 keys + 16 bytes
static_assert(kSlice * kDqSlices == kTileRows, "a K / V tile is one slice per warp of a group");

// Shared memory: Q, dO (kDqRows rows each) | kStages x (K, V) (kTileRows
// rows each), rows of round16(hd) + 8 bf16 | dS and its rest (kDqRows rows
// of kLdS bf16 each) | first valid key. After the key loop Q's rows stage dQ
// for 16-byte stores.
size_t dq_smem_bytes(int hd) {
  const size_t ld = size_t(round16(hd)) + 8;
  return sizeof(bf16) * ((2 * kDqRows + 2 * kStages * kTileRows) * ld + 2 * kDqRows * kLdS) +
         sizeof(int);
}

// kHd: the register tile's width (hd <= kHd); hd itself is a runtime value,
// but for kExact (hd == kHd): no k-step or column is skipped at run time and
// the unrolled loops carry no branch, so their loads and products can be
// scheduled across k-steps.
template <int kHd, bool kExact>
__global__ void __launch_bounds__(kThreadsTc, 1) flash_bwd_dq_mma_kernel(Args a) {
  static_assert(!kExact || kHd == 256, "the exact build is hd = 256");
  constexpr int kCols = kHd / kDqSlices;  // dQ columns of a warp
  extern __shared__ uint4 smem_raw[];
  const int hd = kExact ? kHd : a.hd;
  const int hd16 = kExact ? kHd : round16(hd);
  const int ld = hd16 + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kDqRows * ld;
  bf16* kv_s = g_s + kDqRows * ld;  // stage i: K at kv_s + 2 i kTileRows ld, V kTileRows ld after
  bf16* ds_s = kv_s + 2 * kStages * kTileRows * ld;  // dS: [query row][key of the tile]
  bf16* dsr_s = ds_s + kDqRows * kLdS;               // its rest (split groups)
  int* first_s = reinterpret_cast<int*>(dsr_s + kDqRows * kLdS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = warp / kDqSlices;
  const int slice = warp - group * kDqSlices;
  const int g = lane >> 2;   // accumulator rows g and g + 8
  const int t4 = lane & 3;   // accumulator columns 2 t4, 2 t4 + 1
  const int cb = slice * kCols;  // this warp's dQ columns
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int T_len = a.T_len;
  // the last query tiles (the longest causal walks) of every (b, h) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int qg = q0 + group * kSlice;                     // this warp's first query row
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const uint8_t* valid_row = a.kv_valid + (long long)b * T_len;
  const Copier copy(hd);

  // columns [hd, hd16) of every shared row are zero (cp.async never writes
  // them): hd is a multiple of 8, so that is one 16-byte piece or none
  if (!kExact && hd16 != hd)
    for (int r = tid; r < 2 * kDqRows + 2 * kStages * kTileRows; r += kThreadsTc)
      *reinterpret_cast<uint4*>(q_s + r * ld + hd) = make_uint4(0, 0, 0, 0);
  // the first tiles are copied while the first valid key is looked up
  copy.rows(kv_s, k, a.st, 0, kTileRows, T_len, ld);
  copy.rows(kv_s + kTileRows * ld, v, a.st, 0, kTileRows, T_len, ld);
  copy.rows(q_s, static_cast<const bf16*>(a.q) + base, a.st, q0, kDqRows, T_len, ld);
  copy.rows(g_s, static_cast<const bf16*>(a.g) + (long long)b * a.gb + (long long)h * a.gh,
            a.gt, q0, kDqRows, T_len, ld);
  mma_tiles::cp_async_commit();
  first_valid_key(valid_row, T_len, first_s);

  // keys with p != 0 for a group: up to its last row under causal, every key
  // when a row of the group sees no valid key (see the note at the top); the
  // block walks the tiles of its last group
  const int first = *first_s;
  int k_end = T_len;
  if (a.causal && qg >= first) k_end = min(qg + kSlice, T_len);
  int k_block = T_len;
  if (a.causal && q0 >= first) k_block = min(q0 + kDqRows, T_len);
  const int n_tiles = (k_block + kTileRows - 1) / kTileRows;
  const bool split = holds_unseen(qg, first, T_len, a.causal);

  // LSE and D of rows g and g + 8 (0 past T: those rows are not written)
  float lse[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = qg + g + 8 * hr;
    lse[hr] = row < T_len ? a.lse[(long long)bh * T_len + row] : 0.f;
    dd[hr] = row < T_len ? a.dd[(long long)bh * T_len + row] : 0.f;
  }

  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* q_w = q_s + group * kSlice * ld;
  const bf16* g_w = g_s + group * kSlice * ld;
  bf16* ds_w = ds_s + group * kSlice * kLdS;  // the group's dS rows
  bf16* dsr_w = dsr_s + group * kSlice * kLdS;
  const int n_pieces = copy.pieces(kTileRows);

  for (int j = 0; j < n_tiles; ++j) {
    mma_tiles::cp_async_wait<0>();  // tile j (copied during tile j - 1)
    __syncthreads();
    // the next tile is copied while this one is computed: spread over the
    // k-steps of S / dP in the exact build, else all at once here
    const bool more = j + 1 < n_tiles;
    bf16* nxt = kv_s + ((j + 1) % kStages) * 2 * kTileRows * ld;
    const int k_nxt = (j + 1) * kTileRows;
    auto copy_next = [&](int i) {
      copy.piece<kExact>(nxt, k, a.st, k_nxt, kTileRows, T_len, ld, i, more);
      copy.piece<kExact>(nxt + kTileRows * ld, v, a.st, k_nxt, kTileRows, T_len, ld, i, more);
    };
    if (!kExact && more)
      for (int i = 0; i < n_pieces; ++i) copy_next(i);

    const int k0 = j * kTileRows;
    const int key0 = k0 + slice * kSlice;  // this warp's 16 keys
    const bool active = key0 < k_end;
    const bf16* k_t = kv_s + (j % kStages) * 2 * kTileRows * ld;
    const bf16* k_w = k_t + slice * kSlice * ld;
    const bf16* v_w = k_w + kTileRows * ld;

    // S = Q.K^T and dP = dO.V^T for the group's rows and the warp's keys:
    // two n-tiles of 8 keys each, hd in k-steps of 16 (four mma chains in
    // flight); a warp past its rows' diagonal only copies
    if (active) {
      float s[2][4] = {}, dp[2][4] = {};
      const int a_off = (lane & 15) * ld + (lane >> 4) * 8;
      const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        if (kExact && kk < kExactPieces) copy_next(kk);
        if (kExact || kk * 16 < hd16) {
          uint32_t aq[4], ag[4], bk[4], bv[4];
          mma_tiles::ldmatrix_x4(aq, q_w + a_off + kk * 16);
          mma_tiles::ldmatrix_x4(ag, g_w + a_off + kk * 16);
          mma_tiles::ldmatrix_x4(bk, k_w + b_off + kk * 16);
          mma_tiles::ldmatrix_x4(bv, v_w + b_off + kk * 16);
          mma_tiles::mma_bf16_16816(s[0], aq, bk[0], bk[1]);
          mma_tiles::mma_bf16_16816(s[1], aq, bk[2], bk[3]);
          mma_tiles::mma_bf16_16816(dp[0], ag, bv[0], bv[1]);
          mma_tiles::mma_bf16_16816(dp[1], ag, bv[2], bv[3]);
        }
      }
      // the mask (SET to -1e9), P = exp(S - LSE) and dS = P (dP - D), stored
      // bf16 (with its rest when split) for the group's warps; element e of
      // n-tile nt: row g + 8 (e / 2), key 8 nt + 2 t4 + e % 2
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = key0 + 8 * nt + 2 * t4 + e;
            bool ok = col < T_len && __ldg(valid_row + col);
            if (a.causal) ok = ok && col <= qg + g + 8 * hr;
            const float p = expf((ok ? s[nt][2 * hr + e] * a.scale : kMasked) - lse[hr]);
            ds[e] = p * (dp[nt][2 * hr + e] - dd[hr]);
          }
          const int off = (g + 8 * hr) * kLdS + slice * kSlice + 8 * nt + 2 * t4;
          const uint32_t hi = mma_tiles::pack_bf16x2(ds[0], ds[1]);
          *reinterpret_cast<uint32_t*>(ds_w + off) = hi;
          if (split)
            *reinterpret_cast<uint32_t*>(dsr_w + off) = mma_tiles::pack_bf16x2_rest(ds[0], ds[1], hi);
        }
      }
    } else if (kExact) {
#pragma unroll
      for (int i = 0; i < kExactPieces; ++i) copy_next(i);
    }
    mma_tiles::cp_async_commit();
    __syncthreads();  // the group's dS is in shared memory

    // dQ[the group's rows, columns cb..] += dS.K over the slices that have
    // dS (the same test as above, by each slice's first key), 16 keys a
    // k-step; K's rows are keys (the k dimension): ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < kDqSlices; ++ks) {
      if (k0 + ks * kSlice >= k_end) continue;
      uint32_t fd[4];
      const int a_off = (lane & 15) * kLdS + ks * kSlice + (lane >> 4) * 8;
      mma_tiles::ldmatrix_x4(fd, ds_w + a_off);
      uint32_t fr[4];
      if (split) mma_tiles::ldmatrix_x4(fr, dsr_w + a_off);
#pragma unroll
      for (int nn = 0; nn < kCols / 16; ++nn) {
        if (kExact || cb + 16 * nn < hd16) {
          uint32_t bk[4];
          mma_tiles::ldmatrix_x4_trans(
              bk, k_t + (ks * kSlice + (lane & 15)) * ld + cb + 16 * nn + (lane >> 4) * 8);
          mma_tiles::mma_bf16_16816(acc[2 * nn], fd, bk[0], bk[1]);
          mma_tiles::mma_bf16_16816(acc[2 * nn + 1], fd, bk[2], bk[3]);
          if (split) {
            mma_tiles::mma_bf16_16816(acc[2 * nn], fr, bk[0], bk[1]);
            mma_tiles::mma_bf16_16816(acc[2 * nn + 1], fr, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and the dS tile
  }
  mma_tiles::cp_async_wait<0>();  // the last (zero-writing) copies are done
  __syncthreads();

  // dQ (scaled) as bf16 into Q's rows, then 16-byte stores of the rows below T
  bf16* dq_s = q_s + group * kSlice * ld + cb;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      if (kExact || cb + 8 * n < hd16)
        *reinterpret_cast<uint32_t*>(dq_s + (g + 8 * hr) * ld + 8 * n + 2 * t4) =
            mma_tiles::pack_bf16x2(acc[n][2 * hr] * a.scale, acc[n][2 * hr + 1] * a.scale);
  __syncthreads();
  store_rows(static_cast<bf16*>(a.dq) + (long long)b * a.ob + (long long)h * a.oh, a.ot, q_s,
             ld, q0, kDqRows, T_len, hd);
}

// ---- K6: dk, dv

constexpr int kLdP = kTileRows + 8;  // P^T / dS^T rows: 64 queries + 16 bytes

// A K6 block's key tile: kBK keys (64, or 32 when the grid of 64-key tiles
// would leave SMs idle) in groups of 16; warp w takes key group w % kGroups
// and part w / kGroups: of the tile's queries in phase 1, of the columns in
// phase 2.
template <int kBK>
struct KeyTile {
  static constexpr int kGroups = kBK / kSlice;
  static constexpr int kParts = kWarps / kGroups;
  static constexpr int kWarpQueries = kTileRows / kParts;  // phase 1
  static constexpr int kQ16 = kWarpQueries / 16;
  static_assert(kGroups * kParts == kWarps && kQ16 >= 1, "a whole split of the warps");
};

// Shared memory: K, V (kBK rows each) | kStages x (Q, dO) (kTileRows rows
// each), rows of round16(hd) + 8 bf16 | P^T, dS^T and dS^T's rest (kBK rows
// of kLdP bf16) | kStages x (LSE, D) (kTileRows f32 each) | first valid key:
// at hd = 256, 231,428 bytes (kBK = 64) of the 232,448 a block may have, or
// 183,812 (kBK = 32). After the query loop the Q/dO stages hold dK and dV as
// bf16 for 16-byte stores.
size_t dkdv_smem_bytes(int hd, int bk) {
  const size_t ld = size_t(round16(hd)) + 8;
  return sizeof(bf16) * ((2 * bk + 2 * kStages * kTileRows) * ld + 3 * bk * kLdP) +
         sizeof(float) * 2 * kStages * kTileRows + sizeof(int);
}

template <int kHd, bool kExact, int kKvBK>
__global__ void __launch_bounds__(kThreadsTc, 1) flash_bwd_dkdv_mma_kernel(Args a) {
  static_assert(!kExact || kHd == 256, "the exact build is hd = 256");
  using Tile = KeyTile<kKvBK>;
  constexpr int kKeyGroups = Tile::kGroups;
  constexpr int kWarpQueries = Tile::kWarpQueries;
  constexpr int kQ16 = Tile::kQ16;
  constexpr int kCols = kHd / Tile::kParts;  // dK / dV columns of a warp
  extern __shared__ uint4 smem_raw[];
  const int hd = kExact ? kHd : a.hd;
  const int hd16 = kExact ? kHd : round16(hd);
  const int ld = hd16 + 8;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kKvBK * ld;
  bf16* qg_s = v_s + kKvBK * ld;  // stage i: Q at qg_s + 2 i kTileRows ld, dO kTileRows ld after
  bf16* pt_s = qg_s + 2 * kStages * kTileRows * ld;  // P^T: [key][query]
  bf16* dst_s = pt_s + kKvBK * kLdP;                 // dS^T
  bf16* dsr_s = dst_s + kKvBK * kLdP;                // dS^T's rest (split tiles)
  float* stat_s = reinterpret_cast<float*>(dsr_s + kKvBK * kLdP);  // stage i: LSE, D
  int* first_s = reinterpret_cast<int*>(stat_s + 2 * kStages * kTileRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kgrp = warp % kKeyGroups;
  const int part = warp / kKeyGroups;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int T_len = a.T_len;
  const int k0 = blockIdx.y * kKvBK;  // the first key tiles (the longest walks) first
  const int kw = k0 + kgrp * kSlice;  // this warp's first key
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* dout = static_cast<const bf16*>(a.g) + (long long)b * a.gb + (long long)h * a.gh;
  const uint8_t* valid_row = a.kv_valid + (long long)b * T_len;
  const float* lse_row = a.lse + (long long)bh * T_len;
  const float* dd_row = a.dd + (long long)bh * T_len;
  const Copier copy(hd);

  if (!kExact && hd16 != hd)
    for (int r = tid; r < 2 * kKvBK + 2 * kStages * kTileRows; r += kThreadsTc)
      *reinterpret_cast<uint4*>(k_s + r * ld + hd) = make_uint4(0, 0, 0, 0);
  // K and V are copied while the first valid key is looked up
  copy.rows(k_s, static_cast<const bf16*>(a.k) + base, a.st, k0, kKvBK, T_len, ld);
  copy.rows(v_s, static_cast<const bf16*>(a.v) + base, a.st, k0, kKvBK, T_len, ld);
  first_valid_key(valid_row, T_len, first_s);
  const int first = *first_s;

  // query tiles with p != 0 for these keys: from the diagonal down under
  // causal, and those holding rows that see no valid key (rows < first)
  const int n_q_tiles = (T_len + kTileRows - 1) / kTileRows;
  auto next_tile = [&](int t) {
    while (t < n_q_tiles && a.causal && (t + 1) * kTileRows <= k0 && t * kTileRows >= first) ++t;
    return t;
  };
  const int n_pieces = copy.pieces(kTileRows);
  // piece i of query tile t into a stage (nothing read unless `on`); piece
  // 0 also takes the tile's LSE and D
  auto load_piece = [&](int t, int stage, int i, bool on, auto whole) {
    const int q0 = t * kTileRows;
    bf16* dst = qg_s + stage * 2 * kTileRows * ld;
    copy.piece<decltype(whole)::value>(dst, q, a.st, q0, kTileRows, T_len, ld, i, on);
    copy.piece<decltype(whole)::value>(dst + kTileRows * ld, dout, a.gt, q0, kTileRows, T_len,
                                       ld, i, on);
    if (i == 0 && tid < 2 * kTileRows) {  // LSE, then D, of rows q0.. (0 past T)
      const int r = tid % kTileRows;
      const bool in = on && q0 + r < T_len;
      const float* src = (tid < kTileRows ? lse_row : dd_row) + (in ? q0 + r : 0);
      mma_tiles::cp_async4(stat_s + (2 * stage + tid / kTileRows) * kTileRows + r, src,
                           in ? 4 : 0);
    }
  };
  using Whole = std::integral_constant<bool, kExact>;
  using Part = std::integral_constant<bool, false>;
  int t = next_tile(0);
  for (int i = 0; i < n_pieces; ++i) load_piece(t, 0, i, true, Part{});
  mma_tiles::cp_async_commit();

  // validity of this thread's keys in phase 1 (accumulator rows g, g + 8)
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw + g + 8 * hr;
    key_ok[hr] = key < T_len && valid_row[key];
  }

  float dk[kCols / 8][4], dv[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int stage = 0; t < n_q_tiles; stage ^= 1) {
    mma_tiles::cp_async_wait<0>();  // tile t (copied during the previous tile)
    __syncthreads();
    // the next tile is copied while this one is computed: spread over the
    // k-steps of phase 1 in the exact build, else all at once here
    const int t_next = next_tile(t + 1);
    const bool more = t_next < n_q_tiles;
    if (!kExact && more)
      for (int i = 0; i < n_pieces; ++i) load_piece(t_next, stage ^ 1, i, true, Part{});
    const int q0 = t * kTileRows;
    const bf16* q_t = qg_s + stage * 2 * kTileRows * ld;
    const bf16* g_t = q_t + kTileRows * ld;
    const float* lse_t = stat_s + 2 * stage * kTileRows;
    const float* dd_t = lse_t + kTileRows;
    const bool split = holds_unseen(q0, first, T_len, a.causal);

    // phase 1: P^T and dS^T of keys kw.. x queries qb.. of the tile;
    // zero without any product when every key is past every query's
    // diagonal and every query sees a valid key
    {
      const int qb = part * kWarpQueries;
      const bool zero = a.causal && q0 + qb + kWarpQueries - 1 < kw && q0 + qb >= first;
      float s[2 * kQ16][4] = {}, dp[2 * kQ16][4] = {};
      const int a_off = (kgrp * kSlice + (lane & 15)) * ld + (lane >> 4) * 8;
      if (zero && kExact) {
#pragma unroll
        for (int i = 0; i < kExactPieces; ++i) load_piece(t_next, stage ^ 1, i, more, Whole{});
      }
      if (!zero) {
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        if (kExact && kk < kExactPieces) load_piece(t_next, stage ^ 1, kk, more, Whole{});
        if (kExact || kk * 16 < hd16) {
          uint32_t ak[4], av[4];
          mma_tiles::ldmatrix_x4(ak, k_s + a_off + kk * 16);
          mma_tiles::ldmatrix_x4(av, v_s + a_off + kk * 16);
#pragma unroll
          for (int q16 = 0; q16 < kQ16; ++q16) {
            uint32_t bq[4], bg[4];
            const int b_off = (qb + 16 * q16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                              kk * 16 + ((lane >> 3) & 1) * 8;
            mma_tiles::ldmatrix_x4(bq, q_t + b_off);
            mma_tiles::ldmatrix_x4(bg, g_t + b_off);
            mma_tiles::mma_bf16_16816(s[2 * q16], ak, bq[0], bq[1]);
            mma_tiles::mma_bf16_16816(s[2 * q16 + 1], ak, bq[2], bq[3]);
            mma_tiles::mma_bf16_16816(dp[2 * q16], av, bg[0], bg[1]);
            mma_tiles::mma_bf16_16816(dp[2 * q16 + 1], av, bg[2], bg[3]);
          }
        }
      }
      }
      mma_tiles::cp_async_commit();
      // element e of n-tile nt: key g + 8 (e / 2), query 8 nt + 2 t4 + e % 2
#pragma unroll
      for (int nt = 0; nt < 2 * kQ16; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qb + 8 * nt + 2 * t4 + (e & 1);
          const int row = q0 + qi;
          bool ok = key_ok[e >> 1];
          if (a.causal) ok = ok && kw + g + 8 * (e >> 1) <= row;
          p[e] = (!zero && row < T_len)
                     ? expf((ok ? s[nt][e] * a.scale : kMasked) - lse_t[qi]) : 0.f;
          ds[e] = p[e] * (dp[nt][e] - dd_t[qi]);
        }
        const int off = (kgrp * kSlice + g) * kLdP + qb + 8 * nt + 2 * t4;
        *reinterpret_cast<uint32_t*>(pt_s + off) = mma_tiles::pack_bf16x2(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(pt_s + off + 8 * kLdP) = mma_tiles::pack_bf16x2(p[2], p[3]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t hi = mma_tiles::pack_bf16x2(ds[2 * hr], ds[2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(dst_s + off + 8 * hr * kLdP) = hi;
          if (split)
            *reinterpret_cast<uint32_t*>(dsr_s + off + 8 * hr * kLdP) =
                mma_tiles::pack_bf16x2_rest(ds[2 * hr], ds[2 * hr + 1], hi);
        }
      }
    }
    __syncthreads();

    // phase 2: dV += P^T.dO and dK += dS^T.Q for keys kw.. and columns
    // part * kCols..; a 16-query step whose P^T and dS^T are zero by the
    // causal skip above is skipped
#pragma unroll
    for (int ks = 0; ks < kTileRows / 16; ++ks) {
      if (a.causal && q0 + 16 * ks + 15 < kw && q0 + 16 * ks >= first) continue;
      uint32_t ap[4], ads[4], adr[4];
      const int a_off = (kgrp * kSlice + (lane & 15)) * kLdP + 16 * ks + (lane >> 4) * 8;
      mma_tiles::ldmatrix_x4(ap, pt_s + a_off);
      mma_tiles::ldmatrix_x4(ads, dst_s + a_off);
      if (split) mma_tiles::ldmatrix_x4(adr, dsr_s + a_off);
#pragma unroll
      for (int nn = 0; nn < kCols / 16; ++nn) {
        const int col = part * kCols + 16 * nn;
        if (kExact || col < hd16) {
          uint32_t bg[4], bq[4];
          const int b_off = (16 * ks + (lane & 15)) * ld + col + (lane >> 4) * 8;
          mma_tiles::ldmatrix_x4_trans(bg, g_t + b_off);
          mma_tiles::ldmatrix_x4_trans(bq, q_t + b_off);
          mma_tiles::mma_bf16_16816(dv[2 * nn], ap, bg[0], bg[1]);
          mma_tiles::mma_bf16_16816(dv[2 * nn + 1], ap, bg[2], bg[3]);
          mma_tiles::mma_bf16_16816(dk[2 * nn], ads, bq[0], bq[1]);
          mma_tiles::mma_bf16_16816(dk[2 * nn + 1], ads, bq[2], bq[3]);
          if (split) {
            mma_tiles::mma_bf16_16816(dk[2 * nn], adr, bq[0], bq[1]);
            mma_tiles::mma_bf16_16816(dk[2 * nn + 1], adr, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and P^T / dS^T
    t = t_next;
  }
  mma_tiles::cp_async_wait<0>();  // the last (zero-writing) copies are done
  __syncthreads();

  // dK (scaled) and dV as bf16 into the free Q/dO stages ([key][hd]), then
  // 16-byte stores of the rows below T
  bf16* dk_s = qg_s;
  bf16* dv_s = qg_s + kKvBK * ld;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = kgrp * kSlice + g + 8 * hr;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int col = part * kCols + 8 * n + 2 * t4;
      if (kExact || col < hd16) {
        *reinterpret_cast<uint32_t*>(dk_s + r * ld + col) =
            mma_tiles::pack_bf16x2(dk[n][2 * hr] * a.scale, dk[n][2 * hr + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dv_s + r * ld + col) =
            mma_tiles::pack_bf16x2(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    }
  }
  __syncthreads();
  const long long off = (long long)b * a.ob + (long long)h * a.oh;
  store_rows(static_cast<bf16*>(a.dk) + off, a.ot, dk_s, ld, k0, kKvBK, T_len, hd);
  store_rows(static_cast<bf16*>(a.dv) + off, a.ot, dv_s, ld, k0, kKvBK, T_len, hd);
}

}  // namespace tc

template <typename T>
cudaError_t launch(bool dkdv, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd);
  auto kernel = dkdv ? flash_bwd_dkdv_kernel<T> : flash_bwd_dq_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.T_len + kTile - 1) / kTile, B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// K6's key tile: 64 keys, or 32 when the blocks of 64-key tiles would not
// fill the SMs (B * H = 32 at T = 184: 96 blocks for 132 SMs; 32-key tiles
// give 192, and the longest walk takes half the time)
int key_tile(int B, int H, int T_len) {
  return (long long)B * H * ((T_len + 63) / 64) >= sm_count() ? 64 : 32;
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, size_t smem, int rows, const Args& a, int B,
                       cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // (b * H + h) fastest, so the longest walks of every (b, h) go first
  const dim3 grid(B * a.H, (a.T_len + rows - 1) / rows);
  kernel<<<grid, tc::kThreadsTc, smem, stream>>>(a);
  return cudaGetLastError();
}

// the bf16 kernels: the exact build for hd = 256 (every bf16 path), and one
// that takes every other hd (k-steps and columns past round16(hd) skipped at
// run time)
cudaError_t launch_tc(bool dkdv, const Args& a, int B, cudaStream_t stream) {
  const bool exact = a.hd == kMaxHd;
  if (!dkdv)
    return launch_one(exact ? tc::flash_bwd_dq_mma_kernel<kMaxHd, true>
                            : tc::flash_bwd_dq_mma_kernel<kMaxHd, false>,
                      tc::dq_smem_bytes(a.hd), tc::kDqRows, a, B, stream);
  const int bk = key_tile(B, a.H, a.T_len);
  auto kernel = bk == 64 ? (exact ? tc::flash_bwd_dkdv_mma_kernel<kMaxHd, true, 64>
                                  : tc::flash_bwd_dkdv_mma_kernel<kMaxHd, false, 64>)
                         : (exact ? tc::flash_bwd_dkdv_mma_kernel<kMaxHd, true, 32>
                                  : tc::flash_bwd_dkdv_mma_kernel<kMaxHd, false, 32>);
  return launch_one(kernel, tc::dkdv_smem_bytes(a.hd, bk), bk, a, B, stream);
}

int run(bool dkdv, const void* q, const void* k, const void* v,
        const void* kv_valid, const void* g, const void* lse, const void* dd,
        void* out0, void* out1, int B, int H, int T_len, int hd, float scale,
        int causal, int is_bf16, long long sb, long long sh, long long st,
        long long gb, long long gh, long long gt, long long ob, long long oh,
        long long ot, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > kMaxHd || T_len <= 0 || B <= 0 ||
      H <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.kv_valid = static_cast<const uint8_t*>(kv_valid);
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dq = dkdv ? nullptr : out0;
  a.dk = dkdv ? out0 : nullptr;
  a.dv = dkdv ? out1 : nullptr;
  a.H = H; a.T_len = T_len; a.hd = hd; a.causal = causal; a.scale = scale;
  a.sb = sb; a.sh = sh; a.st = st;
  a.gb = gb; a.gh = gh; a.gt = gt;
  a.ob = ob; a.oh = oh; a.ot = ot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_tc(dkdv, a, B, s);
  return (int)launch<float>(dkdv, a, B, s);
}

}  // namespace

// q, k, v (B, H, T, hd) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), one set of
// element strides (sb, sh, st) for all three; dO (g) in the same type with
// strides (gb, gh, gt); head dims contiguous, rows 16-byte aligned; kv_valid
// (B, T) bytes 0/1, contiguous; lse and D (B, H, T) f32, contiguous; dq (and
// dk, dv) (B, H, T, hd) in q's type with strides (ob, oh, ot). Each returns a
// cudaError_t.
extern "C" int genvc_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* g, const void* lse, const void* dd, void* dq, int B, int H,
    int T_len, int hd, float scale, int causal, int is_bf16, long long sb,
    long long sh, long long st, long long gb, long long gh, long long gt,
    long long ob, long long oh, long long ot, void* stream) {
  return run(false, q, k, v, kv_valid, g, lse, dd, dq, nullptr, B, H, T_len, hd,
             scale, causal, is_bf16, sb, sh, st, gb, gh, gt, ob, oh, ot, stream);
}

extern "C" int genvc_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* g, const void* lse, const void* dd, void* dk, void* dv, int B,
    int H, int T_len, int hd, float scale, int causal, int is_bf16,
    long long sb, long long sh, long long st, long long gb, long long gh,
    long long gt, long long ob, long long oh, long long ot, void* stream) {
  return run(true, q, k, v, kv_valid, g, lse, dd, dk, dv, B, H, T_len, hd,
             scale, causal, is_bf16, sb, sh, st, gb, gh, gt, ob, oh, ot, stream);
}

// dynamic shared memory of one block of K5 (dkdv = 0) or K6 (dkdv = 1) at
// this shape, as the launch picks it
extern "C" size_t genvc_flash_attention_bwd_smem_bytes(int B, int H, int T_len, int hd,
                                                       int dkdv, int is_bf16) {
  if (!is_bf16) return smem_bytes(hd);
  return dkdv ? tc::dkdv_smem_bytes(hd, key_tile(B, H, T_len)) : tc::dq_smem_bytes(hd);
}

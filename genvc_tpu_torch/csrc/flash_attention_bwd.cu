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
//   * p = exp(s - LSE) with the LSE the forward saved; p is never rounded;
//   * dp = dO . v^T and ds = p * (dp - D) in f32, with D = rowsum(dO * O)
//     computed by the caller;
//   * dq = (ds . k) * scale, dk = (ds^T . q) * scale, dv = p^T . dO, summed in
//     f32 and cast to q's type.
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
// Design (a simple kernel, right first; the forward's shape):
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
// the eight rows a warp reads at once fall in eight bank groups. Arithmetic
// is f32 FMA; mma.sync / wgmma tiles, TMA and a split of T are later work.
//
// Bound at the training step's shape (B = 8, H = 4, T = 184, hd = 256,
// bf16): bytes. Both kernels together must read q, k, v and dO and write
// dq, dk and dv (7 * B*H*T*hd * 2 bytes) plus LSE and D (2 * 4 * B*H*T)
// and the key mask: 21.1 MB, 6.3 us at 3.35 TB/s. Their arithmetic is five
// T x T x hd products per (b, h), halved by causality: 2.8 GFLOP, 2.8 us on
// the bf16 tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
  if (is_bf16) return (int)launch<__nv_bfloat16>(dkdv, a, B, s);
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

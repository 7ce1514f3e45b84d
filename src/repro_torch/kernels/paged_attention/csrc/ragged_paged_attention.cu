// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::ragged_paged_attention_pallas
// (body _kernel, inner _attend_page) in its slot-derived-position mode.
//
// What it computes: T query rows of S ragged sequences (cu_q_lens, kv_lens)
// attend causally, with an optional tanh softcap and sliding window, over
// fused head-interleaved KV pages (P, ps, 2*Hkv, D) found through an (S, W)
// page table. Key positions derive from the table slot; null page 0 is
// skipped. Online softmax in fp32; output in the input dtype.
//
// Design. The TPU grid walks (sequence, q-tile, kv-block) in order and
// carries the softmax state in VMEM across kv-blocks. Here one CTA owns one
// (sequence, KV head, tile of kRows query rows) and walks the tile's
// reachable table slots [lo, hi) itself, in ascending slot order, skipping
// null slots. A tile's rows are (query token, group head) pairs flattened
// token-major, so the G = Hq/Hkv query heads that share a KV head share
// every page the CTA stages. Per page the CTA stages this head's K and V rows
// (ps*D*2 elements) in shared memory; each warp then owns up to
// kRowsPerWarp rows and keeps their (m, l, acc) in registers. Scores put one
// key on each lane (K rows are padded in shared memory so the 32 lanes
// reading one column hit 32 banks); P@V puts head-dim columns on lanes.
//
// What bounds it: decode reads each reachable page once per KV head and does
// 4*D flops per (query row, key) — far below the card's ~295 flop/byte bf16
// balance point, so it is memory- (and at small batch, latency-) bound. This
// first version stages pages with plain 16-byte loads and computes with
// FMAs; TMA/cp.async pipelining, wgmma and splitting long KV ranges across
// CTAs are later work.
//
// Fixed page order: the slot walk depends only on cu_q_lens, kv_lens and the
// window, never on the table width W, so trailing null padding leaves the
// result bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (token, group) rows per CTA
constexpr int kMaxKeysPerLane = 4;            // page_size <= 128
constexpr float kNegInf = -2.0e38f;           // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Row stride of the staged K page, in elements: an odd number of 32-bit
// words, so lane `key` reading column d of its own key row lands in bank
// (key * stride_words + d_word) % 32 — 32 distinct banks.
template <typename T, int D> struct KStride;
template <int D> struct KStride<float, D> { static constexpr int value = D + 1; };
template <int D> struct KStride<__nv_bfloat16, D> { static constexpr int value = D + 2; };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* q;            // (T, Hq, D)
  const void* kv_pages;     // (P, ps, 2*Hkv, D)
  const int* page_table;    // (S, W)
  const int* cu_q_lens;     // (S+1,)
  const int* kv_lens;       // (S,)
  void* out;                // (T, Hq, D)
  int num_pages, page_size, table_width, num_q_heads, num_kv_heads;
  float scale;
  int has_cap;
  float cap;
  int has_window, window;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const Params prm) {
  constexpr int KS = KStride<T, D>::value;
  constexpr int kDPL = D / 32;            // head-dim columns per lane
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte load

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int ps = prm.page_size;
  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = 2 * prm.num_kv_heads;

  const int q0 = prm.cu_q_lens[s];
  const int qlen = prm.cu_q_lens[s + 1] - q0;
  const int kv_len = prm.kv_lens[s];
  const int row0 = tile * kRows;          // first flattened (token, group) row
  if (row0 >= qlen * G) return;           // whole CTA: nothing to do
  const int row_end = min(row0 + kRows, qlen * G);

  // The tile's reachable slots (kernel.py:108-118): causal — no key past
  // the tile's last query position; window — no key below the first one's
  // window.
  const int t_first = row0 / G;
  const int t_last = (row_end - 1) / G;
  const int first_qpos = kv_len - qlen + t_first;
  const int last_qpos = kv_len - qlen + t_last;
  const int n_pages = (kv_len + ps - 1) / ps;
  const int hi = min(min(n_pages, last_qpos / ps + 1), prm.table_width);
  const int lo = prm.has_window ? max(first_qpos - prm.window + 1, 0) / ps : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                   // kRows x D
  T* v_s = reinterpret_cast<T*>(q_s + kRows * D);                // ps x D
  T* k_s = v_s + ps * D;                                         // ps x KS

  const T* q = static_cast<const T*>(prm.q);
  const T* kv = static_cast<const T*>(prm.kv_pages);

  // Stage the tile's query rows in fp32 (rows past the tile are zero).
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int fr = row0 + r;
    float x = 0.f;
    if (fr < row_end) {
      const int t = fr / G, g = fr % G;
      x = to_float(q[((size_t)(q0 + t) * Hq + h * G + g) * D + d]);
    }
    q_s[i] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int fr = row0 + warp + i * kWarps;
    live[i] = fr < row_end;               // warp-uniform
    qpos[i] = kv_len - qlen + fr / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPL; ++c) acc[i][c] = 0.f;
  }

  for (int j = lo; j < hi; ++j) {
    const int pid = prm.page_table[s * prm.table_width + j];
    // null slot (and any id outside the pool): no keys, skip the page
    if (pid <= 0 || pid >= prm.num_pages) continue;

    __syncthreads();  // the previous page is consumed (and q_s is staged)
    // Stage this head's K and V rows: for token row i they are the 2*D
    // contiguous elements at kv[((pid*ps + i)*H2 + 2h)*D].
    const int chunks_per_row = 2 * D / kVec;
    for (int c = threadIdx.x; c < ps * chunks_per_row; c += kThreads) {
      const int i = c / chunks_per_row;
      const int e = (c % chunks_per_row) * kVec;  // element in [K row | V row]
      const uint4 v4 = *reinterpret_cast<const uint4*>(
          kv + ((size_t)(pid * ps + i) * H2 + 2 * h) * D + e);
      if (e < D) {
        // K: padded row stride; write as 32-bit words (both strides keep
        // 4-byte alignment for a 16-byte chunk start)
        uint32_t* dst = reinterpret_cast<uint32_t*>(k_s + i * KS + e);
        dst[0] = v4.x; dst[1] = v4.y; dst[2] = v4.z; dst[3] = v4.w;
      } else {
        *reinterpret_cast<uint4*>(v_s + i * D + (e - D)) = v4;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (!live[i]) continue;             // warp-uniform branch
      const float* qr = q_s + (warp + i * kWarps) * D;
      float sc[kMaxKeysPerLane];
      bool ok[kMaxKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kMaxKeysPerLane; ++kk) {
        const int key = lane + 32 * kk;
        sc[kk] = kNegInf;
        ok[kk] = false;
        if (key < ps) {
          const T* kr = k_s + key * KS;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], to_float(kr[d]), dot);
          float x = dot * prm.scale;
          if (prm.has_cap) x = tanhf(x / prm.cap) * prm.cap;
          const int kpos = j * ps + key;
          bool valid = kpos <= qpos[i];
          if (prm.has_window) valid = valid && kpos > qpos[i] - prm.window;
          ok[kk] = valid;
          sc[kk] = valid ? x : kNegInf;
        }
        mx = fmaxf(mx, sc[kk]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // explicit zeroing: while every key so far was masked, m_new is
      // kNegInf and exp(s - m_new) would be 1
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxKeysPerLane; ++kk) {
        sc[kk] = ok[kk] ? expf(sc[kk] - m_new) : 0.f;
        psum += sc[kk];
      }
      psum = warp_sum(psum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int c = 0; c < kDPL; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int kk = 0; kk < kMaxKeysPerLane; ++kk) {
        if (32 * kk >= ps) break;
        const int nk = min(32, ps - 32 * kk);
        for (int src = 0; src < nk; ++src) {
          const float p = __shfl_sync(0xffffffffu, sc[kk], src);
          const T* vr = v_s + (32 * kk + src) * D;
#pragma unroll
          for (int c = 0; c < kDPL; ++c) acc[i][c] = fmaf(p, to_float(vr[lane + 32 * c]), acc[i][c]);
        }
      }
      m[i] = m_new;
    }
  }

  T* out = static_cast<T*>(prm.out);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int fr = row0 + warp + i * kWarps;
    const int t = fr / G, g = fr % G;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((size_t)(q0 + t) * Hq + h * G + g) * D;
#pragma unroll
    for (int c = 0; c < kDPL; ++c) from_float(orow + lane + 32 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  const int G = prm.num_q_heads / prm.num_kv_heads;
  const int tiles = (max_q_len * G + kRows - 1) / kRows;
  if (tiles == 0 || num_seqs == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * kRows * D
                      + sizeof(T) * (size_t)prm.page_size * D
                      + sizeof(T) * (size_t)prm.page_size * KStride<T, D>::value;
  auto kernel = ragged_paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(tiles, prm.num_kv_heads, num_seqs);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& prm, int head_dim, int num_seqs,
                              int max_q_len, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(prm, num_seqs, max_q_len, stream);
    case 64: return launch<T, 64>(prm, num_seqs, max_q_len, stream);
    case 128: return launch<T, 128>(prm, num_seqs, max_q_len, stream);
    case 256: return launch<T, 256>(prm, num_seqs, max_q_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. has_cap / has_window switch the softcap
// and the sliding window on. Returns the launch's cudaError_t (0 = success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* kv_pages, const void* page_table,
    const void* cu_q_lens, const void* kv_lens, void* out,
    int num_seqs, int table_width, int num_pages, int page_size,
    int num_q_heads, int num_kv_heads, int head_dim, int max_q_len,
    float scale, int has_cap, float cap, int has_window, int window,
    int dtype, void* stream) {
  if (page_size <= 0 || page_size > 32 * kMaxKeysPerLane || num_kv_heads <= 0
      || num_q_heads % num_kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.q = q;
  prm.kv_pages = kv_pages;
  prm.page_table = static_cast<const int*>(page_table);
  prm.cu_q_lens = static_cast<const int*>(cu_q_lens);
  prm.kv_lens = static_cast<const int*>(kv_lens);
  prm.out = out;
  prm.num_pages = num_pages;
  prm.page_size = page_size;
  prm.table_width = table_width;
  prm.num_q_heads = num_q_heads;
  prm.num_kv_heads = num_kv_heads;
  prm.scale = scale;
  prm.has_cap = has_cap;
  prm.cap = cap;
  prm.has_window = has_window;
  prm.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_head_dim<float>(prm, head_dim, num_seqs, max_q_len, st);
  else if (dtype == 1)
    e = dispatch_head_dim<__nv_bfloat16>(prm, head_dim, num_seqs, max_q_len, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

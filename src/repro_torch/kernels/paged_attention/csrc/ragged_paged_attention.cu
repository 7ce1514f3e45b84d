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
// What bounds it: decode reads each reachable page once per KV head and does
// 4*D flops per (query row, key) — far below the card's ~295 flop/byte bf16
// balance point, so it is bound by bytes at long contexts and by latency
// (launch, the dependent table -> page loads) at short ones.
//
// Design. The TPU grid walks (sequence, q-tile, kv-block) in order and
// carries the softmax state in VMEM across kv-blocks. Here:
// - Rows. A tile is a fixed number of (token, group-head) rows of one
//   (sequence, KV head), flattened token-major, so the G query heads of a KV
//   head share every page the tile reads: 16 for bf16 (the M of mma.sync),
//   4 for fp32. Decode of qwen3-8b (G 4) is one tile.
// - Splits. The table's slots are cut at fixed boundaries counted from slot
//   0: split i holds slots [n*i, n*i + n), n = split_slots(the sequence's
//   pages), and a group holds kWarps consecutive splits. Each warp of a CTA
//   walks one split of the tile's reachable slots [lo, hi) in ascending
//   order and keeps its own fp32 (m, l, acc) for all rows of the tile. A
//   split with no live slot is an exact identity (l = 0) and every merge
//   skips it.
// - Merge, in one fixed order. A group's partial is the log-sum-exp fold of
//   its warps' partials in split order (through shared memory); the result
//   is the fold of the group partials in group order. For short query
//   ranges (decode) each group gets its own CTA ("spread") and a second
//   launch folds the groups' fp32 partials (a group with no visible key
//   writes only its (m, l), and the merge reads only those); otherwise one
//   CTA folds its groups in a loop. The library makes that choice and sizes
//   the scratch (ragged_paged_attention_scratch_floats). Both run the same fold with explicit fmaf, so a row's
//   bits depend only on its q, its KV and its slots: trailing null slots and
//   the other rows of the launch (decode vs extend) leave them unchanged. No
//   atomics.
// - Staging. Each warp streams its split in blocks of keys (16 for bf16,
//   about 8 KB for fp32) by cp.async into 2 stages of its own, so block j+1
//   loads while block j is computed; keys past a page's end are zero-filled.
// - Arithmetic, bf16 (ragged_paged_attention_mma_kernel): S = Q Kᵀ and
//   O += P V on the tensor cores by mma.sync.m16n8k16 (fp32 sums), P rounded
//   to bf16; the softmax on the fragments.
// - Arithmetic, fp32 (ragged_paged_attention_kernel): lane (kq, dq) =
//   (lane / 8, lane % 8) owns keys kq + 4j of a block and D/8 columns; a
//   score is a D/8-long FMA chain per lane and a 3-step shuffle sum over the
//   8 lanes of its key group; every K and V element loaded feeds all rows.
//   P.V accumulates per lane over its keys, summed over the 4 key groups by
//   shuffles at the split's end. (TF32 would not hold the fp32 tolerance.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 4;                     // splits per group (one per warp)
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                      // (token, group-head) rows per tile
constexpr int kMaxSlots = 8;                  // page slots per split, at most
constexpr int kStageBytes = 8192;             // K and V rows of one block
constexpr float kNegInf = -2.0e38f;           // the reference's NEG_INF

__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// N consecutive elements of shared memory at p (aligned to their size, up
// to 16 bytes), as floats.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    o[i] = x.x; o[i + 1] = x.y; o[i + 2] = x.z; o[i + 3] = x.w;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Page slots per split for a sequence of n_pages pages: one (decode of a
// few pages spreads over as many warps), more for long sequences, so a warp
// streams several blocks and the sequence needs fewer CTAs. A function of
// the sequence alone, never of the table width.
__host__ __device__ __forceinline__ int split_slots(int n_pages) {
  return max(1, min(kMaxSlots, n_pages / 64));
}

// Folds the partial (m2, l2, a2[0..N)) into (m, l, a[0..N)): the
// log-sum-exp merge of two softmax states of one row, N of its columns.
// l2 == 0 (no visible key) is the identity; an empty state takes the
// partial as it is. Explicit fmaf, so every kernel that folds computes the
// same bits.
template <int N, typename A2>
__device__ __forceinline__ void fold(float& m, float& l, float (&a)[N], float m2, float l2,
                                     A2 a2) {
  if (l2 == 0.f) return;
  if (l == 0.f) {
    m = m2; l = l2;
#pragma unroll
    for (int k = 0; k < N; ++k) a[k] = a2(k);
    return;
  }
  const float mn = fmaxf(m, m2);
  const float c1 = expf(m - mn), c2 = expf(m2 - mn);
  l = fmaf(l2, c2, l * c1);
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = fmaf(a2(k), c2, a[k] * c1);
  m = mn;
}

// One thread's share of a tile's merged state: row threadIdx.x / TPR of
// the tile, columns threadIdx.x % TPR + TPR k.
template <int R, int D>
struct RowState {
  static constexpr int TPR = kThreads / R;   // threads a row
  static constexpr int EPT = D / TPR;        // columns a thread
  float m = kNegInf, l = 0.f, a[EPT] = {};

  __device__ __forceinline__ int row() const { return threadIdx.x / TPR; }
  __device__ __forceinline__ int col(int k) const { return threadIdx.x % TPR + TPR * k; }

  // Folds a group's partial into this state: the fold, in split order, of
  // the warps' partials left in mbuf ([warp][row][D columns, m, l]).
  __device__ __forceinline__ void fold_group(const float* mbuf, int warps) {
    float gm = kNegInf, gl = 0.f, ga[EPT];
    for (int w = 0; w < warps; ++w) {
      const float* mw = mbuf + (w * R + row()) * (D + 2);
      fold(gm, gl, ga, mw[D], mw[D + 1], [&](int k) { return mw[col(k)]; });
    }
    fold(m, l, a, gm, gl, [&](int k) { return ga[k]; });
  }
};

struct Params {
  const void* q;            // (T, Hq, D)
  const void* kv_pages;     // (P, ps, 2*Hkv, D)
  const int* page_table;    // (S, W)
  const int* cu_q_lens;     // (S+1,)
  const int* kv_lens;       // (S,)
  void* out;                // (T, Hq, D)
  float* part_acc;          // spread, n_groups > 1: (n_groups, T, Hq, D)
  float* part_ml;           // (n_groups, T, Hq, 2): m, l
  int num_tokens, num_pages, page_size, table_width, num_q_heads, num_kv_heads;
  int n_groups, spread;
  float scale;
  int has_cap;
  float cap;
  int has_window, window;
};

template <int D>
struct Geo {
  static constexpr int VW = 4;                           // floats a 16-byte load
  static constexpr int CPL = D / 8;                      // columns per lane
  static constexpr int NCH = CPL / VW;                   // chunks per lane
  static constexpr int kBlockKeys_ = kStageBytes / (2 * D * 4);
  static constexpr int kBlockKeys = kBlockKeys_ > 32 ? 32 : kBlockKeys_;
  static constexpr int KPL = kBlockKeys / 4;             // keys per lane in a block
  static constexpr int ROW = 2 * D;                      // K row then V row, elements
  static constexpr int stage_elems = kBlockKeys * ROW;
  // shared memory: q (fp32), then per warp 2 stages; the merge buffer
  // (per warp kRows x (D + 2) fp32) reuses the stages
  static constexpr size_t q_bytes = sizeof(float) * kRows * D;
  static constexpr size_t bytes = q_bytes + (size_t)kWarps * 2 * stage_elems * sizeof(float);
  static_assert(kWarps * kRows * (D + 2) <= kWarps * 2 * stage_elems, "merge buffer fits the stages");
};

// The tile's rows from the merged state: the output, or (spread over
// several groups) this group's fp32 partial.
template <typename T, int R, int D>
__device__ __forceinline__ void write_rows(const Params& prm, const RowState<R, D>& run,
                                           int row0, int row_end, int q0, int h, int G,
                                           int group) {
  const int fr = row0 + run.row();
  if (fr >= row_end) return;
  const int Hq = prm.num_q_heads;
  const size_t r = (size_t)(q0 + fr / G) * Hq + h * G + fr % G;
  if (prm.spread && prm.n_groups > 1) {
    // a group with no visible key (l = 0) is the fold's identity: the
    // merge reads its (m, l) only
    const size_t pr = (size_t)group * prm.num_tokens * Hq + r;
    if (run.l != 0.f) {
#pragma unroll
      for (int k = 0; k < RowState<R, D>::EPT; ++k) prm.part_acc[pr * D + run.col(k)] = run.a[k];
    }
    if (run.col(0) == 0) {
      prm.part_ml[2 * pr] = run.m;
      prm.part_ml[2 * pr + 1] = run.l;
    }
  } else {
    const float denom = run.l == 0.f ? 1.f : run.l;
    T* out = static_cast<T*>(prm.out) + r * D;
#pragma unroll
    for (int k = 0; k < RowState<R, D>::EPT; ++k) from_float(out + run.col(k), run.a[k] / denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const Params prm) {
  using GE = Geo<D>;
  using T = float;
  constexpr int VW = GE::VW, NCH = GE::NCH, CPL = GE::CPL, KB = GE::kBlockKeys, KPL = GE::KPL;
  constexpr int ROW = GE::ROW;

  const int n_split_ctas = prm.spread ? prm.n_groups : 1;
  const int tile = blockIdx.x / n_split_ctas;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kq = lane / 8, dq = lane % 8;

  const int ps = prm.page_size;
  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = 2 * prm.num_kv_heads;

  const int q0 = prm.cu_q_lens[s];
  const int qlen = prm.cu_q_lens[s + 1] - q0;
  const int kv_len = prm.kv_lens[s];
  const int row0 = tile * kRows;
  if (row0 >= qlen * G) return;           // whole CTA: nothing to do
  const int row_end = min(row0 + kRows, qlen * G);

  // The tile's reachable slots (kernel.py:108-118): causal — no key past
  // the tile's last query position; window — no key below the first one's
  // window.
  const int first_qpos = kv_len - qlen + row0 / G;
  const int last_qpos = kv_len - qlen + (row_end - 1) / G;
  const int n_pages = (kv_len + ps - 1) / ps;
  const int hi = min(min(n_pages, last_qpos / ps + 1), prm.table_width);
  const int lo = prm.has_window ? max(first_qpos - prm.window + 1, 0) / ps : 0;
  const int slots = split_slots(n_pages), group_slots = slots * kWarps;
  int g_begin, g_end;   // the groups this CTA folds
  if (prm.spread) {
    g_begin = blockIdx.x % n_split_ctas;
    g_end = g_begin + 1;
  } else {
    g_begin = lo / group_slots;
    g_end = hi > lo ? (hi - 1) / group_slots + 1 : g_begin;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                         // kRows x D
  T* stages = reinterpret_cast<T*>(smem + GE::q_bytes);
  T* my_stage = stages + warp * 2 * GE::stage_elems;
  float* mbuf = reinterpret_cast<float*>(stages);                      // [warp][row][D + 2]

  const T* q = static_cast<const T*>(prm.q);
  const T* kv = static_cast<const T*>(prm.kv_pages);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int fr = row0 + r;
    float x = 0.f;
    if (fr < row_end) x = q[((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D + d];
    q_s[i] = x;
  }
  int qpos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) qpos[i] = kv_len - qlen + (row0 + i) / G;
  const int bpp = (ps + KB - 1) / KB;     // blocks per page

  RowState<kRows, D> run;   // this thread's share of the tile's merged state

  for (int grp = g_begin; grp < g_end; ++grp) {
    __syncthreads();   // q staged; the previous group's merge buffer is read
    const int s_lo = max(lo, grp * group_slots + warp * slots);
    const int s_hi = min(hi, grp * group_slots + (warp + 1) * slots);
    const int n_blocks = s_hi > s_lo ? (s_hi - s_lo) * bpp : 0;

    float m[kRows], l[kRows], acc[kRows][CPL];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
    }

    // block b of the split: slot s_lo + b / bpp, keys [kb, kb + nk) of its page
    auto page_of = [&](int b) {
      const int pid = prm.page_table[s * prm.table_width + s_lo + b / bpp];
      return (pid <= 0 || pid >= prm.num_pages) ? -1 : pid;   // null slot: skipped
    };
    auto issue = [&](int b) {
      if (b < n_blocks) {
        const int pid = page_of(b);
        if (pid >= 0) {
          const int kb = (b % bpp) * KB;
          const int nk = min(KB, ps - kb);
          T* dst = my_stage + (b & 1) * GE::stage_elems;
          constexpr int CH = ROW * (int)sizeof(T) / 16;   // 16-byte chunks a key
          for (int c = lane; c < KB * CH; c += 32) {
            const int key = c / CH, e = (c % CH) * (16 / (int)sizeof(T));
            const bool ok = key < nk;
            cp_async16(dst + key * ROW + e,
                       ok ? kv + ((size_t)(pid * ps + kb + key) * H2 + 2 * h) * D + e : kv, ok);
          }
        }
      }
      cp_async_commit();
    };

    issue(0);
    for (int b = 0; b < n_blocks; ++b) {
      issue(b + 1);
      cp_async_wait<1>();
      __syncwarp();
      const int pid = page_of(b);
      if (pid >= 0) {
        const T* st = my_stage + (b & 1) * GE::stage_elems;
        const int kb = (b % bpp) * KB;
        const int kpos0 = (s_lo + b / bpp) * ps + kb;
        const int nk = min(KB, ps - kb);
        // scores: lane partials over its columns, then summed over the 8 lanes of a key group
        float sc[kRows][KPL];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < KPL; ++j) sc[i][j] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int col = (c * 8 + dq) * VW;
          float kf[KPL][VW];
#pragma unroll
          for (int j = 0; j < KPL; ++j) load_vec<VW>(st + (j * 4 + kq) * ROW + col, kf[j]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float qf[VW];
            load_vec<VW>(q_s + i * D + col, qf);
#pragma unroll
            for (int j = 0; j < KPL; ++j)
#pragma unroll
              for (int e = 0; e < VW; ++e) sc[i][j] = fmaf(qf[e], kf[j][e], sc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            sc[i][j] += __shfl_xor_sync(0xffffffffu, sc[i][j], 1);
            sc[i][j] += __shfl_xor_sync(0xffffffffu, sc[i][j], 2);
            sc[i][j] += __shfl_xor_sync(0xffffffffu, sc[i][j], 4);
          }
        // online softmax per row (m, l warp-uniform; each lane sums its own keys into l)
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          uint32_t ok = 0;
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int key = j * 4 + kq;
            float x = sc[i][j] * prm.scale;
            if (prm.has_cap) x = tanhf(x / prm.cap) * prm.cap;
            const int kpos = kpos0 + key;
            bool valid = key < nk && kpos <= qpos[i];
            if (prm.has_window) valid = valid && kpos > qpos[i] - prm.window;
            if (valid) ok |= 1u << j;
            sc[i][j] = valid ? x : kNegInf;
            mx = fmaxf(mx, sc[i][j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[i], mx);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            // explicit zeroing: while every key so far was masked, m_new is
            // kNegInf and exp(s - m_new) would be 1
            sc[i][j] = (ok >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
            psum += sc[i][j];
          }
          const float corr = expf(m[i] - m_new);
          l[i] = fmaf(l[i], corr, psum);
          if (corr != 1.f) {      // warp-uniform; a factor of 1 leaves acc exact
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[i][c] *= corr;
          }
          m[i] = m_new;
        }
        // acc[row][this lane's columns] += sum over this lane's keys of P V
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float vf[VW];
            load_vec<VW>(st + (j * 4 + kq) * ROW + D + (c * 8 + dq) * VW, vf);
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[i][c * VW + e] = fmaf(sc[i][j], vf[e], acc[i][c * VW + e]);
          }
        }
      }
      __syncwarp();   // the stage is consumed before the next issue overwrites it
    }
    cp_async_wait<0>();

    // the split's partial: sum acc and l over the 4 key groups
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 8);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 16);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 8);
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
      }
    }
    __syncthreads();   // every warp is done with its stages: they become the merge buffer
    if (kq == 0) {
      float* mw = mbuf + warp * kRows * (D + 2);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VW; ++e) mw[i * (D + 2) + (c * 8 + dq) * VW + e] = acc[i][c * VW + e];
        if (dq == 0) {
          mw[i * (D + 2) + D] = m[i];
          mw[i * (D + 2) + D + 1] = l[i];
        }
      }
    }
    __syncthreads();
    run.fold_group(mbuf, kWarps);
  }
  write_rows<T>(prm, run, row0, row_end, q0, h, G, g_begin);
}

// Folds the n_groups partials of every (token, query head) row in group
// order (the same fold as the loop over groups above) and writes the
// output. One CTA of D threads per row.
template <typename T, int D>
__global__ void __launch_bounds__(D)
ragged_paged_attention_merge_kernel(const Params prm) {
  const size_t r = (size_t)blockIdx.x * prm.num_q_heads + blockIdx.y;
  const int col = threadIdx.x;
  const size_t stride = (size_t)prm.num_tokens * prm.num_q_heads;
  float m = kNegInf, l = 0.f, a[1] = {0.f};
  constexpr int kBatch = 16;   // groups loaded together, then folded in order
  for (int g0 = 0; g0 < prm.n_groups; g0 += kBatch) {
    float pm[kBatch], pl[kBatch], pa[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const size_t pr = (size_t)min(g0 + i, prm.n_groups - 1) * stride + r;
      pm[i] = prm.part_ml[2 * pr];
      pl[i] = g0 + i < prm.n_groups ? prm.part_ml[2 * pr + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)   // an empty group's acc was never written
      pa[i] = pl[i] != 0.f ? prm.part_acc[((size_t)(g0 + i) * stride + r) * D + col] : 0.f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) fold(m, l, a, pm[i], pl[i], [&](int) { return pa[i]; });
  }
  from_float(static_cast<T*>(prm.out) + r * D + col, a[0] / (l == 0.f ? 1.f : l));
}

// ---------------------------------------------------------------------------
// bf16: the same splits and folds, products on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
//
// A tile is kMmaRows = 16 rows, the M of mma.sync.m16n8k16 (decode of
// qwen3-8b fills 4 of them; a padded row costs tensor-core issue slots,
// which decode has to spare). Per block of 16 keys a warp computes S = Q Kᵀ
// as 2 x D/16 mma (K's fragments by ldmatrix from the stage), the online
// softmax on S's fragments (a row's 16 scores sit in 4 lanes), and O += P V
// as D/8 mma with P rounded to bf16 as the A fragment and V by
// ldmatrix.trans. O accumulates in registers (D/2 a thread). Stage rows are
// padded by 16 bytes so ldmatrix's 8 row addresses fall in 8 different bank
// groups.

constexpr int kMmaRows = 16;
constexpr int kMmaKeys = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, flushing subnormals
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a b: m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
struct MmaGeo {
  static constexpr int QS = D + 8;                       // padded Q row, elements
  static constexpr int RS = 2 * D + 8;                   // padded K|V row
  static constexpr int stage_elems = kMmaKeys * RS;
  static constexpr size_t q_bytes = 2 * kMmaRows * QS;
  static constexpr size_t bytes = q_bytes + (size_t)kWarps * 2 * stage_elems * 2;
  static_assert((size_t)kWarps * kMmaRows * (D + 2) * sizeof(float)
                <= (size_t)kWarps * 2 * stage_elems * 2, "merge buffer fits the stages");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_mma_kernel(const Params prm) {
  using GE = MmaGeo<D>;
  using T = __nv_bfloat16;
  constexpr int R = kMmaRows, KB = kMmaKeys, RS = GE::RS, QS = GE::QS;

  const int n_split_ctas = prm.spread ? prm.n_groups : 1;
  const int tile = blockIdx.x / n_split_ctas;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;            // fragment row, column pair

  const int ps = prm.page_size;
  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = 2 * prm.num_kv_heads;

  // spread, one slot a split (every sequence under 128 pages): a warp's
  // slot is known before its sequence's lengths, so its page id loads
  // together with them
  const int spec_slot = (blockIdx.x % n_split_ctas) * kWarps + warp;
  int spec_pid = -1;
  if (prm.spread && lane == 0 && spec_slot < prm.table_width)
    spec_pid = prm.page_table[s * prm.table_width + spec_slot];

  const int q0 = prm.cu_q_lens[s];
  const int qlen = prm.cu_q_lens[s + 1] - q0;
  const int kv_len = prm.kv_lens[s];
  const int row0 = tile * R;
  if (row0 >= qlen * G) return;
  const int row_end = min(row0 + R, qlen * G);

  const int first_qpos = kv_len - qlen + row0 / G;
  const int last_qpos = kv_len - qlen + (row_end - 1) / G;
  const int n_pages = (kv_len + ps - 1) / ps;
  const int hi = min(min(n_pages, last_qpos / ps + 1), prm.table_width);
  const int lo = prm.has_window ? max(first_qpos - prm.window + 1, 0) / ps : 0;
  const int slots = split_slots(n_pages), group_slots = slots * kWarps;
  int g_begin, g_end;   // the groups this CTA folds
  if (prm.spread) {
    g_begin = blockIdx.x % n_split_ctas;
    g_end = g_begin + 1;
  } else {
    g_begin = lo / group_slots;
    g_end = hi > lo ? (hi - 1) / group_slots + 1 : g_begin;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                                 // R x QS
  T* stages = reinterpret_cast<T*>(smem + GE::q_bytes);
  T* my_stage = stages + warp * 2 * GE::stage_elems;
  float* mbuf = reinterpret_cast<float*>(stages);                      // [warp][row][D + 2]

  const T* q = static_cast<const T*>(prm.q);
  const T* kv = static_cast<const T*>(prm.kv_pages);
  // Q's A fragments (k-step ks: rows g8 / g8 + 8, columns 2 t4 (+8)) stay in
  // registers up to D 128; at D 256 they come from q_s at each use, which
  // leaves the registers to O
  constexpr bool kQRegs = D <= 128;
  uint32_t qa[kQRegs ? D / 16 : 1][4];
  int qpos[2];
  const int bpp = (ps + KB - 1) / KB;
  static_assert(kMaxSlots <= 32, "a lane per slot of a split");

  RowState<R, D> run;   // this thread's share of the tile's merged state

  for (int grp = g_begin; grp < g_end; ++grp) {
    if (grp > g_begin) __syncthreads();   // the previous group's merge buffer is read
    const int s_lo = max(lo, grp * group_slots + warp * slots);
    const int s_hi = min(hi, grp * group_slots + (warp + 1) * slots);
    const int n_blocks = s_hi > s_lo ? (s_hi - s_lo) * bpp : 0;

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    // the split's page ids, lane j holding slot s_lo + j (-1: null, skipped)
    int my_pid = spec_pid;
    if (!(prm.spread && slots == 1) && lane < s_hi - s_lo)
      my_pid = prm.page_table[s * prm.table_width + s_lo + lane];
    if (my_pid <= 0 || my_pid >= prm.num_pages) my_pid = -1;
    auto page_of = [&](int b) { return __shfl_sync(0xffffffffu, my_pid, b / bpp); };
    auto issue = [&](int b) {
      const int pid = page_of(b < n_blocks ? b : 0);
      if (b < n_blocks && pid >= 0) {
        const int kb = (b % bpp) * KB;
        const int nk = min(KB, ps - kb);
        T* dst = my_stage + (b & 1) * GE::stage_elems;
        constexpr int CH = 2 * D / 8;   // 16-byte chunks a key
        for (int c = lane; c < KB * CH; c += 32) {
          const int key = c / CH, e = (c % CH) * 8;
          const bool ok = key < nk;
          cp_async16(dst + key * RS + e,
                     ok ? kv + ((size_t)(pid * ps + kb + key) * H2 + 2 * h) * D + e : kv, ok);
        }
      }
      cp_async_commit();
    };

    issue(0);
    if (grp == g_begin) {   // Q, staged while the first block loads
      for (int i = threadIdx.x; i < R * D / 8; i += kThreads) {
        const int r = i / (D / 8), d = (i % (D / 8)) * 8;
        const int fr = row0 + r;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (fr < row_end)
          x = *reinterpret_cast<const uint4*>(q + ((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D + d);
        *reinterpret_cast<uint4*>(q_s + r * QS + d) = x;
      }
      __syncthreads();
      if constexpr (kQRegs) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          ldmatrix_x4(qa[ks], q_s + ((lane / 8 % 2) * 8 + lane % 8) * QS + ks * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) qpos[hh] = kv_len - qlen + (row0 + g8 + 8 * hh) / G;
    }
    for (int b = 0; b < n_blocks; ++b) {
      issue(b + 1);
      cp_async_wait<1>();
      __syncwarp();
      const int pid = page_of(b);
      if (pid >= 0) {
        const T* st = my_stage + (b & 1) * GE::stage_elems;
        const int kb = (b % bpp) * KB;
        const int kpos0 = (s_lo + b / bpp) * ps + kb;
        const int nk = min(KB, ps - kb);
        // S = Q Kᵀ: n-tile n holds keys 8n..8n+7; sc[n][e]: row g8 + 8 (e / 2), key 8n + 2 t4 + e % 2
        float sc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t kf[4];   // keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7, keys 8-15 | d 8-15
          const int mi = lane / 8;
          ldmatrix_x4(kf, st + ((mi / 2) * 8 + lane % 8) * RS + ks * 16 + (mi % 2) * 8);
          uint32_t qf[4];
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qf[e] = qa[ks][e];
          } else {
            ldmatrix_x4(qf, q_s + ((mi % 2) * 8 + lane % 8) * QS + ks * 16 + (mi / 2) * 8);
          }
          mma_bf16(sc[0], qf, kf[0], kf[1]);
          mma_bf16(sc[1], qf, kf[2], kf[3]);
        }
        // online softmax; a row's scores sit in the 4 lanes of one t4 group
        uint32_t ok = 0;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e / 2, key = 8 * n + 2 * t4 + e % 2, kpos = kpos0 + key;
            float x = sc[n][e] * prm.scale;
            if (prm.has_cap) x = tanhf(x / prm.cap) * prm.cap;
            bool valid = key < nk && kpos <= qpos[hh];
            if (prm.has_window) valid = valid && kpos > qpos[hh] - prm.window;
            if (valid) ok |= 1u << (4 * n + e);
            sc[n][e] = valid ? x : kNegInf;
            mx[hh] = fmaxf(mx[hh], sc[n][e]);
          }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          corr[hh] = fast_exp2((m[hh] - m_new) * kLog2e);
          l[hh] *= corr[hh];
          m[hh] = m_new;
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e / 2;
            // explicit zeroing: while every key so far was masked, m is
            // kNegInf and the exponent would be 0
            sc[n][e] = (ok >> (4 * n + e)) & 1u ? fast_exp2((sc[n][e] - m[hh]) * kLog2e) : 0.f;
            l[hh] += sc[n][e];
          }
        if (corr[0] != 1.f || corr[1] != 1.f) {   // a factor of 1 leaves O exact
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][e] *= corr[e / 2];
        }
        // O += P V: P's A fragment (keys 0-15), V's B fragments by ldmatrix.trans
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t vf[4];   // keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 8-15
          const int mi = lane / 8;
          ldmatrix_x4_trans(vf, st + ((mi % 2) * 8 + lane % 8) * RS + D + dn * 16 + (mi / 2) * 8);
          mma_bf16(o[2 * dn], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
      __syncwarp();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    __syncthreads();   // every warp is done with its stages: they become the merge buffer
    {
      float* mw = mbuf + warp * R * (D + 2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mw[(g8 + 8 * (e / 2)) * (D + 2) + 8 * j + 2 * t4 + e % 2] = o[j][e];
      if (t4 == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mw[(g8 + 8 * hh) * (D + 2) + D] = m[hh];
          mw[(g8 + 8 * hh) * (D + 2) + D + 1] = l[hh];
        }
      }
    }
    __syncthreads();
    run.fold_group(mbuf, kWarps);
  }
  write_rows<T>(prm, run, row0, row_end, q0, h, G, g_begin);
}

template <typename K>
cudaError_t launch_tiles(K kernel, size_t smem, int rows, const Params& prm, int num_seqs,
                         int max_q_len, cudaStream_t stream) {
  const int G = prm.num_q_heads / prm.num_kv_heads;
  const int tiles = (max_q_len * G + rows - 1) / rows;
  if (tiles == 0 || num_seqs == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(tiles * (prm.spread ? prm.n_groups : 1), prm.num_kv_heads, num_seqs);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tiles(ragged_paged_attention_mma_kernel<D>, MmaGeo<D>::bytes, kMmaRows, prm,
                        num_seqs, max_q_len, stream);
  else
    return launch_tiles(ragged_paged_attention_kernel<D>, Geo<D>::bytes, kRows, prm,
                        num_seqs, max_q_len, stream);
}

template <typename T, int D>
cudaError_t launch_and_merge(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  const cudaError_t e = launch<T, D>(prm, num_seqs, max_q_len, stream);
  if (e != cudaSuccess || !prm.spread || prm.n_groups == 1 || prm.num_tokens == 0) return e;
  ragged_paged_attention_merge_kernel<T, D>
      <<<dim3(prm.num_tokens, prm.num_q_heads), D, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& prm, int head_dim, int num_seqs,
                              int max_q_len, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_and_merge<T, 32>(prm, num_seqs, max_q_len, stream);
    case 64: return launch_and_merge<T, 64>(prm, num_seqs, max_q_len, stream);
    case 128: return launch_and_merge<T, 128>(prm, num_seqs, max_q_len, stream);
    case 256: return launch_and_merge<T, 256>(prm, num_seqs, max_q_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kSpreadRows = 16;   // (token, group-head) rows a sequence, at most, to spread

// The groups of splits a sequence of at most `table_width` live slots can
// need: on each range of page counts where split_slots is constant the
// count grows with the pages, so the most is at a range's end or at W.
int max_groups(int table_width) {
  auto groups = [](int n) { return (n + split_slots(n) * kWarps - 1) / (split_slots(n) * kWarps); };
  int most = groups(table_width);
  for (int end = 127; end < 64 * (kMaxSlots + 1); end += 64)
    most = std::max(most, groups(std::min(end, table_width)));
  return most;
}

// Spread (decode: each group of splits gets a CTA of its own, a second
// launch folds their partials) when every sequence has at most kSpreadRows
// (token, group-head) rows; else one CTA folds every group of its rows.
bool spreads(int num_q_heads, int num_kv_heads, int max_q_len) {
  return (long long)max_q_len * (num_q_heads / num_kv_heads) <= kSpreadRows;
}

}  // namespace

// The fp32 scratch, in floats, that a launch with these arguments needs for
// its partials (0: none); the caller passes that much to the launch.
extern "C" long long ragged_paged_attention_scratch_floats(
    int num_tokens, int num_q_heads, int num_kv_heads, int head_dim, int table_width,
    int max_q_len) {
  if (num_kv_heads <= 0 || table_width <= 0 || !spreads(num_q_heads, num_kv_heads, max_q_len))
    return 0;
  const int n_groups = max_groups(table_width);
  return n_groups == 1 ? 0 : (long long)n_groups * num_tokens * num_q_heads * (head_dim + 2);
}

// dtype: 0 = float32, 1 = bfloat16. has_cap / has_window switch the softcap
// and the sliding window on. scratch: ragged_paged_attention_scratch_floats
// floats (null when that is 0). Returns the launch's cudaError_t (0 =
// success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* kv_pages, const void* page_table,
    const void* cu_q_lens, const void* kv_lens, void* out,
    int num_tokens, int num_seqs, int table_width, int num_pages, int page_size,
    int num_q_heads, int num_kv_heads, int head_dim, int max_q_len,
    float scale, int has_cap, float cap, int has_window, int window,
    int dtype, void* scratch, void* stream) {
  if (page_size <= 0 || num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0
      || table_width <= 0)
    return (int)cudaErrorInvalidValue;
  const int spread = spreads(num_q_heads, num_kv_heads, max_q_len);
  const int n_groups = max_groups(table_width);
  if (spread && n_groups > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc == nullptr ? nullptr
                                       : part_acc + (size_t)n_groups * num_tokens * num_q_heads * head_dim;
  Params prm;
  prm.q = q;
  prm.kv_pages = kv_pages;
  prm.page_table = static_cast<const int*>(page_table);
  prm.cu_q_lens = static_cast<const int*>(cu_q_lens);
  prm.kv_lens = static_cast<const int*>(kv_lens);
  prm.out = out;
  prm.part_acc = part_acc;
  prm.part_ml = part_ml;
  prm.num_tokens = num_tokens;
  prm.num_pages = num_pages;
  prm.page_size = page_size;
  prm.table_width = table_width;
  prm.num_q_heads = num_q_heads;
  prm.num_kv_heads = num_kv_heads;
  prm.n_groups = n_groups;
  prm.spread = spread;
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

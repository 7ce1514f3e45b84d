// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py::ragged_paged_attention_pallas
// (body _kernel, inner _attend_page) in both its modes.
//
// What it computes: T query rows of S ragged sequences (cu_q_lens, kv_lens)
// attend causally, with an optional tanh softcap and sliding window, over
// fused head-interleaved KV pages (P, ps, 2*Hkv, D) found through an (S, W)
// page table. Online softmax in fp32; output in the input dtype. Positions:
// - slot-derived (q_pos and kv_pos null): key j of table slot i sits at
//   i*ps + j, query r of a sequence at kv_len - q_len + r; null page 0 is
//   skipped, and so are the slots past the tile's last query and below its
//   first one's window;
// - explicit (q_pos (T,) and kv_pos (P, ps) given, the ring-cache view):
//   every slot below ceil(kv_len / ps) is visited, page 0 included (a ring
//   that wraps is not in position order, so no slot can be skipped from the
//   lengths), and a key counts only if 0 <= kv_pos <= q_pos (and inside the
//   window). A split whose keys are all masked stays the merge's identity
//   (l = 0), a row with no visible key writes 0, and where kv_pos holds the
//   slot-derived positions the output equals the slot-derived mode's bit for
//   bit: the extra slots are fully masked, and a fully masked block leaves
//   (m, l, acc) exactly as they were.
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
// - Arithmetic, fp32 (ragged_paged_attention_kernel): a key's row is split
//   over LPK lanes (8, or 32 from D 512), so lane (kq, dq) = (lane / LPK,
//   lane % LPK) owns keys kq + (32 / LPK) j of a block and every LPK-th
//   16-byte chunk of the row (the last chunk of a lane may lie past D, as at
//   D 80, and is skipped); a score is an FMA chain per lane and a shuffle sum
//   over the LPK lanes of its key; every K and V element loaded feeds all
//   rows. P.V accumulates per lane over its keys, summed over the key groups
//   by shuffles at the split's end. (TF32 would not hold the fp32
//   tolerance.)
// - Latent head (bf16, D 576: MLA's fused [c, kr] row shared by all query
//   heads): ragged_paged_attention_latent_kernel, below — its own split
//   plan (splits of about 192 keys, folded on chip by clusters of 8 in the
//   same launch), TMA-staged 16-key units, and 1 to 2 tiles a CTA on each
//   staged block.
// - Planes. A pool row holds K and V (two planes, (P, ps, 2*Hkv, D)), or,
//   with v_from_k, one plane (P, ps, 1, D) whose value is its key: the MLA
//   ring's stored [c, kr], one KV head. Every kernel takes the plane count
//   as a template argument: in the per-warp kernels only the copy's length
//   and V's offset in the stage change, the latent kernel also halves its
//   staged units. An output column sums over its own V column alone, so
//   lanes [0, r) equal the two-plane [c, 0] read bit for bit.

#include <cuda.h>
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
// the tile, columns threadIdx.x % TPR + TPR k below D.
template <int R, int D>
struct RowState {
  static constexpr int TPR = kThreads / R;            // threads a row
  static constexpr int EPT = (D + TPR - 1) / TPR;     // columns a thread, at most
  float m = kNegInf, l = 0.f, a[EPT] = {};

  __device__ __forceinline__ int row() const { return threadIdx.x / TPR; }
  __device__ __forceinline__ int col(int k) const { return threadIdx.x % TPR + TPR * k; }
  __device__ __forceinline__ bool has(int k) const { return D % TPR == 0 || col(k) < D; }

  // Folds a group's partial into this state: the fold, in split order, of
  // the warps' partials left in mbuf ([warp][row][D columns, m, l]).
  __device__ __forceinline__ void fold_group(const float* mbuf, int warps) {
    float gm = kNegInf, gl = 0.f, ga[EPT];
    for (int w = 0; w < warps; ++w) {
      const float* mw = mbuf + (w * R + row()) * (D + 2);
      fold(gm, gl, ga, mw[D], mw[D + 1], [&](int k) { return has(k) ? mw[col(k)] : 0.f; });
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
  const int* q_pos;         // (T,), or null: slot-derived positions
  const int* kv_pos;        // (P, ps), -1 an empty row; null with q_pos
  void* out;                // (T, Hq, D)
  float* part_acc;          // spread, n_groups > 1: (n_groups, T, Hq, D)
  float* part_ml;           // (n_groups, T, Hq, 2): m, l
  int* counters;            // the latent kernel's, zero between launches
  int tile_groups, max_clusters;   // the latent kernel's plan (launch_latent)
  int kv_tma;               // the latent kernel: 1, a TMA box a unit; 0, rows copied by hand
  CUtensorMap kv_map;       // the latent kernel's pool as (64 columns, rows, 64-column chunks)
  int num_tokens, num_pages, page_size, table_width, num_q_heads, num_kv_heads;
  int n_groups, spread;
  int planes;               // 2: K and V rows; 1: V is K (one KV head, v_from_k);
                            // the launch picks the kernel instantiation by it
  float scale;
  int has_cap;
  float cap;
  int has_window, window;
};

template <int D>
struct Geo {
  static_assert(D % 4 == 0, "a row splits into 16-byte chunks");
  static constexpr int VW = 4;                           // floats a 16-byte load
  static constexpr int LPK = D >= 512 ? 32 : 8;          // lanes a key
  static constexpr int KG = 32 / LPK;                    // keys a warp takes at once
  static constexpr int NV = D / VW;                      // 16-byte chunks a row
  static constexpr int NCH = (NV + LPK - 1) / LPK;       // chunks per lane, at most
  static constexpr int CPL = NCH * VW;                   // columns per lane, at most
  // about kStageBytes of K and V rows a block, at least 4 keys, whole key groups
  static constexpr int kBlockKeys_ = kStageBytes / (2 * D * 4) < 4 ? 4 : kStageBytes / (2 * D * 4);
  static constexpr int kBlockKeys = (kBlockKeys_ > 32 ? 32 : kBlockKeys_) / KG * KG;
  static constexpr int KPL = kBlockKeys / KG;            // keys per lane in a block
  static_assert(KPL >= 1 && KPL <= 32, "a block's keys fit the lanes' masks");
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
      for (int k = 0; k < RowState<R, D>::EPT; ++k)
        if (run.has(k)) prm.part_acc[pr * D + run.col(k)] = run.a[k];
    }
    if (run.col(0) == 0) {
      prm.part_ml[2 * pr] = run.m;
      prm.part_ml[2 * pr + 1] = run.l;
    }
  } else {
    const float denom = run.l == 0.f ? 1.f : run.l;
    T* out = static_cast<T*>(prm.out) + r * D;
#pragma unroll
    for (int k = 0; k < RowState<R, D>::EPT; ++k)
      if (run.has(k)) from_float(out + run.col(k), run.a[k] / denom);
  }
}

template <int D, int kPlanes>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const Params prm) {
  using GE = Geo<D>;
  using T = float;
  constexpr int VW = GE::VW, NCH = GE::NCH, CPL = GE::CPL, KB = GE::kBlockKeys, KPL = GE::KPL;
  constexpr int ROW = GE::ROW, LPK = GE::LPK, KG = GE::KG, NV = GE::NV;

  const int n_split_ctas = prm.spread ? prm.n_groups : 1;
  const int tile = blockIdx.x / n_split_ctas;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kq = lane / LPK, dq = lane % LPK;
  // chunk c of this lane, (c LPK + dq), lies inside the row
  auto live = [&](int c) { return NV % LPK == 0 || c * LPK + dq < NV; };

  const int ps = prm.page_size;
  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = kPlanes * prm.num_kv_heads;      // pool rows a token
  constexpr int voff = kPlanes == 2 ? D : 0;      // V's columns in a stage row

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
  const bool has_pos = prm.q_pos != nullptr;
  // explicit positions: every slot below n_pages (kernel.py:108, :127)
  const int hi = has_pos ? min(n_pages, prm.table_width)
                         : min(min(n_pages, last_qpos / ps + 1), prm.table_width);
  const int lo = prm.has_window && !has_pos ? max(first_qpos - prm.window + 1, 0) / ps : 0;
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
  int qpos[kRows];   // a padded row (past row_end) sees no key in position mode
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    qpos[i] = !has_pos ? kv_len - qlen + (row0 + i) / G
            : row0 + i < row_end ? prm.q_pos[q0 + (row0 + i) / G] : -1;
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
      // null slot (page 0 of a slot-derived table, or out of the pool): skipped
      return (pid < (has_pos ? 0 : 1) || pid >= prm.num_pages) ? -1 : pid;
    };
    auto issue = [&](int b) {
      if (b < n_blocks) {
        const int pid = page_of(b);
        if (pid >= 0) {
          const int kb = (b % bpp) * KB;
          const int nk = min(KB, ps - kb);
          T* dst = my_stage + (b & 1) * GE::stage_elems;
          constexpr int CH = kPlanes * D * (int)sizeof(T) / 16;   // 16-byte chunks a key
          for (int c = lane; c < KB * CH; c += 32) {
            const int key = c / CH, e = (c % CH) * (16 / (int)sizeof(T));
            const bool ok = key < nk;
            cp_async16(dst + key * ROW + e,
                       ok ? kv + ((size_t)(pid * ps + kb + key) * H2 + kPlanes * h) * D + e
                          : kv, ok);
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
        int kpos[KPL];   // this lane's keys' positions; -1: past the page, or empty
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int key = j * KG + kq;
          kpos[j] = key >= nk ? -1 : has_pos ? prm.kv_pos[(size_t)pid * ps + kb + key] : kpos0 + key;
        }
        // scores: lane partials over its columns, then summed over the 8 lanes of a key group
        float sc[kRows][KPL];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < KPL; ++j) sc[i][j] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (!live(c)) continue;
          const int col = (c * LPK + dq) * VW;
          float kf[KPL][VW];
#pragma unroll
          for (int j = 0; j < KPL; ++j) load_vec<VW>(st + (j * KG + kq) * ROW + col, kf[j]);
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
          for (int j = 0; j < KPL; ++j)
#pragma unroll
            for (int o = 1; o < LPK; o <<= 1) sc[i][j] += __shfl_xor_sync(0xffffffffu, sc[i][j], o);
        // online softmax per row (m, l warp-uniform; each lane sums its own keys into l)
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          uint32_t ok = 0;
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            float x = sc[i][j] * prm.scale;
            if (prm.has_cap) x = tanhf(x / prm.cap) * prm.cap;
            bool valid = kpos[j] >= 0 && kpos[j] <= qpos[i];
            if (prm.has_window) valid = valid && kpos[j] > qpos[i] - prm.window;
            if (valid) ok |= 1u << j;
            sc[i][j] = valid ? x : kNegInf;
            mx = fmaxf(mx, sc[i][j]);
          }
#pragma unroll
          for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
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
            if (!live(c)) continue;
            float vf[VW];
            load_vec<VW>(st + (j * KG + kq) * ROW + voff + (c * LPK + dq) * VW, vf);
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

    // the split's partial: sum acc and l over the key groups
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], o);
    }
    __syncthreads();   // every warp is done with its stages: they become the merge buffer
    if (kq == 0) {
      float* mw = mbuf + warp * kRows * (D + 2);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          if (live(c))
#pragma unroll
            for (int e = 0; e < VW; ++e) mw[i * (D + 2) + (c * LPK + dq) * VW + e] = acc[i][c * VW + e];
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

template <int D, int kPlanes>
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
  const int H2 = kPlanes * prm.num_kv_heads;      // pool rows a token
  constexpr int voff = kPlanes == 2 ? D : 0;      // V's columns in a stage row

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
  const bool has_pos = prm.q_pos != nullptr;
  // explicit positions: every slot below n_pages (kernel.py:108, :127)
  const int hi = has_pos ? min(n_pages, prm.table_width)
                         : min(min(n_pages, last_qpos / ps + 1), prm.table_width);
  const int lo = prm.has_window && !has_pos ? max(first_qpos - prm.window + 1, 0) / ps : 0;
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
    if (my_pid < (has_pos ? 0 : 1) || my_pid >= prm.num_pages) my_pid = -1;
    auto page_of = [&](int b) { return __shfl_sync(0xffffffffu, my_pid, b / bpp); };
    auto issue = [&](int b) {
      const int pid = page_of(b < n_blocks ? b : 0);
      if (b < n_blocks && pid >= 0) {
        const int kb = (b % bpp) * KB;
        const int nk = min(KB, ps - kb);
        T* dst = my_stage + (b & 1) * GE::stage_elems;
        constexpr int CH = kPlanes * D / 8;   // 16-byte chunks a key
        for (int c = lane; c < KB * CH; c += 32) {
          const int key = c / CH, e = (c % CH) * 8;
          const bool ok = key < nk;
          cp_async16(dst + key * RS + e,
                     ok ? kv + ((size_t)(pid * ps + kb + key) * H2 + kPlanes * h) * D + e
                        : kv, ok);
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
      for (int hh = 0; hh < 2; ++hh) {
        const int fr = row0 + g8 + 8 * hh;   // a padded row sees no key in position mode
        qpos[hh] = !has_pos ? kv_len - qlen + fr / G
                 : fr < row_end ? prm.q_pos[q0 + fr / G] : -1;
      }
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
        int kpos[2][2];   // this lane's keys 8n + 2 t4 + c; -1: past the page, or empty
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = 8 * n + 2 * t4 + c;
            kpos[n][c] = key >= nk ? -1
                       : has_pos ? prm.kv_pos[(size_t)pid * ps + kb + key] : kpos0 + key;
          }
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
            const int hh = e / 2, kp = kpos[n][e % 2];
            float x = sc[n][e] * prm.scale;
            if (prm.has_cap) x = tanhf(x / prm.cap) * prm.cap;
            bool valid = kp >= 0 && kp <= qpos[hh];
            if (prm.has_window) valid = valid && kp > qpos[hh] - prm.window;
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
          ldmatrix_x4_trans(vf, st + ((mi % 2) * 8 + lane % 8) * RS + voff + dn * 16 + (mi / 2) * 8);
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

// ---------------------------------------------------------------------------
// bf16 at the latent head (MLA): a fixed split plan, whole blocks per step,
// splits folded on chip by clusters
// ---------------------------------------------------------------------------
//
// DeepSeek-V2's absorbed MLA attends one fused latent KV head, K' = [c, kr]
// and V' = [c, 0] of width r + dr = 576, with all its query heads (group
// 16: a decode token is exactly one 16-row tile). Decode reads 1,152 B of
// K' and as much of V' per key for 16 rows: about 16 flops a byte against
// the card's ~295, so a long decode is bound by the bytes in flight and by
// how many SMs stream them, a short one by latency.
// - Split plan. A split is kLatentSplitKeys keys rounded down to whole pages
//   (latent_split_pages: 6 pages of 32), cut at fixed boundaries from slot 0,
//   so a row's bits depend on its own sequence alone. A sequence of one
//   split (the serve lengths) writes its output directly. Longer ones run
//   kLatentCluster consecutive splits as one thread-block cluster at 1 CTA
//   an SM (15 clusters of 8 are resident on 132 SMs): 4 x 4096 tokens are
//   12 clusters, 88 live CTAs, one wave. A split's fp32 partial (37 KB) is
//   8% of the two-plane KV it summarises, and it stays on chip.
// - Staging. The page ids of a split arrive with the lengths; warp 0 then
//   issues one TMA box per 16-key unit (both planes of 16 rows of one page,
//   128-byte swizzled: swz) and keeps a ring of NS units (5 at two planes,
//   about a block and a half in flight while one is computed), each
//   completed on its own mbarrier (the box's bytes, then the stored key
//   positions). Loads carry an L2 evict-first hint: they are read once.
//   Pages of a size no multiple of 16 take no box: warp 0 copies their rows
//   by hand. A key outside the visited slots, or on a null page, is zero
//   with position -1.
// - A step is a block of kLatentBlock keys (two units). Warp w of a tile
//   holds Q's columns [144 w, 144 w + 144) in registers for the whole split
//   and computes its partial S over them for all 32 keys (four mma.sync
//   chains); the partials meet in shared memory (the step's one barrier) and
//   every warp sums them in warp order, so all hold the same S, bit for bit,
//   and run the same online softmax; P stays in registers as the A
//   fragments of P V', and warp w accumulates O's columns [144 w, 144 w +
//   144) (V' by ldmatrix.trans). The softcap is out of line.
// - Extends share each block: a CTA holds NT = 2 tiles (2 tokens) and 8
//   warps. Every row runs the decode's arithmetic (the same chains, block
//   boundaries, sum order and fold), so a row's bits do not depend on NT or
//   on the rest of the launch.
// - Fold, one launch. Each CTA writes its partial (m, l, O) to its own
//   shared memory; after a cluster barrier rank c folds columns [72 c,
//   72 c + 72) of the 8 partials through distributed shared memory: with M
//   the largest m of a partial with a visible key and w = exp(m - M), l and
//   O are the sums of l w and O w in split order. One cluster writes the
//   output. Several write their slices to global scratch, and a
//   per-(row tile, rank) counter (acq_rel) finds the cluster that finishes
//   last, which folds the slices the same way in cluster order and resets
//   the counter. No fp32 scratch and no counter below 9 splits.
// Positions: slot-derived, or explicit (q_pos, kv_pos: the ring cache), as
// in the kernels above — every slot below ceil(kv_len / ps) visited, page 0
// included, a key counted only if 0 <= kv_pos <= q_pos (and inside the
// window), a fully masked block the identity. Two planes (the paged pool)
// read V' from its own plane; one plane (the ring: [c, kr] stored once)
// takes V' from K's columns, so lanes [r, r + dr) carry P·kr, which every
// caller drops, and lanes [0, r) equal the two-plane read bit for bit.

constexpr int kLatentD = 576;
constexpr int kLatentBlock = 32;        // keys of one online-softmax step
constexpr int kLatentUnit = 16;         // keys of one staged unit (an mbarrier)
constexpr int kLatentSplitKeys = 192;   // keys a split, rounded down to whole pages
constexpr int kLatentCluster = 8;       // consecutive splits folded on chip
constexpr int kLatentMaxUnits = 6;      // staged units, at most
constexpr int kSmemBytes = 232448;      // a CTA's shared memory, at most

// Pages a split holds: a function of the page size alone.
__host__ __device__ __forceinline__ int latent_split_pages(int page_size) {
  return max(1, kLatentSplitKeys / page_size);
}

template <int kPlanes, int NT>
struct LatentGeo {
  static constexpr int D = kLatentD;
  static constexpr int R = NT * kMmaRows;          // query rows of a CTA
  static constexpr int KR = D / 4;                 // a warp's columns: of the contraction, and of O
  static constexpr int CH = D / 64;                // 128-byte chunks of a K' (or V') row: 9
  static constexpr int THREADS = 32 * 4 * NT;      // 4 warps a tile
  static constexpr int QS = D + 8;                 // padded Q row: 1,168 B
  static constexpr int FS = D + 4;                 // fp32 partial row of the fold
  static constexpr size_t part_bytes = (size_t)kLatentUnit * D * 2;     // a unit's K' (or V')
  static constexpr size_t unit_bytes = kPlanes * part_bytes;
  static constexpr size_t q_bytes = 2 * (size_t)R * QS;
  // partial scores of a block, two buffers: [buffer][tile][warp][n-tile][lane][4]
  static constexpr size_t s_bytes = sizeof(float) * 2 * NT * 4 * 32 * 16;
  static constexpr size_t misc_bytes = sizeof(float) * R * 2 + sizeof(int) * kLatentMaxUnits
      * kLatentUnit + 8 * (kLatentMaxUnits + 1) + sizeof(int) * kLatentSplitKeys;
  static constexpr size_t fixed = 1024 + q_bytes + s_bytes + misc_bytes;   // 1024: alignment
  static constexpr int NS_ = (int)((kSmemBytes - fixed) / unit_bytes);
  static constexpr int NS = NS_ < kLatentMaxUnits ? NS_ : kLatentMaxUnits;   // staged units
  static constexpr size_t bytes = fixed + NS * unit_bytes;
  static_assert(NS >= 3, "a block and a unit in flight");
  static_assert(part_bytes % 1024 == 0, "units stay aligned for the 128-byte swizzle");
  static_assert(sizeof(float) * R * FS <= NS * unit_bytes + q_bytes, "the fold's partial fits");
  static_assert(sizeof(float) * kLatentCluster * R * 2 <= s_bytes, "the peers' (m, l) fit");
  static_assert(KR % 16 == 0 && D % 64 == 0 && D % (4 * kLatentCluster) == 0, "whole chunks");
};

// The softcap of a score, out of line: the latent kernel's loop stays short
// in the instruction cache when no cap is set.
__device__ __noinline__ float softcap(float x, float cap) { return tanhf(x / cap) * cap; }

// Byte offset of 16-byte group g of 64-column chunk c of key k's row in a
// unit part, as the TMA's 128-byte swizzle lays a (64 columns, 16 keys,
// chunks) box: row 16 c + k of 128 bytes, the group XORed with the row's
// low 3 bits (k mod 8), so ldmatrix's 8 keys at one column hit 8 distinct
// bank groups. A two-plane unit's V' chunks follow its K' chunks.
__device__ __forceinline__ uint32_t swz(int k, int c, int g) {
  return (uint32_t)((c * kLatentUnit + k) * 128 + ((g ^ (k & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the mbarriers initialised so far visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of the given parity has completed; traps (a launch
// error, not a hung card) if it has not after 4 seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  if (done) return;
  uint64_t t0;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (true) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}

// TMA: one box of a 3-D tensor map into shared memory, completing on bar;
// the bytes are read once, so L2 evicts them first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar)), "l"(policy) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 8 or 16 bytes at p's offset in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float2 ld_cluster_f2(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

template <int kPlanes, int NT>
__global__ void __launch_bounds__(LatentGeo<kPlanes, NT>::THREADS, 1)
ragged_paged_attention_latent_kernel(const __grid_constant__ Params prm) {
  using GE = LatentGeo<kPlanes, NT>;
  using T = __nv_bfloat16;
  constexpr int D = GE::D, R = GE::R, KR = GE::KR, KS = KR / 16, CH = GE::CH;
  constexpr int QS = GE::QS, FS = GE::FS, NS = GE::NS;
  constexpr int U = kLatentUnit, NCL = kLatentCluster, THREADS = GE::THREADS;
  constexpr int PIDS = (kLatentSplitKeys + 31) / 32;   // page ids a lane of warp 0 loads

  const int split = blockIdx.x;
  const int tg = blockIdx.y / prm.num_kv_heads, h = blockIdx.y % prm.num_kv_heads;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = warp / 4, kr = warp % 4;        // this warp's tile, and its column range
  const int g8 = lane / 4, t4 = lane % 4;          // fragment row, column pair
  const int mi = lane / 8;                         // ldmatrix: this lane's 8x8 matrix

  const int ps = prm.page_size;
  const int W = prm.table_width;
  const int sp = latent_split_pages(ps);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled units need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stage = smem;                      // NS units: [part][key][9 chunks of 128 B]
  T* q_s = reinterpret_cast<T*>(smem + NS * GE::unit_bytes);             // R x QS
  float* s_buf = reinterpret_cast<float*>(smem + NS * GE::unit_bytes + GE::q_bytes);
  float* ml_s = s_buf + GE::s_bytes / sizeof(float);                     // [row][m, l]
  int* kpos_s = reinterpret_cast<int*>(ml_s + 2 * R);                    // [unit slot][U]
  uint64_t* full = reinterpret_cast<uint64_t*>(kpos_s + kLatentMaxUnits * U);
  int* flag_s = reinterpret_cast<int*>(full + kLatentMaxUnits);
  int* pid_s = flag_s + 2;                                               // [kLatentSplitKeys]
  float* part_s = reinterpret_cast<float*>(smem);   // the fold: over the stages and Q, R x FS
  float* peer_ml = s_buf;                           // the peers' (m, l): [rank][row][2]

  // every load that needs no other, at once: the lengths, and the page ids
  // of this split's slots (volatile: issued here, not where they are used)
  int praw[PIDS];
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < PIDS; ++j) {
      const int sl = split * sp + lane + 32 * j;
      praw[j] = -1;
      if (lane + 32 * j < sp && sl < W)
        asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(praw[j])
                     : "l"(prm.page_table + (size_t)s * W + sl));
    }
  }
  const int q0 = prm.cu_q_lens[s];
  const int qlen = prm.cu_q_lens[s + 1] - q0;
  const int kv_len = prm.kv_lens[s];

  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = kPlanes * prm.num_kv_heads;       // pool rows a token
  const int row0 = tg * R;
  if (row0 >= qlen * G) return;                    // the whole cluster: one (s, tg, h)
  const int row_end = min(row0 + R, qlen * G);
  const bool has_pos = prm.q_pos != nullptr;
  const int n_slots = min((kv_len + ps - 1) / ps, W);
  const int n_splits = max(1, (n_slots + sp - 1) / sp);
  const int n_clusters = (n_splits + NCL - 1) / NCL;
  // one split: CTA 0 alone; else every CTA of a cluster that holds a split
  if (n_splits == 1 ? split > 0 : split >= n_clusters * NCL) return;

  // the visited slots (kernel.py:108-118): causal — no key past the rows'
  // last query position; window — none below the first one's window;
  // explicit positions: every slot below n_slots (kernel.py:127)
  const int first_qpos = kv_len - qlen + row0 / G;
  const int last_qpos = kv_len - qlen + (row_end - 1) / G;
  const int hi = has_pos ? n_slots : min(n_slots, last_qpos / ps + 1);
  const int lo = prm.has_window && !has_pos ? max(first_qpos - prm.window + 1, 0) / ps : 0;
  const int key0 = split * sp * ps;                           // the split's first key
  const int ka = max(lo, split * sp) * ps;                    // visited keys [ka, kb)
  const int kb = min(hi, (split + 1) * sp) * ps;
  const int b_lo = kb > ka ? (ka - key0) / kLatentBlock : 0;  // blocks counted from key0
  const int n_blocks = kb > ka ? (kb - key0 + kLatentBlock - 1) / kLatentBlock - b_lo : 0;
  const int n_units = 2 * n_blocks;

  const T* kv = static_cast<const T*>(prm.kv_pages);
  const T* q = static_cast<const T*>(prm.q);
  // Warp 0 issues the copies. A lane's key of a staged unit: lanes 0-15
  // take unit lu_a, 16-31 unit lu_b (lu -1: none). prepare() finds the page
  // and starts the stored position's load; an iteration later
  // commit_copies() issues the unit's TMA box (16 keys of one page, both
  // planes; the unit's first arrival, with its bytes), or copies its rows
  // by hand where pages are no multiple of 16 keys, and zeroes the rows no
  // page holds; commit_pos() stores the positions (its second arrival).
  struct Key { int lu, pid, row, kpos; };
  auto prepare = [&](int lu_a, int lu_b) {
    Key kk{lane / U ? lu_b : lu_a, -1, 0, -1};
    if (kk.lu < 0 || kk.lu >= n_units) {
      kk.lu = -1;
      return kk;
    }
    const int k = key0 + (2 * b_lo + kk.lu) * U + lane % U;
    if (k >= ka && k < kb) {
      const int sl = k / ps;
      kk.row = k - sl * ps;
      kk.pid = pid_s[sl - split * sp];
      // null slot (page 0 of a slot-derived table, or out of the pool)
      if (kk.pid < (has_pos ? 0 : 1) || kk.pid >= prm.num_pages) kk.pid = -1;
      if (kk.pid >= 0) kk.kpos = has_pos ? prm.kv_pos[(size_t)kk.pid * ps + kk.row] : k;
    }
    return kk;
  };
  const int chunk0 = kPlanes * h * CH;              // this KV head's first chunk of a pool row
  // the unit's TMA box, by its first key's lane: a unit is 16 keys of one
  // page (16 divides the page size, and the visited keys [ka, kb) are whole
  // pages), so its keys are all in or out; no box, no bytes
  auto issue_box = [&](const Key& kk) {
    if (kk.lu < 0 || lane % U != 0) return;
    const bool box = prm.kv_tma && kk.pid >= 0;
    mbar_expect_tx(&full[kk.lu % NS], box ? (int)GE::unit_bytes : 0);
    if (box)
      tma_load_3d(stage + (kk.lu % NS) * GE::unit_bytes, &prm.kv_map, 0, kk.pid * ps + kk.row,
                  chunk0, &full[kk.lu % NS]);
  };
  auto fill_by_hand = [&](const Key& kk) {
    const int r = lane % U;
    unsigned char* base = stage + (kk.lu >= 0 ? kk.lu % NS : 0) * GE::unit_bytes;
    const bool by_hand = kk.lu >= 0 && (!prm.kv_tma || kk.pid < 0);
    if (by_hand) {   // zeros where no page holds the key, so P·V' adds exact zeros
      const uint4* src = reinterpret_cast<const uint4*>(
          kv + ((size_t)kk.pid * ps + kk.row) * H2 * D + kPlanes * h * D);
      for (int part = 0; part < kPlanes; ++part)
        for (int c = 0; c < CH; ++c)
          for (int g = 0; g < 8; ++g)
            *reinterpret_cast<uint4*>(base + part * GE::part_bytes + swz(r, c, g)) =
                kk.pid >= 0 ? src[(part * D + c * 64) / 8 + g] : make_uint4(0, 0, 0, 0);
    }
    if (__any_sync(0xffffffffu, by_hand)) fence_async_smem();   // before a later box lands there
  };
  auto commit_copies = [&](const Key& kk) {
    issue_box(kk);
    fill_by_hand(kk);
  };
  auto commit_pos = [&](const Key& kk) {
    if (kk.lu >= 0) kpos_s[(kk.lu % NS) * U + lane % U] = kk.kpos;
    __syncwarp();
    if (kk.lu >= 0 && lane % U == 0) mbar_arrive(&full[kk.lu % NS]);
  };

  // Q's rows by warps 1.. (warp 0 issues the first units meanwhile: Q is
  // requested before their bytes); padded rows zero
  if (warp > 0) {
    for (int r = warp - 1; r < R; r += THREADS / 32 - 1) {
      const int fr = row0 + r;
      const T* src = q + ((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D;
      for (int c = lane; c < D / 8; c += 32)
        cp_async16(q_s + r * QS + c * 8, fr < row_end ? src + c * 8 : q, fr < row_end);
    }
    cp_async_commit();
  }

  Key next{-1, -1, 0, -1};   // warp 0: the keys of the units the next iteration issues
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < PIDS; ++j)
      if (lane + 32 * j < sp) pid_s[lane + 32 * j] = praw[j];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(&full[i], 2);
      mbar_init_fence();
    }
    __syncwarp();
    // the first units' boxes at once (lane j: unit j, by its first key),
    // then their rows by hand and positions, two units a round
    if (lane < NS && lane < n_units) {
      const int k = key0 + (2 * b_lo + lane) * U;
      int pid = -1, row = 0;
      if (k >= ka && k < kb) {
        const int sl = k / ps;
        row = k - sl * ps;
        pid = pid_s[sl - split * sp];
        if (pid < (has_pos ? 0 : 1) || pid >= prm.num_pages) pid = -1;
      }
      const bool box = prm.kv_tma && pid >= 0;
      mbar_expect_tx(&full[lane], box ? (int)GE::unit_bytes : 0);
      if (box)
        tma_load_3d(stage + lane * GE::unit_bytes, &prm.kv_map, 0, pid * ps + row, chunk0, &full[lane]);
    }
    Key first[(NS + 1) / 2];
#pragma unroll
    for (int j = 0; j < (NS + 1) / 2; ++j) first[j] = prepare(2 * j, 2 * j + 1 < NS ? 2 * j + 1 : -1);
#pragma unroll
    for (int j = 0; j < (NS + 1) / 2; ++j) fill_by_hand(first[j]);
#pragma unroll
    for (int j = 0; j < (NS + 1) / 2; ++j) commit_pos(first[j]);
    next = prepare(NS, NS + 1);
  }
  cp_async_wait<0>();
  const int trow = tile * kMmaRows;                 // this warp's tile's first row in the CTA
  const bool live = row0 + trow < row_end;          // the tile holds a row of the sequence
  int qpos[2];   // a padded row (past row_end) sees no key in position mode
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int fr = row0 + trow + g8 + 8 * hh;
    qpos[hh] = !has_pos ? kv_len - qlen + fr / G
             : fr < row_end ? prm.q_pos[q0 + fr / G] : -1;
  }
  // a key counts for row hh if kfloor < its position <= qpos (a dead tile's
  // rows see none; -1 marks an empty row)
  int kfloor[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!live) qpos[hh] = -1;
    kfloor[hh] = prm.has_window ? max(qpos[hh] - prm.window, -1) : -1;
  }
  __syncthreads();   // Q; the mbarriers
  // Q's A fragments for this warp's tile and columns, held for the whole split
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], q_s + (trow + (mi % 2) * 8 + lane % 8) * QS + kr * KR + ks * 16 + (mi / 2) * 8);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[KR / 8][4];
#pragma unroll
  for (int n = 0; n < KR / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < n_blocks; ++i) {
    const int slot0 = (2 * i) % NS, slot1 = (2 * i + 1) % NS;   // the block's two units
    mbar_wait(&full[slot0], (2 * i / NS) & 1);
    mbar_wait(&full[slot1], ((2 * i + 1) / NS) & 1);
    const unsigned char* st0 = stage + slot0 * GE::unit_bytes;
    const unsigned char* st1 = stage + slot1 * GE::unit_bytes;
    // this warp's share of S = Q K'ᵀ: its 144 columns of the contraction,
    // all 32 keys (n-tile n: keys 8n..8n+7, in unit n / 2), four chains
    float sp4[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp4[n][e] = 0.f;
    if (live) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int d = kr * KR + ks * 16 + (mi % 2) * 8;
        const uint32_t off = swz((mi / 2) * 8 + lane % 8, d >> 6, (d >> 3) & 7);
        uint32_t k0[4], k1[4];   // keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7, keys 8-15 | d 8-15
        ldmatrix_x4(k0, st0 + off);
        ldmatrix_x4(k1, st1 + off);
        mma_bf16(sp4[0], qa[ks], k0[0], k0[1]);
        mma_bf16(sp4[1], qa[ks], k0[2], k0[3]);
        mma_bf16(sp4[2], qa[ks], k1[0], k1[1]);
        mma_bf16(sp4[3], qa[ks], k1[2], k1[3]);
      }
    }
    float4* sb = reinterpret_cast<float4*>(s_buf) + ((i & 1) * NT + tile) * 4 * 4 * 32;   // [warp][n][lane]
#pragma unroll
    for (int n = 0; n < 4; ++n)
      sb[(kr * 4 + n) * 32 + lane] = make_float4(sp4[n][0], sp4[n][1], sp4[n][2], sp4[n][3]);
    __syncthreads();   // the partial scores; every warp is done with block i - 1
    if (warp == 0 && i > 0 && 2 * i - 2 + NS < n_units) {
      commit_copies(next);
      commit_pos(next);
      next = prepare(2 * i + NS, 2 * i + 1 + NS);
    }
    // S, the four column ranges summed in order (every warp of the tile
    // holds the same bits); sc[n][e]: row g8 + 8 (e / 2), key 8n + 2 t4 + e % 2
    float sc[4][4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 v = sb[(w * 4 + n) * 32 + lane];
        if (w == 0) {
          sc[n][0] = v.x; sc[n][1] = v.y; sc[n][2] = v.z; sc[n][3] = v.w;
        } else {
          sc[n][0] += v.x; sc[n][1] += v.y; sc[n][2] += v.z; sc[n][3] += v.w;
        }
      }
    // online softmax; a row's 32 scores sit in the 4 lanes of one t4 group
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= prm.scale;
    if (prm.has_cap) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = softcap(sc[n][e], prm.cap);
    }
    uint32_t ok = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // the positions of this lane's keys 8n + 2 t4 and + 1
      const int2 kp2 = *reinterpret_cast<const int2*>(
          kpos_s + (n < 2 ? slot0 : slot1) * U + 8 * (n % 2) + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2, kp = e % 2 ? kp2.y : kp2.x;
        const bool valid = kp > kfloor[hh] && kp <= qpos[hh];
        ok |= (uint32_t)valid << (4 * n + e);
        sc[n][e] = valid ? sc[n][e] : kNegInf;
        mx[hh] = fmaxf(mx[hh], sc[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = fast_exp2((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // explicit zeroing: while every key so far was masked, m is
        // kNegInf and the exponent would be 0
        sc[n][e] = (ok >> (4 * n + e)) & 1u ? fast_exp2((sc[n][e] - m[e / 2]) * kLog2e) : 0.f;
        rsum[e / 2] += sc[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 1);
      rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 2);
      l[hh] = fmaf(l[hh], corr[hh], rsum[hh]);
    }
    if (corr[0] != 1.f || corr[1] != 1.f) {   // a factor of 1 leaves O exact
#pragma unroll
      for (int n = 0; n < KR / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
    }
    // O[:, this warp's columns] += P V', P from the score fragments (keys
    // 16 kk..16 kk + 15, unit kk), V' by ldmatrix.trans at column D of a
    // two-plane row, K's own columns in one plane
    if (live) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        const unsigned char* vb = (kk == 0 ? st0 : st1) + (kPlanes == 2 ? GE::part_bytes : 0);
#pragma unroll
        for (int dn = 0; dn < KR / 16; ++dn) {
          const int d = kr * KR + dn * 16 + (mi / 2) * 8;
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vb + swz((mi % 2) * 8 + lane % 8, d >> 6, (d >> 3) & 7));
          mma_bf16(o[2 * dn], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  T* out = static_cast<T*>(prm.out);
  auto out_row = [&](int r) {   // CTA row r's output row
    const int fr = row0 + r;
    return out + ((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D;
  };
  if (n_splits == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = trow + g8 + 8 * hh;
      if (row0 + r >= row_end) continue;
      const float denom = l[hh] == 0.f ? 1.f : l[hh];
      T* orow = out_row(r) + kr * KR + 2 * t4;
#pragma unroll
      for (int n = 0; n < KR / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * hh] / denom, o[n][2 * hh + 1] / denom);
    }
    return;
  }

  // The cluster's fold. This CTA's partial to its own shared memory.
  __syncthreads();   // every warp is done with Q, the stages and the scores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = trow + g8 + 8 * hh;
    float* prow = part_s + r * FS + kr * KR + 2 * t4;
#pragma unroll
    for (int n = 0; n < KR / 8; ++n)
      *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    if (kr == 0 && t4 == 0) {
      ml_s[2 * r] = m[hh];
      ml_s[2 * r + 1] = l[hh];
    }
  }
  cluster_arrive();
  cluster_wait();    // every partial of the cluster is written
  // A row's fold over partials p (m_p, l_p, a_p), in order: M the largest
  // m_p of a partial with a visible key, w_p = exp(m_p - M) (0 for none),
  // l = sum of l_p w_p, a = sum of a_p w_p, both accumulated in order.
  // The weights depend on the row alone: R threads compute them once.
  constexpr int SC = D / NCL;            // columns a rank folds: 72
  constexpr int V4 = SC / 4;             // as float4s
  constexpr int J = (R * V4 + THREADS - 1) / THREADS;   // (row, 4 columns) items a thread
  const int rank = split % NCL, cl = split / NCL;
  float* wgt_s = peer_ml;                // [partial][row] weights, then [row] (M, l)
  float* row_ml = peer_ml + NCL * R;
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float mp[NCL], lp[NCL];
#pragma unroll
    for (int p = 0; p < NCL; ++p) {
      const float2 v = ld_cluster_f2(ml_s + 2 * r, p);
      mp[p] = v.x;
      lp[p] = v.y;
    }
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int p = 0; p < NCL; ++p)
      if (lp[p] != 0.f) M = fmaxf(M, mp[p]);
#pragma unroll
    for (int p = 0; p < NCL; ++p) {
      const float w = lp[p] != 0.f ? expf(mp[p] - M) : 0.f;
      wgt_s[p * R + r] = w;
      L = fmaf(lp[p], w, L);
    }
    row_ml[2 * r] = M;
    row_ml[2 * r + 1] = L;
  }
  float4 av[J][NCL];   // every item's 8 partials, loaded together
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < R * V4) {
#pragma unroll
      for (int p = 0; p < NCL; ++p)
        av[j][p] = ld_cluster_f4(part_s + (i / V4) * FS + rank * SC + 4 * (i % V4), p);
    }
  }
  __syncthreads();   // the weights
  const size_t unit = ((size_t)s * prm.tile_groups + tg) * prm.num_kv_heads + h;
  const size_t cpart = unit * prm.max_clusters + cl;          // this cluster's partial
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i >= R * V4) continue;
    const int r = i / V4, c = rank * SC + 4 * (i % V4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < NCL; ++p) {   // split order
      const float w = wgt_s[p * R + r];
      a = make_float4(fmaf(av[j][p].x, w, a.x), fmaf(av[j][p].y, w, a.y),
                      fmaf(av[j][p].z, w, a.z), fmaf(av[j][p].w, w, a.w));
    }
    if (n_clusters == 1) {
      if (row0 + r < row_end) {
        const float L = row_ml[2 * r + 1], denom = L == 0.f ? 1.f : L;
        T* orow = out_row(r) + c;
        *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(a.x / denom, a.y / denom);
        *reinterpret_cast<__nv_bfloat162*>(orow + 2) = __floats2bfloat162_rn(a.z / denom, a.w / denom);
      }
    } else {
      *reinterpret_cast<float4*>(prm.part_acc + (cpart * R + r) * D + c) = a;
      if (i % V4 == 0)
        *reinterpret_cast<float2*>(prm.part_ml + ((cpart * NCL + rank) * R + r) * 2) =
            make_float2(row_ml[2 * r], row_ml[2 * r + 1]);
    }
  }
  cluster_arrive();  // done reading the peers' shared memory

  if (n_clusters > 1) {
    // the last cluster to finish this rank's slice folds the clusters'
    // partials in cluster order, the same way. Thread 0's count releases
    // the CTA's writes (ordered before it by the barrier) and acquires the
    // other clusters'.
    __syncthreads();
    if (threadIdx.x == 0) {
      int* counter = prm.counters + unit * NCL + rank;
      int seen;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(seen) : "l"(counter) : "memory");
      const int last = seen == n_clusters - 1;
      if (last) *counter = 0;   // every cluster has counted: ready for the next launch
      *flag_s = last;
    }
    __syncthreads();
    if (*flag_s) {
      const size_t first = unit * prm.max_clusters;
      constexpr int KB = 4;   // clusters' partials loaded together
      auto ml_of = [&](int j, int k) {   // item j's row (M, l) in cluster k
        const int i = min((int)threadIdx.x + j * THREADS, R * V4 - 1);
        return __ldcg(reinterpret_cast<const float2*>(
            prm.part_ml + (((first + min(k, n_clusters - 1)) * NCL + rank) * R + i / V4) * 2));
      };
      float M[J];   // the row's largest M of a cluster with a visible key
#pragma unroll
      for (int j = 0; j < J; ++j) M[j] = kNegInf;
      if (n_clusters > KB) {
        for (int k0 = 0; k0 < n_clusters; k0 += KB) {
          float2 mlv[J][KB];
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int k = 0; k < KB; ++k) mlv[j][k] = ml_of(j, k0 + k);
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int k = 0; k < KB; ++k)
              if (k0 + k < n_clusters && mlv[j][k].y != 0.f) M[j] = fmaxf(M[j], mlv[j][k].x);
        }
      }
      float4 acc[J];
      float L[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        L[j] = 0.f;
      }
      for (int k0 = 0; k0 < n_clusters; k0 += KB) {
        float2 mlv[J][KB];
        float4 a[J][KB];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = min((int)threadIdx.x + j * THREADS, R * V4 - 1);
          const int r = i / V4, c = rank * SC + 4 * (i % V4);
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            const size_t kp = first + min(k0 + k, n_clusters - 1);
            mlv[j][k] = ml_of(j, k0 + k);
            a[j][k] = __ldcg(reinterpret_cast<const float4*>(prm.part_acc + (kp * R + r) * D + c));
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (n_clusters <= KB) {   // one batch holds every cluster
#pragma unroll
            for (int k = 0; k < KB; ++k)
              if (k < n_clusters && mlv[j][k].y != 0.f) M[j] = fmaxf(M[j], mlv[j][k].x);
          }
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k0 + k >= n_clusters) continue;
            const float w = mlv[j][k].y != 0.f ? expf(mlv[j][k].x - M[j]) : 0.f;
            L[j] = fmaf(mlv[j][k].y, w, L[j]);
            acc[j] = make_float4(fmaf(a[j][k].x, w, acc[j].x), fmaf(a[j][k].y, w, acc[j].y),
                                 fmaf(a[j][k].z, w, acc[j].z), fmaf(a[j][k].w, w, acc[j].w));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i >= R * V4) continue;
        const int r = i / V4, c = rank * SC + 4 * (i % V4);
        if (row0 + r >= row_end) continue;
        const float denom = L[j] == 0.f ? 1.f : L[j];
        T* orow = out_row(r) + c;
        *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(acc[j].x / denom, acc[j].y / denom);
        *reinterpret_cast<__nv_bfloat162*>(orow + 2) = __floats2bfloat162_rn(acc[j].z / denom, acc[j].w / denom);
      }
    }
  }
  cluster_wait();    // no peer reads this CTA's shared memory any more
}

// The latent kernel's launch plan, from what the host knows: NT tiles a CTA
// (one for decode), the row-tile groups of the longest sequence, the most
// splits a table row can hold and the clusters they make.
struct LatentPlan {
  int nt, tile_groups, max_splits, max_clusters;
};

LatentPlan latent_plan(int num_q_heads, int num_kv_heads, int table_width, int page_size,
                       int max_q_len) {
  LatentPlan p;
  const long long rows = (long long)max_q_len * (num_q_heads / num_kv_heads);
  p.nt = rows <= kMmaRows ? 1 : 2;
  p.tile_groups = (int)((rows + p.nt * kMmaRows - 1) / (p.nt * kMmaRows));
  const int sp = latent_split_pages(page_size);
  p.max_splits = (table_width + sp - 1) / sp;
  p.max_clusters = (p.max_splits + kLatentCluster - 1) / kLatentCluster;
  return p;
}

// fp32 scratch for the cluster partials (0: one cluster folds every row)
long long latent_scratch_floats(const LatentPlan& p, int num_seqs, int num_kv_heads) {
  if (p.max_clusters <= 1) return 0;
  const long long parts = (long long)num_seqs * p.tile_groups * num_kv_heads * p.max_clusters;
  return parts * p.nt * kMmaRows * (kLatentD + 2 * kLatentCluster);
}

template <int kPlanes, int NT>
cudaError_t launch_latent_nt(const Params& prm, const LatentPlan& p, int num_seqs,
                             cudaStream_t stream) {
  using GE = LatentGeo<kPlanes, NT>;
  const auto kernel = ragged_paged_attention_latent_kernel<kPlanes, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)GE::bytes);
  if (e != cudaSuccess) return e;
  const int cluster = p.max_splits > 1 ? kLatentCluster : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.max_splits > 1 ? p.max_clusters * kLatentCluster : 1,
                     p.tile_groups * prm.num_kv_heads, num_seqs);
  cfg.blockDim = dim3(GE::THREADS);
  cfg.dynamicSmemBytes = GE::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found)
            == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// The latent kernel's TMA map: the pool as (64 columns, tokens, 64-column
// chunks of a token's rows: K' then V'), a box a unit (16 keys of one page,
// this KV head's chunks), 128-byte swizzled (swz). Pages of a size no
// multiple of 16 take no map: the kernel copies their rows by hand.
cudaError_t latent_map(Params& prm) {
  prm.kv_tma = 0;
  if (prm.page_size % kLatentUnit != 0) return cudaSuccess;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t chunks = (cuuint64_t)prm.planes * prm.num_kv_heads * (kLatentD / 64);
  const cuuint64_t dims[3] = {64, (cuuint64_t)prm.num_pages * prm.page_size, chunks};
  const cuuint64_t strides[2] = {chunks * 128, 128};
  const cuuint32_t box[3] = {64, kLatentUnit, (cuuint32_t)(prm.planes * (kLatentD / 64))};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&prm.kv_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(prm.kv_pages), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  prm.kv_tma = 1;
  return cudaSuccess;
}

cudaError_t launch_latent(Params prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  const LatentPlan p = latent_plan(prm.num_q_heads, prm.num_kv_heads, prm.table_width,
                                   prm.page_size, max_q_len);
  if (num_seqs == 0 || p.tile_groups == 0) return cudaSuccess;
  const cudaError_t e = latent_map(prm);
  if (e != cudaSuccess) return e;
  if (p.max_clusters > 1 && (prm.part_acc == nullptr || prm.counters == nullptr))
    return cudaErrorInvalidValue;
  prm.tile_groups = p.tile_groups;
  prm.max_clusters = p.max_clusters;
  if (prm.part_acc != nullptr)
    prm.part_ml = prm.part_acc + (size_t)num_seqs * p.tile_groups * prm.num_kv_heads
                                     * p.max_clusters * p.nt * kMmaRows * kLatentD;
  if (p.nt == 1)
    return prm.planes == 1 ? launch_latent_nt<1, 1>(prm, p, num_seqs, stream)
                           : launch_latent_nt<2, 1>(prm, p, num_seqs, stream);
  return prm.planes == 1 ? launch_latent_nt<1, 2>(prm, p, num_seqs, stream)
                         : launch_latent_nt<2, 2>(prm, p, num_seqs, stream);
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
    return prm.planes == 1
        ? launch_tiles(ragged_paged_attention_mma_kernel<D, 1>, MmaGeo<D>::bytes, kMmaRows, prm,
                       num_seqs, max_q_len, stream)
        : launch_tiles(ragged_paged_attention_mma_kernel<D, 2>, MmaGeo<D>::bytes, kMmaRows, prm,
                       num_seqs, max_q_len, stream);
  else
    return prm.planes == 1
        ? launch_tiles(ragged_paged_attention_kernel<D, 1>, Geo<D>::bytes, kRows, prm,
                       num_seqs, max_q_len, stream)
        : launch_tiles(ragged_paged_attention_kernel<D, 2>, Geo<D>::bytes, kRows, prm,
                       num_seqs, max_q_len, stream);
}

template <typename T, int D>
cudaError_t launch_and_merge(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D == kLatentD) {
    return launch_latent(prm, num_seqs, max_q_len, stream);   // folds in the same launch
  } else {
    const cudaError_t e = launch<T, D>(prm, num_seqs, max_q_len, stream);
    if (e != cudaSuccess || !prm.spread || prm.n_groups == 1 || prm.num_tokens == 0) return e;
    ragged_paged_attention_merge_kernel<T, D>
        <<<dim3(prm.num_tokens, prm.num_q_heads), D, 0, stream>>>(prm);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& prm, int head_dim, int num_seqs,
                              int max_q_len, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_and_merge<T, 32>(prm, num_seqs, max_q_len, stream);
    case 64: return launch_and_merge<T, 64>(prm, num_seqs, max_q_len, stream);
    case 80: return launch_and_merge<T, 80>(prm, num_seqs, max_q_len, stream);
    case 128: return launch_and_merge<T, 128>(prm, num_seqs, max_q_len, stream);
    case 256: return launch_and_merge<T, 256>(prm, num_seqs, max_q_len, stream);
    case kLatentD: return launch_and_merge<T, kLatentD>(prm, num_seqs, max_q_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kSpreadRows = 16;   // (token, group-head) rows a sequence, at most, to spread

// The groups of kWarps splits a sequence of at most `table_width` live
// slots can need: on each range of page counts where split_slots is
// constant the count grows with the pages, so the most is at a range's end
// or at W.
int max_groups(int table_width) {
  auto groups = [&](int n) { return (n + split_slots(n) * kWarps - 1) / (split_slots(n) * kWarps); };
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

bool is_latent(int head_dim, int dtype) { return dtype == 1 && head_dim == kLatentD; }

}  // namespace

// The fp32 scratch, in floats, that a launch with these arguments needs for
// its partials (0: none); the caller passes that much to the launch.
extern "C" long long ragged_paged_attention_scratch_floats(
    int num_tokens, int num_seqs, int num_q_heads, int num_kv_heads, int head_dim,
    int table_width, int page_size, int max_q_len, int dtype) {
  if (num_kv_heads <= 0 || table_width <= 0 || page_size <= 0) return 0;
  if (is_latent(head_dim, dtype))
    return latent_scratch_floats(
        latent_plan(num_q_heads, num_kv_heads, table_width, page_size, max_q_len),
        num_seqs, num_kv_heads);
  if (!spreads(num_q_heads, num_kv_heads, max_q_len)) return 0;
  const int n_groups = max_groups(table_width);
  return n_groups == 1 ? 0 : (long long)n_groups * num_tokens * num_q_heads * (head_dim + 2);
}

// The int32 counters, zero between launches, that a launch with these
// arguments needs (0: none): the latent kernel's, one per (sequence, row
// tile group, KV head, cluster rank) when a row spans several clusters.
// Each launch leaves them zero again; launches sharing them run in order.
extern "C" long long ragged_paged_attention_counters(
    int num_seqs, int num_q_heads, int num_kv_heads, int head_dim, int table_width,
    int page_size, int max_q_len, int dtype) {
  if (num_kv_heads <= 0 || table_width <= 0 || page_size <= 0 || !is_latent(head_dim, dtype))
    return 0;
  const LatentPlan p = latent_plan(num_q_heads, num_kv_heads, table_width, page_size, max_q_len);
  return p.max_clusters <= 1 ? 0
                             : (long long)num_seqs * p.tile_groups * num_kv_heads * kLatentCluster;
}

// dtype: 0 = float32, 1 = bfloat16. has_cap / has_window switch the softcap
// and the sliding window on. q_pos / kv_pos: both null (slot-derived
// positions) or both given (explicit positions). v_from_k: the pool is one
// plane (P, ps, num_kv_heads = 1, D) whose value is its key. scratch:
// ragged_paged_attention_scratch_floats floats (null when that is 0);
// counters: ragged_paged_attention_counters int32s, zero (null when 0).
// Returns the launch's cudaError_t (0 = success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* kv_pages, const void* page_table,
    const void* cu_q_lens, const void* kv_lens, void* out,
    const void* q_pos, const void* kv_pos,
    int num_tokens, int num_seqs, int table_width, int num_pages, int page_size,
    int num_q_heads, int num_kv_heads, int head_dim, int max_q_len, int v_from_k,
    float scale, int has_cap, float cap, int has_window, int window,
    int dtype, void* scratch, void* counters, void* stream) {
  if (page_size <= 0 || num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0
      || table_width <= 0 || (q_pos == nullptr) != (kv_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  // one plane: a latent ring, one KV head
  if (v_from_k && num_kv_heads != 1) return (int)cudaErrorInvalidValue;
  const bool latent = is_latent(head_dim, dtype);   // its own plan (launch_latent)
  const int spread = !latent && spreads(num_q_heads, num_kv_heads, max_q_len);
  const int n_groups = latent ? 1 : max_groups(table_width);
  if (spread && n_groups > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc == nullptr || latent
      ? nullptr : part_acc + (size_t)n_groups * num_tokens * num_q_heads * head_dim;
  Params prm;
  prm.q = q;
  prm.kv_pages = kv_pages;
  prm.page_table = static_cast<const int*>(page_table);
  prm.cu_q_lens = static_cast<const int*>(cu_q_lens);
  prm.kv_lens = static_cast<const int*>(kv_lens);
  prm.q_pos = static_cast<const int*>(q_pos);
  prm.kv_pos = static_cast<const int*>(kv_pos);
  prm.out = out;
  prm.part_acc = part_acc;
  prm.part_ml = part_ml;
  prm.counters = static_cast<int*>(counters);
  prm.tile_groups = prm.max_clusters = 0;
  prm.num_tokens = num_tokens;
  prm.num_pages = num_pages;
  prm.page_size = page_size;
  prm.table_width = table_width;
  prm.num_q_heads = num_q_heads;
  prm.num_kv_heads = num_kv_heads;
  prm.n_groups = n_groups;
  prm.spread = spread;
  prm.planes = v_from_k ? 1 : 2;
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

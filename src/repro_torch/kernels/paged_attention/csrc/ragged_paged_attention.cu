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
//   heads): ragged_paged_attention_latent_kernel, below — the 4 warps of a
//   CTA share one split instead of walking one each.
// - Planes. A pool row holds K and V (two planes, (P, ps, 2*Hkv, D)), or,
//   with v_from_k, one plane (P, ps, 1, D) whose value is its key: the MLA
//   ring's stored [c, kr], one KV head. Every kernel takes the plane count
//   as a template argument: in the per-warp kernels only the copy's length
//   and V's offset in the stage change, the latent kernel also halves its
//   stage rows. An output column sums over its own V column alone, so
//   lanes [0, r) equal the two-plane [c, 0] read bit for bit.

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
// bf16 at the latent head (MLA): the 4 warps of a CTA share one split
// ---------------------------------------------------------------------------
//
// DeepSeek-V2's absorbed MLA attends one fused latent KV head, K' = [c, kr]
// and V' = [c, 0] of width r + dr = 576, with all its query heads (group
// 16: a decode token is exactly one 16-row tile). The per-warp splits above
// do not fit that width: each warp would keep O for all 576 columns (288
// fp32 registers a thread), and 4 warps x 2 stages x 16 keys x 2,320 B of
// K|V rows exceed a CTA's shared memory. Here a group is one split, and
// the CTA walks it with all 4 warps on each block of 16 keys:
// - S = Q K'ᵀ: warp w contracts columns [144 w, 144 w + 144) (9 k-steps of
//   mma.sync); the 4 partial 16x16 tiles meet in shared memory and every
//   warp sums them in warp order, so all warps hold the same scores, bit
//   for bit, and run the same online softmax (m, l);
// - O += P V': warp w accumulates output columns [144 w, 144 w + 144) (72
//   fp32 registers a thread), V' by ldmatrix.trans as above;
// - a 16-key K|V stage is 37,120 B (one plane: 18,688 B), two stages, one
//   block in flight while the other is computed; two barriers a block.
// Positions: slot-derived, or explicit (q_pos, kv_pos: the ring cache), as
// in the kernels above — every slot below ceil(kv_len / ps) visited, page 0
// included, a key counted only if 0 <= kv_pos <= q_pos (and inside the
// window), a fully masked block the identity.
// Splits, groups and folds keep the rules above: slots cut at fixed
// boundaries (split_slots), empty groups identities, spread decode folded
// by the merge launch (kPartial: the CTA writes its group's partial),
// otherwise the CTA folds its groups in order in registers with the same
// fold — so a row's bits do not depend on the launch. The two
// instantiations share every line of a group's arithmetic; the partial one
// keeps no running state, which leaves its registers to O. Two planes
// (the paged pool: K' = [c, kr], V' = [c, 0]) read c twice; one plane (the
// ring: [c, kr] stored once, kPlanes = 1) takes V' from K's columns, so
// lanes [r, r + dr) carry P·kr, which every caller drops.

constexpr int kLatentD = 576;
constexpr int kLatentCols = kLatentD / kWarps;   // a warp's share of the contraction and of O

template <int kPlanes>
struct LatentGeo {
  static constexpr int D = kLatentD;
  static constexpr int QS = D + 8;               // padded Q row: 1,168 B, an odd number of 16 B
  static constexpr int RS = kPlanes * D + 8;     // padded K'|V' row: 2,320 B (one plane: 1,168 B), likewise
  static constexpr int stage_elems = kMmaKeys * RS;
  static constexpr size_t q_bytes = 2 * kMmaRows * QS;
  static constexpr size_t stage_bytes = 2 * stage_elems;
  static constexpr size_t score_bytes = sizeof(float) * kWarps * 32 * 8;   // [warp][lane][8]
  static constexpr size_t bytes = q_bytes + 2 * stage_bytes + score_bytes;
  static_assert(kLatentCols % 16 == 0, "a warp's columns are whole k-steps");
};

template <bool kPartial, int kPlanes>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_latent_kernel(const Params prm) {
  using GE = LatentGeo<kPlanes>;
  using T = __nv_bfloat16;
  constexpr int D = GE::D, R = kMmaRows, KB = kMmaKeys, RS = GE::RS, QS = GE::QS;
  constexpr int WC = kLatentCols, NT = WC / 8;

  const int n_split_ctas = prm.spread ? prm.n_groups : 1;
  const int tile = blockIdx.x / n_split_ctas;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;            // fragment row, column pair
  const int mi = lane / 8;                           // ldmatrix: this lane's 8x8 matrix

  const int ps = prm.page_size;
  const int Hq = prm.num_q_heads;
  const int G = Hq / prm.num_kv_heads;
  const int H2 = kPlanes * prm.num_kv_heads;        // pool rows a token

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
  const int slots = split_slots(n_pages);           // a group is one split
  int g_begin, g_end;   // the groups this CTA folds
  if (prm.spread) {
    g_begin = blockIdx.x % n_split_ctas;
    g_end = g_begin + 1;
  } else {
    g_begin = lo / slots;
    g_end = hi > lo ? (hi - 1) / slots + 1 : g_begin;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                                        // R x QS
  T* stages = reinterpret_cast<T*>(smem + GE::q_bytes);                       // 2 x KB x RS
  float* sbuf = reinterpret_cast<float*>(smem + GE::q_bytes + 2 * GE::stage_bytes);

  const T* q = static_cast<const T*>(prm.q);
  const T* kv = static_cast<const T*>(prm.kv_pages);
  for (int i = threadIdx.x; i < R * D / 8; i += kThreads) {
    const int r = i / (D / 8), d = (i % (D / 8)) * 8;
    const int fr = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (fr < row_end)
      x = *reinterpret_cast<const uint4*>(q + ((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D + d);
    *reinterpret_cast<uint4*>(q_s + r * QS + d) = x;
  }
  int qpos[2];   // a padded row (past row_end) sees no key in position mode
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int fr = row0 + g8 + 8 * hh;
    qpos[hh] = !has_pos ? kv_len - qlen + fr / G
             : fr < row_end ? prm.q_pos[q0 + fr / G] : -1;
  }
  const int bpp = (ps + KB - 1) / KB;
  static_assert(kMaxSlots <= 32, "a lane per slot of a split");

  // the folded state of this thread's rows (g8, g8 + 8) and columns
  constexpr int RT = kPartial ? 1 : NT;
  float rm[2] = {kNegInf, kNegInf}, rl[2] = {0.f, 0.f}, ro[RT][4];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ro[j][e] = 0.f;

  for (int grp = g_begin; grp < g_end; ++grp) {
    const int s_lo = max(lo, grp * slots);
    const int s_hi = min(hi, (grp + 1) * slots);
    const int n_blocks = s_hi > s_lo ? (s_hi - s_lo) * bpp : 0;

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    // the split's page ids, lane j holding slot s_lo + j (-1: null, skipped);
    // every warp reads the same ids, so a block's skip is CTA-uniform
    int my_pid = -1;
    if (lane < s_hi - s_lo) my_pid = prm.page_table[s * prm.table_width + s_lo + lane];
    // null slot (page 0 of a slot-derived table, or out of the pool): skipped
    if (my_pid < (has_pos ? 0 : 1) || my_pid >= prm.num_pages) my_pid = -1;
    auto page_of = [&](int b) { return __shfl_sync(0xffffffffu, my_pid, b / bpp); };
    auto issue = [&](int b) {   // every thread copies its share of block b
      const int pid = page_of(b < n_blocks ? b : 0);
      if (b < n_blocks && pid >= 0) {
        const int kb = (b % bpp) * KB;
        const int nk = min(KB, ps - kb);
        T* dst = stages + (b & 1) * GE::stage_elems;
        constexpr int CH = kPlanes * D / 8;   // 16-byte chunks a key
        for (int c = threadIdx.x; c < KB * CH; c += kThreads) {
          const int key = c / CH, e = (c % CH) * 8;
          const bool ok = key < nk;
          cp_async16(dst + key * RS + e,
                     ok ? kv + ((size_t)(pid * ps + kb + key) * H2 + kPlanes * h) * D + e
                        : kv, ok);
        }
      }
      cp_async_commit();
    };

    __syncthreads();   // Q staged; the previous group's last stage is consumed
    issue(0);
    for (int b = 0; b < n_blocks; ++b) {
      cp_async_wait<0>();
      // block b has landed from every thread's copies, and every warp is
      // done with block b - 1: its stage and the score buffer are free
      __syncthreads();
      issue(b + 1);
      const int pid = page_of(b);
      if (pid < 0) continue;
      const T* st = stages + (b & 1) * GE::stage_elems;
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
      // this warp's partial S over its columns; sc[n][e]: row g8 + 8 (e / 2), key 8n + 2 t4 + e % 2
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < WC / 16; ++ks) {
        const int col = warp * WC + ks * 16;
        uint32_t kf[4], qf[4];
        ldmatrix_x4(kf, st + ((mi / 2) * 8 + lane % 8) * RS + col + (mi % 2) * 8);
        ldmatrix_x4(qf, q_s + ((mi % 2) * 8 + lane % 8) * QS + col + (mi / 2) * 8);
        mma_bf16(sc[0], qf, kf[0], kf[1]);
        mma_bf16(sc[1], qf, kf[2], kf[3]);
      }
      float4* mine = reinterpret_cast<float4*>(sbuf + (warp * 32 + lane) * 8);
      mine[0] = make_float4(sc[0][0], sc[0][1], sc[0][2], sc[0][3]);
      mine[1] = make_float4(sc[1][0], sc[1][1], sc[1][2], sc[1][3]);
      __syncthreads();
      // the whole S, summed in warp order
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4* part = reinterpret_cast<const float4*>(sbuf + (w * 32 + lane) * 8);
        const float4 a = part[0], c = part[1];
        if (w == 0) {
          sc[0][0] = a.x; sc[0][1] = a.y; sc[0][2] = a.z; sc[0][3] = a.w;
          sc[1][0] = c.x; sc[1][1] = c.y; sc[1][2] = c.z; sc[1][3] = c.w;
        } else {
          sc[0][0] += a.x; sc[0][1] += a.y; sc[0][2] += a.z; sc[0][3] += a.w;
          sc[1][0] += c.x; sc[1][1] += c.y; sc[1][2] += c.z; sc[1][3] += c.w;
        }
      }
      // online softmax, as the per-warp kernel runs it
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
          sc[n][e] = (ok >> (4 * n + e)) & 1u ? fast_exp2((sc[n][e] - m[hh]) * kLog2e) : 0.f;
          l[hh] += sc[n][e];
        }
      if (corr[0] != 1.f || corr[1] != 1.f) {   // a factor of 1 leaves O exact
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] *= corr[e / 2];
      }
      // O[:, this warp's columns] += P V'
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dn = 0; dn < WC / 16; ++dn) {
        uint32_t vf[4];
        // V' at column D of a two-plane row, K's own columns in one plane
        ldmatrix_x4_trans(vf, st + ((mi % 2) * 8 + lane % 8) * RS + (kPlanes == 2 ? D : 0)
                                  + warp * WC + dn * 16 + (mi / 2) * 8);
        mma_bf16(o[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    if constexpr (kPartial) {
      // this group's fp32 partial; a group with no visible key (l = 0) is the
      // fold's identity: the merge reads its (m, l) only
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int fr = row0 + g8 + 8 * hh;
        if (fr >= row_end) continue;
        const size_t pr = (size_t)grp * prm.num_tokens * Hq
                          + (size_t)(q0 + fr / G) * Hq + h * G + fr % G;
        if (l[hh] != 0.f) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float* dst = prm.part_acc + pr * D + warp * WC + 8 * j + 2 * t4;
            dst[0] = o[j][2 * hh];
            dst[1] = o[j][2 * hh + 1];
          }
        }
        if (warp == 0 && t4 == 0) {
          prm.part_ml[2 * pr] = m[hh];
          prm.part_ml[2 * pr + 1] = l[hh];
        }
      }
    } else {
      // fold the group into the running state, in group order (the merge
      // launch's fold, column by column)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float a[2 * RT];
#pragma unroll
        for (int k = 0; k < 2 * RT; ++k) a[k] = ro[k / 2][2 * hh + k % 2];
        fold(rm[hh], rl[hh], a, m[hh], l[hh], [&](int k) { return o[k / 2][2 * hh + k % 2]; });
#pragma unroll
        for (int k = 0; k < 2 * RT; ++k) ro[k / 2][2 * hh + k % 2] = a[k];
      }
    }
  }
  if constexpr (!kPartial) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int fr = row0 + g8 + 8 * hh;
      if (fr >= row_end) continue;
      const float denom = rl[hh] == 0.f ? 1.f : rl[hh];
      T* out = static_cast<T*>(prm.out) + ((size_t)(q0 + fr / G) * Hq + h * G + fr % G) * D
               + warp * WC + 2 * t4;
#pragma unroll
      for (int j = 0; j < RT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(ro[j][2 * hh] / denom, ro[j][2 * hh + 1] / denom);
    }
  }
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

template <int kPlanes>
cudaError_t launch_latent(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  constexpr size_t bytes = LatentGeo<kPlanes>::bytes;
  return prm.spread && prm.n_groups > 1
      ? launch_tiles(ragged_paged_attention_latent_kernel<true, kPlanes>, bytes, kMmaRows,
                     prm, num_seqs, max_q_len, stream)
      : launch_tiles(ragged_paged_attention_latent_kernel<false, kPlanes>, bytes, kMmaRows,
                     prm, num_seqs, max_q_len, stream);
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int num_seqs, int max_q_len, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D == kLatentD)
    return prm.planes == 1 ? launch_latent<1>(prm, num_seqs, max_q_len, stream)
                           : launch_latent<2>(prm, num_seqs, max_q_len, stream);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
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
    case 80: return launch_and_merge<T, 80>(prm, num_seqs, max_q_len, stream);
    case 128: return launch_and_merge<T, 128>(prm, num_seqs, max_q_len, stream);
    case 256: return launch_and_merge<T, 256>(prm, num_seqs, max_q_len, stream);
    case kLatentD: return launch_and_merge<T, kLatentD>(prm, num_seqs, max_q_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kSpreadRows = 16;   // (token, group-head) rows a sequence, at most, to spread

// Splits a group: one a warp, except the bf16 latent kernel's one a CTA.
int group_splits(int head_dim, int dtype) {
  return dtype == 1 && head_dim == kLatentD ? 1 : kWarps;
}

// The groups of splits a sequence of at most `table_width` live slots can
// need: on each range of page counts where split_slots is constant the
// count grows with the pages, so the most is at a range's end or at W.
int max_groups(int table_width, int splits) {
  auto groups = [&](int n) { return (n + split_slots(n) * splits - 1) / (split_slots(n) * splits); };
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
    int max_q_len, int dtype) {
  if (num_kv_heads <= 0 || table_width <= 0 || !spreads(num_q_heads, num_kv_heads, max_q_len))
    return 0;
  const int n_groups = max_groups(table_width, group_splits(head_dim, dtype));
  return n_groups == 1 ? 0 : (long long)n_groups * num_tokens * num_q_heads * (head_dim + 2);
}

// dtype: 0 = float32, 1 = bfloat16. has_cap / has_window switch the softcap
// and the sliding window on. q_pos / kv_pos: both null (slot-derived
// positions) or both given (explicit positions). v_from_k: the pool is one
// plane (P, ps, num_kv_heads = 1, D) whose value is its key. scratch:
// ragged_paged_attention_scratch_floats floats (null when that is 0).
// Returns the launch's cudaError_t (0 = success).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* kv_pages, const void* page_table,
    const void* cu_q_lens, const void* kv_lens, void* out,
    const void* q_pos, const void* kv_pos,
    int num_tokens, int num_seqs, int table_width, int num_pages, int page_size,
    int num_q_heads, int num_kv_heads, int head_dim, int max_q_len, int v_from_k,
    float scale, int has_cap, float cap, int has_window, int window,
    int dtype, void* scratch, void* stream) {
  if (page_size <= 0 || num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0
      || table_width <= 0 || (q_pos == nullptr) != (kv_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  // one plane: a latent ring, one KV head
  if (v_from_k && num_kv_heads != 1) return (int)cudaErrorInvalidValue;
  const int spread = spreads(num_q_heads, num_kv_heads, max_q_len);
  const int n_groups = max_groups(table_width, group_splits(head_dim, dtype));
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
  prm.q_pos = static_cast<const int*>(q_pos);
  prm.kv_pos = static_cast<const int*>(kv_pos);
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

// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_bh (body
// _flash_kernel) as the forward, and the custom VJP of
// src/repro/models/attention.py::chunked_attention (_flash_chunk_bwd) as
// the backward, which the JAX package computes in jnp and which has no
// Pallas kernel.
//
// What it computes: causal self-attention of q (B, Sq, H, D) against k/v
// (B, Skv, Hkv, D), query i at position i and key j at position j, query
// head h reading KV head h / G (G = H / Hkv; the group repeat the JAX
// wrapper builds is never materialised). Scores are scaled, then tanh
// softcapped, then masked (causal, optional sliding window, keys < Skv),
// as in attention.py:75-82. Softmax state, sums and gradients in fp32;
// q/k/v/out/dq/dk/dv in the input dtype (fp32 or bf16). A row with no
// visible key has l == 0, stored as 1, and outputs 0. Rows are the
// flattened (token, group-head) axis of one KV head, so the G query heads
// that share a KV head share every staged K/V tile. Nothing uses atomics
// and every sum runs in a fixed order: two launches on the same inputs
// give the same bits.
//
// What bounds it: operations. At the gemma-2b training shape (B 4, S 2048,
// H 8, Hkv 1, D 256, causal) the forward does 4*B*H*D*S(S+1)/2 = 68.7
// GFLOP on ~0.05 GB: ~1,400 flop per byte, far above the card's balance
// point, so its bound is the bf16 tensor-core rate (989 TFLOP/s).
//
// bf16 runs on the tensor cores (the "tensor-core kernels" section):
// - forward: warp-specialised, one producer warpgroup (Q by cp.async, K/V
//   by TMA into 128-byte-swizzled tiles, 2 stages under mbarriers) and two
//   consumer warpgroups of 64 rows each, S and P.V by wgmma with P as a
//   register operand, fp32 online softmax in the accumulator registers;
// - dK/dV: warp-specialised the same way; keys on the M axis, K/V
//   resident, Q/dO streamed by TMA; one consumer warpgroup accumulates dV,
//   the other dK, both by wgmma with the probabilities as a register
//   operand; the causal row range of a key tile is cut into units at fixed
//   row boundaries (ops.dkdv_plan) whose fp32 partials a second launch sums
//   in row order.
// - dQ: warp-specialised the same way; rows on the M axis, Q/dO resident,
//   K/V streamed by TMA; each consumer warpgroup owns 64 rows and computes
//   S and dP by wgmma, dS in registers and dQ += dS K with dS as a register
//   operand; every CTA owns its rows, so one launch and no partial sums.
// fp32 keeps the first FMA kernels on the CUDA cores (below): they carry
// every fp32 parity check (kernel 3e-5 / 2e-4, reduced training 1e-4, the
// full-width gradient check), which TF32 tensor cores (10-bit mantissas)
// could not meet.
//
// FMA kernels (fp32):
// - forward: one CTA of 128 threads per (batch, KV head, tile of 32
//   rows); it walks only the 64-key tiles in its rows' causal/window range,
//   keeps (m, l, acc) in registers and writes out, m and l (B, H, Sq).
// - backward dK/dV: one CTA of 256 threads per (batch, KV head, 32-key
//   tile); it loops over the rows that see those keys, 32 at a time,
//   recomputes P = exp(s - m) / l, and accumulates dV += Pᵀ dO and
//   dK += dSᵀ Q in registers.
// - backward dQ: one CTA of 256 threads per (batch, KV head, 32-row tile);
//   it loops over the 32-key tiles in range and accumulates dQ += dS K.
// Both backward kernels read delta = rowsum(dO * O) (B, H, Sq), fp32,
// computed by the caller. dS = P (dO Vᵀ - delta), times (1 - tanh²) under
// a softcap (attention.py:153-156), times the scale. Every thread of an FMA
// kernel holds a register tile (forward: 4 rows x 4 keys of scores and 4
// rows x D/16 output columns; backward: 2x2 scores and an 8x4 (D 256) tile
// of dK/dV or dQ), so each 16-byte shared-memory load feeds 4-16 FMAs.
//
// Shared memory at D 256: bf16 forward 193 KB (Q 64 KB, 2 stages of K and
// V), bf16 dK/dV 210 KB (K, V, 2 stages of Q and dO, a 16 KB exchange),
// bf16 dQ 193 KB (Q and dO of 128 rows, 2 stages of 32 keys of K and V);
// FMA forward 174 KB (fp32), backward 142 KB. Above 48 KB the launcher
// raises the kernel's dynamic shared-memory limit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -2.0e38f;   // the reference's NEG_INF

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// N consecutive floats at p (aligned to the vector width used, up to 16
// bytes): shared or global memory.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x; o[i + 1] = x.y; o[i + 2] = x.z; o[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    static_assert(N == 1, "vector width");
    o[0] = p[0];
  }
}

__device__ __forceinline__ float max16(float v) {   // over 16 aligned lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* q;       // (B, Sq, H, D)
  const void* k;       // (B, Skv, Hkv, D)
  const void* v;       // (B, Skv, Hkv, D)
  const void* dout;    // (B, Sq, H, D)       backward only
  const float* delta;  // (B, H, Sq)          backward only
  float* m;            // (B, H, Sq)          forward writes, backward reads
  float* l;            // (B, H, Sq)
  void* out;           // forward: out (B, Sq, H, D); dQ kernel: dq
  void* dk;            // (B, Skv, Hkv, D)    dK/dV kernel
  void* dv;
  int B, Sq, Skv, H, Hkv;
  float scale;
  int has_cap;
  float cap;
  int has_window, window;
  const int* plan;     // bf16 dK/dV: units (key tile, row begin, row end, slot)
  const int* reduce;   // bf16 dK/dV: split key tiles (key tile, first slot, count)
  float* scratch;      // bf16 dK/dV: fp32 partials (slot, B, Hkv, 2, 64, D)
  int n_units, n_reduce;
  int rows_tma;                 // bf16: Q (and dO) rows by TMA (G divides the row tile)
  CUtensorMap tmap_k, tmap_v;   // bf16: K and V for TMA (swizzled 64-key tiles)
  CUtensorMap tmap_q, tmap_do;  // bf16: Q and dO rows of one KV head
};

// Post-cap score of one (query token t, key) pair, and whether the key is
// visible to the query.
__device__ __forceinline__ float post_cap(const Params& p, float dot, float* th) {
  const float x = dot * p.scale;
  if (!p.has_cap) return x;
  *th = tanhf(x / p.cap);
  return *th * p.cap;
}

__device__ __forceinline__ bool visible(const Params& p, int t, int key) {
  return key < p.Skv && key <= t && (!p.has_window || key > t - p.window);
}

// Rows of the flattened (token, group-head) axis of one KV head: row fr is
// token fr / G, query head hkv * G + fr % G.
__device__ __forceinline__ size_t q_offset(const Params& p, int b, int hkv, int G,
                                           int fr, int D) {
  const int t = fr / G, h = hkv * G + fr % G;
  return ((size_t)(b * p.Sq + t) * p.H + h) * D;
}

__device__ __forceinline__ size_t stat_offset(const Params& p, int b, int hkv, int G, int fr) {
  const int t = fr / G, h = hkv * G + fr % G;
  return (size_t)(b * p.H + h) * p.Sq + t;
}

__device__ __forceinline__ size_t kv_offset(const Params& p, int b, int hkv, int key, int D) {
  return ((size_t)(b * p.Skv + key) * p.Hkv + hkv) * D;
}

// Copy rows of a (rows x D) slice of global memory into fp32 shared rows of
// stride `stride` floats; rows where row_ok(r) is false become zeros.
template <typename T, int D, int NT, typename Src>
__device__ __forceinline__ void stage_f32(float* dst, int stride, int rows, Src src) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    const T* g = src(r);
    float x[V];
    if (g != nullptr) {
      load_vec<V>(g + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + r * stride + c + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 128;
constexpr int kFwdRows = 32;   // (token, group-head) rows per CTA
constexpr int kFwdKeys = 64;   // keys per staged tile

template <typename T, int D>
struct FwdSmem {
  static constexpr int QS = D + 4;                  // fp32 Q row stride
  static constexpr int KVEC = 16 / sizeof(T);
  static constexpr int KS = D + KVEC;               // K row stride (+16 bytes)
  static constexpr size_t bytes = sizeof(float) * (kFwdRows * QS + kFwdKeys * kFwdRows)
                                  + sizeof(T) * (size_t)kFwdKeys * (KS + D);
};

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const Params p) {
  using SM = FwdSmem<T, D>;
  constexpr int BR = kFwdRows, BC = kFwdKeys;
  constexpr int QS = SM::QS, KS = SM::KS, KVEC = SM::KVEC;
  constexpr int CPT = D / 16;                       // output columns per thread
  constexpr int VW = CPT < KVEC ? CPT : KVEC;       // V vector width
  constexpr int NCH = CPT / VW;

  const int tile = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid / 16;   // rows rg + 8*i
  const int kg = tid % 16;   // keys kg + 16*j; output columns of group kg
  const int G = p.H / p.Hkv;
  const int row0 = tile * BR;
  const int row_end = min(row0 + BR, p.Sq * G);
  const int t_first = row0 / G, t_last = (row_end - 1) / G;
  const int hi = min(p.Skv, t_last + 1);
  const int lo = p.has_window ? max(0, t_first - p.window + 1) : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);        // BR x QS
  float* p_s = q_s + BR * QS;                          // BC x BR, row slot rg*4+i
  T* k_s = reinterpret_cast<T*>(p_s + BC * BR);        // BC x KS
  T* v_s = k_s + BC * KS;                              // BC x D

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  stage_f32<T, D, kFwdThreads>(q_s, QS, BR, [&](int r) -> const T* {
    return row0 + r < row_end ? q + q_offset(p, b, hkv, G, row0 + r, D) : nullptr;
  });

  float m[4], l[4], acc[4][CPT];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = (row0 + rg + 8 * i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BC) {
    const int nk = min(BC, hi - k0);
    __syncthreads();   // the previous tile's P.V is done (and Q is staged)
    constexpr int PER_ROW = D / KVEC;
    for (int i = tid; i < BC * PER_ROW; i += kFwdThreads) {
      const int j = i / PER_ROW, c = (i % PER_ROW) * KVEC;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (j < nk) {
        const size_t off = kv_offset(p, b, hkv, k0 + j, D) + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + j * KS + c) = kx;
      *reinterpret_cast<uint4*>(v_s + j * D + c) = vx;
    }
    __syncthreads();

    // scores: s[i][j] = q[rg + 8i] . k[kg + 16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += KVEC) {
      float kf[4][KVEC];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_vec<KVEC>(k_s + (kg + 16 * j) * KS + d, kf[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float qf[KVEC];
        load_vec<KVEC>(q_s + (rg + 8 * i) * QS + d, qf);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < KVEC; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
      }
    }

    // online softmax over this tile; a row's 16 key groups are 16 aligned lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float th;
        const float x = post_cap(p, s[i][j], &th);
        ok[j] = visible(p, qpos[i], k0 + kg + 16 * j);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (kg + 16 * j) * BR + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[i][cols of kg] += sum_key P[row i][key] V[key][cols]
    for (int kk = 0; kk < nk; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(p_s + kk * BR + rg * 4);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int h = 0; h < NCH; ++h) {
        float vf[VW];
        load_vec<VW>(v_s + kk * D + h * 16 * VW + kg * VW, vf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[i][h * VW + e] = fmaf(pr[i], vf[e], acc[i][h * VW + e]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fr = row0 + rg + 8 * i;
    if (fr >= row_end) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + q_offset(p, b, hkv, G, fr, D);
#pragma unroll
    for (int h = 0; h < NCH; ++h)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(orow + h * 16 * VW + kg * VW + e, acc[i][h * VW + e] / denom);
    if (kg == 0) {
      const size_t so = stat_offset(p, b, hkv, G, fr);
      p.m[so] = m[i];
      p.l[so] = denom;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 32;   // (token, group-head) rows per tile
constexpr int kBwdKeys = 32;   // keys per tile

template <int D>
struct BwdSmem {
  static constexpr int S = D + 4;   // fp32 row stride of Q, dO, K, V
  static constexpr size_t bytes = sizeof(float) * (2 * kBwdRows * S + 2 * kBwdKeys * S
                                                   + 2 * kBwdRows * kBwdKeys + 3 * kBwdRows);
};

// Accumulator tile of phase B: XPT rows (keys for dK/dV, query rows for
// dQ) x CPT columns per thread, (32 / XPT) x (D / CPT) threads.
template <int D>
struct BwdTile {
  static constexpr int CPT = D >= 128 ? 4 : (D == 64 ? 2 : 1);
  static constexpr int XPT = (32 * D) / (kBwdThreads * CPT);
  static constexpr int NCG = D / CPT;
  static_assert((32 / XPT) * NCG == kBwdThreads, "tile covers the block");
};

struct BwdShared {
  float *q_s, *do_s, *k_s, *v_s, *p_s, *ds_s, *m_s, *l_s, *dl_s;
};

template <int D>
__device__ __forceinline__ BwdShared bwd_shared(unsigned char* smem) {
  constexpr int S = BwdSmem<D>::S;
  BwdShared sh;
  sh.q_s = reinterpret_cast<float*>(smem);
  sh.do_s = sh.q_s + kBwdRows * S;
  sh.k_s = sh.do_s + kBwdRows * S;
  sh.v_s = sh.k_s + kBwdKeys * S;
  sh.p_s = sh.v_s + kBwdKeys * S;
  sh.ds_s = sh.p_s + kBwdRows * kBwdKeys;
  sh.m_s = sh.ds_s + kBwdRows * kBwdKeys;
  sh.l_s = sh.m_s + kBwdRows;
  sh.dl_s = sh.l_s + kBwdRows;
  return sh;
}

// Stage the Q and dO rows [row0, row0 + 32) of one KV head (zeros past
// row_end) and their m, l, delta.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const Params& p, const BwdShared& sh, int b,
                                           int hkv, int G, int row0, int row_end) {
  constexpr int S = BwdSmem<D>::S;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  stage_f32<T, D, kBwdThreads>(sh.q_s, S, kBwdRows, [&](int r) -> const T* {
    return row0 + r < row_end ? q + q_offset(p, b, hkv, G, row0 + r, D) : nullptr;
  });
  stage_f32<T, D, kBwdThreads>(sh.do_s, S, kBwdRows, [&](int r) -> const T* {
    return row0 + r < row_end ? dout + q_offset(p, b, hkv, G, row0 + r, D) : nullptr;
  });
  if (threadIdx.x < kBwdRows) {
    const int fr = row0 + threadIdx.x;
    const bool ok = fr < row_end;
    const size_t so = ok ? stat_offset(p, b, hkv, G, fr) : 0;
    sh.m_s[threadIdx.x] = ok ? p.m[so] : 0.f;
    sh.l_s[threadIdx.x] = ok ? p.l[so] : 1.f;
    sh.dl_s[threadIdx.x] = ok ? p.delta[so] : 0.f;
  }
}

// Stage keys [k0, k0 + 32) of K and V (zeros past Skv).
template <typename T, int D>
__device__ __forceinline__ void stage_keys(const Params& p, const BwdShared& sh, int b,
                                           int hkv, int k0) {
  constexpr int S = BwdSmem<D>::S;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  stage_f32<T, D, kBwdThreads>(sh.k_s, S, kBwdKeys, [&](int j) -> const T* {
    return k0 + j < p.Skv ? k + kv_offset(p, b, hkv, k0 + j, D) : nullptr;
  });
  stage_f32<T, D, kBwdThreads>(sh.v_s, S, kBwdKeys, [&](int j) -> const T* {
    return k0 + j < p.Skv ? v + kv_offset(p, b, hkv, k0 + j, D) : nullptr;
  });
}

// Phase A: for the staged 32 rows x 32 keys, recompute P = exp(s - m) / l
// on visible pairs (0 elsewhere) and dS = P (dO.V - delta) [* (1 - tanh²)]
// * scale. Each thread owns rows ra + 16i, keys ka + 16j (i, j < 2).
// ROW_MAJOR: P and dS stored [row][key] (dK/dV); else dS stored [key][row]
// and P not stored (dQ).
template <int D, bool ROW_MAJOR>
__device__ __forceinline__ void probs_and_dscores(const Params& p, const BwdShared& sh,
                                                  int G, int row0, int row_end, int k0) {
  constexpr int S = BwdSmem<D>::S;
  const int ra = threadIdx.x / 16, ka = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float qf[2][4], gf[2][4], kf[2][4], vf[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      load_vec<4>(sh.q_s + (ra + 16 * i) * S + d, qf[i]);
      load_vec<4>(sh.do_s + (ra + 16 * i) * S + d, gf[i]);
      load_vec<4>(sh.k_s + (ka + 16 * i) * S + d, kf[i]);
      load_vec<4>(sh.v_s + (ka + 16 * i) * S + d, vf[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][j] = fmaf(qf[i][e], kf[j][e], s[i][j]);
          dp[i][j] = fmaf(gf[i][e], vf[j][e], dp[i][j]);
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 16 * i, fr = row0 + r;
    const int t = fr / G;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = ka + 16 * j;
      float th = 0.f;
      const float x = post_cap(p, s[i][j], &th);
      const bool ok = fr < row_end && visible(p, t, k0 + c);
      const float pr = ok ? expf(x - sh.m_s[r]) / sh.l_s[r] : 0.f;
      float ds = pr * (dp[i][j] - sh.dl_s[r]);
      if (p.has_cap) ds *= 1.f - th * th;
      ds *= p.scale;
      if (ROW_MAJOR) {
        sh.p_s[r * kBwdKeys + c] = pr;
        sh.ds_s[r * kBwdKeys + c] = ds;
      } else {
        sh.ds_s[c * kBwdRows + r] = ds;
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const Params p) {
  using TL = BwdTile<D>;
  constexpr int S = BwdSmem<D>::S, XPT = TL::XPT, CPT = TL::CPT;
  const int ktile = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int xg = threadIdx.x / TL::NCG;   // keys xg*XPT + i
  const int cg = threadIdx.x % TL::NCG;   // columns cg*CPT + e
  const int G = p.H / p.Hkv;
  const int k0 = ktile * kBwdKeys;
  const int k1 = min(p.Skv, k0 + kBwdKeys);
  // tokens that see a key in [k0, k1): t >= k0 and, under a window,
  // t < k1 - 1 + window
  const int t_end = p.has_window ? min(p.Sq, k1 - 1 + p.window) : p.Sq;
  const int row_begin = k0 * G, row_end = t_end * G;

  extern __shared__ __align__(16) unsigned char smem[];
  const BwdShared sh = bwd_shared<D>(smem);
  stage_keys<T, D>(p, sh, b, hkv, k0);

  float dk[XPT][CPT], dv[XPT][CPT];
#pragma unroll
  for (int i = 0; i < XPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += kBwdRows) {
    __syncthreads();   // the previous rows' phase B is done
    stage_rows<T, D>(p, sh, b, hkv, G, row0, row_end);
    __syncthreads();
    probs_and_dscores<D, true>(p, sh, G, row0, row_end, k0);
    __syncthreads();
    const int nr = min(kBwdRows, row_end - row0);
    for (int r = 0; r < nr; ++r) {
      float pr[XPT], dsr[XPT], qf[CPT], gf[CPT];
      load_vec<XPT>(sh.p_s + r * kBwdKeys + xg * XPT, pr);
      load_vec<XPT>(sh.ds_s + r * kBwdKeys + xg * XPT, dsr);
      load_vec<CPT>(sh.q_s + r * S + cg * CPT, qf);
      load_vec<CPT>(sh.do_s + r * S + cg * CPT, gf);
#pragma unroll
      for (int i = 0; i < XPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv[i][c] = fmaf(pr[i], gf[c], dv[i][c]);
          dk[i][c] = fmaf(dsr[i], qf[c], dk[i][c]);
        }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const int key = k0 + xg * XPT + i;
    if (key >= k1) continue;
    const size_t off = kv_offset(p, b, hkv, key, D) + cg * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(dk_out + off + c, dk[i][c]);
      store(dv_out + off + c, dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const Params p) {
  using TL = BwdTile<D>;
  constexpr int S = BwdSmem<D>::S, XPT = TL::XPT, CPT = TL::CPT;
  const int tile = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int xg = threadIdx.x / TL::NCG;   // rows xg*XPT + i
  const int cg = threadIdx.x % TL::NCG;
  const int G = p.H / p.Hkv;
  const int row0 = tile * kBwdRows;
  const int row_end = min(row0 + kBwdRows, p.Sq * G);
  const int t_first = row0 / G, t_last = (row_end - 1) / G;
  const int hi = min(p.Skv, t_last + 1);
  const int lo = p.has_window ? max(0, t_first - p.window + 1) : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const BwdShared sh = bwd_shared<D>(smem);
  stage_rows<T, D>(p, sh, b, hkv, G, row0, row_end);

  float dq[XPT][CPT];
#pragma unroll
  for (int i = 0; i < XPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += kBwdKeys) {
    __syncthreads();   // the previous keys' phase B is done (rows staged)
    stage_keys<T, D>(p, sh, b, hkv, k0);
    __syncthreads();
    probs_and_dscores<D, false>(p, sh, G, row0, row_end, k0);
    __syncthreads();
    const int nk = min(kBwdKeys, hi - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float dsr[XPT], kf[CPT];
      load_vec<XPT>(sh.ds_s + kk * kBwdRows + xg * XPT, dsr);
      load_vec<CPT>(sh.k_s + kk * S + cg * CPT, kf);
#pragma unroll
      for (int i = 0; i < XPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(dsr[i], kf[c], dq[i][c]);
    }
  }

  T* dq_out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const int fr = row0 + xg * XPT + i;
    if (fr >= row_end) continue;
    T* orow = dq_out + q_offset(p, b, hkv, G, fr, D) + cg * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + c, dq[i][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (wgmma)
// ---------------------------------------------------------------------------
//
// Every product is a warpgroup matrix multiply (wgmma m64nNk16, bf16
// inputs, fp32 sums in registers). Tiles in shared memory are stored as TMA
// writes them with 128-byte swizzling (64-byte at D 32): atoms of R rows x
// 64 columns (32 at D 32), the 16-byte piece c of row r at piece
// c ^ (r * row bytes / 128 % pieces a row); rows that no TMA box can hold
// (G not dividing the row tile) are copied into the same layout by
// cp.async. A K-major descriptor (Q, K as the left/right of S = Q Kᵀ; K, V,
// Q, dO in Sᵀ = K Qᵀ and dPᵀ = V dOᵀ) has stride offset 8 rows, and each
// k-step moves its start 32 bytes within the atom; a tile read MN-major
// (V, dO and Q as the right-hand side of P V, Pᵀ dO and dSᵀ Q) has leading
// offset one atom (the next 64 columns) and stride offset 8 rows. Both
// were checked against torch.matmul on the card. Writes by cp.async reach
// wgmma, which reads through the async proxy, only after fence.proxy.async.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor (the caller ors in the swizzle mode);
// offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((stride >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the accumulators' order against the asynchronous wgmma statements:
// the compiler may not move a read of x across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) become
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA: one box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N)); }

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N)); }

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, flushing subnormals
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_log2(float x) {   // log2(x), flushing subnormals
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, fp32 += bf16 x bf16. D holds N/2 registers a thread:
// register r of thread t is row 16 (t / 32 % 4) + (t % 32) / 4 + 8 ((r >> 1) & 1),
// column 8 (r >> 2) + 2 (t % 4) + (r & 1). wgmma_ss (S = Q Kᵀ and dPᵀ = V
// dOᵀ, N = 64): A and B K-major from shared memory. wgmma_rs (P V, Pᵀ dO,
// dSᵀ Q, N = D): A from registers in the accumulator's row layout (a[0]:
// rows r, k 2(t%4)+{0,1}; a[1]: rows r+8; a[2], a[3]: the same at k+8), B
// read MN-major. acc = 0 overwrites D.
#define WG_ACC8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
                   "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_ACC16(o) WG_ACC8(o), WG_ACC8(o + 8)
#define WG_ACC32(o) WG_ACC16(o), WG_ACC16(o + 16)
#define WG_ACC64(o) WG_ACC32(o), WG_ACC32(o + 32)
#define WG_ACC128(o) WG_ACC64(o), WG_ACC64(o + 64)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC16(0)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_ACC128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

constexpr int kTcThreads = 256;   // the two consumer warpgroups
constexpr int kTcKeys = 64;       // keys per tile (forward) or per dK/dV unit
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row bf16 tile as TMA writes it: atoms of kAtom columns, 128-byte
// rows swizzled in 8-row groups (64-byte rows at D 32).
template <int D>
struct SwizzledTile {
  static constexpr int tile_bytes = kTcKeys * D * 2;
  static constexpr int kAtom = D < 64 ? D : 64;
  static constexpr int row_bytes = kAtom * 2;
  static constexpr int atom_bytes = kTcKeys * row_bytes;
  static constexpr uint64_t swizzle = D < 64 ? 2ull << 62 : 1ull << 62;   // wgmma B64 / B128
};

// Rows [r0, r0 + RT) of one KV head's flattened (token, group-head) axis of
// a q-shaped tensor x into a swizzled tile at dst (atoms of RT rows), by
// 16-byte cp.async from threads t of nt; rows at or past r_end read zeros.
// For G that does not divide RT, where no TMA box holds the rows.
template <int D, int RT>
__device__ __forceinline__ void stage_rows_swizzled(unsigned char* dst, const __nv_bfloat16* x,
                                                    const Params& p, int b, int hkv, int G,
                                                    int r0, int r_end, int t, int nt) {
  using T = SwizzledTile<D>;
  constexpr int C = D / 8, pieces = T::kAtom / 8;   // 16-byte pieces a row, an atom row
  for (int i = t; i < RT * C; i += nt) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < r_end;
    const int sw = r * T::row_bytes / 128 % pieces;   // row r's swizzle
    cp_async16(dst + c / pieces * RT * T::row_bytes + r * T::row_bytes + (c % pieces ^ sw) * 16,
               ok ? x + q_offset(p, b, hkv, G, r0 + r, D) + c * 8 : x, ok);
  }
}

template <int D>
struct FwdTc : SwizzledTile<D> {
  using T = SwizzledTile<D>;
  static constexpr int kRows = 128;                       // 64 per consumer warpgroup
  static constexpr int kThreads = 384;                    // 2 consumer warpgroups, 1 producer
  static constexpr int q_bytes = kRows * D * 2;           // Q: atoms of 128 rows
  static constexpr int bar_off = q_bytes + 4 * T::tile_bytes;   // Q, 2 stages of K and V
  static constexpr size_t bytes = 1024 + bar_off + 5 * sizeof(uint64_t);  // + alignment
};

// Forward, bf16. One CTA per (batch, KV head, 128 flattened rows), the
// heaviest causal tiles first. Warpgroup 2 is the producer: one thread
// loads Q once and streams the K/V tiles by TMA through 2 stages, diagonal
// tile first (CTAs that start together then read different tiles); a
// stage's "full" mbarrier completes when its bytes land and its "empty"
// one when both consumers are done with it. Consumer warpgroup w owns rows
// 64w..64w+63: S = Q Kᵀ (m64n64, Q and K in shared memory), the online
// softmax on S's registers (masking only on tiles that need it), P rounded
// to bf16 (the plain version's rounding point) and used as the register A
// operand of O += P V (m64nD, V read MN-major). O stays in registers (D/2 a
// thread). The consumers take turns to issue S (two named barriers), so
// one's softmax runs while the other's product holds the tensor cores.
template <int D>
__global__ void __launch_bounds__(FwdTc<D>::kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ Params p) {
  using L = FwdTc<D>;
  const int tile = gridDim.x - 1 - blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int G = p.H / p.Hkv;
  const int row0 = tile * L::kRows;
  const int row_end = min(row0 + L::kRows, p.Sq * G);
  const int t_first = row0 / G, t_last = (row_end - 1) / G;
  const int hi = min(p.Skv, t_last + 1);
  const int lo = p.has_window ? max(0, t_first - p.window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + kTcKeys - 1) / kTcKeys : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + L::q_bytes;   // stage s: K at s * 2 * tile_bytes, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;               // [stage]
  uint64_t* empty = q_full + 3;              // [stage]
  if (tid == 0) {
    mbar_init(q_full, p.rows_tma ? 1 : 128);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kTcThreads);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    setmaxnreg_dec<40>();
    const int pt = tid - 256;
    if (p.rows_tma) {
      if (pt == 0) {
        mbar_expect_tx(q_full, L::q_bytes);
#pragma unroll
        for (int a = 0; a < D / L::kAtom; ++a)
          tma_load_4d(q_s + a * L::kRows * L::row_bytes, &p.tmap_q, a * L::kAtom, 0, hkv,
                      b * p.Sq + row0 / G, q_full);
      }
    } else {
      stage_rows_swizzled<D, L::kRows>(q_s, static_cast<const __nv_bfloat16*>(p.q), p, b, hkv,
                                       G, row0, row_end, pt, 128);
      mbar_arrive_cp_async(q_full);
    }
    if (pt == 0) {   // one thread drives the TMA ring
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, k0 = lo + (n_tiles - 1 - it) * kTcKeys;
        unsigned char* ks = kv_s + st * 2 * L::tile_bytes;
        mbar_wait(empty + st, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * L::tile_bytes);
#pragma unroll
        for (int a = 0; a < D / L::kAtom; ++a) {
          tma_load_3d(ks + a * L::atom_bytes, &p.tmap_k, a * L::kAtom, hkv, b * p.Skv + k0,
                      full + st);
          tma_load_3d(ks + L::tile_bytes + a * L::atom_bytes, &p.tmap_v, a * L::kAtom, hkv,
                      b * p.Skv + k0, full + st);
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  setmaxnreg_inc<232>();
  // this thread's two rows (h = 0, 1) and their softmax state
  const int rw0 = row0 + 64 * wg;
  const int t_min = rw0 / G;
  int tpos[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) tpos[h] = (rw0 + 16 * warp + lane / 4 + 8 * h) / G;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const unsigned char* q_w = q_s + wg * 64 * L::row_bytes;   // rows 64 wg.. of the Q tile
  mbar_wait(q_full, 0);
  if (wg == 1 && n_tiles > 0) named_arrive(1, kTcThreads);   // warpgroup 0 issues first

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = lo + (n_tiles - 1 - it) * kTcKeys;
    mbar_wait(full + st, (it >> 1) & 1);
    fence_async_smem();
    const unsigned char* ks = kv_s + st * 2 * L::tile_bytes;
    const unsigned char* vs = ks + L::tile_bytes;

    float s[32];
    named_sync(1 + wg, kTcThreads);   // this warpgroup's turn on the tensor cores
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ka = kk * 16 / L::kAtom, kw = kk * 16 % L::kAtom;   // atom, column within it
      wgmma_ss(s, gmma_desc(q_w + ka * L::kRows * L::row_bytes + kw * 2, 16, 8 * L::row_bytes)
                      | L::swizzle,
               gmma_desc(ks + ka * L::atom_bytes + kw * 2, 16, 8 * L::row_bytes) | L::swizzle,
               kk > 0);
    }
    wg_commit();
    if (wg == 0 || it + 1 < n_tiles) named_arrive(2 - wg, kTcThreads);   // the other's turn
    wg_wait_all();
    fence_regs(s);

    // online softmax on the registers; a row's 16 values a thread, 4 lanes a row
    uint32_t vis = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
    float mult = kLog2e;   // s[r] * mult - m * log2(e) is the exponent in base 2
    if (p.has_cap || !(p.scale > 0.f) || p.has_window || k0 + kTcKeys > p.Skv
        || k0 + kTcKeys - 1 > t_min) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int h = (r >> 1) & 1;
        float th;
        float x = post_cap(p, s[r], &th);
        if (!visible(p, tpos[h], k0 + (r >> 2) * 8 + 2 * (lane % 4) + (r & 1))) {
          vis &= ~(1u << r);
          x = kNegInf;
        }
        s[r] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    } else {   // no cap, every pair visible: scale the row max only
#pragma unroll
      for (int r = 0; r < 32; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
      mx[0] *= p.scale;
      mx[1] *= p.scale;
      mult = p.scale * kLog2e;
    }
    float corr[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = fast_exp2((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      ml[h] = m_new * kLog2e;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1;
      s[r] = (vis >> r) & 1u ? fast_exp2(fmaf(s[r], mult, -ml[h])) : 0.f;
      l[h] += s[r];
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);

    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs(o, a[j], gmma_desc(vs + j * 16 * L::row_bytes, L::atom_bytes, 8 * L::row_bytes)
                            | L::swizzle, 1);
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(empty + st);   // this warpgroup is done with the stage
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int fr = rw0 + 16 * warp + lane / 4 + 8 * h;
    if (fr >= row_end) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* orow = out + q_offset(p, b, hkv, G, fr, D) + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] / denom, o[4 * i + 2 * h + 1] / denom);
    if (lane % 4 == 0) {
      const size_t so = stat_offset(p, b, hkv, G, fr);
      p.m[so] = m[h];
      p.l[so] = denom;
    }
  }
}

template <int D>
struct DkdvTc : SwizzledTile<D> {
  using T = SwizzledTile<D>;
  static constexpr int kThreads = 384;                      // 2 consumer warpgroups, 1 producer
  static constexpr int k_off = 0, v_off = T::tile_bytes;    // resident K, V
  static constexpr int stage_off = 2 * T::tile_bytes;       // 2 stages of (Q, dO)
  static constexpr int g_off = stage_off + 4 * T::tile_bytes;   // P (1 - tanh²) scale, fp32
  static constexpr int stat_off = g_off + 64 * 64 * 4;      // 2 stages of m, l, delta
  static constexpr int bar_off = stat_off + 2 * 3 * 64 * 4;
  static constexpr size_t bytes = 1024 + bar_off + 5 * sizeof(uint64_t);   // + alignment
};

// dK/dV, bf16. One CTA per unit of the plan (ops.dkdv_plan: key tile, row
// range, partial slot), per (batch, KV head). Keys sit on the M axis: K and
// V stay resident while the CTA walks the unit's (token, group-head) rows
// 64 at a time. Warpgroup 2 is the producer: one warp loads K/V once and
// streams Q/dO (TMA; cp.async where G does not divide 64) and m, l, delta
// (cp.async) through 2 stages under "full"/"empty" mbarriers. Warpgroup 0
// computes Sᵀ = K Qᵀ, Pᵀ from it, and dV += Pᵀ dO with Pᵀ as the register
// A operand; warpgroup 1 computes dPᵀ = V dOᵀ and, once warpgroup 0 has
// left P (1 - tanh²) scale in shared memory (named barrier 3; barrier 4
// hands the buffer back), dSᵀ and dK += dSᵀ Q the same way. So one
// warpgroup's elementwise work runs under the other's products. Each holds
// one D-wide accumulator (D/2 registers a thread). A unit that covers its
// key tile alone writes dK/dV; the others write fp32 partials that
// flash_bwd_dkdv_reduce_kernel sums in row order.
template <int D>
__global__ void __launch_bounds__(DkdvTc<D>::kThreads, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ Params p) {
  using L = DkdvTc<D>;
  const int* unit = p.plan + 4 * blockIdx.x;
  const int k0 = unit[0] * kTcKeys, r_begin = unit[1], r_end = unit[2], slot = unit[3];
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int G = p.H / p.Hkv;
  const bool tma = p.rows_tma;
  const int n_blocks = r_end > r_begin ? (r_end - r_begin + 63) / 64 : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = smem + L::k_off;
  unsigned char* v_s = smem + L::v_off;
  float* g_s = reinterpret_cast<float*>(smem + L::g_off);
  float* stat_s = reinterpret_cast<float*>(smem + L::stat_off);   // [stage][m, l, delta][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;    // [stage]
  uint64_t* empty = kv_full + 3;   // [stage]
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + st, tma ? 1 + 32 : 32);
      mbar_init(empty + st, kTcThreads);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    setmaxnreg_dec<40>();
    if (warp != 0) return;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
    if (lane == 0 && n_blocks > 0) {
      mbar_expect_tx(kv_full, 2 * L::tile_bytes);
#pragma unroll
      for (int a = 0; a < D / L::kAtom; ++a) {
        tma_load_3d(k_s + a * L::atom_bytes, &p.tmap_k, a * L::kAtom, hkv, b * p.Skv + k0, kv_full);
        tma_load_3d(v_s + a * L::atom_bytes, &p.tmap_v, a * L::kAtom, hkv, b * p.Skv + k0, kv_full);
      }
    }
    for (int it = 0; it < n_blocks; ++it) {
      const int st = it & 1, rb = r_begin + it * 64;
      unsigned char* base = smem + L::stage_off + st * 2 * L::tile_bytes;
      mbar_wait(empty + st, ((it >> 1) & 1) ^ 1);
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::tile_bytes);
#pragma unroll
          for (int a = 0; a < D / L::kAtom; ++a) {
            tma_load_4d(base + a * L::atom_bytes, &p.tmap_q, a * L::kAtom, 0, hkv,
                        b * p.Sq + rb / G, full + st);
            tma_load_4d(base + L::tile_bytes + a * L::atom_bytes, &p.tmap_do, a * L::kAtom, 0,
                        hkv, b * p.Sq + rb / G, full + st);
          }
        }
      } else {   // rows that no box holds
        stage_rows_swizzled<D, kTcKeys>(base, q, p, b, hkv, G, rb, r_end, lane, 32);
        stage_rows_swizzled<D, kTcKeys>(base + L::tile_bytes, dout, p, b, hkv, G, rb, r_end,
                                        lane, 32);
      }
      for (int i = lane; i < 3 * 64; i += 32) {
        const int which = i / 64, r = i % 64;
        const bool ok = rb + r < r_end;
        const float* src = which == 0 ? p.m : which == 1 ? p.l : p.delta;
        cp_async4(stat_s + (st * 3 + which) * 64 + r,
                  ok ? src + stat_offset(p, b, hkv, G, rb + r) : src, ok);
      }
      mbar_arrive_cp_async(full + st);
    }
    cp_async_wait<0>();
    return;
  }

  setmaxnreg_inc<232>();
  float acc[D / 2];   // warpgroup 0: dV; warpgroup 1: dK (64 keys x D)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int kq = 16 * warp + lane / 4;   // this thread's keys: kq and kq + 8
  if (n_blocks > 0) mbar_wait(kv_full, 0);

  for (int it = 0; it < n_blocks; ++it) {
    const int rb = r_begin + it * 64, st = it & 1;
    mbar_wait(full + st, (it >> 1) & 1);
    fence_async_smem();
    const unsigned char* q_st = smem + L::stage_off + st * 2 * L::tile_bytes;
    const unsigned char* do_st = q_st + L::tile_bytes;
    const float* m_s = stat_s + st * 3 * 64;
    const float* l_s = m_s + 64;
    const float* dl_s = l_s + 64;

    // warpgroup 0: Sᵀ = K Qᵀ; warpgroup 1: dPᵀ = V dOᵀ (64 keys x 64 rows)
    float s[32];
    {
      const unsigned char* a_s = wg == 0 ? k_s : v_s;
      const unsigned char* b_s = wg == 0 ? q_st : do_st;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = kk * 16 / L::kAtom * L::atom_bytes + kk * 16 % L::kAtom * 2;
        wgmma_ss(s, gmma_desc(a_s + off, 16, 8 * L::row_bytes) | L::swizzle,
                    gmma_desc(b_s + off, 16, 8 * L::row_bytes) | L::swizzle, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);
    }
    if (wg == 0) {
      // P = exp(x - m) / l = 2^(x log2(e) - log2(e^m l)) on visible pairs (0
      // elsewhere); this thread's rows (columns) c each serve two keys. The
      // plain case folds the scale into the exponent.
      if (it > 0) named_sync(4, kTcThreads);   // warpgroup 1 has read the last block's
      auto probs = [&](auto general) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = i * 8 + 2 * (lane % 4) + e;   // row within the block
            const float lse = fmaf(m_s[c], kLog2e, fast_log2(l_s[c]));   // log2(e^m l)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 4 * i + 2 * h + e;
              float pr, gr;
              if constexpr (decltype(general)::value) {
                float th = 0.f;
                const float x = post_cap(p, s[r], &th);
                const bool ok = rb + c < r_end && visible(p, (rb + c) / G, k0 + kq + 8 * h);
                pr = ok ? fast_exp2(fmaf(x, kLog2e, -lse)) : 0.f;
                gr = pr * (p.has_cap ? 1.f - th * th : 1.f) * p.scale;
              } else {
                pr = fast_exp2(fmaf(s[r], p.scale * kLog2e, -lse));
                gr = pr * p.scale;
              }
              g_s[r * 128 + wt] = gr;
              s[r] = pr;
            }
          }
      };
      if (p.has_cap || !(p.scale > 0.f) || p.has_window || k0 + kTcKeys > p.Skv
          || rb + 64 > r_end || k0 + kTcKeys - 1 > rb / G)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      named_arrive(3, kTcThreads);   // P (1 - tanh²) scale is in shared memory
    } else {
      named_sync(3, kTcThreads);
#pragma unroll
      for (int r = 0; r < 32; ++r)   // dSᵀ = P (dPᵀ - delta) (1 - tanh²) scale
        s[r] = g_s[r * 128 + wt] * (s[r] - dl_s[(r >> 2) * 8 + 2 * (lane % 4) + (r & 1)]);
      if (it + 1 < n_blocks) named_arrive(4, kTcThreads);   // the buffer is free again
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
    // warpgroup 0: dV += Pᵀ dO; warpgroup 1: dK += dSᵀ Q (B read MN-major)
    const unsigned char* rhs = wg == 0 ? do_st : q_st;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs(acc, a[j], gmma_desc(rhs + j * 16 * L::row_bytes, L::atom_bytes,
                                    8 * L::row_bytes) | L::swizzle, 1);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + st);   // this warpgroup is done with the stage
  }

  // partial slot layout (slot, B, Hkv, dK / dV, 64, D)
  const size_t part = (((size_t)slot * p.B + b) * p.Hkv + hkv) * 2 + (wg == 0 ? 1 : 0);
  float* out_part = slot < 0 ? nullptr : p.scratch + part * kTcKeys * D;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(wg == 0 ? p.dv : p.dk);
#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int kk = kq + 8 * ((r >> 1) & 1);
    const int col = (r >> 2) * 8 + 2 * (lane % 4);
    if (out_part != nullptr) {
      *reinterpret_cast<float2*>(out_part + kk * D + col) = make_float2(acc[r], acc[r + 1]);
    } else if (k0 + kk < p.Skv) {
      *reinterpret_cast<__nv_bfloat162*>(out + kv_offset(p, b, hkv, k0 + kk, D) + col) =
          __floats2bfloat162_rn(acc[r], acc[r + 1]);
    }
  }
}

// Sums the fp32 partials of each split key tile in slot (row) order and
// writes dK/dV. Row e of p.reduce: key tile, first slot, slot count. Each
// CTA takes 1024 of the tile's 64 x D values, 4 a thread.
constexpr int kReduceChunk = 4 * kTcThreads;

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_reduce_kernel(const Params p) {
  constexpr int kChunks = kTcKeys * D / kReduceChunk;
  const int* e = p.reduce + 3 * (blockIdx.x / kChunks);
  const int k0 = e[0] * kTcKeys, first = e[1], n = e[2];
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int i = (blockIdx.x % kChunks) * kReduceChunk + 4 * threadIdx.x;   // of 64 x D
  const int kk = i / D, col = i % D;
  if (k0 + kk >= p.Skv) return;
  const size_t part = (size_t)2 * kTcKeys * D;
  const float* src = p.scratch + (((size_t)first * p.B + b) * p.Hkv + hkv) * part + i;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int u = 0; u < n; ++u) {
    const float* s = src + (size_t)u * p.B * p.Hkv * part;
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 c = *reinterpret_cast<const float4*>(s + kTcKeys * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  const size_t off = kv_offset(p, b, hkv, k0 + kk, D) + col;
  __nv_bfloat162* dk = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.dk) + off);
  __nv_bfloat162* dv = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.dv) + off);
  dk[0] = __floats2bfloat162_rn(sk.x, sk.y);
  dk[1] = __floats2bfloat162_rn(sk.z, sk.w);
  dv[0] = __floats2bfloat162_rn(sv.x, sv.y);
  dv[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <int D>
struct DqTc : SwizzledTile<D> {
  using T = SwizzledTile<D>;
  static constexpr int kRows = 128;                          // 64 per consumer warpgroup
  static constexpr int kKeys = D > 128 ? 32 : 64;            // keys per streamed tile
  static constexpr int kThreads = 384;                       // 2 consumer warpgroups, 1 producer
  static constexpr int q_bytes = kRows * D * 2;              // Q (and dO): atoms of 128 rows
  static constexpr int kv_atom_bytes = kKeys * T::row_bytes;
  static constexpr int kv_bytes = kKeys * D * 2;             // one K or V tile
  static constexpr int stage_off = 2 * q_bytes;              // 2 stages of (K, V)
  static constexpr int bar_off = stage_off + 4 * kv_bytes;
  static constexpr size_t bytes = 1024 + bar_off + 5 * sizeof(uint64_t);   // + alignment
};

// dQ, bf16. One CTA per (batch, KV head, 128 flattened rows), the heaviest
// causal tiles first; each CTA owns its rows outright, so no atomics and no
// second pass. Rows sit on the M axis: Q and dO stay resident (64 KB each at
// D 256), m, l and delta stay in registers, and warpgroup 2 (the producer)
// loads Q/dO once and streams the K/V tiles of the rows' causal/window range
// by TMA through 2 stages, diagonal tile first. Consumer warpgroup w owns
// rows 64w..64w+63 and, per key tile: S = Q Kᵀ and dP = dO Vᵀ (two wgmma
// chains from shared memory, one commit), P = 2^(x log2 e − log2(e^m l)),
// dS = P (dP − delta) (1 − tanh²) scale in the accumulator registers
// (masking only on tiles that need it), and dQ += dS K with dS rounded to
// bf16 as the register A operand and K read MN-major. dQ stays in registers
// (D/2 a thread). Shared memory at D 256: Q 64 KB + dO 64 KB + 2 stages of
// 32 keys of K and V (2 x 32 KB) = 192 KB; a 64-key stage (64 KB) would
// need 256 KB. At D <= 128 the key tile is 64 (128 KB at D 128).
template <int D>
__global__ void __launch_bounds__(DqTc<D>::kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ Params p) {
  using L = DqTc<D>;
  constexpr int KEYS = L::kKeys;
  const int tile = gridDim.x - 1 - blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int G = p.H / p.Hkv;
  const int row0 = tile * L::kRows;
  const int row_end = min(row0 + L::kRows, p.Sq * G);
  const int t_first = row0 / G, t_last = (row_end - 1) / G;
  const int hi = min(p.Skv, t_last + 1);
  const int lo = p.has_window ? max(0, t_first - p.window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + KEYS - 1) / KEYS : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + L::q_bytes;
  unsigned char* kv_s = smem + L::stage_off;   // stage s: K at s * 2 * kv_bytes, V after it
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = qd_full + 1;                // [stage]
  uint64_t* empty = qd_full + 3;               // [stage]
  if (tid == 0) {
    mbar_init(qd_full, p.rows_tma ? 1 : 128);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kTcThreads);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    setmaxnreg_dec<40>();
    const int pt = tid - 256;
    if (p.rows_tma) {
      if (pt == 0) {
        mbar_expect_tx(qd_full, 2 * L::q_bytes);
#pragma unroll
        for (int a = 0; a < D / L::kAtom; ++a) {
          tma_load_4d(q_s + a * L::kRows * L::row_bytes, &p.tmap_q, a * L::kAtom, 0, hkv,
                      b * p.Sq + row0 / G, qd_full);
          tma_load_4d(do_s + a * L::kRows * L::row_bytes, &p.tmap_do, a * L::kAtom, 0, hkv,
                      b * p.Sq + row0 / G, qd_full);
        }
      }
    } else {   // rows that no box holds
      stage_rows_swizzled<D, L::kRows>(q_s, static_cast<const __nv_bfloat16*>(p.q), p, b, hkv,
                                       G, row0, row_end, pt, 128);
      stage_rows_swizzled<D, L::kRows>(do_s, static_cast<const __nv_bfloat16*>(p.dout), p, b,
                                       hkv, G, row0, row_end, pt, 128);
      mbar_arrive_cp_async(qd_full);
    }
    if (pt == 0) {   // one thread drives the TMA ring
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, k0 = lo + (n_tiles - 1 - it) * KEYS;
        unsigned char* ks = kv_s + st * 2 * L::kv_bytes;
        mbar_wait(empty + st, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * L::kv_bytes);
#pragma unroll
        for (int a = 0; a < D / L::kAtom; ++a) {
          tma_load_3d(ks + a * L::kv_atom_bytes, &p.tmap_k, a * L::kAtom, hkv, b * p.Skv + k0,
                      full + st);
          tma_load_3d(ks + L::kv_bytes + a * L::kv_atom_bytes, &p.tmap_v, a * L::kAtom, hkv,
                      b * p.Skv + k0, full + st);
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  setmaxnreg_inc<232>();
  // this thread's two rows (h = 0, 1): position, log2(e^m l) and delta; a
  // row past the tile gets P = 0
  const int rw0 = row0 + 64 * wg;
  const int t_min = rw0 / G;
  int tpos[2];
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = rw0 + 16 * warp + lane / 4 + 8 * h;
    tpos[h] = fr / G;
    if (fr < row_end) {
      const size_t so = stat_offset(p, b, hkv, G, fr);
      lse[h] = fmaf(p.m[so], kLog2e, fast_log2(p.l[so]));
      dl[h] = p.delta[so];
    } else {
      lse[h] = __int_as_float(0x7f800000);   // +inf
      dl[h] = 0.f;
    }
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const unsigned char* q_w = q_s + wg * 64 * L::row_bytes;    // rows 64 wg.. of Q
  const unsigned char* do_w = do_s + wg * 64 * L::row_bytes;  // and of dO
  mbar_wait(qd_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = lo + (n_tiles - 1 - it) * KEYS;
    mbar_wait(full + st, (it >> 1) & 1);
    fence_async_smem();
    const unsigned char* ks = kv_s + st * 2 * L::kv_bytes;
    const unsigned char* vs = ks + L::kv_bytes;

    float s[KEYS / 2], dp[KEYS / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ka = kk * 16 / L::kAtom, kw = kk * 16 % L::kAtom;   // atom, column within it
      wgmma_ss(s, gmma_desc(q_w + ka * L::kRows * L::row_bytes + kw * 2, 16, 8 * L::row_bytes)
                      | L::swizzle,
               gmma_desc(ks + ka * L::kv_atom_bytes + kw * 2, 16, 8 * L::row_bytes) | L::swizzle,
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ka = kk * 16 / L::kAtom, kw = kk * 16 % L::kAtom;
      wgmma_ss(dp, gmma_desc(do_w + ka * L::kRows * L::row_bytes + kw * 2, 16, 8 * L::row_bytes)
                       | L::swizzle,
               gmma_desc(vs + ka * L::kv_atom_bytes + kw * 2, 16, 8 * L::row_bytes) | L::swizzle,
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of S; register r: row h = (r >> 1) & 1, key 8 (r >> 2) + 2 (lane % 4) + (r & 1)
    if (p.has_cap || !(p.scale > 0.f) || p.has_window || k0 + KEYS > p.Skv
        || k0 + KEYS - 1 > t_min) {
#pragma unroll
      for (int r = 0; r < KEYS / 2; ++r) {
        const int h = (r >> 1) & 1;
        float th = 0.f;
        const float x = post_cap(p, s[r], &th);
        const bool ok = visible(p, tpos[h], k0 + (r >> 2) * 8 + 2 * (lane % 4) + (r & 1));
        const float pr = ok ? fast_exp2(fmaf(x, kLog2e, -lse[h])) : 0.f;
        float ds = pr * (dp[r] - dl[h]);
        if (p.has_cap) ds *= 1.f - th * th;
        s[r] = ds * p.scale;
      }
    } else {   // no cap, every pair visible: the scale folds into the exponent
      const float mult = p.scale * kLog2e;
#pragma unroll
      for (int r = 0; r < KEYS / 2; ++r) {
        const int h = (r >> 1) & 1;
        s[r] = fast_exp2(fmaf(s[r], mult, -lse[h])) * (dp[r] - dl[h]) * p.scale;
      }
    }
    uint32_t a[KEYS / 16][4];
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);

    fence_regs(dq);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j)
      wgmma_rs(dq, a[j], gmma_desc(ks + j * 16 * L::row_bytes, L::kv_atom_bytes,
                                   8 * L::row_bytes) | L::swizzle, 1);
    wg_commit();
    wg_wait_all();
    fence_regs(dq);
    mbar_arrive(empty + st);   // this warpgroup is done with the stage
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = rw0 + 16 * warp + lane / 4 + 8 * h;
    if (fr >= row_end) continue;
    __nv_bfloat16* orow = out + q_offset(p, b, hkv, G, fr, D) + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(dq[4 * i + 2 * h], dq[4 * i + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

enum Which { kForward = 0, kBackwardDkDv = 1, kBackwardDq = 2 };

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, int threads, size_t smem, const Params& p,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
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

// A TMA map over a bf16 tensor of `rank` dims (innermost first; `strides`
// in bytes for dims 1..), boxes of `box`, swizzled as wgmma reads a tile of
// `atom`-column rows (128 bytes; 64 at D 32). Out-of-range rows read zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box, int atom) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K or V (B, S, Hkv, D) as (D, Hkv, B * S): `keys` keys of one KV head a box.
cudaError_t kv_tensor_map(CUtensorMap* map, const void* base, int B, int S, int Hkv, int D,
                          int atom, int keys = kTcKeys) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)B * S};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)atom, 1, (cuuint32_t)keys};
  return tensor_map(map, base, 3, dims, strides, box, atom);
}

// Q or dO (B, S, H, D) as (D, G, Hkv, B * S): `rows` flattened (token,
// group-head) rows of one KV head a box, which needs G to divide rows.
cudaError_t row_tensor_map(CUtensorMap* map, const void* base, int B, int S, int H, int Hkv,
                           int D, int atom, int rows) {
  const int G = H / Hkv;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)B * S};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)G * D * 2, (cuuint64_t)H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)atom, (cuuint32_t)G, 1, (cuuint32_t)(rows / G)};
  return tensor_map(map, base, 4, dims, strides, box, atom);
}

template <int D>
cudaError_t launch_fwd_tc(const Params& p, cudaStream_t stream) {
  using L = FwdTc<D>;
  Params tp = p;
  tp.rows_tma = L::kRows % (p.H / p.Hkv) == 0;
  cudaError_t e = kv_tensor_map(&tp.tmap_k, p.k, p.B, p.Skv, p.Hkv, D, L::kAtom);
  if (e == cudaSuccess) e = kv_tensor_map(&tp.tmap_v, p.v, p.B, p.Skv, p.Hkv, D, L::kAtom);
  if (e == cudaSuccess && tp.rows_tma)
    e = row_tensor_map(&tp.tmap_q, p.q, p.B, p.Sq, p.H, p.Hkv, D, L::kAtom, L::kRows);
  if (e != cudaSuccess) return e;
  const int rows = p.Sq * (p.H / p.Hkv);
  return launch_kernel(flash_fwd_tc_kernel<D>, dim3((rows + L::kRows - 1) / L::kRows, p.Hkv, p.B),
                       L::kThreads, L::bytes, tp, stream);
}

template <int D>
cudaError_t launch_dq_tc(const Params& p, cudaStream_t stream) {
  using L = DqTc<D>;
  Params tp = p;
  tp.rows_tma = L::kRows % (p.H / p.Hkv) == 0;
  cudaError_t e = kv_tensor_map(&tp.tmap_k, p.k, p.B, p.Skv, p.Hkv, D, L::kAtom, L::kKeys);
  if (e == cudaSuccess) e = kv_tensor_map(&tp.tmap_v, p.v, p.B, p.Skv, p.Hkv, D, L::kAtom, L::kKeys);
  if (e == cudaSuccess && tp.rows_tma)
    e = row_tensor_map(&tp.tmap_q, p.q, p.B, p.Sq, p.H, p.Hkv, D, L::kAtom, L::kRows);
  if (e == cudaSuccess && tp.rows_tma)
    e = row_tensor_map(&tp.tmap_do, p.dout, p.B, p.Sq, p.H, p.Hkv, D, L::kAtom, L::kRows);
  if (e != cudaSuccess) return e;
  const int rows = p.Sq * (p.H / p.Hkv);
  return launch_kernel(flash_bwd_dq_tc_kernel<D>, dim3((rows + L::kRows - 1) / L::kRows, p.Hkv, p.B),
                       L::kThreads, L::bytes, tp, stream);
}

template <typename T, int D>
cudaError_t launch(Which which, const Params& p, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const int rows = p.Sq * G;
  switch (which) {
    case kForward:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_fwd_tc<D>(p, stream);
      else
        return launch_kernel(flash_fwd_kernel<T, D>,
                             dim3((rows + kFwdRows - 1) / kFwdRows, p.Hkv, p.B),
                             kFwdThreads, FwdSmem<T, D>::bytes, p, stream);
    case kBackwardDkDv:
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (p.plan == nullptr || p.n_units <= 0 || (p.n_reduce > 0 && p.scratch == nullptr))
          return cudaErrorInvalidValue;
        Params tp = p;
        tp.rows_tma = kTcKeys % (p.H / p.Hkv) == 0;
        cudaError_t e = kv_tensor_map(&tp.tmap_k, p.k, p.B, p.Skv, p.Hkv, D, DkdvTc<D>::kAtom);
        if (e == cudaSuccess)
          e = kv_tensor_map(&tp.tmap_v, p.v, p.B, p.Skv, p.Hkv, D, DkdvTc<D>::kAtom);
        if (e != cudaSuccess) return e;
        if (tp.rows_tma) {
          e = row_tensor_map(&tp.tmap_q, p.q, p.B, p.Sq, p.H, p.Hkv, D, DkdvTc<D>::kAtom, kTcKeys);
          if (e == cudaSuccess)
            e = row_tensor_map(&tp.tmap_do, p.dout, p.B, p.Sq, p.H, p.Hkv, D, DkdvTc<D>::kAtom,
                               kTcKeys);
          if (e != cudaSuccess) return e;
        }
        e = launch_kernel(flash_bwd_dkdv_tc_kernel<D>, dim3(p.n_units, p.Hkv, p.B),
                          DkdvTc<D>::kThreads, DkdvTc<D>::bytes, tp, stream);
        if (e != cudaSuccess || p.n_reduce == 0) return e;
        return launch_kernel(flash_bwd_dkdv_reduce_kernel<D>,
                             dim3(p.n_reduce * (kTcKeys * D / kReduceChunk), p.Hkv, p.B),
                             kTcThreads, 0, p, stream);
      } else {
        return launch_kernel(flash_bwd_dkdv_kernel<T, D>,
                             dim3((p.Skv + kBwdKeys - 1) / kBwdKeys, p.Hkv, p.B),
                             kBwdThreads, BwdSmem<D>::bytes, p, stream);
      }
    case kBackwardDq:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_dq_tc<D>(p, stream);
      else
        return launch_kernel(flash_bwd_dq_kernel<T, D>,
                             dim3((rows + kBwdRows - 1) / kBwdRows, p.Hkv, p.B),
                             kBwdThreads, BwdSmem<D>::bytes, p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_head_dim(Which which, int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(which, p, stream);
    case 64: return launch<T, 64>(which, p, stream);
    case 128: return launch<T, 128>(which, p, stream);
    case 256: return launch<T, 256>(which, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, Params& p, int B, int Sq, int Skv, int H, int Hkv, int head_dim,
        float scale, int has_cap, float cap, int has_window, int window, int dtype,
        void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || Hkv > 65535 || B > 65535
      || (has_cap && !(cap > 0.f)) || (has_window && window <= 0))
    return (int)cudaErrorInvalidValue;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.Hkv = Hkv;
  p.scale = scale; p.has_cap = has_cap; p.cap = cap;
  p.has_window = has_window; p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_head_dim<float>(which, head_dim, p, st);
  else if (dtype == 1)
    e = dispatch_head_dim<__nv_bfloat16>(which, head_dim, p, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim in {32, 64, 128, 256};
// has_cap / has_window switch the softcap and the sliding window on. Each
// returns the launch's cudaError_t (0 = success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* m, void* l,
    int B, int Sq, int Skv, int H, int Hkv, int head_dim, float scale,
    int has_cap, float cap, int has_window, int window, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.m = static_cast<float*>(m); p.l = static_cast<float*>(l);
  return run(kForward, p, B, Sq, Skv, H, Hkv, head_dim, scale, has_cap, cap,
             has_window, window, dtype, stream);
}

extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* m,
    const void* l, const void* delta, void* dk, void* dv,
    int B, int Sq, int Skv, int H, int Hkv, int head_dim, float scale,
    int has_cap, float cap, int has_window, int window, int dtype, void* stream,
    const void* plan, int n_units, const void* reduce, int n_reduce, void* scratch) {
  Params p = {};
  p.plan = static_cast<const int*>(plan); p.n_units = n_units;
  p.reduce = static_cast<const int*>(reduce); p.n_reduce = n_reduce;
  p.scratch = static_cast<float*>(scratch);
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.m = const_cast<float*>(static_cast<const float*>(m));
  p.l = const_cast<float*>(static_cast<const float*>(l));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk; p.dv = dv;
  return run(kBackwardDkDv, p, B, Sq, Skv, H, Hkv, head_dim, scale, has_cap, cap,
             has_window, window, dtype, stream);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* m,
    const void* l, const void* delta, void* dq,
    int B, int Sq, int Skv, int H, int Hkv, int head_dim, float scale,
    int has_cap, float cap, int has_window, int window, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.m = const_cast<float*>(static_cast<const float*>(m));
  p.l = const_cast<float*>(static_cast<const float*>(l));
  p.delta = static_cast<const float*>(delta);
  p.out = dq;
  return run(kBackwardDq, p, B, Sq, Skv, H, Hkv, head_dim, scale, has_cap, cap,
             has_window, window, dtype, stream);
}

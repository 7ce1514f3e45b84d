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
// visible key has l == 0, stored as 1, and outputs 0.
//
// Three kernels, all launched on the caller's stream:
// - forward: one CTA of 128 threads per (batch, KV head, tile of 32
//   (token, group-head) rows flattened token-major), so the G query heads
//   that share a KV head share every K/V tile the CTA stages. The CTA
//   walks only the 64-key tiles in its rows' causal/window range, keeps
//   (m, l, acc) in registers and writes out, m and l (B, H, Sq).
// - backward dK/dV: one CTA of 256 threads per (batch, KV head, 32-key
//   tile); it loops over the (token, group-head) rows that see those keys,
//   32 at a time, recomputes P = exp(s - m) / l, and accumulates
//   dV += Pᵀ dO and dK += dSᵀ Q in registers. No atomics.
// - backward dQ: one CTA of 256 threads per (batch, KV head, 32-row tile);
//   it loops over the 32-key tiles in range and accumulates dQ += dS K.
// Both backward kernels read delta = rowsum(dO * O) (B, H, Sq), fp32,
// computed by the caller. dS = P (dO Vᵀ - delta), times (1 - tanh²) under
// a softcap (attention.py:153-156), times the scale. Every sum runs in a
// fixed order, so two launches on the same inputs give the same bits.
//
// What bounds it: operations. At the gemma-2b training shape (B 4, S 2048,
// H 8, Hkv 1, D 256, causal) the forward does 4*B*H*D*S(S+1)/2 = 68.7
// GFLOP on 2*4*2048*8*256 + 2*4*2048*256 bytes (~0.05 GB): ~1,400 flop per
// byte, far above the card's balance point, so its bound is the bf16
// tensor-core rate. This first version runs every product as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), so it cannot come near that bound; its
// design keeps the CUDA cores, not shared memory, the limit: every thread
// holds a register tile (forward: 4 rows x 4 keys of scores and 4 rows x
// D/16 output columns; backward: 2x2 scores and an 8x4 (D 256) tile of
// dK/dV or dQ), so each 16-byte shared-memory load feeds 4-16 FMAs. K/V
// tiles are staged with 16-byte loads; rows are padded by 16 bytes so the
// lanes of a warp reading different rows hit different banks. wgmma,
// TMA/cp.async pipelining and splitting long causal ranges are later work.
//
// Shared memory at D 256: forward 108 KB (bf16: Q as fp32, K and V as
// stored) or 174 KB (fp32); backward 142 KB (Q, dO, K, V as fp32). Above
// 48 KB the launcher raises the kernel's dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;   // the reference's NEG_INF

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float* o) {
  o[0] = __uint_as_float(u << 16);          // element 0: the low half
  o[1] = __uint_as_float(u & 0xffff0000u);
}

// N consecutive elements at p, as floats. p is aligned to the vector
// width used (up to 16 bytes): shared or global memory.
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

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      unpack_bf16x2(u.x, o + i); unpack_bf16x2(u.y, o + i + 2);
      unpack_bf16x2(u.z, o + i + 4); unpack_bf16x2(u.w, o + i + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(u.x, o); unpack_bf16x2(u.y, o + 2);
  } else if constexpr (N == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
    static_assert(N == 1, "vector width");
    o[0] = __bfloat162float(*p);
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

template <typename T, int D>
cudaError_t launch(Which which, const Params& p, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  const int rows = p.Sq * G;
  switch (which) {
    case kForward:
      return launch_kernel(flash_fwd_kernel<T, D>,
                           dim3((rows + kFwdRows - 1) / kFwdRows, p.Hkv, p.B),
                           kFwdThreads, FwdSmem<T, D>::bytes, p, stream);
    case kBackwardDkDv:
      return launch_kernel(flash_bwd_dkdv_kernel<T, D>,
                           dim3((p.Skv + kBwdKeys - 1) / kBwdKeys, p.Hkv, p.B),
                           kBwdThreads, BwdSmem<D>::bytes, p, stream);
    case kBackwardDq:
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
    int has_cap, float cap, int has_window, int window, int dtype, void* stream) {
  Params p = {};
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

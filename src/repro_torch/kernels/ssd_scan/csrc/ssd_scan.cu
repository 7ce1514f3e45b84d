// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bh (body _ssd_kernel), and
// extends it as serving needs: an optional initial state in, the final state
// out.
//
// What it computes, per (batch, head), over the sequence in order:
//   y_t     = C_t . state_t             (state_t: (P, N), fp32)
//   state_t = exp(dt_t * a) * state_{t-1} + (x_t * dt_t) (outer) B_t
// in the chunked SSD form: inside a block of L tokens the quadratic term
// (C.B^T (.) exp-segsum decay) . (x*dt), plus the carried state scaled by
// exp(cumsum(dt*a)); then the state moves to the block's end. Inputs are read
// in the model layout: x (B, S, H, P) and b/c (B, S, G, N) in the model
// dtype (fp32 or bf16), head h reading group h / (H/G); dt (B, S, H) and a
// (H,) in fp32; init_state / final_state (B, H, P, N) in fp32 (a null
// init_state means zeros). y (B, S, H, P) comes out in x's dtype. Every sum
// is in fp32.
//
// Shared by both kernels. The TPU grid walks (batch*head, chunk) in order and
// carries the state in VMEM across grid steps. Here one CTA owns one
// (batch*head, tile of 16 rows of P): the state rows of a tile are
// independent, so at the serving shape (H 80, P 64) the grid has 320 CTAs for
// the card's 132 SMs, all resident at once. The CTA keeps its (16, N) state
// in shared memory and walks the sequence itself in blocks of 32 tokens (its
// own block, not the model's ssm_chunk: a 256x256 fp32 decay tile would not
// fit in shared memory); every warp that needs the cumsum of dt*a over a
// block scans it itself with shuffles. No atomics, no split of a sum across
// CTAs, and every sum runs in a fixed order, so the result is a pure
// function of the inputs and S: the engine's hit-vs-cold bit equality rests
// on it.
//
// What bounds it. At the serving shape (B 1, S 32, H 80, P 64, N 128) the
// function must read and write 5.2 MB of fp32 state and ~0.7 MB of x, y, b,
// c, dt: 1.77 us at 3.35 TB/s. Its ~115 MFLOP are small beside that on the
// tensor cores, so the kernel is a streaming kernel: the state has to move at
// device-memory rate with the products hidden under it. What it meets on the
// card (chip_smoke.py, PERF.md) is latency: one block's loads, products and
// stores in a chain, ~6-7 us at S 1-32 in all.
//
// bf16 (ssd_scan_mma_kernel), in the order a CTA runs it:
// - Loads. The CTAs of a cluster (up to 8: the P tiles of one head, and of
//   two heads of one group) read the same B, C rows. Each CTA sends its
//   share of the rows to L2 at once (cp.async.bulk.prefetch), issues its
//   state tile (16 bulk row copies under an mbarrier, cp.async.bulk), and
//   x, dt (cp.async, 16- and 4-byte pieces, zero-filled past S); after the
//   cluster barrier that makes every CTA's mbarriers valid, it multicasts
//   its B, C rows into all CTAs of the cluster (.multicast::cluster). Rows
//   past S are zeroed in place. Two stages when S > 32, so block j+1 loads
//   behind block j; a cluster barrier guards a stage's reuse.
// - Products, all on mma.sync.m16n8k16 (bf16 in, fp32 sums), each arranged
//   so one operand is an exact bf16 input and the fp32 operand is split
//   into bf16 hi + lo, hi summed before lo (about 16 bits of that operand's
//   mantissa kept; single-pass bf16 or TF32 rounding of the carried state
//   would not hold the 2e-4 state tolerance over chunks):
//   warps 0-1, the rows l of 16 mt (mt = warp), while the state is in flight:
//     C.B^T              exact x exact, the causal tiles only;
//     y_in = M . x       M[l,s] = (C.B^T)[l,s] exp(cs_l - cs_s) dt_s, s <= l
//                        (masked before the exp), split, from the accumulators;
//   warps 2-3, the 16-column groups j of N (even for warp 2, odd for 3):
//     state' = exp(cs_last) state + (x w)^T . B,  w_s = dt_s exp(cs_last - cs_s),
//                        x w split, B exact; accumulators start from
//                        exp(cs_last) state;
//     y_off = C . state^T over k in group j: the raw state fragments that
//                        start the update are y_off's B fragments (split), C
//                        exact;
//   then warps 0-1 write y = y_in + exp(cs_l) (y_off of warp 2 + of warp 3).
// - The new state goes to the other of two shared buffers and out by bulk
//   row copies after fence.proxy.async, as soon as warps 2-3 are done.
// Rows are padded by 16 bytes (B, C, x) or 8 words (state) so fragment loads
// hit distinct banks. C.B^T is recomputed by each P tile: 16-32 mma.
//
// fp32 (ssd_scan_fma_kernel), kept from the first port: TF32 would not hold
// the fp32 tolerances. Per block it stages B, C (rows padded to N+1 words so
// lanes that walk different rows hit different banks), its x*dt tile and the
// cumsum with plain loads; forms C.B^T (.) decay for s <= l; writes y = that
// . x*dt + exp(cs) (C . state^T); then updates the state, all with FMAs on the
// CUDA cores. Shared-memory issue and the FMA chains, not bytes, bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;   // tokens per block step: one warp scans them
constexpr int kRows = 16;    // rows of P per CTA
constexpr int kMaxState = 256;

static_assert(kChunk == 32, "the cumsum is one warp's shuffle scan");
static_assert(kRows == 16, "a P tile is the M (or N pair) of one mma.sync");

struct Params {
  const void* x;            // (B, S, H, P), strides x_sb, x_ss; (H, P) dense
  const float* dt;          // (B, S, H)
  const float* a;           // (H,)
  const void* b;            // (B, S, G, N), strides b_sb, b_ss; (G, N) dense
  const void* c;            // (B, S, G, N), strides c_sb, c_ss; (G, N) dense
  const float* init_state;  // (B, H, P, N) or null
  void* y;                  // (B, S, H, P)
  float* final_state;       // (B, H, P, N)
  int batch, seqlen, heads, headdim, groups, dstate;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// Shared memory, in floats: B and C blocks, the state tile (rows of N+1),
// the C.B^T tile (rows of kChunk+1), the x*dt tile, and per-token cumsum,
// exp(cumsum) and tail-decay vectors.
__host__ __device__ inline size_t fma_smem_floats(int dstate) {
  return (size_t)(2 * kChunk + kRows) * (dstate + 1) + kChunk * (kChunk + 1)
         + kChunk * kRows + 3 * kChunk;
}

__global__ void __launch_bounds__(kThreads) ssd_scan_fma_kernel(const Params prm) {
  extern __shared__ float smem[];
  const int N = prm.dstate, ldn = N + 1;
  float* sB = smem;
  float* sC = sB + kChunk * ldn;
  float* sState = sC + kChunk * ldn;
  float* sCB = sState + kRows * ldn;
  float* sX = sCB + kChunk * (kChunk + 1);
  float* sCs = sX + kChunk * kRows;   // cumsum of dt*a within the block
  float* sE = sCs + kChunk;           // exp(cs_l): carried-state decay
  float* sW = sE + kChunk;            // exp(cs_last - cs_s): tail decay

  const int tid = threadIdx.x;
  const int H = prm.heads, P = prm.headdim, S = prm.seqlen;
  const int bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int p0 = blockIdx.x * kRows;
  const int rows = min(kRows, P - p0);
  const int g = h / (H / prm.groups);
  const float a = prm.a[h];
  const float* x = static_cast<const float*>(prm.x) + bi * prm.x_sb + (long long)h * P + p0;
  const float* b = static_cast<const float*>(prm.b) + bi * prm.b_sb + (long long)g * N;
  const float* c = static_cast<const float*>(prm.c) + bi * prm.c_sb + (long long)g * N;
  const float* dt = prm.dt + (long long)bi * S * H + h;        // token stride H
  float* y = static_cast<float*>(prm.y) + ((long long)bi * S * H + h) * P + p0;  // stride H*P
  const long long state_off = ((long long)bh * P + p0) * N;

  for (int i = tid; i < kRows * N; i += kThreads) {
    const int r = i / N, n = i % N;
    float v = 0.f;
    if (prm.init_state != nullptr && r < rows)
      v = prm.init_state[state_off + (long long)r * N + n];
    sState[r * ldn + n] = v;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int L = min(kChunk, S - t0);
    for (int i = tid; i < L * N; i += kThreads) {
      const int s = i / N, n = i % N;
      sB[s * ldn + n] = b[(long long)(t0 + s) * prm.b_ss + n];
      sC[s * ldn + n] = c[(long long)(t0 + s) * prm.c_ss + n];
    }
    for (int i = tid; i < L * kRows; i += kThreads) {
      const int s = i / kRows, r = i % kRows;
      float v = 0.f;
      if (r < rows)
        v = x[(long long)(t0 + s) * prm.x_ss + r] * dt[(long long)(t0 + s) * H];
      sX[s * kRows + r] = v;
    }
    if (tid < 32) {
      // inclusive scan of dt*a over the block; lanes past L add zeros
      float v = tid < L ? dt[(long long)(t0 + tid) * H] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, L - 1);
      sCs[tid] = v;
      sE[tid] = expf(v);
      sW[tid] = tid < L ? expf(last - v) : 0.f;
    }
    __syncthreads();

    // C.B^T (.) decay over s <= l: lane = s, so B rows are read at a
    // stride of N+1 words (distinct banks) and the C row is a broadcast
    for (int i = tid; i < L * kChunk; i += kThreads) {
      const int l = i / kChunk, s = i % kChunk;
      float v = 0.f;
      if (s <= l) {
        const float* cr = sC + l * ldn;
        const float* br = sB + s * ldn;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(cr[n], br[n], acc);
        v = acc * expf(sCs[l] - sCs[s]);
      }
      sCB[l * (kChunk + 1) + s] = v;
    }
    __syncthreads();

    // y = (C.B^T (.) decay) . x*dt + exp(cs_l) * (C . state^T)
    for (int i = tid; i < L * kRows; i += kThreads) {
      const int l = i / kRows, r = i % kRows;
      if (r >= rows) continue;
      const float* cbr = sCB + l * (kChunk + 1);
      float acc = 0.f;
      for (int s = 0; s <= l; ++s) acc = fmaf(cbr[s], sX[s * kRows + r], acc);
      const float* cr = sC + l * ldn;
      const float* st = sState + r * ldn;
      float off = 0.f;
      for (int n = 0; n < N; ++n) off = fmaf(cr[n], st[n], off);
      y[(long long)(t0 + l) * H * P + r] = acc + off * sE[l];
    }
    __syncthreads();

    // state = exp(cs_last) * state + sum_s exp(cs_last - cs_s) x*dt_s B_s
    const float total = sE[L - 1];
    for (int i = tid; i < kRows * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < L; ++s)
        acc = fmaf(sW[s] * sX[s * kRows + r], sB[s * ldn + n], acc);
      sState[r * ldn + n] = sState[r * ldn + n] * total + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * N; i += kThreads) {
    const int r = i / N, n = i % N;
    prm.final_state[state_off + (long long)r * N + n] = sState[r * ldn + n];
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, the state by bulk copies
// ---------------------------------------------------------------------------

constexpr int kXS = kRows + 8;   // padded x row, bf16 elements (48 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Bulk copy global -> shared, completing bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Fetches bytes of global memory into L2, no completion to wait for.
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" :: "l"(src), "r"(bytes) : "memory");
}

// Bulk copy shared -> global, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed bulk stores have read their shared
// memory (the CTA may then exit; the writes complete on their own).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Generic-proxy writes to shared memory become visible to the bulk copies,
// which read through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// (v0, v1) -> the bf16 pairs hi = bf16(v), lo = bf16(v - hi): hi + lo keeps
// about 16 bits of each value's mantissa.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// Bulk copy global -> shared of this CTA and of every CTA in ``mask`` of its
// cluster (the same offset in each), completing bytes on each one's bar.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, int bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// Arrival that orders nothing: enough after fence.mbarrier_init.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_size() {
  int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Shared memory of the bf16 kernel, in bytes from the (16-aligned) base:
// mbarriers, two state buffers, one stage of B, C, x, dt per block up to two
// (a single block needs one, so more CTAs fit an SM), a 32-float line per
// warp and the y_off partials of warps 2-3.
struct MmaSmem {
  int lds, ldb, stages;         // state row (floats), B/C row (bf16)
  size_t state, b, c, x, dt, line, part, bytes;
  __host__ __device__ MmaSmem(int N, int S)
      : lds(N + 8), ldb(N + 8), stages(S > kChunk ? 2 : 1) {
    state = 32;                                                     // after 3 mbarriers
    b = state + (size_t)2 * kRows * lds * sizeof(float);
    c = b + (size_t)stages * kChunk * ldb * sizeof(__nv_bfloat16);
    x = c + (size_t)stages * kChunk * ldb * sizeof(__nv_bfloat16);
    dt = x + (size_t)stages * kChunk * kXS * sizeof(__nv_bfloat16);
    line = dt + (size_t)stages * kChunk * sizeof(float);
    part = line + (size_t)(kThreads / 32) * 32 * sizeof(float);
    bytes = part + (size_t)2 * 2 * 8 * 32 * sizeof(float);
  }
};

// One CTA per (batch*head, 16 rows of P); the CTAs of a cluster read the
// same B, C rows: each issues a share of the row copies, multicast to all.
__global__ void __launch_bounds__(kThreads) ssd_scan_mma_kernel(const Params prm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = prm.dstate, nks = N / 16;
  const MmaSmem lay(N, prm.seqlen);
  const int lds = lay.lds, ldb = lay.ldb;
  uint64_t* bar_state = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_bc = bar_state + 1;                                          // [stages]
  float* sState = reinterpret_cast<float*>(smem_raw + lay.state);            // [2][16][lds]
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.b);    // [stages][32][ldb]
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.c);    // [stages][32][ldb]
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.x);    // [stages][32][kXS]
  float* sDt = reinterpret_cast<float*>(smem_raw + lay.dt);                  // [stages][32]
  float* sLine = reinterpret_cast<float*>(smem_raw + lay.line);              // [warp][32]
  float* sPart = reinterpret_cast<float*>(smem_raw + lay.part);              // [2][2][8][32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int H = prm.heads, P = prm.headdim, S = prm.seqlen;
  const int bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int p0 = blockIdx.x * kRows;
  const int grp = h / (H / prm.groups);
  const int rank = cluster_rank(), csize = cluster_size();
  const float a = prm.a[h];
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(prm.x) + bi * prm.x_sb
                           + (long long)h * P + p0;
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(prm.b) + bi * prm.b_sb
                           + (long long)grp * N;
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(prm.c) + bi * prm.c_sb
                           + (long long)grp * N;
  const float* dt = prm.dt + (long long)bi * S * H + h;        // token stride H
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(prm.y) + ((long long)bi * S * H + h) * P + p0;
  const long long state_off = ((long long)bh * P + p0) * N;
  const bool has_init = prm.init_state != nullptr;
  const int row_bytes = N * (int)sizeof(__nv_bfloat16);

  const int nb = (S + kChunk - 1) / kChunk;
  // this CTA's share of the first block's B, C rows on their way to L2
  // while the cluster's mbarriers are set up
  if (warp == 1) {
    const int s = rank + csize * lane;
    if (s < min(kChunk, S)) {
      prefetch_l2(b + (long long)s * prm.b_ss, row_bytes);
      prefetch_l2(c + (long long)s * prm.c_ss, row_bytes);
    }
  }
  if (tid == 0) {
    mbar_init(bar_state, 1);
    for (int st = 0; st < lay.stages; ++st) mbar_init(bar_bc + st, 1);
  }
  if (!has_init)
    for (int i = tid; i < kRows * lds; i += kThreads) sState[i] = 0.f;
  // every CTA's mbarriers must exist before a peer's copy lands in them:
  // arrive now, wait just before the first multicast
  cluster_arrive_relaxed();
  // the state tile, this CTA's own: 16 row copies of N floats under one
  // mbarrier
  if (has_init && warp == 0) {
    if (lane == 0) mbar_expect_tx(bar_state, kRows * N * (int)sizeof(float));
    __syncwarp();
    if (lane < kRows)
      bulk_load(sState + lane * lds, prm.init_state + state_off + (long long)lane * N,
                N * (int)sizeof(float), bar_state);
  }

  // B, C rows of a block: rows s = rank, rank + csize, ... copied by this
  // CTA into every CTA of the cluster; rows past S zeroed here (a padded B
  // row meets x w = 0 in the tensor cores, where 0 * garbage is not 0). x
  // and dt (this CTA's own) by cp.async, zero-filled past S.
  auto load_block = [&](int stage, int t0, bool first) {
    const int L = min(kChunk, S - t0);
    __nv_bfloat16* db = sB + stage * kChunk * ldb;
    __nv_bfloat16* dc = sC + stage * kChunk * ldb;
    if (tid < 2 * kChunk) {
      const int s = tid / 2, e = (tid % 2) * 8;
      const long long t = t0 + (s < L ? s : 0);
      cp_async16(sX + (stage * kChunk + s) * kXS + e, x + t * prm.x_ss + e, s < L);
    } else if (tid < 3 * kChunk) {
      const int s = tid - 2 * kChunk;
      const long long t = t0 + (s < L ? s : 0);
      cp_async4(sDt + stage * kChunk + s, dt + t * H, s < L);
    }
    cp_async_commit();
    if (tid == 0) mbar_expect_tx(bar_bc + stage, 2 * L * row_bytes);
    if (first) cluster_wait();
    if (warp == 1) {
      const int s = rank + csize * lane;
      if (s < L) {
        const uint16_t all = (uint16_t)((1u << csize) - 1);
        bulk_load_multicast(db + s * ldb, b + (long long)(t0 + s) * prm.b_ss, row_bytes,
                            bar_bc + stage, all);
        bulk_load_multicast(dc + s * ldb, c + (long long)(t0 + s) * prm.c_ss, row_bytes,
                            bar_bc + stage, all);
      }
    }
    for (int i = L * N / 2 + tid; i < kChunk * N / 2; i += kThreads) {
      const int s = i / (N / 2), e = 2 * (i % (N / 2));
      *reinterpret_cast<uint32_t*>(db + s * ldb + e) = 0u;
      *reinterpret_cast<uint32_t*>(dc + s * ldb + e) = 0u;
    }
  };

  load_block(0, 0, true);

  for (int k = 0; k < nb; ++k) {
    const int stage = k % lay.stages, buf = k & 1, t0 = k * kChunk;
    const int L = min(kChunk, S - t0);
    if (k + 1 < nb) {
      load_block((k + 1) % lay.stages, t0 + kChunk, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    mbar_wait(bar_bc + stage, (k / lay.stages) & 1);
    __syncthreads();

    const __nv_bfloat16* cB = sB + stage * kChunk * ldb;
    const __nv_bfloat16* cC = sC + stage * kChunk * ldb;
    const __nv_bfloat16* cX = sX + stage * kChunk * kXS;
    const float* cDt = sDt + stage * kChunk;
    const float* st = sState + buf * kRows * lds;            // state before the block
    float* st_next = sState + (buf ^ 1) * kRows * lds;       // state after it
    float* line = sLine + warp * 32;

    // every warp scans dt*a itself (the same bits in each): lane = token
    const float dt_l = cDt[lane];                            // 0 past L
    float cs = lane < L ? dt_l * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, cs, o);
      if (lane >= o) cs += u;
    }
    const float cs_last = __shfl_sync(0xffffffffu, cs, L - 1);
    const int mt = warp % 2;                 // rows l in [16 mt, 16 mt + 16) of y
    const int l0 = mt * 16 + g8;

    if (warp < 2) {
      float yin[2][4] = {};
      if (16 * mt < L) {
        line[lane] = cs;
        // C.B^T over the causal s tiles (n-tile pairs np <= mt)
        float cb[4][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < nks; ++ks) {
          uint32_t ca[4];
          ldmatrix_x4(ca, cC + (mt * 16 + (mi % 2) * 8 + lane % 8) * ldb + ks * 16 + (mi / 2) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (np > mt) continue;
            uint32_t bf[4];
            ldmatrix_x4(bf, cB + (np * 16 + (mi / 2) * 8 + lane % 8) * ldb + ks * 16 + (mi % 2) * 8);
            mma_bf16(cb[2 * np], ca, bf[0], bf[1]);
            mma_bf16(cb[2 * np + 1], ca, bf[2], bf[3]);
          }
        }
        __syncwarp();
        // M = C.B^T exp(cs_l - cs_s) dt_s for s <= l (masked before the exp),
        // split into hi / lo A fragments of M . x
        const float cs_l[2] = {line[l0], line[l0 + 8]};
        uint32_t mhi[2][4], mlo[2][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float m[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int l = l0 + 8 * (e / 2), s = nt * 8 + 2 * t4 + e % 2;
            m[e] = nt / 2 <= mt && s <= l ? cb[nt][e] * expf(cs_l[e / 2] - line[s]) * cDt[s] : 0.f;
          }
          // accumulator (rows g8, g8 + 8; cols 2 t4, +1) -> A fragment halves
          split_pair(m[0], m[1], mhi[nt / 2][2 * (nt % 2)], mlo[nt / 2][2 * (nt % 2)]);
          split_pair(m[2], m[3], mhi[nt / 2][2 * (nt % 2) + 1], mlo[nt / 2][2 * (nt % 2) + 1]);
        }
        // y_in = M . x: x exact (B fragments by ldmatrix.trans), hi then lo
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk > mt) continue;
          uint32_t xf[4];
          ldmatrix_x4_trans(xf, cX + (kk * 16 + (mi % 2) * 8 + lane % 8) * kXS + (mi / 2) * 8);
          mma_bf16(yin[0], mhi[kk], xf[0], xf[1]);
          mma_bf16(yin[0], mlo[kk], xf[0], xf[1]);
          mma_bf16(yin[1], mhi[kk], xf[2], xf[3]);
          mma_bf16(yin[1], mlo[kk], xf[2], xf[3]);
        }
      }
      // y = y_in + exp(cs_l) (y_off of warp 2 + y_off of warp 3)
      named_sync(2, kThreads);
      if (16 * mt < L) {
        const float* part = sPart + mt * 8 * 32 + lane;       // [warp 2, 3][mt][8][32]
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = l0 + 8 * hh;
          if (l >= L) continue;
          const float e_l = expf(line[l]);
          __nv_bfloat16* yr = y + (long long)(t0 + l) * H * P;
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = rt * 4 + 2 * hh + e;
              v[e] = fmaf(e_l, part[i * 32] + part[(16 + i) * 32], yin[rt][2 * hh + e]);
            }
            *reinterpret_cast<__nv_bfloat162*>(yr + rt * 8 + 2 * t4) = __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
    } else {
      // state' = exp(cs_last) state + (x w)^T . B, w_s = dt_s exp(cs_last - cs_s),
      // and y_off = C . state^T split over k: warp 2 the even 16-column
      // groups j of N, warp 3 the odd ones. The raw state fragments that
      // start the update's accumulators are y_off's B fragments for k-step
      // j (split hi / lo; C exact); the hi and lo products go to
      // accumulators of their own, added at the end.
      line[lane] = lane < L ? dt_l * expf(cs_last - cs) : 0.f;
      __syncwarp();
      uint32_t ahi[2][4], alo[2][4];         // A = (x w)^T: rows r, k = s
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {         // a0..a3: (row g8 | g8+8, s | s+8)
          const int r = g8 + 8 * (q % 2), s = kk * 16 + 2 * t4 + 8 * (q / 2);
          const float x0 = __bfloat162float(cX[s * kXS + r]);
          const float x1 = __bfloat162float(cX[(s + 1) * kXS + r]);
          split_pair(x0 * line[s], x1 * line[s + 1], ahi[kk][q], alo[kk][q]);
        }
      }
      const float total = expf(cs_last);
      const bool two = L > 16;                 // rows 16-31 of y exist
      float yoff[2][2][4] = {}, yoff_lo[2][2][4] = {};   // [mt][rt]
      if (k == 0 && has_init) mbar_wait(bar_state, 0);
      for (int j = warp - 2; j < nks; j += 2) {   // 16 columns of N at a time
        float acc[2][4];
        uint32_t shi[2][2], slo[2][2];         // y_off B fragments [rt][b0, b1]
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 v = *reinterpret_cast<const float2*>(
                st + (g8 + 8 * hh) * lds + j * 16 + nn * 8 + 2 * t4);
            acc[nn][2 * hh] = v.x * total;
            acc[nn][2 * hh + 1] = v.y * total;
            split_pair(v.x, v.y, shi[hh][nn], slo[hh][nn]);
          }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (16 * kk >= L) continue;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, cB + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldb + j * 16 + (mi / 2) * 8);
          mma_bf16(acc[0], ahi[kk], bf[0], bf[1]);
          mma_bf16(acc[0], alo[kk], bf[0], bf[1]);
          mma_bf16(acc[1], ahi[kk], bf[2], bf[3]);
          mma_bf16(acc[1], alo[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(st_next + (g8 + 8 * hh) * lds + j * 16 + nn * 8 + 2 * t4) =
                make_float2(acc[nn][2 * hh], acc[nn][2 * hh + 1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && !two) continue;
          uint32_t ca[4];
          ldmatrix_x4(ca, cC + (m * 16 + (mi % 2) * 8 + lane % 8) * ldb + j * 16 + (mi / 2) * 8);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
            mma_bf16(yoff[m][rt], ca, shi[rt][0], shi[rt][1]);
            mma_bf16(yoff_lo[m][rt], ca, slo[rt][0], slo[rt][1]);
          }
        }
      }
      float* part = sPart + (warp - 2) * 16 * 32 + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          part[(m * 8 + i) * 32] = yoff[m][i / 4][i % 4] + yoff_lo[m][i / 4][i % 4];
      if (k + 1 == nb) fence_async_smem();     // the bulk store reads st_next
      named_arrive(2, kThreads);
      if (k + 1 == nb) {
        // the final state out: 16 row copies from shared memory, while
        // warps 0-1 finish y
        named_sync(1, 64);
        if (warp == 2 && lane < kRows) {
          bulk_store(prm.final_state + state_off + (long long)lane * N, st_next + lane * lds,
                     N * (int)sizeof(float));
          bulk_commit();                       // waited for at exit
        }
      }
    }
    // the next block's copies reuse a stage that every CTA of the cluster
    // must have finished reading
    if (k + 2 < nb)
      cluster_sync();
    else if (k + 1 < nb)
      __syncthreads();
  }
  if (warp == 2 && lane < kRows) bulk_wait_read();
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch_fma(const Params& prm, cudaStream_t stream) {
  const size_t smem = fma_smem_floats(prm.dstate) * sizeof(float);
  cudaError_t e = set_smem((const void*)ssd_scan_fma_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((prm.headdim + kRows - 1) / kRows, prm.batch * prm.heads);
  ssd_scan_fma_kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch_mma(const Params& prm, cudaStream_t stream) {
  // 16-row P tiles, 16-deep k-steps over N, 16-byte copies of every row
  if (prm.headdim % 16 || prm.dstate % 16 || !aligned16(prm.x) || !aligned16(prm.b)
      || !aligned16(prm.c) || (prm.init_state && !aligned16(prm.init_state))
      || !aligned16(prm.final_state) || prm.x_sb % 8 || prm.x_ss % 8 || prm.b_sb % 8
      || prm.b_ss % 8 || prm.c_sb % 8 || prm.c_ss % 8)
    return cudaErrorInvalidValue;
  const size_t smem = MmaSmem(prm.dstate, prm.seqlen).bytes;
  cudaError_t e = set_smem((const void*)ssd_scan_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  // all of the SM's 228 KB as shared memory: every CTA of the serving
  // shape resident at once, its state copy in flight from the start
  e = cudaFuncSetAttribute((const void*)ssd_scan_mma_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  // a cluster holds up to 8 P tiles of one head (4 at P 64), and of two
  // heads of one group (the same B, C rows) where that fits in 8
  const int tiles = prm.headdim / kRows;
  int cluster = 1;
  while (cluster < 8 && tiles % (2 * cluster) == 0) cluster *= 2;
  const int heads_per_cluster = cluster <= 4 && (prm.heads / prm.groups) % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, prm.batch * prm.heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = heads_per_cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_scan_mma_kernel, prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// No TPU kernel computes it: the reference differentiates its jnp chunked
// SSD (src/repro/models/ssm.py:75, ssd_chunked) with JAX autodiff. Per
// 32-token block of L tokens, with cs the cumsum of dt a in the block,
// w_ls = exp(cs_l - cs_s) (s <= l), tail_s = exp(cs_last - cs_s), e_l =
// exp(cs_l), xdt = x dt, S0 the state at the block's start and dS the
// cotangent of the state at its end:
//   M_ls = (C_l.B_s) w_ls, Q_ls = (dy_l.xdt_s) w_ls, G_ls = M_ls (dy_l.xdt_s)
//   dxdt_s = sum_{l>=s} M_ls dy_l + tail_s (dS B_s)        -> dx = dt dxdt
//   dC_l   = sum_{s<=l} Q_ls B_s + e_l (dy_l S0)           (summed over a group's heads)
//   dB_s   = sum_{l>=s} Q_ls C_l + tail_s (xdt_s dS)       (the same)
//   d(cs_l) = rowsum G - colsum G + e_l C_l.(dy_l S0) - T_l
//             (+ exp(cs_last) <dS, S0> + sum T at the last token),
//             T_s = tail_s xdt_s.(dS B_s);
//   d(da) = the reverse cumsum of d(cs), d(dt) = a d(da) + x.dxdt, d(a) =
//   the sum of dt d(da).
// Across blocks only two linear recurrences carry, each with a scalar decay:
//   S0_{k+1} = exp(cs_last) S0_k + (x w)^T . B,  w_s = dt_s tail_s,
//   dS_{k-1} = exp(cs_last) dS_k + (dy e)^T . C.
// Every exponent is <= 0: exp(-cs) is never formed (it overflows under
// strong decay), so the states are not carried backwards but written out.
// Every kernel below is a pure function of its inputs: no atomics, every
// sum in a fixed order, so two launches are bit-equal.
//
// bf16: mma.sync on the tensor cores, three launches.
// 1. ssd_bwd_states_mma_kernel: both recurrences in one launch, one CTA per
//    (16 rows of P, batch*head, direction), with the forward kernel's state
//    update: the products on mma.sync.m16n8k16 with the fp32 operand (x w,
//    dy e) split into bf16 hi + lo, B (C) rows multicast over the cluster
//    of a head's P tiles, the (16, N) state in the warps' accumulators. It
//    writes S0_k and dS_k for every block and d_init. S0_k and dS_k go out
//    already split into bf16 hi + lo planes, the bytes of fp32: (2, B, nb,
//    H, 2, P, N) scratch, rows swizzled for the gradients kernel's ldmatrix.
// 2. ssd_bwd_grads_mma_kernel: every block at once, one CTA per (batch,
//    block, group) walking the group's heads in order (a cluster of CTAs
//    splitting them in fixed shares where one CTA a group would leave SMs
//    idle), a warp per 16 columns of N and a warp per 16 rows of P. A
//    head's S0 and dS planes arrive by bulk copies behind the previous
//    head's work, and the next head's 32 x 32 block matrices (M, Q and G's
//    sums) are formed beside this head's products. Every product runs on
//    mma.sync with one exact bf16 operand and the fp32 one (M, Q, S0, dS)
//    split, hi before lo. dx and d(dt) go out per head; dB and dC sum over
//    the heads in fp32 in registers and go out once (a cluster's CTAs add
//    theirs through distributed shared memory in rank order); d(a) goes out
//    as (batch, block, head) partials.
// 3. ssd_bwd_da_reduce_kernel: d(a) = those partials summed over batch and
//    block in order.
// What bounds it. At mamba2-2.7b's training shape (B 4, S 2048, H 80, P 64,
// N 128) the function reads and writes 0.28 GB (0.082 ms at 3.35 TB/s) and
// its products are ~54 GFLOP (0.055 ms at the bf16 tensor-core rate). The
// design adds S0 and dS, 1.34 GB written once and read once (0.8 ms); its
// products, ~108 GFLOP with the hi + lo passes, were to hide under that
// traffic. On an H100 SXM at 700 W (chip_smoke.py, PERF.md) it takes 1.58
// ms there (the FMA design 12.13): states 0.68, gradients 0.87, d(a)
// 0.03. The gradients pass is bound by its work per head, not by its
// copies, yet its products run far below the tensor cores' rate (PERF.md
// §7); the states pass by the chain each CTA walks block after block.
//
// fp32: FMAs on the CUDA cores (TF32, or a bf16 split of fp32 inputs, would
// not hold the fp32 tolerances), three launches:
// 1. ssd_scan_bwd_states_kernel: one CTA per (batch*head, 16 rows of P), as
//    the forward's, writes the state at each block's start (B, nb, H, P, N).
// 2. ssd_scan_bwd_kernel: one CTA per (batch, head) over all of P, so that
//    the sums over P stay inside the CTA. It walks the blocks last to first,
//    carrying dS (P, N) in shared memory, and writes dx, d(dt), d_init and
//    per-head fp32 partials of dB, dC (B, S, H, N) and d(a). Each warp owns 4
//    tokens of a block and keeps 4 independent FMA chains a thread, one
//    operand broadcast from shared memory.
// 3. ssd_scan_bwd_reduce_kernel: db, dc = the partials summed over each
//    group's heads, d(a) over the batch, in order.

struct BwdParams {
  const void* x;            // (B, S, H, P), strides x_sb, x_ss
  const float* dt;          // (B, S, H)
  const float* a;           // (H,)
  const void* b;            // (B, S, G, N), strides b_sb, b_ss
  const void* c;            // (B, S, G, N), strides c_sb, c_ss
  const float* init_state;  // (B, H, P, N) or null
  const void* dy;           // (B, S, H, P) dense
  const float* d_final;     // (B, H, P, N) or null
  void* states;             // fp32: (B, nb, H, P, N) fp32; bf16: (2, B, nb, H, 2, P, N) bf16
                            // (S0 then dS; hi then lo; swizzled rows, swz)
  void* dx;                 // (B, S, H, P) dense
  float* d_dt;              // (B, S, H)
  float* d_a_part;          // fp32: (B, H); bf16: (B, nb, H)
  float* db_part;           // fp32: (B, S, H, N); bf16: unused
  float* dc_part;           // fp32: (B, S, H, N); bf16: unused
  float* d_init;            // (B, H, P, N)
  void* db;                 // (B, S, G, N) dense
  void* dc;                 // (B, S, G, N) dense
  float* d_a;               // (H,)
  int batch, seqlen, heads, headdim, groups, dstate;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive scan over the lanes (lane = token); lanes past L hold zeros
__device__ __forceinline__ float warp_cumsum(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// the sum over lanes >= this one (the reverse inclusive scan)
__device__ __forceinline__ float warp_rcumsum(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

// ---------------------------------------------------------------------------
// Backward, bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kStateGroups = kMaxState / 16 / 4;   // 16-column groups of N a warp carries
constexpr int kGradMaxWarps = 12;                   // the gradients kernel's CTA, at most
constexpr int kLdL = kChunk + 8;                    // padded row of the 32 x 32 M, Q tiles

// 4 bytes of a peer CTA's shared memory x 4: the same offset as p in the
// CTA of the given rank in this cluster
__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// Where 16-byte chunk c of row p of a (rows, N) bf16 state plane lies in
// that row: the chunks are permuted by an XOR with the row, so that
// ldmatrix's 8 rows at one chunk column hit distinct banks with no padding
// (the planes are copied whole). The XOR range is the largest power of 2 up
// to 8 dividing the row's N / 8 chunks; rows narrower than 128 bytes share
// a bank line, so the XOR takes the row's place among them.
__host__ __device__ __forceinline__ int swz(int p, int c, int N) {
  const int C = N / 8;
  const int R = C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 2;
  const int sh = N >= 64 ? 0 : N == 32 ? 1 : 2;
  return c ^ ((p >> sh) & (R - 1));
}

constexpr int kStateStages = 4;   // blocks in flight: loads run 3 blocks ahead

// Shared memory of the states kernel, in bytes from the base: an mbarrier a
// stage, then per stage the R rows (B, or C in reverse), the V tile (16
// columns of x, or of dy) and dt.
struct StatesSmem {
  int ldr;
  size_t r, v, dt, bytes;
  __host__ __device__ explicit StatesSmem(int N) : ldr(N + 8) {
    r = 32;
    v = r + (size_t)kStateStages * kChunk * ldr * sizeof(__nv_bfloat16);
    dt = v + (size_t)kStateStages * kChunk * kXS * sizeof(__nv_bfloat16);
    bytes = dt + (size_t)kStateStages * kChunk * sizeof(float);
  }
};

// One CTA per (16 rows of P, batch*head, direction). Direction 0 walks the
// blocks first to last, S <- exp(cs_last) S + (x w)^T . B, and writes S at
// each block's start; direction 1 walks them last to first, dS <-
// exp(cs_last) dS + (dy e)^T . C, writes dS at each block's end and, after
// block 0, d_init. Warp w carries the 16-column groups j = w + 4 q of N in
// its accumulators. The CTAs of a cluster (a head's P tiles, and two heads
// of a group where that fits in 8) share the B (C) rows: each issues a
// share of the row copies, multicast to all. Four stages: block i + 3's
// copies go out once block i is computed and every CTA of the cluster has
// arrived after block i - 1, whose stage they reuse; the arrive and the
// wait are split so that a CTA waits for its peers one block late. The
// states go out split into bf16 hi and lo planes with swizzled rows (swz):
// the same bytes as fp32, in the form the gradients kernel multiplies.
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_mma_kernel(const BwdParams prm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = prm.dstate, nks = N / 16, H = prm.heads, P = prm.headdim, S = prm.seqlen;
  const int nb = (S + kChunk - 1) / kChunk;
  const StatesSmem lay(N);
  const int ldr = lay.ldr;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);                     // [kStateStages]
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.r);    // [stages][32][ldr]
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.v);    // [stages][32][kXS]
  float* sDt = reinterpret_cast<float*>(smem_raw + lay.dt);                  // [stages][32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int bh = blockIdx.y, bi = bh / H, h = bh % H;
  const int p0 = blockIdx.x * kRows;
  const bool rev = blockIdx.z == 1;
  const int grp = h / (H / prm.groups);
  const int rank = cluster_rank(), csize = cluster_size();
  const float a = prm.a[h];
  const __nv_bfloat16* v = rev
      ? static_cast<const __nv_bfloat16*>(prm.dy) + ((long long)bi * S * H + h) * P + p0
      : static_cast<const __nv_bfloat16*>(prm.x) + bi * prm.x_sb + (long long)h * P + p0;
  const long long v_ss = rev ? (long long)H * P : prm.x_ss;
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(rev ? prm.c : prm.b)
                           + bi * (rev ? prm.c_sb : prm.b_sb) + (long long)grp * N;
  const long long r_ss = rev ? prm.c_ss : prm.b_ss;
  const float* dt = prm.dt + (long long)bi * S * H + h;                      // token stride H
  // S0 (or dS) of block k at out + k H 2 P N: a hi and a lo (P, N) plane
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(prm.states)
                       + ((long long)((rev ? prm.batch : 0) + bi) * nb * H + h) * 2 * P * N;
  const float* start = rev ? prm.d_final : prm.init_state;
  const long long state_off = ((long long)bh * P + p0) * N;
  const int steps = rev ? nb : nb - 1;    // the forward needs no state past the last block's start
  const int row_bytes = N * (int)sizeof(__nv_bfloat16);

  if (tid == 0)
    for (int st = 0; st < kStateStages; ++st) mbar_init(bar + st, 1);
  // every CTA's mbarriers must exist before a peer's copy lands in them:
  // arrive now, wait just before the first multicast
  cluster_arrive_relaxed();

  float acc[kStateGroups][2][4];
#pragma unroll
  for (int q = 0; q < kStateGroups; ++q) {
    const int j = warp + 4 * q;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 s = make_float2(0.f, 0.f);
        if (start != nullptr && j < nks)
          s = *reinterpret_cast<const float2*>(start + state_off + (g8 + 8 * hh) * N + j * 16
                                               + nn * 8 + 2 * t4);
        acc[q][nn][2 * hh] = s.x;
        acc[q][nn][2 * hh + 1] = s.y;
      }
  }

  // The i-th block walked, into stage i % kStateStages: R rows s = rank,
  // rank + csize, ... copied by this CTA into every CTA of the cluster, rows
  // past S zeroed here; V and dt (this CTA's own) by cp.async, zero-filled
  // past S, in a commit group of their own (empty past the last block, so
  // that every block's group sits kStateStages - 1 groups back).
  auto load_block = [&](int i) {
    if (i >= steps) {
      cp_async_commit();
      return;
    }
    const int stage = i % kStateStages, k = rev ? nb - 1 - i : i;
    const int t0 = k * kChunk, L = min(kChunk, S - t0);
    __nv_bfloat16* dr = sR + stage * kChunk * ldr;
    if (tid < 2 * kChunk) {
      const int s = tid / 2, e = (tid % 2) * 8;
      const long long t = t0 + (s < L ? s : 0);
      cp_async16(sV + (stage * kChunk + s) * kXS + e, v + t * v_ss + e, s < L);
    } else if (tid < 3 * kChunk) {
      const int s = tid - 2 * kChunk;
      const long long t = t0 + (s < L ? s : 0);
      cp_async4(sDt + stage * kChunk + s, dt + t * H, s < L);
    }
    cp_async_commit();
    if (tid == 0) mbar_expect_tx(bar + stage, L * row_bytes);
    if (warp == 1) {
      const int s = rank + csize * lane;
      if (s < L)
        bulk_load_multicast(dr + s * ldr, r + (long long)(t0 + s) * r_ss, row_bytes, bar + stage,
                            (uint16_t)((1u << csize) - 1));
    }
    for (int z = L * N / 2 + tid; z < kChunk * N / 2; z += kThreads) {
      const int s = z / (N / 2), e = 2 * (z % (N / 2));
      *reinterpret_cast<uint32_t*>(dr + s * ldr + e) = 0u;
    }
  };

  cluster_wait();
  for (int i = 0; i + 1 < kStateStages; ++i) load_block(i);

  for (int i = 0; i < nb; ++i) {
    const int k = rev ? nb - 1 - i : i;
    // the state entering block k's update, S0_k or dS_k, split into bf16
    // hi + lo where it is made (the gradients kernel reads it so). Chunks
    // 2j and 2j + 1 of a row land side by side (swz flips bit 0 at most):
    // the row's 4 lanes trade words so that lane t4 stores 8 contiguous
    // bytes of that 32-byte pair, a full sector per quad
    __nv_bfloat16* o = out + (long long)k * H * 2 * P * N;
    const int src = (lane & ~3) | (2 * (t4 & 1));
#pragma unroll
    for (int q = 0; q < kStateGroups; ++q) {
      const int j = warp + 4 * q;
      if (j >= nks) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = p0 + g8 + 8 * hh, pos = swz(p, 2 * j, N);
        const bool swap = ((t4 >> 1) ^ (pos & 1)) != 0;    // chunk 2j + 1 at this lane's half
        uint32_t hi[2], lo[2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          split_pair(acc[q][nn][2 * hh], acc[q][nn][2 * hh + 1], hi[nn], lo[nn]);
        uint32_t w[2][2][2];                                  // [hi, lo][nn][word]
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            w[0][nn][u] = __shfl_sync(0xffffffffu, hi[nn], src + u);
            w[1][nn][u] = __shfl_sync(0xffffffffu, lo[nn], src + u);
          }
        const int off = p * N + (pos & ~1) * 8 + 4 * t4;
        *reinterpret_cast<uint2*>(o + off) = swap ? make_uint2(w[0][1][0], w[0][1][1])
                                                  : make_uint2(w[0][0][0], w[0][0][1]);
        *reinterpret_cast<uint2*>(o + P * N + off) = swap ? make_uint2(w[1][1][0], w[1][1][1])
                                                          : make_uint2(w[1][0][0], w[1][0][1]);
      }
    }
    if (i == steps) break;
    const int stage = i % kStateStages, t0 = k * kChunk;
    const int L = min(kChunk, S - t0);
    cp_async_wait<kStateStages - 2>();
    mbar_wait(bar + stage, (i / kStateStages) & 1);
    __syncthreads();

    const __nv_bfloat16* cR = sR + stage * kChunk * ldr;
    const __nv_bfloat16* cV = sV + stage * kChunk * kXS;
    // every warp scans dt*a itself (the same bits in each): lane = token
    const float dt_l = sDt[stage * kChunk + lane];          // 0 past L
    const float cs = warp_cumsum(lane < L ? dt_l * a : 0.f, lane);
    const float cs_last = __shfl_sync(0xffffffffu, cs, L - 1);
    const float wgt = lane < L ? (rev ? expf(cs) : dt_l * expf(cs_last - cs)) : 0.f;
    const float total = expf(cs_last);
    // A = (V wgt)^T: rows r of the tile, k = token s; split hi / lo
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {         // a0..a3: (row g8 | g8+8, s | s+8)
        const int rr = g8 + 8 * (q % 2), s = kk * 16 + 2 * t4 + 8 * (q / 2);
        const float w0 = __shfl_sync(0xffffffffu, wgt, s);
        const float w1 = __shfl_sync(0xffffffffu, wgt, s + 1);
        split_pair(__bfloat162float(cV[s * kXS + rr]) * w0,
                   __bfloat162float(cV[(s + 1) * kXS + rr]) * w1, ahi[kk][q], alo[kk][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kStateGroups; ++q) {
      const int j = warp + 4 * q;
      if (j >= nks) continue;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][nn][e] *= total;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (16 * kk >= L) continue;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, cR + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldr + j * 16 + (mi / 2) * 8);
        mma_bf16(acc[q][0], ahi[kk], bf[0], bf[1]);
        mma_bf16(acc[q][0], alo[kk], bf[0], bf[1]);
        mma_bf16(acc[q][1], ahi[kk], bf[2], bf[3]);
        mma_bf16(acc[q][1], alo[kk], bf[2], bf[3]);
      }
    }
    // block i + 3's copies reuse block i - 1's stage, which every CTA of
    // the cluster must have finished reading. This CTA's reads of block i's
    // stage are done (their values are in the accumulators): the arrival
    // orders nothing, so it does not wait for the state stores to drain.
    if (i > 0) cluster_wait();
    load_block(i + kStateStages - 1);
    cluster_arrive_relaxed();
  }
  if (steps > 0) cluster_wait();   // the last arrival's
  if (rev) {
#pragma unroll
    for (int q = 0; q < kStateGroups; ++q) {
      const int j = warp + 4 * q;
      if (j >= nks) continue;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(prm.d_init + state_off + (g8 + 8 * hh) * N + j * 16 + nn * 8
                                     + 2 * t4) =
              make_float2(acc[q][nn][2 * hh], acc[q][nn][2 * hh + 1]);
    }
  }
}

// Shared memory of the gradients kernel, in bytes from the base: six
// mbarriers; nbuf heads' S0 and dS as copied, each a hi and a lo (P, N)
// bf16 plane with swizzled rows (at the end, the CTA's dC and dB sums in
// fp32); the block's B and C rows; x and dy, three heads; M and Q hi and
// lo, two heads; the per-head vectors e, tail, dt and exp(cs_last) and G's
// row and column sums, three heads each; the task partials, two heads.
struct GradSmem {
  int ldn, ldp, partsz;
  size_t st, b, c, x, dy, m, q, vec, gsum, part, bytes;
  __host__ __device__ GradSmem(int P, int N, int nbuf) : ldn(N + 8), ldp(P + 8) {
    const size_t mq = (size_t)kChunk * kLdL * sizeof(__nv_bfloat16);
    const size_t heads = (size_t)nbuf * 4 * P * N * sizeof(__nv_bfloat16);
    const size_t sums = (size_t)2 * kChunk * N * sizeof(float);
    // a head's task partials, floats: dot [16], CU [N/16][32], T and XD
    // [P/16][32]
    partsz = 16 + (N / 16 + 2 * (P / 16)) * kChunk;
    st = 64;                                                          // after 6 mbarriers
    b = st + (heads > sums ? heads : sums);
    c = b + (size_t)kChunk * ldn * sizeof(__nv_bfloat16);
    x = c + (size_t)kChunk * ldn * sizeof(__nv_bfloat16);
    dy = x + (size_t)3 * kChunk * ldp * sizeof(__nv_bfloat16);
    m = dy + (size_t)3 * kChunk * ldp * sizeof(__nv_bfloat16);       // [2][hi, lo]
    q = m + 4 * mq;                                                   // [2][hi, lo]
    vec = q + 4 * mq;                     // [3][3][32] e, tail, dt; [3] exp(cs_last); pad
    gsum = vec + (size_t)(3 * 3 * kChunk + 4) * sizeof(float);     // [3][rowG, colG][2][32]
    part = gsum + (size_t)3 * 4 * kChunk * sizeof(float);
    bytes = part + (size_t)2 * partsz * sizeof(float);
  }
};

// Heads whose S0 and dS planes the gradients kernel holds at once: two
// (the next head's copies run behind this head's work) where they fit in
// the 227 KB of shared memory, else one.
__host__ __device__ inline int grad_bufs(int P, int N) {
  return GradSmem(P, N, 2).bytes <= 232448 ? 2 : 1;
}

// Column tasks (below) a warp of the gradients kernel keeps: one up to N
// 192, two beyond.
__host__ __device__ inline int grad_kt(int N) { return N / 16 > kGradMaxWarps ? 2 : 1; }

// Warps of the gradients kernel's CTA at (P, N): with one column task a
// warp, one a column task and one a row task, at least the 4 of phase A and
// at most 12; with two, 8.
__host__ __device__ inline int grad_warps(int P, int N) {
  if (grad_kt(N) == 2) return 8;
  const int w = N / 16 + P / 16;
  return w < 4 ? 4 : w > kGradMaxWarps ? kGradMaxWarps : w;
}

// One CTA per (batch, block, group) and share of the group's heads (the
// cluster's rank), walking them in order with one CTA barrier a head.
// Between two barriers, for head i:
// - column task j (warp j; KT: tasks j = warp + warps q a warp keeps)
//   takes columns [16 j, 16 j + 16) of N for both l-tiles: U = dy.S0, then
//   Z = x.dS with <dS, S0> over these columns from the same fragments, one
//   read of dS and two of S0 there; e U and tail dt Z, then Q.B and Q^T.C
//   go straight into its dC and dB sums;
// - row task ip (the warps after the column tasks) takes rows [16 ip, 16
//   ip + 16) of P for both s-tiles: dxdt = M^T.dy + tail B.dS^T, dx;
// - then the last four warps (the row tasks' at the model's widths): the
//   fourth finishes head i - 1 (d(cs) from its partials, d(da), d(dt),
//   d(a)) and issues the copies of what later heads need into the buffers
//   head i - 1 has left (x, dy rows two heads ahead, S0 and dS planes one
//   ahead); the other three run phase A of head i + 1: W = dy.x^T over
//   their 16 x 16 unit of the (l, s) block (l-tile um, s-tile un; the unit
//   above the diagonal is zero), then M, Q and G's row and column sums
//   there. So phase A, a chain on three warps, runs beside the products.
// The d(cs) terms x.dxdt, T and e C.U go to per-task row partials.
template <int KT>
__global__ void __launch_bounds__(KT == 1 ? kGradMaxWarps * 32 : 256)
    ssd_bwd_grads_mma_kernel(const BwdParams prm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = prm.dstate, P = prm.headdim, S = prm.seqlen, H = prm.heads, G = prm.groups;
  const int nks = N / 16, pks = P / 16, rep = H / G;
  const int nw = blockDim.x / 32;
  const int nb = gridDim.y, k = blockIdx.y, bi = blockIdx.z / G, g = blockIdx.z % G;
  const int rank = cluster_rank(), hc = cluster_size();
  const int share = rep / hc, extra = rep % hc;
  const int nh = share + (rank < extra ? 1 : 0);
  const int h0 = g * rep + rank * share + min(rank, extra);
  const int nbuf = grad_bufs(P, N);
  const GradSmem lay(P, N, nbuf);
  const int ldn = lay.ldn, ldp = lay.ldp;
  uint64_t* bar_bc = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_st = bar_bc + 1;                                                  // [2]
  uint64_t* bar_xy = bar_bc + 3;                                                  // [3]
  // [nbuf heads][S0 hi, S0 lo, dS hi, dS lo][P * N], rows swizzled
  __nv_bfloat16* sSt = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.st);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.b);        // [32][ldn]
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.c);        // [32][ldn]
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.x);        // [3][32][ldp]
  __nv_bfloat16* sDy = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.dy);      // [3][32][ldp]
  __nv_bfloat16* sM = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.m);        // [2][hi, lo][32][kLdL]
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);        // [2][hi, lo][32][kLdL]
  float* sVec = reinterpret_cast<float*>(smem_raw + lay.vec);     // [3][e, tail, dt][32]
  float* sTotal = sVec + 3 * 3 * kChunk;                          // [3]
  float* sGsum = reinterpret_cast<float*>(smem_raw + lay.gsum);   // [3][rowG [un], colG [um]][32]
  float* sPart = reinterpret_cast<float*>(smem_raw + lay.part);   // [2][partsz]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int t0 = k * kChunk, L = min(kChunk, S - t0);
  const long long plane = (long long)prm.batch * nb * H * 2 * P * N;
  const __nv_bfloat16* states = static_cast<const __nv_bfloat16*>(prm.states)
                                + ((long long)bi * nb + k) * H * 2 * P * N;        // + h 2 P N
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(prm.x) + bi * prm.x_sb
                            + (long long)t0 * prm.x_ss;                           // + s x_ss + h P
  const __nv_bfloat16* dyg = static_cast<const __nv_bfloat16*>(prm.dy)
                             + ((long long)bi * S + t0) * H * P;                  // + (s H + h) P
  __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(prm.dx) + ((long long)bi * S + t0) * H * P;
  const float* dtg = prm.dt + ((long long)bi * S + t0) * H;                       // + s H + h
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(prm.b) + bi * prm.b_sb
                            + (long long)t0 * prm.b_ss + (long long)g * N;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(prm.c) + bi * prm.c_sb
                            + (long long)t0 * prm.c_ss + (long long)g * N;
  const int xrow = P * (int)sizeof(__nv_bfloat16), nrow = N * (int)sizeof(__nv_bfloat16);
  const int state_bytes = 2 * P * N * (int)sizeof(__nv_bfloat16);   // hi and lo
  // the last four warps: phase A units (aw 0-2) and the finishing warp
  // (aw 3), which also issues the copies
  const int aw = warp - (nw - 4);
  const bool unit = aw >= 0 && aw < 3;
  const int um = aw == 0 ? 0 : 1, un = aw == 2 ? 1 : 0;

  // head i's G sums: rowG [un][32 l], colG [um][32 s]; its task partials:
  // dot [column task], CU [N/16][32], T and XD [P/16][32]
  auto gsum = [&](int i) { return sGsum + (i % 3) * 4 * kChunk; };
  auto part = [&](int i) { return sPart + (i & 1) * lay.partsz; };
  auto mq = [&](__nv_bfloat16* base, int i, int lo) {
    return base + ((i & 1) * 2 + lo) * kChunk * kLdL;
  };
  // copies of head i (the finishing warp): x, dy rows into stage i % 3,
  // the S0, dS planes into buffer i % nbuf
  auto issue_xy = [&](int i) {
    const int h = h0 + i, s3 = i % 3;
    if (lane == 0) mbar_expect_tx(bar_xy + s3, 2 * L * xrow);
    __syncwarp();
    if (lane < L) {
      bulk_load(sX + (s3 * kChunk + lane) * ldp, xg + lane * prm.x_ss + (long long)h * P, xrow,
                bar_xy + s3);
      bulk_load(sDy + (s3 * kChunk + lane) * ldp, dyg + ((long long)lane * H + h) * P, xrow,
                bar_xy + s3);
    }
  };
  auto issue_st = [&](int i) {
    const int h = h0 + i;
    __nv_bfloat16* dst = sSt + (i % nbuf) * 4 * P * N;
    if (lane == 0) {
      mbar_expect_tx(bar_st + (i & 1), 2 * state_bytes);
      bulk_load(dst, states + (long long)h * 2 * P * N, state_bytes, bar_st + (i & 1));
      bulk_load(dst + 2 * P * N, states + plane + (long long)h * 2 * P * N, state_bytes,
                bar_st + (i & 1));
    }
  };

  if (tid == 0) {
    mbar_init(bar_bc, 1);
    for (int s = 0; s < 5; ++s) mbar_init(bar_st + s, 1);
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(bar_bc, 2 * L * nrow);
    __syncwarp();
    if (lane < L) {
      bulk_load(sB + lane * ldn, bg + lane * prm.b_ss, nrow, bar_bc);
      bulk_load(sC + lane * ldn, cg + lane * prm.c_ss, nrow, bar_bc);
    }
  } else if (aw == 3) {
    issue_xy(0);
    if (nh > 1) issue_xy(1);
    issue_st(0);
    if (nbuf == 2 && nh > 1) issue_st(1);
  }
  // rows past L zeroed (a padded row meets zeros in the tensor cores, where
  // 0 * garbage is not 0), M and Q zeroed (the unit above the diagonal stays
  // so), and the partials (the zero unit's G sums stay so)
  for (int i = L * N / 2 + tid; i < kChunk * N / 2; i += blockDim.x) {
    const int s = i / (N / 2), e = 2 * (i % (N / 2));
    *reinterpret_cast<uint32_t*>(sB + s * ldn + e) = 0u;
    *reinterpret_cast<uint32_t*>(sC + s * ldn + e) = 0u;
  }
  for (int i = L * P / 2 + tid; i < kChunk * P / 2; i += blockDim.x) {
    const int s = i / (P / 2), e = 2 * (i % (P / 2));
    for (int s3 = 0; s3 < 3; ++s3) {
      *reinterpret_cast<uint32_t*>(sX + (s3 * kChunk + s) * ldp + e) = 0u;
      *reinterpret_cast<uint32_t*>(sDy + (s3 * kChunk + s) * ldp + e) = 0u;
    }
  }
  for (int i = tid; i < 2 * kChunk * kLdL; i += blockDim.x) {   // pairs: [2][hi, lo]
    *reinterpret_cast<uint32_t*>(sM + 2 * i) = 0u;
    *reinterpret_cast<uint32_t*>(sQ + 2 * i) = 0u;
  }
  for (int i = tid; i < 3 * 4 * kChunk; i += blockDim.x) sGsum[i] = 0.f;
  __syncthreads();
  mbar_wait(bar_bc, 0);

  // the phase A units: C.B^T over the unit once, kept in registers
  float cb[2][4] = {};
  if (unit) {
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t ca[4], bf[4];
      ldmatrix_x4(ca, sC + (um * 16 + (mi % 2) * 8 + lane % 8) * ldn + ks * 16 + (mi / 2) * 8);
      ldmatrix_x4(bf, sB + (un * 16 + (mi / 2) * 8 + lane % 8) * ldn + ks * 16 + (mi % 2) * 8);
      mma_bf16(cb[0], ca, bf[0], bf[1]);
      mma_bf16(cb[1], ca, bf[2], bf[3]);
    }
  }
  // column tasks j = warp + nw q: dC, dB summed over the heads, [q][l or s
  // tile m][n8]
  float dC[KT][2][2][4] = {}, dB[KT][2][2][4] = {};

  // phase A of head i (the units): cs, the per-head vectors, W = dy.x^T
  // over the unit (both exact), then M = C.B^T w, Q = W dt_s w, G = C.B^T Q
  // for s <= l < L (masked before the exp), and G's row and column sums
  auto phase_a = [&](int i) {
    const int h = h0 + i;
    const float a = prm.a[h];
    const float d = lane < L ? dtg[(long long)lane * H + h] : 0.f;
    const __nv_bfloat16* cX = sX + (i % 3) * kChunk * ldp;
    const __nv_bfloat16* cDy = sDy + (i % 3) * kChunk * ldp;
    mbar_wait(bar_xy + i % 3, (i / 3) & 1);
    const float cs = warp_cumsum(d * a, lane);             // d = 0 past L
    const float cs_last = __shfl_sync(0xffffffffu, cs, L - 1);
    if (aw == 0) {
      float* vec = sVec + (i % 3) * 3 * kChunk;
      vec[lane] = lane < L ? expf(cs) : 0.f;                            // e
      vec[kChunk + lane] = lane < L ? expf(cs_last - cs) : 0.f;         // tail
      vec[2 * kChunk + lane] = d;                                       // dt
      if (lane == 0) sTotal[i % 3] = expf(cs_last);
    }
    float wacc[2][4] = {};
    for (int kp = 0; kp < pks; ++kp) {
      uint32_t ad[4], bx[4];
      ldmatrix_x4(ad, cDy + (um * 16 + (mi % 2) * 8 + lane % 8) * ldp + kp * 16 + (mi / 2) * 8);
      ldmatrix_x4(bx, cX + (un * 16 + (mi / 2) * 8 + lane % 8) * ldp + kp * 16 + (mi % 2) * 8);
      mma_bf16(wacc[0], ad, bx[0], bx[1]);
      mma_bf16(wacc[1], ad, bx[2], bx[3]);
    }
    __nv_bfloat16 *mhi = mq(sM, i, 0), *mlo = mq(sM, i, 1), *qhi = mq(sQ, i, 0), *qlo = mq(sQ, i, 1);
    float rowp[2] = {}, colp[2][2] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = um * 16 + g8 + 8 * hh;
      const float cs_l = __shfl_sync(0xffffffffu, cs, l);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        float mv[2], qv[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int s = un * 16 + nn * 8 + 2 * t4 + e2;
          const float cs_s = __shfl_sync(0xffffffffu, cs, s);
          const float dt_s = __shfl_sync(0xffffffffu, d, s);
          const bool valid = s <= l && l < L;
          const float w = valid ? expf(cs_l - cs_s) : 0.f;
          const float c_b = cb[nn][2 * hh + e2];
          mv[e2] = c_b * w;
          qv[e2] = wacc[nn][2 * hh + e2] * dt_s * w;
          const float gv = c_b * qv[e2];
          rowp[hh] += gv;
          colp[nn][e2] += gv;
        }
        const int off = l * kLdL + un * 16 + nn * 8 + 2 * t4;
        uint32_t hi, lo;
        split_pair(mv[0], mv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(mhi + off) = hi;
        *reinterpret_cast<uint32_t*>(mlo + off) = lo;
        split_pair(qv[0], qv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(qhi + off) = hi;
        *reinterpret_cast<uint32_t*>(qlo + off) = lo;
      }
    }
    // row sums over the unit's 16 columns (across t4), column sums over
    // its 16 rows (across g8)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rowp[hh] += __shfl_xor_sync(0xffffffffu, rowp[hh], 1);
      rowp[hh] += __shfl_xor_sync(0xffffffffu, rowp[hh], 2);
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          colp[nn][e2] += __shfl_xor_sync(0xffffffffu, colp[nn][e2], o);
    float* pa = gsum(i);
    if (t4 == 0)
      for (int hh = 0; hh < 2; ++hh) pa[un * kChunk + um * 16 + g8 + 8 * hh] = rowp[hh];
    if (g8 == 0)
      for (int nn = 0; nn < 2; ++nn)
        for (int e2 = 0; e2 < 2; ++e2)
          pa[(2 + um) * kChunk + un * 16 + nn * 8 + 2 * t4 + e2] = colp[nn][e2];
  };

  // head j's d(cs) from its partials, then d(da), d(dt), d(a) (aw 3)
  auto finish = [&](int j) {
    const int h = h0 + j;
    const float* pj = gsum(j);
    const float* sDot = part(j);
    const float* sCU = sDot + 16;
    const float* sT = sCU + nks * kChunk;
    const float* sXD = sT + pks * kChunk;
    float dcs = 0.f, tt = 0.f, xd = 0.f;
    if (lane < L) {
      float cu = 0.f;
      for (int jj = 0; jj < nks; ++jj) cu += sCU[jj * kChunk + lane];
      for (int ip = 0; ip < pks; ++ip) {
        tt += sT[ip * kChunk + lane];
        xd += sXD[ip * kChunk + lane];
      }
      dcs = (pj[lane] + pj[kChunk + lane]) - (pj[2 * kChunk + lane] + pj[3 * kChunk + lane])
            + cu - tt;
    }
    const float t_sum = warp_sum(tt);
    if (lane == L - 1) {
      float dot = 0.f;
      for (int jj = 0; jj < nks; ++jj) dot += sDot[jj];
      dcs += sTotal[j % 3] * dot + t_sum;
    }
    const float dda = warp_rcumsum(dcs, lane);
    if (lane < L) prm.d_dt[((long long)bi * S + t0 + lane) * H + h] = fmaf(prm.a[h], dda, xd);
    const float da = warp_sum(lane < L ? dda * sVec[(j % 3) * 3 * kChunk + 2 * kChunk + lane] : 0.f);
    if (lane == 0) prm.d_a_part[((long long)bi * nb + k) * H + h] = da;
  };

  if (unit) phase_a(0);
  __syncthreads();

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const __nv_bfloat16* cX = sX + (i % 3) * kChunk * ldp;
    const __nv_bfloat16* cDy = sDy + (i % 3) * kChunk * ldp;
    const __nv_bfloat16* cS0hi = sSt + (i % nbuf) * 4 * P * N;
    const __nv_bfloat16* cS0lo = cS0hi + P * N;
    const __nv_bfloat16* cDShi = cS0hi + 2 * P * N;
    const __nv_bfloat16* cDSlo = cS0hi + 3 * P * N;
    const __nv_bfloat16 *cMhi = mq(sM, i, 0), *cMlo = mq(sM, i, 1);
    const __nv_bfloat16 *cQhi = mq(sQ, i, 0), *cQlo = mq(sQ, i, 1);
    const float* vec = sVec + (i % 3) * 3 * kChunk;
    float* sDot = part(i);
    float* sCU = sDot + 16;
    float* sT = sCU + nks * kChunk;
    float* sXD = sT + pks * kChunk;
    // copies into what head i - 1 has left (stage 2 is fresh at i = 0): x,
    // dy of head i + 2, and the S0, dS planes of head i + 1 (of head i with
    // one buffer)
    if (aw == 3) {
      fence_async_smem();
      if (i + 2 < nh) issue_xy(i + 2);
      if (i > 0 && (nbuf == 2 ? i + 1 < nh : true)) issue_st(nbuf == 2 ? i + 1 : i);
    }
    mbar_wait(bar_st + (i & 1), (i >> 1) & 1);

#pragma unroll
    for (int q = 0; q < KT; ++q) {
      // column task j, in two passes (one set of accumulators)
      const int j = warp + nw * q;
      if (j >= nks) break;
      // U = dy.S0 (S0 split, one read for both tiles); dC += e_l U and the
      // row partials e_l C_l.U_l
      float acc[2][2][4] = {};
      for (int kp = 0; kp < pks; ++kp) {
        const int pr = kp * 16 + (mi % 2) * 8 + lane % 8;
        const int off = pr * N + swz(pr, 2 * j + mi / 2, N) * 8;
        uint32_t sh[4], sl[4];
        ldmatrix_x4_trans(sh, cS0hi + off);
        ldmatrix_x4_trans(sl, cS0lo + off);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ad[4];
          ldmatrix_x4(ad, cDy + (m * 16 + (mi % 2) * 8 + lane % 8) * ldp + kp * 16 + (mi / 2) * 8);
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
            mma_bf16(acc[m][n8], ad, sh[2 * n8], sh[2 * n8 + 1]);
            mma_bf16(acc[m][n8], ad, sl[2 * n8], sl[2 * n8 + 1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = m * 16 + g8 + 8 * hh;
          const float e_l = vec[l];
          float cu = 0.f;
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sC + l * ldn + j * 16 + n8 * 8 + 2 * t4));
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float uu = acc[m][n8][2 * hh + e2];
              dC[q][m][n8][2 * hh + e2] = fmaf(e_l, uu, dC[q][m][n8][2 * hh + e2]);
              cu = fmaf(e2 ? cv.y : cv.x, uu, cu);
            }
          }
          cu += __shfl_xor_sync(0xffffffffu, cu, 1);
          cu += __shfl_xor_sync(0xffffffffu, cu, 2);
          if (t4 == 0) sCU[j * kChunk + l] = e_l * cu;
        }
      // Z = x.dS (dS split, one read for both tiles) and <dS, S0> over these
      // columns from the same fragments (S0's read again); dB += tail_s dt_s Z
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n8][e] = 0.f;
      float dot = 0.f;
      for (int kp = 0; kp < pks; ++kp) {
        const int pr = kp * 16 + (mi % 2) * 8 + lane % 8;
        const int off = pr * N + swz(pr, 2 * j + mi / 2, N) * 8;
        uint32_t sh[4], sl[4], dh[4], dl[4];
        ldmatrix_x4_trans(dh, cDShi + off);
        ldmatrix_x4_trans(dl, cDSlo + off);
        ldmatrix_x4_trans(sh, cS0hi + off);
        ldmatrix_x4_trans(sl, cS0lo + off);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ax[4];
          ldmatrix_x4(ax, cX + (m * 16 + (mi % 2) * 8 + lane % 8) * ldp + kp * 16 + (mi / 2) * 8);
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
            mma_bf16(acc[m][n8], ax, dh[2 * n8], dh[2 * n8 + 1]);
            mma_bf16(acc[m][n8], ax, dl[2 * n8], dl[2 * n8 + 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 s_h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sh[r]));
          const float2 s_l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sl[r]));
          const float2 d_h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dh[r]));
          const float2 d_l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dl[r]));
          dot = fmaf(d_h.x + d_l.x, s_h.x + s_l.x, dot);
          dot = fmaf(d_h.y + d_l.y, s_h.y + s_l.y, dot);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = m * 16 + g8 + 8 * hh;
          const float wz = vec[kChunk + s] * vec[2 * kChunk + s];
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2)
              dB[q][m][n8][2 * hh + e2] = fmaf(wz, acc[m][n8][2 * hh + e2], dB[q][m][n8][2 * hh + e2]);
        }
      dot = warp_sum(dot);
      if (lane == 0) sDot[j] = dot;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (16 * kk >= L) break;
        uint32_t bb[4], cc[4];
        ldmatrix_x4_trans(bb, sB + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldn + j * 16 + (mi / 2) * 8);
        ldmatrix_x4_trans(cc, sC + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldn + j * 16 + (mi / 2) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t qh[4], ql[4];
          if (kk <= m) {          // Q.B: rows l of tile m, s <= l
            ldmatrix_x4(qh, cQhi + (m * 16 + (mi % 2) * 8 + lane % 8) * kLdL + kk * 16 + (mi / 2) * 8);
            ldmatrix_x4(ql, cQlo + (m * 16 + (mi % 2) * 8 + lane % 8) * kLdL + kk * 16 + (mi / 2) * 8);
#pragma unroll
            for (int n8 = 0; n8 < 2; ++n8) {
              mma_bf16(dC[q][m][n8], qh, bb[2 * n8], bb[2 * n8 + 1]);
              mma_bf16(dC[q][m][n8], ql, bb[2 * n8], bb[2 * n8 + 1]);
            }
          }
          if (kk >= m) {          // Q^T.C: rows s of tile m, l >= s
            ldmatrix_x4_trans(qh, cQhi + (kk * 16 + (mi >> 1) * 8 + lane % 8) * kLdL + m * 16 + (mi & 1) * 8);
            ldmatrix_x4_trans(ql, cQlo + (kk * 16 + (mi >> 1) * 8 + lane % 8) * kLdL + m * 16 + (mi & 1) * 8);
#pragma unroll
            for (int n8 = 0; n8 < 2; ++n8) {
              mma_bf16(dB[q][m][n8], qh, cc[2 * n8], cc[2 * n8 + 1]);
              mma_bf16(dB[q][m][n8], ql, cc[2 * n8], cc[2 * n8 + 1]);
            }
          }
        }
      }
    }
    // row tasks: dxdt over (s-tile m, p-tile ip) for both s-tiles: M^T.dy
    // (M split) + tail_s B.dS^T (dS split, one read for both tiles); dx =
    // dt dxdt; row partials of x.dxdt and T
    for (int ip = ((warp - nks) % nw + nw) % nw; ip < pks; ip += nw) {
      float md[2][2][4] = {}, bd[2][2][4] = {};
      for (int ks = 0; ks < nks; ++ks) {
        const int pr = ip * 16 + (mi / 2) * 8 + lane % 8;
        const int off = pr * N + swz(pr, 2 * ks + mi % 2, N) * 8;
        uint32_t dh[4], dl[4];
        ldmatrix_x4(dh, cDShi + off);
        ldmatrix_x4(dl, cDSlo + off);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ab[4];
          ldmatrix_x4(ab, sB + (m * 16 + (mi % 2) * 8 + lane % 8) * ldn + ks * 16 + (mi / 2) * 8);
          mma_bf16(bd[m][0], ab, dh[0], dh[1]);
          mma_bf16(bd[m][0], ab, dl[0], dl[1]);
          mma_bf16(bd[m][1], ab, dh[2], dh[3]);
          mma_bf16(bd[m][1], ab, dl[2], dl[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (16 * kk >= L) break;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, cDy + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldp + ip * 16 + (mi / 2) * 8);
#pragma unroll
        for (int m = 0; m <= kk; ++m) {      // l >= s
          uint32_t mh[4], ml[4];
          ldmatrix_x4_trans(mh, cMhi + (kk * 16 + (mi >> 1) * 8 + lane % 8) * kLdL + m * 16 + (mi & 1) * 8);
          ldmatrix_x4_trans(ml, cMlo + (kk * 16 + (mi >> 1) * 8 + lane % 8) * kLdL + m * 16 + (mi & 1) * 8);
          mma_bf16(md[m][0], mh, bf[0], bf[1]);
          mma_bf16(md[m][0], ml, bf[0], bf[1]);
          mma_bf16(md[m][1], mh, bf[2], bf[3]);
          mma_bf16(md[m][1], ml, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = m * 16 + g8 + 8 * hh;
          const float tail = vec[kChunk + s], dts = vec[2 * kChunk + s];
          float xd = 0.f, tv = 0.f;
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
            const int p = ip * 16 + n8 * 8 + 2 * t4;
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cX + s * ldp + p));
            const float d0 = fmaf(tail, bd[m][n8][2 * hh], md[m][n8][2 * hh]);
            const float d1 = fmaf(tail, bd[m][n8][2 * hh + 1], md[m][n8][2 * hh + 1]);
            if (s < L)
              *reinterpret_cast<__nv_bfloat162*>(dxg + (long long)s * H * P + (long long)h * P + p) =
                  __floats2bfloat162_rn(d0 * dts, d1 * dts);
            xd = fmaf(xv.x, d0, xd);
            xd = fmaf(xv.y, d1, xd);
            tv = fmaf(xv.x, bd[m][n8][2 * hh], tv);
            tv = fmaf(xv.y, bd[m][n8][2 * hh + 1], tv);
          }
          xd += __shfl_xor_sync(0xffffffffu, xd, 1);
          xd += __shfl_xor_sync(0xffffffffu, xd, 2);
          tv += __shfl_xor_sync(0xffffffffu, tv, 1);
          tv += __shfl_xor_sync(0xffffffffu, tv, 2);
          if (t4 == 0) {
            sXD[ip * kChunk + s] = xd;
            sT[ip * kChunk + s] = tail * dts * tv;
          }
        }
    }
    // beside the products: head i - 1 finished, phase A of head i + 1
    if (aw == 3 && i > 0) finish(i - 1);
    if (unit && i + 1 < nh) phase_a(i + 1);
    __syncthreads();
  }
  if (aw == 3) finish(nh - 1);

  // dC, dB: this CTA's sums into the state buffers, then every CTA of the
  // cluster sums its share of the elements over the ranks in order
  float* sRed = reinterpret_cast<float*>(sSt);   // dC [32][N], dB [32][N]
#pragma unroll
  for (int q = 0; q < KT; ++q) {
    const int j = warp + nw * q;
    if (j >= nks) break;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (m * 16 + g8 + 8 * hh) * N + j * 16 + n8 * 8 + 2 * t4;
          *reinterpret_cast<float2*>(sRed + off) =
              make_float2(dC[q][m][n8][2 * hh], dC[q][m][n8][2 * hh + 1]);
          *reinterpret_cast<float2*>(sRed + kChunk * N + off) =
              make_float2(dB[q][m][n8][2 * hh], dB[q][m][n8][2 * hh + 1]);
        }
  }
  cluster_sync();
  for (int e = rank + hc * tid; e < 2 * kChunk * N / 4; e += hc * blockDim.x) {
    float4 sum = ld_cluster_f4(sRed + 4 * e, 0);
    for (int rr = 1; rr < hc; ++rr) {
      const float4 v = ld_cluster_f4(sRed + 4 * e, rr);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int which = 4 * e / (kChunk * N), l = (4 * e / N) % kChunk, n = 4 * e % N;
    if (l < L) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(which ? prm.db : prm.dc)
                           + (((long long)bi * S + t0 + l) * G + g) * N + n;
      uint2 packed;
      packed.x = pack_bf16(sum.x, sum.y);
      packed.y = pack_bf16(sum.z, sum.w);
      *reinterpret_cast<uint2*>(dst) = packed;
    }
  }
  // a peer's shared memory stays until every CTA has read it
  cluster_sync();
}

// d(a) (H,): the (batch, block, head) partials summed over batch and block
// in order
__global__ void __launch_bounds__(128) ssd_bwd_da_reduce_kernel(const BwdParams prm) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= prm.heads) return;
  const long long n = (long long)prm.batch * ((prm.seqlen + kChunk - 1) / kChunk);
  float s = 0.f;
  for (long long i = 0; i < n; ++i) s += prm.d_a_part[i * prm.heads + h];
  prm.d_a[h] = s;
}

// A kernel's dynamic shared memory, with all of the SM's 228 KB preferred
// as shared memory (more CTAs resident).
cudaError_t prefer_smem(const void* kernel, size_t smem) {
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// kernel(prm) over grid, in clusters of (cx, cy) CTAs.
template <typename Kernel>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads, size_t smem, int cx, int cy,
                             const BwdParams& prm, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, prm);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int KT>
cudaError_t launch_grads(const BwdParams& prm, int nb, cudaStream_t stream) {
  const auto kernel = ssd_bwd_grads_mma_kernel<KT>;
  const int P = prm.headdim, N = prm.dstate;
  const size_t smem = GradSmem(P, N, grad_bufs(P, N)).bytes;
  const int threads = 32 * grad_warps(P, N);
  cudaError_t e = prefer_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  // a cluster of hc CTAs splits a group's heads where one CTA per (batch,
  // block, group) would leave resident slots empty
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
      != cudaSuccess)
    return e;
  const long long ctas = (long long)prm.batch * nb * prm.groups;
  const int rep = prm.heads / prm.groups;
  int hc = 1;
  while (2 * hc <= 8 && 2 * hc <= rep && ctas * hc < (long long)per_sm * sms) hc *= 2;
  return launch_clustered(kernel, dim3(hc, nb, prm.batch * prm.groups), threads, smem, hc, 1,
                          prm, stream);
}

size_t bwd_mma_smem_bytes(int headdim, int dstate) {
  return GradSmem(headdim, dstate, grad_bufs(headdim, dstate)).bytes;
}

cudaError_t launch_bwd_mma(const BwdParams& prm, cudaStream_t stream) {
  // 16-row P tiles and 16-deep k-steps over N and P; 16-byte copies of
  // every row and state
  if (prm.headdim % 16 || prm.dstate % 16 || !aligned16(prm.x) || !aligned16(prm.b)
      || !aligned16(prm.c) || !aligned16(prm.dy) || !aligned16(prm.states)
      || (prm.init_state && !aligned16(prm.init_state))
      || (prm.d_final && !aligned16(prm.d_final)) || !aligned16(prm.d_init)
      || !aligned16(prm.dx) || !aligned16(prm.db) || !aligned16(prm.dc) || prm.x_sb % 8
      || prm.x_ss % 8 || prm.b_sb % 8 || prm.b_ss % 8 || prm.c_sb % 8 || prm.c_ss % 8)
    return cudaErrorInvalidValue;
  const int nb = (prm.seqlen + kChunk - 1) / kChunk;
  if (nb > 65535 || (long long)prm.batch * prm.groups > 65535) return cudaErrorInvalidValue;
  // 1. S0 and dS: both directions, clusters of a head's P tiles (and of
  // two heads of a group where that fits in 8), as the forward
  const size_t smem = StatesSmem(prm.dstate).bytes;
  cudaError_t e = prefer_smem((const void*)ssd_bwd_states_mma_kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = prm.headdim / kRows;
  int cluster = 1;
  while (cluster < 8 && tiles % (2 * cluster) == 0) cluster *= 2;
  const int heads_per_cluster = cluster <= 4 && (prm.heads / prm.groups) % 2 == 0 ? 2 : 1;
  e = launch_clustered(ssd_bwd_states_mma_kernel, dim3(tiles, prm.batch * prm.heads, 2),
                       kThreads, smem, cluster, heads_per_cluster, prm, stream);
  if (e != cudaSuccess) return e;
  // 2. the per-block gradients
  e = grad_kt(prm.dstate) == 1 ? launch_grads<1>(prm, nb, stream)
                                : launch_grads<2>(prm, nb, stream);
  if (e != cudaSuccess) return e;
  // 3. d(a)
  ssd_bwd_da_reduce_kernel<<<(prm.heads + 127) / 128, 128, 0, stream>>>(prm);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kTok = kChunk / kBwdWarps;     // a warp's tokens of a block
static_assert(kTok * kBwdWarps == kChunk, "the warps split a block's tokens evenly");

// Shared memory of the states kernel, in floats: the B block, the state
// tile, the block's x tile and the per-token weights dt_s exp(cs_last - cs_s).
__host__ __device__ inline size_t bwd_states_smem_floats(int dstate) {
  return (size_t)(kChunk + kRows) * (dstate + 1) + kChunk * kRows + kChunk + 1;
}

__global__ void __launch_bounds__(kThreads) ssd_scan_bwd_states_kernel(const BwdParams prm) {
  extern __shared__ float smem[];
  const int N = prm.dstate, ldn = N + 1;
  float* sB = smem;                     // [32][ldn]
  float* sState = sB + kChunk * ldn;    // [16][ldn]
  float* sX = sState + kRows * ldn;     // [32][16]
  float* sW = sX + kChunk * kRows;      // [32]
  float* sTotal = sW + kChunk;          // [1]
  const int tid = threadIdx.x;
  const int H = prm.heads, P = prm.headdim, S = prm.seqlen;
  const int bh = blockIdx.y, bi = bh / H, h = bh % H;
  const int p0 = blockIdx.x * kRows, rows = min(kRows, P - p0);
  const int g = h / (H / prm.groups);
  const int nb = (S + kChunk - 1) / kChunk;
  const float a = prm.a[h];
  const float* x = static_cast<const float*>(prm.x) + bi * prm.x_sb + (long long)h * P + p0;
  const float* b = static_cast<const float*>(prm.b) + bi * prm.b_sb + (long long)g * N;
  const float* dt = prm.dt + (long long)bi * S * H + h;
  for (int i = tid; i < kRows * N; i += kThreads) {
    const int r = i / N, n = i % N;
    float v = 0.f;
    if (prm.init_state != nullptr && r < rows)
      v = prm.init_state[((long long)bh * P + p0 + r) * N + n];
    sState[r * ldn + n] = v;
  }
  for (int k = 0; k < nb; ++k) {
    const int t0 = k * kChunk, L = min(kChunk, S - t0);
    float* out = static_cast<float*>(prm.states) + (((long long)bi * nb + k) * H + h) * P * N
                 + (long long)p0 * N;
    // the state at this block's start (each thread its own elements, read
    // by nobody else until the next barrier)
    for (int i = tid; i < rows * N; i += kThreads)
      out[i] = sState[(i / N) * ldn + i % N];
    if (k + 1 == nb) break;
    for (int i = tid; i < L * N; i += kThreads) {
      const int s = i / N, n = i % N;
      sB[s * ldn + n] = b[(long long)(t0 + s) * prm.b_ss + n];
    }
    for (int i = tid; i < L * kRows; i += kThreads) {
      const int s = i / kRows, r = i % kRows;
      sX[s * kRows + r] = r < rows ? x[(long long)(t0 + s) * prm.x_ss + r] : 0.f;
    }
    if (tid < 32) {
      const float d = tid < L ? dt[(long long)(t0 + tid) * H] : 0.f;
      const float cs = warp_cumsum(d * a, tid);
      const float last = __shfl_sync(0xffffffffu, cs, L - 1);
      sW[tid] = tid < L ? d * expf(last - cs) : 0.f;
      if (tid == 0) *sTotal = expf(last);
    }
    __syncthreads();
    const float total = *sTotal;
    for (int i = tid; i < kRows * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc = fmaf(sW[s] * sX[s * kRows + r], sB[s * ldn + n], acc);
      sState[r * ldn + n] = fmaf(sState[r * ldn + n], total, acc);
    }
    __syncthreads();
  }
}

// Shared memory of the backward kernel, in floats: B and C blocks, the
// start state and the carried dState (rows of N+1), x, x*dt and dy (rows of
// P+1), M, Q and G (rows of 33), eight per-token vectors and the per-warp
// partials of <dState, S0>.
__host__ __device__ inline size_t bwd_smem_floats(int headdim, int dstate) {
  return (size_t)(2 * kChunk + 2 * headdim) * (dstate + 1) + (size_t)3 * kChunk * (headdim + 1)
         + 3 * kChunk * (kChunk + 1) + 7 * kChunk + kBwdWarps;
}

__global__ void __launch_bounds__(kBwdThreads) ssd_scan_bwd_kernel(const BwdParams prm) {
  extern __shared__ float smem[];
  const int N = prm.dstate, P = prm.headdim, S = prm.seqlen, H = prm.heads;
  const int ldn = N + 1, ldp = P + 1, ldl = kChunk + 1;
  float* sB = smem;                    // [32][ldn]
  float* sC = sB + kChunk * ldn;       // [32][ldn]
  float* sS0 = sC + kChunk * ldn;      // [P][ldn] the state at the block's start
  float* sDS = sS0 + P * ldn;          // [P][ldn] d(the state at the block's end)
  float* sX = sDS + P * ldn;           // [32][ldp] x
  float* sXdt = sX + kChunk * ldp;     // [32][ldp] x dt
  float* sDy = sXdt + kChunk * ldp;    // [32][ldp] dy
  float* sM = sDy + kChunk * ldp;      // [32][ldl]
  float* sQ = sM + kChunk * ldl;       // [32][ldl]
  float* sG = sQ + kChunk * ldl;       // [32][ldl]
  float* sDt = sG + kChunk * ldl;      // [32]
  float* sCs = sDt + kChunk;           // [32] cumsum of dt a in the block
  float* sE = sCs + kChunk;            // [32] exp(cs_l)
  float* sTail = sE + kChunk;          // [32] exp(cs_last - cs_s)
  float* sDxX = sTail + kChunk;        // [32] x_s . dxdt_s
  float* sT = sDxX + kChunk;           // [32] T_s
  float* sYoff = sT + kChunk;          // [32] exp(cs_l) C_l.(dy_l S0)
  float* sRed = sYoff + kChunk;        // [warps]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int g = h / (H / prm.groups);
  const int nb = (S + kChunk - 1) / kChunk;
  const float a = prm.a[h];
  const float* x = static_cast<const float*>(prm.x) + bi * prm.x_sb + (long long)h * P;
  const float* b = static_cast<const float*>(prm.b) + bi * prm.b_sb + (long long)g * N;
  const float* c = static_cast<const float*>(prm.c) + bi * prm.c_sb + (long long)g * N;
  const float* dy = static_cast<const float*>(prm.dy) + ((long long)bi * S * H + h) * P;   // token stride H P
  float* dx = static_cast<float*>(prm.dx) + ((long long)bi * S * H + h) * P;
  const float* dt = prm.dt + (long long)bi * S * H + h;                                     // token stride H
  float* d_dt = prm.d_dt + (long long)bi * S * H + h;
  float* db_part = prm.db_part + ((long long)bi * S * H + h) * N;                   // token stride H N
  float* dc_part = prm.dc_part + ((long long)bi * S * H + h) * N;
  const long long state_off = (long long)bh * P * N;

  for (int i = tid; i < P * N; i += kBwdThreads) {
    const int p = i / N, n = i % N;
    sDS[p * ldn + n] = prm.d_final != nullptr ? prm.d_final[state_off + i] : 0.f;
  }
  float d_a_acc = 0.f;                 // warp 0: this lane's tokens' dt d(da)

  for (int k = nb - 1; k >= 0; --k) {
    const int t0 = k * kChunk, L = min(kChunk, S - t0);
    const float* st = static_cast<const float*>(prm.states) + (((long long)bi * nb + k) * H + h) * P * N;
    for (int i = tid; i < L * N; i += kBwdThreads) {
      const int s = i / N, n = i % N;
      sB[s * ldn + n] = b[(long long)(t0 + s) * prm.b_ss + n];
      sC[s * ldn + n] = c[(long long)(t0 + s) * prm.c_ss + n];
    }
    for (int i = tid; i < L * P; i += kBwdThreads) {
      const int s = i / P, p = i % P;
      const float xv = x[(long long)(t0 + s) * prm.x_ss + p];
      sX[s * ldp + p] = xv;
      sXdt[s * ldp + p] = xv * dt[(long long)(t0 + s) * H];
      sDy[s * ldp + p] = dy[(long long)(t0 + s) * H * P + p];
    }
    for (int i = tid; i < P * N; i += kBwdThreads) sS0[(i / N) * ldn + i % N] = st[i];
    if (warp == 0) {
      const float d = lane < L ? dt[(long long)(t0 + lane) * H] : 0.f;
      const float cs = warp_cumsum(d * a, lane);
      const float last = __shfl_sync(0xffffffffu, cs, L - 1);
      sDt[lane] = d;
      sCs[lane] = cs;
      sE[lane] = lane < L ? expf(cs) : 0.f;
      sTail[lane] = lane < L ? expf(last - cs) : 0.f;
    }
    __syncthreads();

    // Every warp owns the kTok tokens warp + 8 k of the block and works on
    // them together: kTok independent FMA chains a thread, each operand
    // loaded once for all of them. M, Q and G are zero where s > l or l >= L,
    // so the sums below run over the whole block without a bound per token.

    // M, Q, G: lane = s (B and x*dt rows read at strides of N+1 and P+1
    // words), the warp's rows l broadcast
    {
      const int s = lane;
      float cb[kTok] = {}, yx[kTok] = {};
      for (int n = 0; n < N; ++n) {
        const float bv = sB[s * ldn + n];
#pragma unroll
        for (int k = 0; k < kTok; ++k) cb[k] = fmaf(sC[(warp + kBwdWarps * k) * ldn + n], bv, cb[k]);
      }
      for (int p = 0; p < P; ++p) {
        const float xv = sXdt[s * ldp + p];
#pragma unroll
        for (int k = 0; k < kTok; ++k) yx[k] = fmaf(sDy[(warp + kBwdWarps * k) * ldp + p], xv, yx[k]);
      }
#pragma unroll
      for (int k = 0; k < kTok; ++k) {
        const int l = warp + kBwdWarps * k;
        const bool valid = l < L && s <= l;     // rows past L hold stale values
        const float w = valid ? expf(sCs[l] - sCs[s]) : 0.f;
        sM[l * ldl + s] = valid ? cb[k] * w : 0.f;
        sQ[l * ldl + s] = valid ? yx[k] * w : 0.f;
        sG[l * ldl + s] = valid ? cb[k] * w * yx[k] : 0.f;
      }
    }
    __syncthreads();

    // dxdt (and dx), x.dxdt and T for the warp's tokens s: lanes over P
    {
      float xd[kTok] = {}, xv[kTok] = {};
      for (int p = lane; p < P; p += 32) {
        float acc[kTok] = {}, v[kTok] = {};
        for (int l = 0; l < L; ++l) {
          const float dyv = sDy[l * ldp + p];
#pragma unroll
          for (int k = 0; k < kTok; ++k) acc[k] = fmaf(sM[l * ldl + warp + kBwdWarps * k], dyv, acc[k]);
        }
        for (int n = 0; n < N; ++n) {
          const float ds = sDS[p * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) v[k] = fmaf(ds, sB[(warp + kBwdWarps * k) * ldn + n], v[k]);
        }
#pragma unroll
        for (int k = 0; k < kTok; ++k) {
          const int s = warp + kBwdWarps * k;
          if (s >= L) continue;
          const float d = fmaf(sTail[s], v[k], acc[k]);
          dx[(long long)(t0 + s) * H * P + p] = d * sDt[s];
          xd[k] = fmaf(d, sX[s * ldp + p], xd[k]);
          xv[k] = fmaf(sXdt[s * ldp + p], v[k], xv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTok; ++k) {
        const int s = warp + kBwdWarps * k;
        const float a_ = warp_sum(xd[k]), b_ = warp_sum(xv[k]);
        if (lane == 0 && s < L) {
          sDxX[s] = a_;
          sT[s] = sTail[s] * b_;
        }
      }
    }
    // dC (this head's part) and exp(cs_l) C_l.(dy_l S0) for the warp's
    // tokens l, and dB (this head's part) for its tokens s: lanes over N
    {
      float cu[kTok] = {};
      for (int n = lane; n < N; n += 32) {
        float acc[kTok] = {}, u[kTok] = {};
        for (int s = 0; s < L; ++s) {
          const float bv = sB[s * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) acc[k] = fmaf(sQ[(warp + kBwdWarps * k) * ldl + s], bv, acc[k]);
        }
        for (int p = 0; p < P; ++p) {
          const float s0 = sS0[p * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) u[k] = fmaf(sDy[(warp + kBwdWarps * k) * ldp + p], s0, u[k]);
        }
#pragma unroll
        for (int k = 0; k < kTok; ++k) {
          const int l = warp + kBwdWarps * k;
          if (l >= L) continue;
          dc_part[(long long)(t0 + l) * H * N + n] = fmaf(sE[l], u[k], acc[k]);
          cu[k] = fmaf(sC[l * ldn + n], u[k], cu[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTok; ++k) {
        const int l = warp + kBwdWarps * k;
        const float c_ = warp_sum(cu[k]);
        if (lane == 0 && l < L) sYoff[l] = sE[l] * c_;
      }
      for (int n = lane; n < N; n += 32) {
        float acc[kTok] = {}, z[kTok] = {};
        for (int l = 0; l < L; ++l) {
          const float cv = sC[l * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) acc[k] = fmaf(sQ[l * ldl + warp + kBwdWarps * k], cv, acc[k]);
        }
        for (int p = 0; p < P; ++p) {
          const float ds = sDS[p * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) z[k] = fmaf(sXdt[(warp + kBwdWarps * k) * ldp + p], ds, z[k]);
        }
#pragma unroll
        for (int k = 0; k < kTok; ++k) {
          const int s = warp + kBwdWarps * k;
          if (s < L) db_part[(long long)(t0 + s) * H * N + n] = fmaf(sTail[s], z[k], acc[k]);
        }
      }
    }
    __syncthreads();

    // dState <- exp(cs_last) dState + sum_l exp(cs_l) dy_l (outer) C_l, and
    // <dState, S0> from the old values: thread t owns column n = t % N and
    // rows t / N + R j (R = the rows a pass covers), kTok rows at once
    const float total = sE[L - 1];
    float dot = 0.f;
    {
      const int R = kBwdThreads / N, n = tid % N;
      for (int p0 = tid / N; R > 0 && tid < R * N && p0 < P; p0 += kTok * R) {
        float acc[kTok] = {};
        for (int l = 0; l < L; ++l) {
          const float ec = sE[l] * sC[l * ldn + n];
#pragma unroll
          for (int k = 0; k < kTok; ++k) {
            const int p = min(p0 + R * k, P - 1);   // rows past P: computed, not kept
            acc[k] = fmaf(sDy[l * ldp + p], ec, acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kTok; ++k) {
          const int p = p0 + R * k;
          if (p >= P) continue;
          const float old = sDS[p * ldn + n];
          dot = fmaf(old, sS0[p * ldn + n], dot);
          sDS[p * ldn + n] = fmaf(total, old, acc[k]);
        }
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) sRed[warp] = dot;
    __syncthreads();

    // d(cs), its reverse cumsum d(da), d(dt) and d(a): warp 0, lane = token
    if (warp == 0) {
      float dcs = 0.f, t = 0.f;
      if (lane < L) {
        float row = 0.f, col = 0.f;
        for (int s = 0; s <= lane; ++s) row += sG[lane * ldl + s];
        for (int l = lane; l < L; ++l) col += sG[l * ldl + lane];
        t = sT[lane];
        dcs = row - col + sYoff[lane] - t;
      }
      const float t_sum = warp_sum(t);
      if (lane == L - 1) {
        float ds0 = 0.f;
        for (int w = 0; w < kBwdWarps; ++w) ds0 += sRed[w];
        dcs += total * ds0 + t_sum;
      }
      const float dda = warp_rcumsum(dcs, lane);
      if (lane < L) {
        d_dt[(long long)(t0 + lane) * H] = fmaf(a, dda, sDxX[lane]);
        d_a_acc = fmaf(dda, sDt[lane], d_a_acc);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kBwdThreads)
    prm.d_init[state_off + i] = sDS[(i / N) * ldn + i % N];
  if (warp == 0) {
    d_a_acc = warp_sum(d_a_acc);
    if (lane == 0) prm.d_a_part[bh] = d_a_acc;
  }
}

// db, dc (B, S, G, N) = the per-head partials summed over each group's
// heads in order; d(a) (H,) = its per-(batch, head) partials summed over
// the batch in order.
__global__ void __launch_bounds__(256) ssd_scan_bwd_reduce_kernel(const BwdParams prm) {
  const int H = prm.heads, G = prm.groups, N = prm.dstate, rep = H / G;
  const long long total = (long long)prm.batch * prm.seqlen * G * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int n = (int)(i % N), g = (int)((i / N) % G);
    const long long bs = i / ((long long)N * G);
    const long long base = (bs * H + (long long)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += prm.db_part[base + (long long)r * N];
      sc += prm.dc_part[base + (long long)r * N];
    }
    static_cast<float*>(prm.db)[i] = sb;
    static_cast<float*>(prm.dc)[i] = sc;
  }
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < H) {
    float sa = 0.f;
    for (int bi = 0; bi < prm.batch; ++bi) sa += prm.d_a_part[(long long)bi * H + j];
    prm.d_a[j] = sa;
  }
}

cudaError_t launch_bwd_fma(const BwdParams& prm, cudaStream_t stream) {
  const size_t smem1 = bwd_states_smem_floats(prm.dstate) * sizeof(float);
  const size_t smem2 = bwd_smem_floats(prm.headdim, prm.dstate) * sizeof(float);
  cudaError_t e = set_smem((const void*)ssd_scan_bwd_states_kernel, smem1);
  if (e != cudaSuccess) return e;
  e = set_smem((const void*)ssd_scan_bwd_kernel, smem2);
  if (e != cudaSuccess) return e;
  const dim3 grid1((prm.headdim + kRows - 1) / kRows, prm.batch * prm.heads);
  ssd_scan_bwd_states_kernel<<<grid1, kThreads, smem1, stream>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_scan_bwd_kernel<<<prm.batch * prm.heads, kBwdThreads, smem2, stream>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)prm.batch * prm.seqlen * prm.groups * prm.dstate;
  long long blocks = (n + 255) / 256;
  if (blocks < (prm.heads + 255) / 256) blocks = (prm.heads + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  ssd_scan_bwd_reduce_kernel<<<(int)blocks, 256, 0, stream>>>(prm);
  return cudaGetLastError();
}
}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel; P and N multiples of 16, x/b/c rows and the states 16-byte
// aligned). Strides are in elements. Returns the launch's cudaError_t
// (0 = success).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    const void* init_state, void* y, void* final_state,
    int batch, int seqlen, int heads, int headdim, int groups, int dstate,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || headdim <= 0 || groups <= 0
      || heads % groups != 0 || dstate <= 0 || dstate > kMaxState
      || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.x = x;
  prm.dt = static_cast<const float*>(dt);
  prm.a = static_cast<const float*>(a);
  prm.b = b;
  prm.c = c;
  prm.init_state = static_cast<const float*>(init_state);
  prm.y = y;
  prm.final_state = static_cast<float*>(final_state);
  prm.batch = batch;
  prm.seqlen = seqlen;
  prm.heads = heads;
  prm.headdim = headdim;
  prm.groups = groups;
  prm.dstate = dstate;
  prm.x_sb = x_sb;
  prm.x_ss = x_ss;
  prm.b_sb = b_sb;
  prm.b_ss = b_ss;
  prm.c_sb = c_sb;
  prm.c_ss = c_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_fma(prm, st);
  else if (dtype == 1)
    e = launch_mma(prm, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// Bytes of shared memory a backward CTA takes at (headdim, dstate): the
// fp32 backward kernel's (dtype 0, all of P at once) or the bf16 gradients
// kernel's (dtype 1); ssd_scan_bwd_launch refuses more than 232448 (227 KB).
extern "C" long long ssd_scan_bwd_smem_bytes(int headdim, int dstate, int dtype) {
  if (dtype == 1) return (long long)bwd_mma_smem_bytes(headdim, dstate);
  return (long long)(bwd_smem_floats(headdim, dstate) * sizeof(float));
}

// The backward: dx (B, S, H, P) and db, dc (B, S, G, N) in x's dtype,
// d_dt (B, S, H), d_a (H,) and d_init (B, H, P, N) in fp32, from dy (B, S,
// H, P) dense in x's dtype and d_final (B, H, P, N) fp32 or null (zeros).
// Scratch: dtype 0 (float32, FMAs) takes states (B, ceil(S/32), H, P, N)
// fp32, d_a_part (B, H) and db_part, dc_part (B, S, H, N) fp32; dtype 1
// (bfloat16, the tensor cores; P and N multiples of 16, rows and states
// 16-byte aligned) takes states (2, B, ceil(S/32), H, 2, P, N) bf16 (S0 and
// dS split into hi and lo) and d_a_part (B, ceil(S/32), H) fp32, and
// db_part, dc_part null. Returns the launches'
// cudaError_t (0 = success).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    const void* init_state, const void* dy, const void* d_final, void* states,
    void* dx, void* d_dt, void* d_a_part, void* db_part, void* dc_part, void* d_init,
    void* db, void* dc, void* d_a,
    int batch, int seqlen, int heads, int headdim, int groups, int dstate,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || headdim <= 0 || groups <= 0
      || heads % groups != 0 || dstate <= 0 || dstate > kMaxState
      || (long long)batch * heads > 65535 || (dtype != 0 && dtype != 1)
      || ssd_scan_bwd_smem_bytes(headdim, dstate, dtype) > 232448)
    return (int)cudaErrorInvalidValue;
  BwdParams prm;
  prm.x = x;
  prm.dt = static_cast<const float*>(dt);
  prm.a = static_cast<const float*>(a);
  prm.b = b;
  prm.c = c;
  prm.init_state = static_cast<const float*>(init_state);
  prm.dy = dy;
  prm.d_final = static_cast<const float*>(d_final);
  prm.states = states;
  prm.dx = dx;
  prm.d_dt = static_cast<float*>(d_dt);
  prm.d_a_part = static_cast<float*>(d_a_part);
  prm.db_part = static_cast<float*>(db_part);
  prm.dc_part = static_cast<float*>(dc_part);
  prm.d_init = static_cast<float*>(d_init);
  prm.db = db;
  prm.dc = dc;
  prm.d_a = static_cast<float*>(d_a);
  prm.batch = batch;
  prm.seqlen = seqlen;
  prm.heads = heads;
  prm.headdim = headdim;
  prm.groups = groups;
  prm.dstate = dstate;
  prm.x_sb = x_sb;
  prm.x_ss = x_ss;
  prm.b_sb = b_sb;
  prm.b_ss = b_ss;
  prm.c_sb = c_sb;
  prm.c_ss = c_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_bwd_fma(prm, st) : launch_bwd_mma(prm, st));
}

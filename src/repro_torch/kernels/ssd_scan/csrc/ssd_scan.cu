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
// Design. The TPU grid walks (batch*head, chunk) in order and carries the
// state in VMEM across grid steps. Here one CTA owns one (batch*head, tile of
// kRows rows of P): the state rows of a tile are independent, so at the
// serving shape (H 80, P 64) the grid has 320 CTAs for the card's 132 SMs.
// The CTA keeps its (kRows, N) state in shared memory and walks the sequence
// itself in blocks of kChunk tokens (its own block, not the model's
// ssm_chunk: a 256x256 fp32 decay tile would not fit in shared memory). Per
// block it stages B, C (kChunk x N, rows padded to N+1 words so lanes that
// walk different rows hit different banks), its x*dt tile and the cumsum of
// dt*a (one warp, shuffle scan); forms C.B^T (.) decay for s <= l (recomputed
// per P tile: cheap); writes y = that . x*dt + exp(cs) (C . state^T); then
// updates the state. No atomics, and every sum runs in a fixed order, so the
// result is a pure function of the inputs and S: the engine's hit-vs-cold
// bit equality rests on it.
//
// What bounds it. At the serving shape (B 1, S 32, H 80, P 64, N 128) the
// function must read and write 5.2 MB of fp32 state and ~0.7 MB of x, y, b,
// c, dt: ~1.8 us at 3.35 TB/s; its ~115 MFLOP need ~1.7 us of the CUDA
// cores' fp32 rate. This first version stages with plain loads and computes
// with FMAs on the CUDA cores; mma.sync/wgmma for C.B^T and the state
// products, and cp.async/TMA staging, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;   // tokens per block step: one warp scans them
constexpr int kRows = 16;    // rows of P per CTA
constexpr int kMaxState = 256;

static_assert(kChunk == 32, "the cumsum is one warp's shuffle scan");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// Shared memory, in floats: B and C blocks, the state tile (rows of N+1),
// the C.B^T tile (rows of kChunk+1), the x*dt tile, and per-token cumsum,
// exp(cumsum) and tail-decay vectors.
__host__ __device__ inline size_t smem_floats(int dstate) {
  return (size_t)(2 * kChunk + kRows) * (dstate + 1) + kChunk * (kChunk + 1)
         + kChunk * kRows + 3 * kChunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params prm) {
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
  const T* x = static_cast<const T*>(prm.x) + bi * prm.x_sb + (long long)h * P + p0;
  const T* b = static_cast<const T*>(prm.b) + bi * prm.b_sb + (long long)g * N;
  const T* c = static_cast<const T*>(prm.c) + bi * prm.c_sb + (long long)g * N;
  const float* dt = prm.dt + (long long)bi * S * H + h;        // token stride H
  T* y = static_cast<T*>(prm.y) + ((long long)bi * S * H + h) * P + p0;  // stride H*P
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
      sB[s * ldn + n] = to_float(b[(long long)(t0 + s) * prm.b_ss + n]);
      sC[s * ldn + n] = to_float(c[(long long)(t0 + s) * prm.c_ss + n]);
    }
    for (int i = tid; i < L * kRows; i += kThreads) {
      const int s = i / kRows, r = i % kRows;
      float v = 0.f;
      if (r < rows)
        v = to_float(x[(long long)(t0 + s) * prm.x_ss + r])
            * dt[(long long)(t0 + s) * H];
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
      from_float(y + (long long)(t0 + l) * H * P + r, acc + off * sE[l]);
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

template <typename T>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = smem_floats(prm.dstate) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((prm.headdim + kRows - 1) / kRows, prm.batch * prm.heads);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y). Strides are in elements.
// Returns the launch's cudaError_t (0 = success).
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
    e = launch<float>(prm, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(prm, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

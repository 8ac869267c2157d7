// RWKV-6 WKV recurrence in chunk-parallel form, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv.py :: wkv / _wkv_kernel
// (pl.pallas_call at wkv.py:86). Computes what the plain version
// repro_torch.layers.rwkv.wkv_chunk_parallel computes, for one (b, h) row:
//
//   per chunk of C = 32 steps, with cl the exclusive cumsum of the log
//   decay wl, ci = cl + wl, ce = ci[C-1], mid = cl[C/2]:
//     y  = (r e^cl) S  +  tril_{-1}(r e^(cl-mid) . (k e^min(mid-ci, 60))^T) v
//          + (sum_n r u k) v
//     S' = e^ce S + (k e^min(ce-ci, 0))^T v
//
// Inputs r, k, v, wl are (BH, T, N) f32, u (BH, N), the state (BH, N, N)
// f32; outputs y (BH, T, N) and the final state. T % 32 == 0.
//
// What bounds it on the H100: at the serving path's shape (B 4 x H 40 rows,
// T 128, N 64) it reads 21 MB of r, k, v, wl, writes 5 MB of y and moves
// 5 MB of state: 9.4 us at 3.35 TB/s, against 0.42 GFLOP of f32 products
// (6.3 us at 67 TFLOP/s). Both are small; the kernel is bound by latency:
// four dependent chunk steps, each a handful of synchronised phases.
//
// Design: one 256-thread block per (b, h) row, as the reference's grid;
// the (N, N) f32 state stays in shared memory across all chunks (16 KB at
// N = 64, 64 KB at N = 128), so it is read and written once. Each chunk
// stages its r, k, v, wl tiles in shared memory (rows padded to N + 1, an
// odd stride, so a warp reading one column of 32 rows hits 32 banks), then
//   1. the bonus diagonal (one warp per step, shuffle-reduced) and the
//      per-column cumsum of the log decay;
//   2. the four decay-scaled tiles r e^cl, r e^(cl-mid), k e^(mid-ci) and
//      k e^(ce-ci), elementwise, with expf (not __expf, no fast math) and
//      the reference's clips at 60 and 0;
//   3. the strictly causal (C, C) matrix A;
//   4. y = y1 + y2, written once;
//   5. the state update in place.
// All arithmetic is f32 FMAs on the CUDA cores. Shared memory per block is
// 4 * (6 C (N+1) + N^2 + C^2 + C + N) bytes (kernels/wkv.py smem_bytes),
// 70.8 KB at N = 64 (three blocks an SM) and 169 KB at N = 128, set above
// 48 KB with cudaFuncAttributeMaxDynamicSharedMemorySize. A simple kernel
// that is right comes first: the path's grid is 160 blocks on 132 SMs, and
// a later version can split the value columns m across blocks.
//
// Build: kernels/build.py compiles this file with nvcc into its own shared
// library; repro_wkv is the C entry point.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int C = 32;  // CHUNK, the reference's
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

size_t smem_bytes(int N) {
  return sizeof(float) *
         (6 * static_cast<size_t>(C) * (N + 1) + static_cast<size_t>(N) * N +
          C * C + C + N);
}

__global__ void __launch_bounds__(THREADS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ wl,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int T, int N) {
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 1;
  float* R = smem;          // [C][ld]  r, then r e^cl
  float* RM = R + C * ld;   // [C][ld]  r e^(cl - mid)
  float* K = RM + C * ld;   // [C][ld]  k, then k e^min(ce - ci, 0)
  float* KI = K + C * ld;   // [C][ld]  k e^min(mid - ci, 60)
  float* V = KI + C * ld;   // [C][ld]  v
  float* W = V + C * ld;    // [C][ld]  wl, then cl
  float* S = W + C * ld;    // [N][N]   the state
  float* A = S + N * N;     // [C][C]   strictly causal intra-chunk matrix
  float* D = A + C * C;     // [C]      bonus diagonal sum_n r u k
  float* CE = D + C;        // [N]      chunk-end cumulative log decay

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t bh = blockIdx.x;
  const float* ub = u + bh * N;
  const size_t nn = static_cast<size_t>(N) * N;
  for (int e = tid; e < N * N; e += THREADS) S[e] = s0[bh * nn + e];

  for (int t0 = 0; t0 < T; t0 += C) {
    const size_t base = (bh * T + t0) * N;
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, o = t * ld + (e - t * N);
      R[o] = r[base + e];
      K[o] = k[base + e];
      V[o] = v[base + e];
      W[o] = wl[base + e];
    }
    __syncthreads();

    // 1. bonus diagonal, one warp per step; cumsum, one thread per column
    for (int t = warp; t < C; t += WARPS) {
      float acc = 0.f;
      for (int n = lane; n < N; n += 32) acc += R[t * ld + n] * ub[n] * K[t * ld + n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) D[t] = acc;
    }
    for (int n = tid; n < N; n += THREADS) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float w = W[t * ld + n];
        W[t * ld + n] = run;  // cl[t], exclusive
        run += w;
      }
      CE[n] = run;
    }
    __syncthreads();

    // 2. decay-scaled tiles; ci[t] = cl[t + 1], and ce for the last step
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, n = e - t * N, o = t * ld + n;
      const float cl = W[o];
      const float ci = t + 1 < C ? W[o + ld] : CE[n];
      const float mid = W[(C / 2) * ld + n];
      const float rv = R[o], kv = K[o];
      R[o] = rv * expf(cl);
      RM[o] = rv * expf(cl - mid);
      KI[o] = kv * expf(fminf(mid - ci, 60.f));
      K[o] = kv * expf(fminf(CE[n] - ci, 0.f));
    }
    __syncthreads();

    // 3. A[t][s] = sum_n r e^(cl-mid)[t,n] k e^(mid-ci)[s,n] for s < t
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e - t * C;
      float acc = 0.f;
      if (s < t)
        for (int n = 0; n < N; ++n) acc += RM[t * ld + n] * KI[s * ld + n];
      A[e] = acc;
    }
    __syncthreads();

    // 4. y[t][m] = sum_n r e^cl[t,n] S[n,m] + sum_{s<t} A[t,s] v[s,m] + D[t] v[t,m]
    for (int e = tid; e < C * N; e += THREADS) {
      const int t = e / N, m = e - t * N;
      float y1 = 0.f, y2 = 0.f;
      for (int n = 0; n < N; ++n) y1 += R[t * ld + n] * S[n * N + m];
      for (int s = 0; s < t; ++s) y2 += A[t * C + s] * V[s * ld + m];
      y2 += D[t] * V[t * ld + m];
      y[base + e] = y1 + y2;
    }
    __syncthreads();

    // 5. S[n][m] = e^ce[n] S[n][m] + sum_s k e^(ce-ci)[s,n] v[s,m]
    for (int e = tid; e < N * N; e += THREADS) {
      const int n = e / N, m = e - n * N;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += K[s * ld + n] * V[s * ld + m];
      S[e] = expf(CE[n]) * S[e] + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < N * N; e += THREADS) s_out[bh * nn + e] = S[e];
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* wl, const void* u, const void* s0,
                         void* y, void* s_out, int BH, int T, int N,
                         void* stream) {
  if (BH <= 0 || N <= 0 || T < 0 || T % C != 0) return cudaErrorInvalidValue;
  static int smem_optin = -1;  // one attribute call per process
  if (smem_optin < 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    smem_optin = optin;
  }
  const size_t smem = smem_bytes(N);
  if (smem > static_cast<size_t>(smem_optin)) return cudaErrorInvalidValue;
  wkv_kernel<<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(wl),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T, N);
  return cudaGetLastError();
}

// Fat GEMM with the fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/matmul.py :: matmul / _mm_kernel
// (pl.pallas_call at matmul.py:193).
//
//   C[M,N] = cast(round?(act(acc * out_scale + bias)))   acc = A[M,K] . B
//
// B is (K, N) for b_col == 0 ("row") or (N, K) for b_col != 0 ("col").
// Epilogue order is the reference's (matmul.py:87-101): requant out_scale ->
// bias in f32 (without a scale, bias adds to the raw accumulator) ->
// activation -> rint when the output is an int and a scale was given ->
// saturating cast.
//
// What bounds it on the H100: the main path multiplies a bf16 activation by
// an f32 weight. The reference promotes A to f32 and takes a full-f32
// product, so this kernel runs f32 FMAs on the CUDA cores (67 TFLOP/s
// dense, not the tensor cores, not TF32). Prefill GEMMs (M = 512) are bound
// by those operations; decode GEMMs (M = batch) are bound by reading the f32
// weight once from HBM (3.35 TB/s).
//
// Design: one 256-thread block owns one (BM, BN) output tile and walks K in
// steps of the plan's bk. Each step stages the A and B slices through
// dynamic shared memory, already converted to the accumulator type (f32, or
// i32 for int8 x int8), so the inner loop is pure FMAs on registers; each
// thread keeps 8 staging loads in flight, since one block per SM cannot
// hide a global load's latency any other way. Rows of
// the staged tiles are padded by one element so neither the transposing
// stores nor the inner-loop reads conflict on shared-memory banks. Each
// thread holds a (BM/16) x (BN/16) accumulator in registers; the epilogue
// runs once on it and the output is written once. Ragged M, N and K edges
// are masked with zeros on load and skipped on store, so no operand is ever
// padded or copied. The tile set (BM in {16, 32, 64, 128}, BN in {64, 128},
// at most 64 accumulators a thread) is exactly the set the h100 planner
// offers; BM = 16 keeps decode GEMMs (M = batch) from wasting FMAs on
// masked rows. Shared memory per block is bk * ((BM+1) + (BN+1)) * 4 bytes,
// the planner's working-set model, set above 48 KB with
// cudaFuncAttributeMaxDynamicSharedMemorySize. No wgmma, TMA or
// multi-stage pipeline yet: a simple kernel that is right comes first.
//
// Build: kernels/build.py compiles this file once per part, in parallel,
// and links the objects into one shared library: -DREPRO_PART=1, 2, 3
// instantiate the kernels for A = bf16, f32, int8; part 0 holds the C entry
// point that dispatches to them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#ifndef REPRO_PART
#define REPRO_PART 0
#endif

namespace repro_mm {

enum DType { F32 = 0, BF16 = 1, I8 = 2, I16 = 3, I32 = 4 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU2 = 2, ACT_GELU = 3, ACT_SILU = 4 };

struct Args {
  const void* a;
  const void* b;
  const float* bias;   // (N,) f32 or null
  const float* scale;  // (N,) f32 or null
  void* out;
  int M, K, N, bm, bk, bn, b_type, out_type, b_col, act;
  cudaStream_t stream;
};

// One per part: the instantiations for one A type.
cudaError_t run_a_bf16(const Args& p);
cudaError_t run_a_f32(const Args& p);
cudaError_t run_a_i8(const Args& p);

}  // namespace repro_mm

namespace {

using namespace repro_mm;

constexpr int THREADS = 256;  // a 16 x 16 grid of threads over the tile

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float cvt(float v) { return v; }
__device__ __forceinline__ float cvt(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int cvt(int8_t v) { return static_cast<int>(v); }

__device__ __forceinline__ float act_f(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_RELU2: { float r = fmaxf(x, 0.f); return r * r; }
    case ACT_GELU: {  // tanh approximation, jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.f + expf(-x));
    default: return x;
  }
}

__device__ __forceinline__ int act_i(int x, int act) {
  switch (act) {
    case ACT_RELU: return max(x, 0);
    case ACT_RELU2: { int r = max(x, 0); return r * r; }
    default: return x;  // gelu / silu on an int accumulator: refused by the wrapper
  }
}

// The epilogue of one output element from an f32 value (float accumulator,
// or an i32 one with a requant scale): scale, bias, activation, rint before
// an int cast when scaled, saturating store. Out of line: inlined into the
// unrolled TM x TN loop, its branches multiplied the code and the build time.
__device__ __noinline__ void emit_f(void* out, size_t o, float v, int gn,
                                    const float* scale, const float* bias,
                                    int act, int ot) {
  // separate roundings, never a fused multiply-add: the reference rounds
  // the requantized value before it adds the bias
  if (scale != nullptr) v = __fmul_rn(v, scale[gn]);
  if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
  v = act_f(v, act);
  if (ot == F32) { static_cast<float*>(out)[o] = v; return; }
  if (ot == BF16) { static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v); return; }
  if (scale != nullptr) v = rintf(v);  // half to even, like jnp.round
  if (ot == I8) {
    static_cast<int8_t*>(out)[o] = static_cast<int8_t>(fminf(fmaxf(v, -128.f), 127.f));
  } else if (ot == I16) {
    static_cast<int16_t*>(out)[o] =
        static_cast<int16_t>(fminf(fmaxf(v, -32768.f), 32767.f));
  } else {
    static_cast<int32_t*>(out)[o] = __float2int_rz(v);  // saturates on overflow
  }
}

// The epilogue of one element of an i32 accumulator without requant: the
// bias adds in the i32 domain, as the reference's bias.astype(int32) does.
__device__ __noinline__ void emit_i(void* out, size_t o, int v, int gn,
                                    const float* bias, int act, int ot) {
  if (bias != nullptr) v += __float2int_rz(bias[gn]);
  v = act_i(v, act);
  if (ot == F32) static_cast<float*>(out)[o] = static_cast<float>(v);
  else if (ot == BF16) static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(static_cast<float>(v));
  else if (ot == I8) static_cast<int8_t*>(out)[o] = static_cast<int8_t>(min(max(v, -128), 127));
  else if (ot == I16) static_cast<int16_t*>(out)[o] = static_cast<int16_t>(min(max(v, -32768), 32767));
  else static_cast<int32_t*>(out)[o] = v;
}

// Stage an R x C slice of a global matrix (C contiguous, row stride ld,
// starting at (r0, c0); zeros beyond (rmax, cmax)) into shared memory as
// the accumulator type, at dst[c * sld + r] when transposed, else
// dst[r * sld + c]. Neighbouring threads take neighbouring c (C is a
// multiple of 32, so a warp reads one contiguous run), and each thread
// issues LOADS loads before it stores any, so they are in flight together.
constexpr int LOADS = 8;

template <typename T, typename AccT>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t ld,
                                      int r0, int rmax, int c0, int cmax,
                                      int R, int C, AccT* dst, int sld,
                                      bool transposed) {
  const int total = R * C;
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * LOADS) {
    AccT v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / C, c = e - r * C;
      v[u] = AccT(0);
      if (e < total && r0 + r < rmax && c0 + c < cmax)
        v[u] = cvt(src[static_cast<size_t>(r0 + r) * ld + c0 + c]);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * THREADS;
      if (e >= total) break;
      const int r = e / C, c = e - r * C;
      dst[transposed ? c * sld + r : r * sld + c] = v[u];
    }
  }
}

template <int BM, int BN, typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
          const float* __restrict__ bias, const float* __restrict__ scale,
          void* __restrict__ out, int M, int K, int N, int bk, int b_col,
          int act, int out_type) {
  using AccT = typename AccOf<TA>::type;
  constexpr bool kFloatAcc = std::is_same<AccT, float>::value;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BM + 1, LDB = BN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* As = reinterpret_cast<AccT*>(smem_raw);  // [bk][LDA], A transposed
  AccT* Bs = As + static_cast<size_t>(bk) * LDA;  // [bk][LDB]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  AccT acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = AccT(0);

  for (int k0 = 0; k0 < K; k0 += bk) {
    stage(a, K, m0, M, k0, K, BM, bk, As, LDA, true);      // A (M, K)
    if (b_col)
      stage(b, K, n0, N, k0, K, BN, bk, Bs, LDB, true);    // B (N, K)
    else
      stage(b, N, k0, K, n0, N, bk, BN, Bs, LDB, false);   // B (K, N)
    __syncthreads();
    const int kmax = min(bk, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      AccT av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm >= M || gn >= N) continue;
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (kFloatAcc || scale != nullptr)
        emit_f(out, o, static_cast<float>(acc[i][j]), gn, scale, bias, act,
               out_type);
      else
        emit_i(out, o, static_cast<int>(acc[i][j]), gn, bias, act, out_type);
    }
  }
}

template <int BM, int BN, typename TA, typename TB>
cudaError_t launch(const Args& p) {
  using AccT = typename AccOf<TA>::type;
  auto kern = mm_kernel<BM, BN, TA, TB>;
  static int smem_optin = -1;  // one attribute call per instantiation
  if (smem_optin < 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    smem_optin = optin;
  }
  const size_t smem = static_cast<size_t>(p.bk) * ((BM + 1) + (BN + 1)) * sizeof(AccT);
  if (smem > static_cast<size_t>(smem_optin)) return cudaErrorInvalidValue;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const TA*>(p.a), static_cast<const TB*>(p.b), p.bias, p.scale,
      p.out, p.M, p.K, p.N, p.bk, p.b_col, p.act, p.out_type);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t by_tile(const Args& p) {
#define REPRO_TILE(BM_, BN_) \
  if (p.bm == BM_ && p.bn == BN_) return launch<BM_, BN_, TA, TB>(p);
  REPRO_TILE(16, 64) REPRO_TILE(16, 128) REPRO_TILE(32, 64) REPRO_TILE(32, 128)
  REPRO_TILE(64, 64) REPRO_TILE(64, 128) REPRO_TILE(128, 64) REPRO_TILE(128, 128)
#undef REPRO_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

#if REPRO_PART == 1
cudaError_t repro_mm::run_a_bf16(const Args& p) {
  if (p.b_type == F32) return by_tile<__nv_bfloat16, float>(p);
  if (p.b_type == BF16) return by_tile<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 2
cudaError_t repro_mm::run_a_f32(const Args& p) {
  if (p.b_type == F32) return by_tile<float, float>(p);
  if (p.b_type == BF16) return by_tile<float, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 3
cudaError_t repro_mm::run_a_i8(const Args& p) {
  if (p.b_type == I8) return by_tile<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#else
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int repro_matmul(const void* a, const void* b, const void* bias,
                            const void* scale, void* out, int M, int K, int N,
                            int bm, int bk, int bn, int a_type, int b_type,
                            int out_type, int b_col, int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || bk % 32 != 0)
    return cudaErrorInvalidValue;
  const repro_mm::Args p{a, b, static_cast<const float*>(bias),
                         static_cast<const float*>(scale), out, M, K, N, bm,
                         bk, bn, b_type, out_type, b_col, act,
                         static_cast<cudaStream_t>(stream)};
  switch (a_type) {
    case repro_mm::BF16: return repro_mm::run_a_bf16(p);
    case repro_mm::F32: return repro_mm::run_a_f32(p);
    case repro_mm::I8: return repro_mm::run_a_i8(p);
    default: return cudaErrorInvalidValue;
  }
}
#endif

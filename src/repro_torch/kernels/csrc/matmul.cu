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
// saturating cast. Every route runs this one epilogue (emit_f / emit_i) on
// an f32 (i32) accumulator, writes each output once, and masks ragged M, N
// and K itself: no operand is ever padded or copied. One call is one launch.
//
// Four routes. The wrapper (kernels/matmul.py, route()) picks one by a rule
// on M, the dtypes, B's layout and the 16-byte alignment of the strides and
// base pointers, before the launch; a route is never taken because another
// failed.
//
// 1. Tensor cores, A bf16 x B f32 or bf16, M > 32 (every prefill GEMM).
//    Bound: operations. The reference promotes a bf16 x f32 product to full
//    f32, which the tensor cores do not take. So a split warpgroup cuts each
//    staged f32 B tile once into three bf16 terms by truncation,
//    B1 = hi16(B), B2 = hi16(B - B1), B3 = B - B1 - B2 (each difference is
//    exact, and B3 fits 8 bits): B1 + B2 + B3 == B for every f32 of
//    magnitude at least 2^-110 (kernels/ref.py, split_bf16x3). A bf16 x
//    bf16 product is exact in f32, so A.B1 + A.B2 + A.B3 is the f32 product
//    up to summation order, at 989/3 TFLOP/s instead of 67. wgmma rounds
//    each accumulate by truncation, so B1's term and the two small terms
//    go to two accumulators, added once at the end: the f32 result errs no
//    more than a bf16 B's would. A bf16 B is one term, loaded by TMA
//    straight into its swizzled tile. Design: TMA fills rings of shared-
//    memory stages (A (BM x 64) and B (64 x 128), 128-byte swizzle; out-of-
//    bounds boxes are zero-filled, which masks ragged M, N and K), mbarriers
//    pass each stage on, and one or two consumer warpgroups (BM = 64 or
//    128) issue wgmma m64n128k16 from shared memory with f32 accumulators in
//    registers. B row layout is wgmma's MN-major operand, B col layout its
//    K-major one, so neither is transposed. An f32 B has a staging ring of
//    its own, freed as soon as it is split, and a ring of split terms; the
//    split warpgroup's first thread issues the loads. The epilogue stages
//    the tile through shared memory: each thread keeps one column (its
//    scale and bias in registers) and walks the rows, so each warp writes
//    whole rows, and the activation is chosen once a tile.
// 2. Split-K streaming, M <= 32, any dtypes (the decode-shaped fat GEMMs).
//    Bound: reading B from HBM once. B streams once per group of 8 rows with
//    16-byte loads (scalar loads when not aligned); K is split across
//    blockIdx.y until the grid holds ~2 blocks per SM. Each split writes an
//    f32 (i32) partial into a workspace the wrapper allocates; the last
//    block of each output tile, found by an atomic ticket, sums the partials
//    in split order (deterministic) and runs the epilogue, then resets its
//    ticket (the wrapper keeps the tickets per device, zeroed once).
// 3. Tensor cores, int8 x int8, B col layout, M > 32 (the W8A8 path).
//    Bound: operations at 1,979 TOP/s. wgmma s8 needs both operands K-major,
//    which a (N, K) int8 weight is; the same rings as route 1 with k32
//    steps and i32 accumulators; the requant epilogue stays exact.
// 4. CUDA cores, everything else (f32 A, int8 B row, strides or pointers
//    not 16-byte aligned for TMA). One 256-thread block per (BM, BN) tile
//    walks K in steps of the plan's bk, staging A and B through shared
//    memory in the 4-byte accumulator type; f32 FMAs (i32 for int8). Bound:
//    operations at 67 TFLOP/s.
//
// Build: kernels/build.py compiles this file once per part, in parallel,
// and links the objects into one shared library: -DREPRO_PART=1..9
// instantiate the kernels of one route and type each; part 0 holds the C
// entry point that dispatches to them.

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled: looked up at run time)
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
enum Route { TENSOR_CORE = 1, SPLIT_K = 2, TENSOR_CORE_INT8 = 3, CUDA_CORE = 4 };

struct Args {
  const void* a;
  const void* b;
  const float* bias;   // (N,) f32 or null
  const float* scale;  // (N,) f32 or null
  void* out;
  void* ws;            // split-K partials (splits, M, N) f32 / i32
  unsigned* tickets;   // split-K: one zeroed counter per output tile
  int M, K, N, bm, bk, bn, b_type, out_type, b_col, act;
  int splits, k_per_split, vec_ok;
  cudaStream_t stream;
};

// One per part.
cudaError_t run_core_bf16(const Args& p);
cudaError_t run_core_f32(const Args& p);
cudaError_t run_core_i8(const Args& p);
cudaError_t run_split_k_bf16(const Args& p);
cudaError_t run_split_k_other(const Args& p);
cudaError_t run_tc_f32_row(const Args& p);
cudaError_t run_tc_f32_col(const Args& p);
cudaError_t run_tc_bf16(const Args& p);
cudaError_t run_tc_i8(const Args& p);

}  // namespace repro_mm

namespace {

using namespace repro_mm;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float cvt(float v) { return v; }
__device__ __forceinline__ float cvt(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int cvt(int8_t v) { return static_cast<int>(v); }

// The activation, fixed at compile time (A: Act).
template <int A>
__device__ __forceinline__ float act_c(float x) {
  if constexpr (A == ACT_RELU) return fmaxf(x, 0.f);
  if constexpr (A == ACT_RELU2) { const float r = fmaxf(x, 0.f); return r * r; }
  if constexpr (A == ACT_GELU) {  // tanh approximation, jax.nn.gelu's default
    // in the plain version's order (torch's gelu(approximate="tanh"):
    // x^3 first, then x + kappa x^3), so an int8 x int8 product, exact in
    // i32, leaves this epilogue bit-equal to it
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float x3 = x * x * x;
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x3)));
  }
  if constexpr (A == ACT_SILU) return x / (1.f + expf(-x));
  return x;
}
template <int A>
__device__ __forceinline__ int act_c(int x) {
  if constexpr (A == ACT_RELU) return max(x, 0);
  if constexpr (A == ACT_RELU2) { const int r = max(x, 0); return r * r; }
  return x;  // gelu / silu on an int accumulator: refused by the wrapper
}

// The epilogue of one output element from an f32 value (float accumulator,
// or an i32 one with a requant scale): scale, bias, activation, rint before
// an int cast when scaled, saturating store.
// `sv` / `bv`: the column's scale and bias when `scaled` / `biased`.
template <int A>
__device__ __forceinline__ void epi_f(void* out, size_t o, float v, bool scaled,
                                      float sv, bool biased, float bv, int ot) {
  // separate roundings, never a fused multiply-add: the reference rounds
  // the requantized value before it adds the bias
  if (scaled) v = __fmul_rn(v, sv);
  if (biased) v = __fadd_rn(v, bv);
  v = act_c<A>(v);
  if (ot == F32) { static_cast<float*>(out)[o] = v; return; }
  if (ot == BF16) { static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v); return; }
  if (scaled) v = rintf(v);  // half to even, like jnp.round
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
template <int A>
__device__ __forceinline__ void epi_i(void* out, size_t o, int v, bool biased,
                                      float bv, int ot) {
  if (biased) v += __float2int_rz(bv);
  v = act_c<A>(v);
  if (ot == F32) static_cast<float*>(out)[o] = static_cast<float>(v);
  else if (ot == BF16) static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(static_cast<float>(v));
  else if (ot == I8) static_cast<int8_t*>(out)[o] = static_cast<int8_t>(min(max(v, -128), 127));
  else if (ot == I16) static_cast<int16_t*>(out)[o] = static_cast<int16_t>(min(max(v, -32768), 32767));
  else static_cast<int32_t*>(out)[o] = v;
}

// Either epilogue for an accumulator of type AccT and activation A, inline.
template <int A, typename AccT>
__device__ __forceinline__ void epi(void* out, size_t o, AccT v, bool scaled,
                                    float sv, bool biased, float bv, int ot) {
  if (std::is_same<AccT, float>::value || scaled)
    epi_f<A>(out, o, static_cast<float>(v), scaled, sv, biased, bv, ot);
  else
    epi_i<A>(out, o, static_cast<int>(v), biased, bv, ot);
}

// The same out of line with the activation chosen at run time, for
// unrolled loops: inlined there, its branches multiplied the code and the
// build time.
__device__ __noinline__ void emit_f(void* out, size_t o, float v, int gn,
                                    const float* scale, const float* bias,
                                    int act, int ot) {
  const bool sc = scale != nullptr, bi = bias != nullptr;
  const float sv = sc ? scale[gn] : 0.f, bv = bi ? bias[gn] : 0.f;
  switch (act) {
    case ACT_RELU: epi_f<ACT_RELU>(out, o, v, sc, sv, bi, bv, ot); return;
    case ACT_RELU2: epi_f<ACT_RELU2>(out, o, v, sc, sv, bi, bv, ot); return;
    case ACT_GELU: epi_f<ACT_GELU>(out, o, v, sc, sv, bi, bv, ot); return;
    case ACT_SILU: epi_f<ACT_SILU>(out, o, v, sc, sv, bi, bv, ot); return;
    default: epi_f<ACT_NONE>(out, o, v, sc, sv, bi, bv, ot);
  }
}
__device__ __noinline__ void emit_i(void* out, size_t o, int v, int gn,
                                    const float* bias, int act, int ot) {
  const bool bi = bias != nullptr;
  const float bv = bi ? bias[gn] : 0.f;
  switch (act) {
    case ACT_RELU: epi_i<ACT_RELU>(out, o, v, bi, bv, ot); return;
    case ACT_RELU2: epi_i<ACT_RELU2>(out, o, v, bi, bv, ot); return;
    default: epi_i<ACT_NONE>(out, o, v, bi, bv, ot);
  }
}
template <typename AccT>
__device__ __forceinline__ void emit(void* out, size_t o, AccT v, int gn,
                                     const float* scale, const float* bias,
                                     int act, int ot) {
  if (std::is_same<AccT, float>::value || scale != nullptr)
    emit_f(out, o, static_cast<float>(v), gn, scale, bias, act, ot);
  else
    emit_i(out, o, static_cast<int>(v), gn, bias, act, ot);
}

// Opt a kernel in to the device's dynamic shared-memory maximum, less its
// static shared memory, once per instantiation (`avail`, the caller's
// static, starts at -1), and check the need.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, long long& avail) {
  if (avail < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
    const long long a = static_cast<long long>(optin) - fa.sharedSizeBytes;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(a));
    if (e != cudaSuccess) return e;
    avail = a;
  }
  return static_cast<long long>(smem) > avail ? cudaErrorInvalidValue : cudaSuccess;
}

// ===================================================== route 4: CUDA cores
namespace core {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads over the tile

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

// One block owns one (BM, BN) tile; each thread a (BM/16) x (BN/16)
// accumulator. Staged rows are padded by one element so neither the
// transposing stores nor the inner-loop reads conflict on banks.
template <int BM, int BN, typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
mm_core(const TA* __restrict__ a, const TB* __restrict__ b,
        const float* __restrict__ bias, const float* __restrict__ scale,
        void* __restrict__ out, int M, int K, int N, int bk, int b_col,
        int act, int out_type) {
  using AccT = typename AccOf<TA>::type;
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
      emit(out, static_cast<size_t>(gm) * N + gn, acc[i][j], gn, scale, bias,
           act, out_type);
    }
  }
}

template <int BM, int BN, typename TA, typename TB>
cudaError_t launch(const Args& p) {
  using AccT = typename AccOf<TA>::type;
  auto kern = mm_core<BM, BN, TA, TB>;
  static long long avail = -1;
  const size_t smem = static_cast<size_t>(p.bk) * ((BM + 1) + (BN + 1)) * sizeof(AccT);
  cudaError_t e = allow_smem(kern, smem, avail);
  if (e != cudaSuccess) return e;
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

}  // namespace core

// ================================================== route 2: split-K stream
namespace sk {

constexpr int THREADS = 256;

template <typename T> struct VecOf { static constexpr int n = 16 / sizeof(T); };
template <> struct VecOf<int8_t> { static constexpr int n = 8; };

// Aligned vector loads of VEC consecutive B elements.
__device__ __forceinline__ void load_vec(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x; w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const int8_t* p, int (&w)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = c[i];
}

// A rows [r0, r0 + ROWS) x k [k0, k0 + kl) -> as[ROWS][bk], zero beyond.
template <int ROWS, typename TA, typename AccT>
__device__ __forceinline__ void stage_a(const TA* __restrict__ a, AccT* as,
                                        int r0, int rb, int K, int k0, int kl,
                                        int bk) {
  for (int r = 0; r < ROWS; ++r)
    for (int kk = threadIdx.x; kk < bk; kk += THREADS)
      as[r * bk + kk] = (r < rb && kk < kl)
          ? cvt(a[static_cast<size_t>(r0 + r) * K + k0 + kk]) : AccT(0);
}

// Grid (ceil(N / bn), splits, ceil(M / ROWS)). A block sums k in
// [y * k_per_split, (y + 1) * k_per_split) for ROWS rows and bn columns.
//  * row: its threads split into bn/VEC column lanes (neighbouring threads
//    on neighbouring 16-byte vectors of one B row) times k-lanes, summed
//    through shared memory at the end;
//  * col: one warp per output column, lanes striding K, a shuffle sum.
template <int ROWS, typename TA, typename TB, bool COL>
__global__ void __launch_bounds__(THREADS)
mm_split_k(const TA* __restrict__ a, const TB* __restrict__ b,
           const float* __restrict__ bias, const float* __restrict__ scale,
           void* __restrict__ out, typename AccOf<TA>::type* __restrict__ ws,
           unsigned* __restrict__ tickets, int M, int K, int N, int bk, int bn,
           int k_per_split, int act, int out_type, int vec_ok) {
  using AccT = typename AccOf<TA>::type;
  constexpr int VEC = VecOf<TB>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* as = reinterpret_cast<AccT*>(smem_raw);  // [ROWS][bk]
  AccT* red = as + ROWS * bk;                    // row: [KS][ROWS][bn]
  __shared__ int last;

  const int splits = gridDim.y;
  const int r0 = blockIdx.z * ROWS, rb = min(ROWS, M - r0);
  const int n0 = blockIdx.x * bn;
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  // a partial goes to the workspace, or straight through the epilogue
  auto put = [&](int r, int n, AccT v) {
    const size_t o = static_cast<size_t>(r0 + r) * N + n;
    if (splits > 1) ws[static_cast<size_t>(blockIdx.y) * M * N + o] = v;
    else emit(out, o, v, n, scale, bias, act, out_type);
  };

  if constexpr (!COL) {
    const int CL = bn / VEC, KS = THREADS / CL;
    const int c = threadIdx.x % CL, s = threadIdx.x / CL;
    const int n = n0 + c * VEC;
    AccT acc[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = AccT(0);
    for (int k0 = kb; k0 < ke; k0 += bk) {
      const int kl = min(bk, ke - k0);
      stage_a<ROWS>(a, as, r0, rb, K, k0, kl, bk);
      __syncthreads();
      if (n < N) {
        const bool full = vec_ok && n + VEC <= N;
#pragma unroll 4
        for (int kk = s; kk < kl; kk += KS) {
          const TB* p = b + static_cast<size_t>(k0 + kk) * N + n;
          AccT wv[VEC];
          if (full) {
            load_vec(p, wv);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) wv[v] = (n + v < N) ? cvt(p[v]) : AccT(0);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const AccT av = as[r * bk + kk];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] += av * wv[v];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[(s * ROWS + r) * bn + c * VEC + v] = acc[r][v];
    __syncthreads();
    for (int o = threadIdx.x; o < ROWS * bn; o += THREADS) {
      const int r = o / bn, col = o - r * bn;
      if (r >= rb || n0 + col >= N) continue;
      AccT sum = AccT(0);
      for (int ss = 0; ss < KS; ++ss) sum += red[(ss * ROWS + r) * bn + col];
      put(r, n0 + col, sum);
    }
  } else {
    constexpr int WARPS = THREADS / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int j = 0; j < bn; j += WARPS) {
      const int n = n0 + j + warp;
      AccT acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = AccT(0);
      for (int k0 = kb; k0 < ke; k0 += bk) {
        const int kl = min(bk, ke - k0);
        __syncthreads();  // the previous slice is no longer read
        stage_a<ROWS>(a, as, r0, rb, K, k0, kl, bk);
        __syncthreads();
        if (n >= N) continue;
        const TB* p = b + static_cast<size_t>(n) * K + k0;
        for (int kk = lane * VEC; kk < kl; kk += 32 * VEC) {
          AccT wv[VEC];
          if (vec_ok && kk + VEC <= kl) {
            load_vec(p + kk, wv);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[r] += as[r * bk + kk + v] * wv[v];
          } else {
            for (int v = 0; v < VEC && kk + v < kl; ++v) {
              const AccT wk = cvt(p[kk + v]);
#pragma unroll
              for (int r = 0; r < ROWS; ++r) acc[r] += as[r * bk + kk + v] * wk;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
      if (lane == 0 && n < N)
        for (int r = 0; r < rb; ++r) put(r, n, acc[r]);
    }
  }
  if (splits == 1) return;

  // The last split to finish this tile sums the partials in split order.
  __threadfence();
  __syncthreads();
  const unsigned tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
    if (last) tickets[tile] = 0;  // ready for the next launch on this stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < ROWS * bn; o += THREADS) {
    const int r = o / bn, n = n0 + o - (o / bn) * bn;
    if (r >= rb || n >= N) continue;
    const size_t i = static_cast<size_t>(r0 + r) * N + n;
    AccT sum = AccT(0);
    for (int sp = 0; sp < splits; ++sp)
      sum += __ldcg(ws + static_cast<size_t>(sp) * M * N + i);
    emit(out, i, sum, n, scale, bias, act, out_type);
  }
}

template <int ROWS, typename TA, typename TB>
cudaError_t launch(const Args& p) {
  using AccT = typename AccOf<TA>::type;
  constexpr int VEC = VecOf<TB>::n;
  if (p.bn < VEC || p.bn % VEC != 0 || THREADS % (p.bn / VEC) != 0)
    return cudaErrorInvalidValue;
  if (p.splits > 1 && (p.ws == nullptr || p.tickets == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(ROWS) * p.bk +
                       (p.b_col ? 0 : static_cast<size_t>(THREADS) * ROWS * VEC)) *
                      sizeof(AccT);
  auto kern = p.b_col ? mm_split_k<ROWS, TA, TB, true> : mm_split_k<ROWS, TA, TB, false>;
  static long long avail[2] = {-1, -1};  // per instantiation and layout
  cudaError_t e = allow_smem(kern, smem, avail[p.b_col ? 1 : 0]);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + p.bn - 1) / p.bn, p.splits, (p.M + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const TA*>(p.a), static_cast<const TB*>(p.b), p.bias,
      p.scale, p.out, static_cast<AccT*>(p.ws), p.tickets, p.M, p.K, p.N,
      p.bk, p.bn, p.k_per_split, p.act, p.out_type, p.vec_ok);
  return cudaGetLastError();
}

// Rows one block keeps in registers (kernels/matmul.py rows_per_group);
// more rows go to further blockIdx.z groups, each streaming B again.
template <typename TA, typename TB>
cudaError_t by_rows(const Args& p) {
  if (p.M <= 1) return launch<1, TA, TB>(p);
  if (p.M <= 2) return launch<2, TA, TB>(p);
  if (p.M <= 4) return launch<4, TA, TB>(p);
  return launch<8, TA, TB>(p);
}

}  // namespace sk

// ============================================ routes 1 and 3: tensor cores
namespace tc {

constexpr int BN = 128;                  // output columns: one wgmma n128
constexpr int ROW = 128;                 // bytes of K in one swizzled row
constexpr int TILE_B = BN * ROW;         // one B operand tile of a stage
constexpr int BOX_F32 = 64 * BN * 4;     // one staged f32 B tile (64 x 128)

enum BMode { B_BF16_COL, B_BF16_ROW, B_F32_COL, B_F32_ROW, B_I8_COL };

template <int NWG, int MODE> struct Cfg {
  static constexpr bool kSplit = MODE == B_F32_COL || MODE == B_F32_ROW;
  static constexpr bool kInt = MODE == B_I8_COL;
  // B (K, N): N contiguous, wgmma's MN-major ("transposed") operand
  static constexpr bool kMnMajor = MODE == B_BF16_ROW || MODE == B_F32_ROW;
  static constexpr int kTerms = kSplit ? 3 : 1;
  static constexpr int kBM = 64 * NWG;
  static constexpr int kBK = kInt ? 128 : 64;  // K of one stage
  static constexpr int kA = kBM * ROW;
  // ring A: A tiles (and a bf16 or int8 B's tile beside each), filled by
  // TMA, freed by the consumers; ring B: f32 B tiles, filled by TMA, freed
  // by the split; ring 2: the split's three bf16 terms, freed by the
  // consumers. Kept apart, the f32 staging refills as soon as it is split.
  static constexpr int kStagesA = 4;
  static constexpr int kStagesB = kSplit ? 2 : 0;
  static constexpr int kStages2 = kSplit ? 2 : 0;
  static constexpr int kStageA = kA + (kSplit ? 0 : TILE_B);
  static constexpr int kRingA = kStagesA * kStageA;
  static constexpr int kRingB = kStagesB * BOX_F32;
  static constexpr int kRing2 = kStages2 * 3 * TILE_B;
  static constexpr int kBars = 2 * (kStagesA + kStagesB + kStages2);
  // + 1024: the base is aligned up to the 128-byte swizzle's 1024 bytes
  static constexpr int kSmem = 1024 + kRingA + kRingB + kRing2 + 8 * kBars;
  static_assert(kBM * (BN + 4) * 4 <= kRingA + kRingB + kRing2,
                "the epilogue's staged tile fits in the rings");
  static constexpr int kMmaThreads = 128 * NWG;
  // the split warpgroup also issues the TMA loads; without it, a producer
  // warp does
  static constexpr int kSplitThreads = kSplit ? 128 : 0;
  static constexpr int kThreads = kMmaThreads + (kSplit ? 128 : 32);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity. A wait of seconds is a broken
// pipeline, never a slow one: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// 2-D TMA load of one box at element coordinates (c0 inner, c1 outer).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operand (rows
// of 128 bytes of K, 8-row groups 1024 bytes apart): lbo unused (16), sbo
// 1024. MN-major operand (rows of 64 N elements per k, 8-k groups 1024
// bytes apart, 64-column strips lbo apart): lbo = strip bytes, sbo 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across the async MMA.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define REPRO_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define REPRO_8(C, i)                                                     \
  C(d[i + 0]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),        \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define REPRO_64(C)                                                       \
  REPRO_8(C, 0), REPRO_8(C, 8), REPRO_8(C, 16), REPRO_8(C, 24),           \
      REPRO_8(C, 32), REPRO_8(C, 40), REPRO_8(C, 48), REPRO_8(C, 56)

// D(64 x 128, f32) += A(64 x 16, bf16, K-major) . B(16 x 128, bf16); TB = 1
// when B is MN-major.
template <int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_64("+f")
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D(64 x 128, s32) += A(64 x 32, s8) . B(32 x 128, s8), both K-major.
template <int TB>
__device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REPRO_D64
      ", %64, %65, p;\n}\n"
      : REPRO_64("+r")
      : "l"(da), "l"(db), "r"(1));
}

// The high 16 bits of two f32 bit patterns as one bf16x2 (x0 in the low half).
__device__ __forceinline__ uint32_t hi2(uint32_t x0, uint32_t x1) {
  return __byte_perm(x0, x1, 0x7632);
}

// Split 8 f32 into three bf16x8 terms by truncation: t1 = hi16(x),
// t2 = hi16(x - t1), t3 = x - t1 - t2 (exact, and its low 16 bits are 0).
__device__ __forceinline__ void split8(const float4& lo, const float4& hi,
                                       uint4& t1, uint4& t2, uint4& t3) {
  const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t p1[4], p2[4], p3[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t u[2], v[2], w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float xf = x[2 * i + j];
      u[j] = __float_as_uint(xf);
      const float r1 = __fsub_rn(xf, __uint_as_float(u[j] & 0xFFFF0000u));
      v[j] = __float_as_uint(r1);
      w[j] = __float_as_uint(__fsub_rn(r1, __uint_as_float(v[j] & 0xFFFF0000u)));
    }
    p1[i] = hi2(u[0], u[1]);
    p2[i] = hi2(v[0], v[1]);
    p3[i] = hi2(w[0], w[1]);
  }
  t1 = make_uint4(p1[0], p1[1], p1[2], p1[3]);
  t2 = make_uint4(p2[0], p2[1], p2[2], p2[3]);
  t3 = make_uint4(p3[0], p3[1], p3[2], p3[3]);
}

// Block (blockIdx.x, blockIdx.y) owns rows [64 NWG x, ...) and columns
// [128 y, ...): blocks that share a B tile run side by side, so B comes
// from HBM about once. Warps: NWG consumer warpgroups (wgmma), then either
// the split warpgroup (f32 B; its first thread also issues the TMA loads)
// or a producer warp.
template <int NWG, int MODE>
__global__ void __launch_bounds__(Cfg<NWG, MODE>::kThreads, 1)
mm_wgmma(const __grid_constant__ CUtensorMap tma_a,
         const __grid_constant__ CUtensorMap tma_b,
         const float* __restrict__ bias, const float* __restrict__ scale,
         void* __restrict__ out, int M, int K, int N, int act, int out_type) {
  using C = Cfg<NWG, MODE>;
  using AccT = typename std::conditional<C::kInt, int, float>::type;
  constexpr int SA = C::kStagesA, SB = C::kStagesB, S2 = C::kStages2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ringA = smem_u32(smem);
  const uint32_t ringB = ringA + C::kRingA;
  const uint32_t ring2 = ringB + C::kRingB;
  const uint32_t bars = ring2 + C::kRing2;
  auto fullA = [&](int s) { return bars + 8 * s; };
  auto emptyA = [&](int s) { return bars + 8 * (SA + s); };
  auto fullB = [&](int s) { return bars + 8 * (2 * SA + s); };
  auto emptyB = [&](int s) { return bars + 8 * (2 * SA + SB + s); };
  auto full2 = [&](int s) { return bars + 8 * (2 * SA + 2 * SB + s); };
  auto empty2 = [&](int s) { return bars + 8 * (2 * SA + 2 * SB + S2 + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(fullA(s), 1);
      mbar_init(emptyA(s), C::kMmaThreads);
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(fullB(s), 1);
      mbar_init(emptyB(s), C::kSplitThreads);
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(full2(s), C::kSplitThreads);
      mbar_init(empty2(s), C::kMmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * C::kBM, n0 = blockIdx.y * BN;
  const int KT = (K + C::kBK - 1) / C::kBK;

  // TMA loads of step j, each into its ring's slot once that slot is free:
  // the f32 B first (the split waits for it), then A (and a direct B)
  auto produce = [&](int j) {
    const int k0 = j * C::kBK;
    if constexpr (C::kSplit) {
      const int s = j % SB;
      mbar_wait(emptyB(s), ((j / SB) & 1) ^ 1);
      mbar_expect_tx(fullB(s), BOX_F32);
      if (MODE == B_F32_ROW)
        tma_load(ringB + s * BOX_F32, &tma_b, fullB(s), n0, k0);
      else  // col layout: (k, n) box
        tma_load(ringB + s * BOX_F32, &tma_b, fullB(s), k0, n0);
    }
    const int s = j % SA;
    mbar_wait(emptyA(s), ((j / SA) & 1) ^ 1);
    const uint32_t st = ringA + s * C::kStageA, sb = st + C::kA;
    mbar_expect_tx(fullA(s), C::kStageA);
    tma_load(st, &tma_a, fullA(s), k0, m0);
    if (MODE == B_BF16_ROW) {  // two 64-column strips of (64 k x 64 n)
      tma_load(sb, &tma_b, fullA(s), n0, k0);
      tma_load(sb + TILE_B / 2, &tma_b, fullA(s), n0 + 64, k0);
    } else if (!C::kSplit) {  // col layout: (k, n) box
      tma_load(sb, &tma_b, fullA(s), k0, n0);
    }
  };

  if (tid >= C::kMmaThreads) {
    const int t = tid - C::kMmaThreads;
    if constexpr (!C::kSplit) {  // producer warp
      if (t == 0)
        for (int j = 0; j < KT; ++j) produce(j);
    } else {  // split warpgroup: f32 B -> 3 bf16 terms
      // staging [R][CC] f32 as TMA wrote it; the terms go where TMA would
      // put a bf16 B: 128-byte rows, 128-byte swizzle; row layout, two
      // MN-major strips of 64 k rows; col layout, 128 K-major rows
      constexpr int R = MODE == B_F32_ROW ? 64 : BN;
      constexpr int CC = MODE == B_F32_ROW ? BN : 64;
      constexpr int kAhead = 2;  // loads issued ahead of the split
      if (t == 0)
        for (int j = 0; j < kAhead && j < KT; ++j) produce(j);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % SB, s2 = kt % S2;
        mbar_wait(fullB(s), (kt / SB) & 1);
        mbar_wait(empty2(s2), ((kt / S2) & 1) ^ 1);
        const float* stg = reinterpret_cast<const float*>(smem + C::kRingA + s * BOX_F32);
        unsigned char* dst = smem + C::kRingA + C::kRingB + s2 * 3 * TILE_B;
#pragma unroll 2
        for (int g = t; g < R * CC / 8; g += 128) {
          const int r = g / (CC / 8), c8 = g % (CC / 8);
          const float4* src = reinterpret_cast<const float4*>(stg + r * CC + c8 * 8);
          uint4 t1, t2, t3;
          split8(src[0], src[1], t1, t2, t3);
          const int off = (c8 / 8) * (R * ROW) + r * ROW + (((c8 % 8) ^ (r % 8)) * 16);
          *reinterpret_cast<uint4*>(dst + off) = t1;
          *reinterpret_cast<uint4*>(dst + TILE_B + off) = t2;
          *reinterpret_cast<uint4*>(dst + 2 * TILE_B + off) = t3;
        }
        // generic-proxy writes, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full2(s2));
        mbar_arrive(emptyB(s));
        // step kt + 2 reuses the f32 slot just split and the A slot of step
        // kt - 2, which the consumers free once they issue step kt - 1:
        // neither release waits on this thread
        if (t == 0 && kt + kAhead < KT) produce(kt + kAhead);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64). An f32 B's
  // small terms (B2, B3) go to a second accumulator, added once at the
  // end: the tensor cores round each accumulate by truncation, so the main
  // sum takes no more accumulate steps than a bf16 B's would.
  const int wg = tid / 128;
  AccT d[64], d2[C::kSplit ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = AccT(0);
  if constexpr (C::kSplit) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d2[i] = AccT(0);
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % SA;
    mbar_wait(fullA(s), (kt / SA) & 1);
    const uint32_t a = ringA + s * C::kStageA + wg * 64 * ROW;
    uint32_t b = ringA + s * C::kStageA + C::kA;
    if constexpr (C::kSplit) {
      const int s2 = kt % S2;
      mbar_wait(full2(s2), (kt / S2) & 1);
      b = ring2 + s2 * 3 * TILE_B;
    }
    fence_acc(d);
    if constexpr (C::kSplit) fence_acc(d2);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < C::kTerms; ++term)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // a k16 (k32 for int8) step is 32 bytes along a K-major row, or
        // 16 rows of 128 bytes of an MN-major strip
        const uint64_t da = desc(a + kk * 32, 16);
        const uint64_t db =
            C::kMnMajor ? desc(b + term * TILE_B + kk * 16 * ROW, TILE_B / 2)
                        : desc(b + term * TILE_B + kk * 32, 16);
        if (term == 0)
          mma<C::kMnMajor ? 1 : 0>(d, da, db);
        else if constexpr (C::kSplit)
          mma<C::kMnMajor ? 1 : 0>(d2, da, db);
      }
    wgmma_commit();
    fence_acc(d);
    if constexpr (C::kSplit) fence_acc(d2);
    wgmma_wait<1>();  // the previous step's MMAs are done: free its slots
    fence_acc(d);
    if constexpr (C::kSplit) fence_acc(d2);
    if (kt > 0) {
      mbar_arrive(emptyA((kt - 1) % SA));
      if constexpr (C::kSplit) mbar_arrive(empty2((kt - 1) % S2));
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  if constexpr (C::kSplit) {
    fence_acc(d2);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = __fadd_rn(d[i], d2[i]);
  }

  // Epilogue through shared memory, so that each warp writes whole rows:
  // every ring is free once both consumer warpgroups are past their MMAs
  // (the split and producer threads are done: their last step was consumed).
  // Accumulator fragment: d[4j + 2h + e] is row 16 w + lane / 4 + 8 h,
  // column 8 j + 2 (lane % 4) + e of this warpgroup's 64 x 128 tile.
  constexpr int LD = BN + 4;  // row stride of the staged tile, in elements
  AccT* tile = reinterpret_cast<AccT*>(smem);
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::kMmaThreads) : "memory");
  {
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        AccT* p = tile + (r0 + 8 * h) * LD + 8 * j + 2 * (lane % 4);
        p[0] = d[4 * j + 2 * h];
        p[1] = d[4 * j + 2 * h + 1];
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::kMmaThreads) : "memory");
  // Each thread keeps one column (its scale and bias in registers) and
  // walks rows; one loop for each activation: chosen at run time inside the
  // loop, the epilogue's code for every activation ran on every element.
  auto write = [&](auto a) {
    constexpr int A = decltype(a)::value;
    const int c = tid % BN, gn = n0 + c;
    if (gn >= N) return;
    const bool sc = scale != nullptr, bi = bias != nullptr;
    const float sv = sc ? scale[gn] : 0.f, bv = bi ? bias[gn] : 0.f;
    for (int r = tid / BN; r < C::kBM && m0 + r < M; r += C::kMmaThreads / BN)
      epi<A>(out, static_cast<size_t>(m0 + r) * N + gn, tile[r * LD + c], sc, sv,
             bi, bv, out_type);
  };
  switch (act) {
    case ACT_RELU: write(std::integral_constant<int, ACT_RELU>()); break;
    case ACT_RELU2: write(std::integral_constant<int, ACT_RELU2>()); break;
    case ACT_GELU: write(std::integral_constant<int, ACT_GELU>()); break;
    case ACT_SILU: write(std::integral_constant<int, ACT_SILU>()); break;
    default: write(std::integral_constant<int, ACT_NONE>());
  }
}

// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a row-major (outer, inner) matrix with the given row stride
// in bytes; boxes of (box_outer, box_inner) elements; zero fill outside.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int inner, int outer, size_t row_bytes, int box_inner,
              int box_outer, bool swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int MODE>
cudaError_t launch(const Args& p) {
  using C = Cfg<NWG, MODE>;
  const bool i8 = C::kInt;
  const int ea = i8 ? 1 : 2;  // A: bf16 or int8
  CUtensorMap ma, mb;
  bool ok = make_map(&ma, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     p.a, p.K, p.M, static_cast<size_t>(p.K) * ea, C::kBK, C::kBM, true);
  switch (MODE) {
    case B_BF16_COL:
      ok = ok && make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.b, p.K, p.N,
                          static_cast<size_t>(p.K) * 2, 64, BN, true);
      break;
    case B_BF16_ROW:
      ok = ok && make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.b, p.N, p.K,
                          static_cast<size_t>(p.N) * 2, 64, 64, true);
      break;
    case B_F32_COL:
      ok = ok && make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.b, p.K, p.N,
                          static_cast<size_t>(p.K) * 4, 64, BN, false);
      break;
    case B_F32_ROW:
      ok = ok && make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.b, p.N, p.K,
                          static_cast<size_t>(p.N) * 4, BN, 64, false);
      break;
    default:  // B_I8_COL
      ok = ok && make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.b, p.K, p.N,
                          static_cast<size_t>(p.K), 128, BN, true);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kern = mm_wgmma<NWG, MODE>;
  static long long avail = -1;
  cudaError_t e = allow_smem(kern, C::kSmem, avail);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + C::kBM - 1) / C::kBM, (p.N + BN - 1) / BN);
  kern<<<grid, C::kThreads, C::kSmem, p.stream>>>(ma, mb, p.bias, p.scale, p.out,
                                                  p.M, p.K, p.N, p.act, p.out_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t by_tile(const Args& p) {
  if (p.bn != BN) return cudaErrorInvalidValue;
  if (p.bm == 64) return launch<1, MODE>(p);
  if (p.bm == 128) return launch<2, MODE>(p);
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

#if REPRO_PART == 1
cudaError_t repro_mm::run_core_bf16(const Args& p) {
  if (p.b_type == F32) return core::by_tile<__nv_bfloat16, float>(p);
  if (p.b_type == BF16) return core::by_tile<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 2
cudaError_t repro_mm::run_core_f32(const Args& p) {
  if (p.b_type == F32) return core::by_tile<float, float>(p);
  if (p.b_type == BF16) return core::by_tile<float, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 3
cudaError_t repro_mm::run_core_i8(const Args& p) {
  if (p.b_type == I8) return core::by_tile<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 4
cudaError_t repro_mm::run_split_k_bf16(const Args& p) {
  if (p.b_type == F32) return sk::by_rows<__nv_bfloat16, float>(p);
  if (p.b_type == BF16) return sk::by_rows<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 5
cudaError_t repro_mm::run_split_k_other(const Args& p) {
  if (p.b_type == F32) return sk::by_rows<float, float>(p);
  if (p.b_type == BF16) return sk::by_rows<float, __nv_bfloat16>(p);
  if (p.b_type == I8) return sk::by_rows<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 6
cudaError_t repro_mm::run_tc_f32_row(const Args& p) {
  return tc::by_tile<tc::B_F32_ROW>(p);
}
#elif REPRO_PART == 7
cudaError_t repro_mm::run_tc_f32_col(const Args& p) {
  return tc::by_tile<tc::B_F32_COL>(p);
}
#elif REPRO_PART == 8
cudaError_t repro_mm::run_tc_bf16(const Args& p) {
  return p.b_col ? tc::by_tile<tc::B_BF16_COL>(p) : tc::by_tile<tc::B_BF16_ROW>(p);
}
#elif REPRO_PART == 9
cudaError_t repro_mm::run_tc_i8(const Args& p) {
  return tc::by_tile<tc::B_I8_COL>(p);
}
#else
// Returns a cudaError_t: 0 when the launch was accepted. The route is the
// wrapper's choice (kernels/matmul.py route()); this checks only what a
// route cannot take at all.
extern "C" int repro_matmul(const void* a, const void* b, const void* bias,
                            const void* scale, void* out, void* ws,
                            void* tickets, int M, int K, int N, int bm, int bk,
                            int bn, int a_type, int b_type, int out_type,
                            int b_col, int act, int route, int splits,
                            int k_per_split, int vec_ok, void* stream) {
  using namespace repro_mm;
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const Args p{a, b, static_cast<const float*>(bias),
               static_cast<const float*>(scale), out, ws,
               static_cast<unsigned*>(tickets), M, K, N, bm, bk, bn, b_type,
               out_type, b_col, act, splits, k_per_split, vec_ok,
               static_cast<cudaStream_t>(stream)};
  switch (route) {
    case TENSOR_CORE:
      if (a_type != BF16) return cudaErrorInvalidValue;
      if (b_type == BF16) return run_tc_bf16(p);
      if (b_type != F32) return cudaErrorInvalidValue;
      return b_col ? run_tc_f32_col(p) : run_tc_f32_row(p);
    case TENSOR_CORE_INT8:
      if (a_type != I8 || b_type != I8 || !b_col) return cudaErrorInvalidValue;
      return run_tc_i8(p);
    case SPLIT_K:
      if (M > 32 || bk <= 0 || bk % 32 != 0 || splits <= 0 ||
          k_per_split % bk != 0 || static_cast<long long>(splits) * k_per_split < K)
        return cudaErrorInvalidValue;
      return a_type == BF16 ? run_split_k_bf16(p) : run_split_k_other(p);
    case CUDA_CORE:
      if (bk <= 0 || bk % 32 != 0) return cudaErrorInvalidValue;
      switch (a_type) {
        case BF16: return run_core_bf16(p);
        case F32: return run_core_f32(p);
        case I8: return run_core_i8(p);
        default: return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
}
#endif

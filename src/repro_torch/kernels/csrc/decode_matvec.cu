// Skinny decode GEMM (GEMV), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_matvec.py ::
// decode_matvec / _gemv_kernel (pl.pallas_call at decode_matvec.py:83).
//
//   out[B,N] = cast(x[B,K] . W)   W (K, N) "row" or (N, K) "col", B <= 128,
//   f32 accumulation (i32 for int8 x int8), saturating cast, no epilogue.
//
// What bounds it on the H100: reading W. A decode step multiplies a few
// rows by every f32 weight once (the qwen1.5-4b unembed alone is 1.56 GB),
// so the kernel is bound by HBM bandwidth (3.35 TB/s); its FLOPs are
// 2*B per weight element read, far below the f32 CUDA-core rate.
//
// Design: W streams exactly once per group of ROWS rows, with 16-byte
// vector loads along its contiguous axis (8 bytes for int8), and x stays in
// shared memory one bk slice at a time, converted to the accumulator type.
//  * row: a block owns bn columns. Its 256 threads split into bn/VEC
//    column lanes (neighbouring threads on neighbouring 16-byte vectors of
//    one W row, so a warp reads one contiguous run) times 256/(bn/VEC)
//    k-lanes; each thread accumulates ROWS x VEC sums in registers, and the
//    k-lanes are summed through shared memory at the end.
//  * col: one warp per output column, lanes striding K with vector loads,
//    then a warp-shuffle reduction.
// When ceil(N/bn) blocks would leave the 132 SMs idle (N = 2560 gives 20
// blocks of 128 columns), the wrapper splits K across blockIdx.y: each
// split writes an f32/i32 partial and a second small kernel sums the splits
// in a fixed order and casts. Rows beyond 8 go to blockIdx.z groups, each
// streaming W again. Ragged N, K and B edges are masked; W is never padded
// or copied. Every (bk, bn) the h100 planner returns for M <= 128 is
// accepted (bn in {64, 128}, bk a multiple of 32).
//
// Build: kernels/build.py compiles this file once per part, in parallel,
// and links the objects into one shared library: -DREPRO_PART=1, 2, 3
// instantiate the kernels for x = bf16, f32, int8; part 0 holds the C entry
// point that dispatches to them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef REPRO_PART
#define REPRO_PART 0
#endif

namespace repro_mv {

enum DType { F32 = 0, BF16 = 1, I8 = 2, I16 = 3, I32 = 4 };

struct Args {
  const void* x;
  const void* w;
  void* out;
  void* partial;  // (splits, B, N) f32/i32 scratch, unused when splits == 1
  int B, K, N, bk, bn, splits, k_per_split, w_type, out_type, w_col, vec_ok;
  cudaStream_t stream;
};

// One per part: the instantiations for one x type.
cudaError_t run_x_bf16(const Args& p);
cudaError_t run_x_f32(const Args& p);
cudaError_t run_x_i8(const Args& p);

}  // namespace repro_mv

namespace {

using namespace repro_mv;

constexpr int THREADS = 256;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };
template <typename T> struct VecOf { static constexpr int n = 16 / sizeof(T); };
template <> struct VecOf<int8_t> { static constexpr int n = 8; };

__device__ __forceinline__ float cvt(float v) { return v; }
__device__ __forceinline__ float cvt(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int cvt(int8_t v) { return static_cast<int>(v); }

// Aligned vector loads of VEC consecutive W elements.
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

__device__ __forceinline__ void store(void* out, size_t i, int ot, float v) {
  if (ot == F32) static_cast<float*>(out)[i] = v;
  else if (ot == BF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else if (ot == I8) static_cast<int8_t*>(out)[i] = static_cast<int8_t>(fminf(fmaxf(v, -128.f), 127.f));
  else if (ot == I16) static_cast<int16_t*>(out)[i] = static_cast<int16_t>(fminf(fmaxf(v, -32768.f), 32767.f));
  else static_cast<int32_t*>(out)[i] = __float2int_rz(v);
}
__device__ __forceinline__ void store(void* out, size_t i, int ot, int v) {
  if (ot == F32) static_cast<float*>(out)[i] = static_cast<float>(v);
  else if (ot == BF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(static_cast<float>(v));
  else if (ot == I8) static_cast<int8_t*>(out)[i] = static_cast<int8_t>(min(max(v, -128), 127));
  else if (ot == I16) static_cast<int16_t*>(out)[i] = static_cast<int16_t>(min(max(v, -32768), 32767));
  else static_cast<int32_t*>(out)[i] = v;
}

// x rows [r0, r0 + ROWS) x k [k0, k0 + kl) -> xs[ROWS][bk], zero beyond.
template <int ROWS, typename TX, typename AccT>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, AccT* xs,
                                        int r0, int rb, int K, int k0, int kl,
                                        int bk) {
  for (int r = 0; r < ROWS; ++r)
    for (int kk = threadIdx.x; kk < bk; kk += THREADS)
      xs[r * bk + kk] = (r < rb && kk < kl)
          ? cvt(x[static_cast<size_t>(r0 + r) * K + k0 + kk]) : AccT(0);
}

template <int ROWS, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
gemv_row(const TX* __restrict__ x, const TW* __restrict__ w,
         void* __restrict__ out, typename AccOf<TX>::type* __restrict__ partial,
         int B, int K, int N, int bk, int bn, int k_per_split, int out_type,
         int vec_ok) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = VecOf<TW>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* xs = reinterpret_cast<AccT*>(smem_raw);          // [ROWS][bk]
  AccT* red = xs + ROWS * bk;                            // [KS][ROWS][bn]

  const int CL = bn / VEC, KS = THREADS / CL;
  const int c = threadIdx.x % CL, s = threadIdx.x / CL;
  const int n0 = blockIdx.x * bn + c * VEC;
  const int r0 = blockIdx.z * ROWS, rb = min(ROWS, B - r0);
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);

  AccT acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = AccT(0);

  for (int k0 = kb; k0 < ke; k0 += bk) {
    const int kl = min(bk, ke - k0);
    stage_x<ROWS>(x, xs, r0, rb, K, k0, kl, bk);
    __syncthreads();
    if (n0 < N) {
      const bool full = vec_ok && n0 + VEC <= N;
#pragma unroll 4
      for (int kk = s; kk < kl; kk += KS) {
        const TW* p = w + static_cast<size_t>(k0 + kk) * N + n0;
        AccT wv[VEC];
        if (full) {
          load_vec(p, wv);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) wv[v] = (n0 + v < N) ? cvt(p[v]) : AccT(0);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const AccT xv = xs[r * bk + kk];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] += xv * wv[v];
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
    const int n = blockIdx.x * bn + col;
    if (r >= rb || n >= N) continue;
    AccT sum = AccT(0);
    for (int ss = 0; ss < KS; ++ss) sum += red[(ss * ROWS + r) * bn + col];
    const size_t oi = static_cast<size_t>(r0 + r) * N + n;
    if (partial != nullptr) partial[static_cast<size_t>(blockIdx.y) * B * N + oi] = sum;
    else store(out, oi, out_type, sum);
  }
}

template <int ROWS, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
gemv_col(const TX* __restrict__ x, const TW* __restrict__ w,
         void* __restrict__ out, typename AccOf<TX>::type* __restrict__ partial,
         int B, int K, int N, int bk, int bn, int k_per_split, int out_type,
         int vec_ok) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = VecOf<TW>::n;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* xs = reinterpret_cast<AccT*>(smem_raw);  // [ROWS][bk]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.z * ROWS, rb = min(ROWS, B - r0);
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);

  for (int j = 0; j < bn; j += WARPS) {
    const int n = blockIdx.x * bn + j + warp;
    AccT acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = AccT(0);
    for (int k0 = kb; k0 < ke; k0 += bk) {
      const int kl = min(bk, ke - k0);
      __syncthreads();  // the previous slice is no longer read
      stage_x<ROWS>(x, xs, r0, rb, K, k0, kl, bk);
      __syncthreads();
      if (n >= N) continue;
      const TW* p = w + static_cast<size_t>(n) * K + k0;
      for (int kk = lane * VEC; kk < kl; kk += 32 * VEC) {
        AccT wv[VEC];
        if (vec_ok && kk + VEC <= kl) {
          load_vec(p + kk, wv);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r] += xs[r * bk + kk + v] * wv[v];
        } else {
          for (int v = 0; v < VEC && kk + v < kl; ++v) {
            const AccT wk = cvt(p[kk + v]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] += xs[r * bk + kk + v] * wk;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
    if (lane == 0 && n < N) {
      for (int r = 0; r < rb; ++r) {
        const size_t oi = static_cast<size_t>(r0 + r) * N + n;
        if (partial != nullptr) partial[static_cast<size_t>(blockIdx.y) * B * N + oi] = acc[r];
        else store(out, oi, out_type, acc[r]);
      }
    }
  }
}

template <typename AccT>
__global__ void __launch_bounds__(THREADS)
sum_splits(const AccT* __restrict__ partial, void* __restrict__ out,
           int splits, size_t count, int out_type) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= count) return;
  AccT sum = AccT(0);
  for (int p = 0; p < splits; ++p) sum += partial[static_cast<size_t>(p) * count + i];
  store(out, i, out_type, sum);
}

template <typename K_>
cudaError_t allow_smem(K_ kern, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

template <int ROWS, typename TX, typename TW>
cudaError_t launch(const Args& p) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = VecOf<TW>::n;
  if (p.bn < VEC || p.bn % VEC != 0 || THREADS % (p.bn / VEC) != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(ROWS) * p.bk +
                       (p.w_col ? 0 : static_cast<size_t>(THREADS) * ROWS * VEC)) *
                      sizeof(AccT);
  auto kern = p.w_col ? gemv_col<ROWS, TX, TW> : gemv_row<ROWS, TX, TW>;
  static bool attr_set[2] = {false, false};  // per instantiation and layout
  if (!attr_set[p.w_col ? 1 : 0]) {
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    attr_set[p.w_col ? 1 : 0] = true;
  }
  AccT* part = p.splits > 1 ? static_cast<AccT*>(p.partial) : nullptr;
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  dim3 grid((p.N + p.bn - 1) / p.bn, p.splits, (p.B + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const TX*>(p.x), static_cast<const TW*>(p.w), p.out, part,
      p.B, p.K, p.N, p.bk, p.bn, p.k_per_split, p.out_type, p.vec_ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t count = static_cast<size_t>(p.B) * p.N;
  const unsigned blocks = static_cast<unsigned>((count + THREADS - 1) / THREADS);
  sum_splits<AccT><<<blocks, THREADS, 0, p.stream>>>(part, p.out, p.splits,
                                                     count, p.out_type);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t by_rows(const Args& p) {
  if (p.B <= 1) return launch<1, TX, TW>(p);
  if (p.B <= 2) return launch<2, TX, TW>(p);
  if (p.B <= 4) return launch<4, TX, TW>(p);
  return launch<8, TX, TW>(p);
}

}  // namespace

#if REPRO_PART == 1
cudaError_t repro_mv::run_x_bf16(const Args& p) {
  if (p.w_type == F32) return by_rows<__nv_bfloat16, float>(p);
  if (p.w_type == BF16) return by_rows<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 2
cudaError_t repro_mv::run_x_f32(const Args& p) {
  if (p.w_type == F32) return by_rows<float, float>(p);
  if (p.w_type == BF16) return by_rows<float, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 3
cudaError_t repro_mv::run_x_i8(const Args& p) {
  if (p.w_type == I8) return by_rows<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#else
// Returns a cudaError_t: 0 when every launch was accepted. `partial` is an
// (splits, B, N) f32/i32 scratch buffer, unused when splits == 1.
extern "C" int repro_decode_matvec(const void* x, const void* w, void* out,
                                   void* partial, int B, int K, int N, int bk,
                                   int bn, int splits, int k_per_split,
                                   int x_type, int w_type, int out_type,
                                   int w_col, int vec_ok, void* stream) {
  if (B <= 0 || B > 128 || K <= 0 || N <= 0 || bk <= 0 || bk % 32 != 0 ||
      splits <= 0 || k_per_split % bk != 0 ||
      static_cast<long long>(splits) * k_per_split < K)
    return cudaErrorInvalidValue;
  const repro_mv::Args p{x, w, out, partial, B, K, N, bk, bn, splits,
                         k_per_split, w_type, out_type, w_col, vec_ok,
                         static_cast<cudaStream_t>(stream)};
  switch (x_type) {
    case repro_mv::BF16: return repro_mv::run_x_bf16(p);
    case repro_mv::F32: return repro_mv::run_x_f32(p);
    case repro_mv::I8: return repro_mv::run_x_i8(p);
    default: return cudaErrorInvalidValue;
  }
}
#endif

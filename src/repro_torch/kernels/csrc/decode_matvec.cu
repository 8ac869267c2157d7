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
// so at small B the kernel is bound by HBM bandwidth (3.35 TB/s): the whole
// design is about keeping enough of W in flight on every SM. At B = 64-128
// the f32 FMAs (2 B per weight) bound it instead, and W must still cross
// HBM once, not once per group of rows.
//
// Two routes, picked by the wrapper (kernels/decode_matvec.py, route())
// before the launch; a route is never taken because another failed.
//
// 1. tma: W's base and its contiguous row stride are 16-byte multiples.
//    Block (blockIdx.x, blockIdx.y) owns bn columns and one K split. A
//    producer warp (one thread) streams the block's W through a 64 KB ring
//    of shared-memory stages with cp.async.bulk.tensor.2d, each completing
//    on an mbarrier: row layout a (stage_k, bn) box, col layout a
//    (bn, 128 bytes of K) box with the 128-byte swizzle. Boxes beyond K or
//    N are zero-filled, which masks the ragged edges. Eight consumer warps
//    first stage x for the block's whole K range once (its own dtype, rows
//    padded to a multiple of the row group), then read every stage from
//    shared memory while the next ones are in flight, and release it to
//    the producer with one arrive a warp. The block's row groups together
//    hold all B rows, so W crosses HBM once for any B <= 128: more rows
//    cost FMAs and registers only. Consumers on the CUDA cores (f32 / i32
//    FMAs): every thread owns RT rows of a few columns.
//     * row: a thread reads one 16-byte vector of a stage row (8 bytes for
//       int8), neighbouring threads on neighbouring vectors; the remaining
//       threads split the stage's rows (k-lanes) in chunks of CH rows.
//     * col: a thread reads 16-byte chunks of K of CPT columns; column
//       lanes are the fastest thread index, so a warp's reads land on the
//       8 swizzled chunk positions without bank conflicts; k-lanes split
//       the 8 chunks of a stage row.
//    The k-lanes are summed through shared memory (the ring, once drained)
//    in a fixed order. Consumers on the tensor cores (gemv_tma_mma): bf16
//    x, row layout, 8 < B <= 128, where a CUDA-core thread would read each W
//    vector from shared memory once per group of rows and shared memory,
//    not HBM, would bound the call.
// 2. cuda_core: W unaligned (e.g. a ragged f32 row of 3108 bytes, which TMA
//    cannot address). The CUDA-core kernels of the first port: 16-byte
//    vector loads where aligned, x staged a bk slice at a time, rows beyond
//    8 in blockIdx.z groups that stream W again.
//
// Split-K (both routes): the wrapper's partition splits K across blockIdx.y
// so that the grid fills the 132 SMs. Each split writes an f32 (i32)
// partial into scratch the wrapper allocates; the last block of a column
// tile, found by an atomic ticket, sums the partials in split order
// (deterministic), casts, and resets its ticket for the next launch (the
// wrapper keeps the tickets per device, zeroed once). One call is one
// launch.
//
// Every mbarrier wait traps after 2^33 cycles (~4.7 s): a broken ring fails
// the launch instead of hanging the card.
//
// Build: kernels/build.py compiles this file once per part, in parallel,
// and links the objects into one shared library: -DREPRO_PART=1..5
// instantiate the kernels of one route and type each; part 0 holds the C
// entry point and the tensor-map encoding.

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled: looked up at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef REPRO_PART
#define REPRO_PART 0
#endif

namespace repro_mv {

enum DType { F32 = 0, BF16 = 1, I8 = 2, I16 = 3, I32 = 4 };
enum Route { TMA = 1, CUDA_CORE = 2 };

struct Args {
  const void* x;
  const void* w;
  void* out;
  void* partial;      // (splits, B, N) f32 / i32 scratch, unused when splits == 1
  unsigned* tickets;  // one zeroed counter per column tile (per grid tile)
  const CUtensorMap* map;  // tma route: W's tensor map
  int B, K, N, bk, bn, splits, k_per_split, x_type, w_type, out_type, w_col, vec_ok;
  // tma route: rows a thread holds, columns a thread holds (col), K of one
  // stage, stages in the ring, x loads may be 16-byte vectors
  int rt, cpt, stage_k, stages, x_vec;
  int mt;  // tma route: row tiles of 16 on the tensor cores, 0 on the CUDA cores
  cudaStream_t stream;
};

// One per part.
cudaError_t run_tma_bf16_row(const Args& p);
cudaError_t run_tma_bf16_col(const Args& p);
cudaError_t run_tma_f32(const Args& p);
cudaError_t run_tma_i8(const Args& p);
cudaError_t run_core(const Args& p);
cudaError_t run_tma_mma(const Args& p);

}  // namespace repro_mv

namespace {

using namespace repro_mv;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float cvt(float v) { return v; }
__device__ __forceinline__ float cvt(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int cvt(int8_t v) { return static_cast<int>(v); }

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

// Element i of the little-endian words `raw`, widened to the accumulator
// type with register arithmetic (no type punning through memory).
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  __device__ static __forceinline__ float at(const uint32_t* raw, int i) {
    return __uint_as_float(raw[i]);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  __device__ static __forceinline__ float at(const uint32_t* raw, int i) {
    const uint32_t w = raw[i / 2];
    return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Unpack<int8_t> {
  __device__ static __forceinline__ int at(const uint32_t* raw, int i) {
    return static_cast<int>(raw[i / 4] << (24 - 8 * (i % 4))) >> 24;
  }
};

// n consecutive elements from memory, in 16-byte pieces (or one piece of
// 8, 4, 2 or 1 bytes, aligned to its size), converted to the accumulator
// type.
template <int n, typename T, typename AccT>
__device__ __forceinline__ void load_n(const T* p, AccT (&v)[n]) {
  constexpr int bytes = n * static_cast<int>(sizeof(T));
  static_assert(bytes % 16 == 0 || bytes <= 8, "vector");
  uint32_t raw[bytes >= 4 ? bytes / 4 : 1];
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      raw[4 * i] = q.x; raw[4 * i + 1] = q.y; raw[4 * i + 2] = q.z; raw[4 * i + 3] = q.w;
    }
  } else if constexpr (bytes == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    raw[0] = q.x; raw[1] = q.y;
  } else if constexpr (bytes == 4) {
    raw[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (bytes == 2) {
    raw[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    raw[0] = *reinterpret_cast<const uint8_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = Unpack<T>::at(raw, i);
}

// The last block of a tile to finish sums the partials in split order and
// writes the output (`each_output`, after every split's partial is in
// global memory); it resets its ticket for the next launch on this stream.
// Called by the `nthreads` threads that synchronise on named barrier `bar`.
template <typename F>
__device__ __forceinline__ void finish_splits(unsigned* __restrict__ tickets,
                                              unsigned tile, int splits,
                                              int nthreads, int bar, int* last,
                                              F each_output) {
  __threadfence();
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(nthreads) : "memory");
  if (threadIdx.x == 0) {
    *last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
    if (*last) tickets[tile] = 0;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(nthreads) : "memory");
  if (!*last) return;
  __threadfence();
  each_output();
}

// The tile's outputs o in [0, count), spread over `nthreads` threads: the
// sum of the `splits` partials of each (at `stride` elements apart), in
// split order, cast and stored. `where(o, i)` gives an output's index i and
// whether it lies inside the matrix. The loads of 4 outputs x 8 splits are
// issued before any is added, so the last block waits for L2 a few times,
// not once a split.
template <typename AccT, typename F>
__device__ __forceinline__ void sum_partials(const AccT* __restrict__ partial,
                                             void* __restrict__ out, int splits,
                                             int count, int nthreads,
                                             size_t stride, int out_type,
                                             F where) {
  constexpr int OU = 4, SU = 8;
  for (int o0 = threadIdx.x; o0 < count; o0 += OU * nthreads) {
    size_t idx[OU];
    bool in[OU];
    AccT sum[OU];
#pragma unroll
    for (int u = 0; u < OU; ++u) {
      const int o = o0 + u * nthreads;
      in[u] = o < count && where(o, idx[u]);
      sum[u] = AccT(0);
    }
    for (int sp0 = 0; sp0 < splits; sp0 += SU) {
      AccT v[OU][SU];
#pragma unroll
      for (int u = 0; u < OU; ++u)
#pragma unroll
        for (int j = 0; j < SU; ++j)
          v[u][j] = in[u] && sp0 + j < splits
              ? __ldcg(partial + static_cast<size_t>(sp0 + j) * stride + idx[u])
              : AccT(0);
#pragma unroll
      for (int u = 0; u < OU; ++u)
#pragma unroll
        for (int j = 0; j < SU; ++j)
          if (sp0 + j < splits) sum[u] += v[u][j];
    }
#pragma unroll
    for (int u = 0; u < OU; ++u)
      if (in[u]) store(out, idx[u], out_type, sum[u]);
  }
}

__device__ __forceinline__ float from_bits(uint32_t b, float) { return __uint_as_float(b); }
__device__ __forceinline__ int from_bits(uint32_t b, int) { return static_cast<int>(b); }

// sum_partials over groups q of 4 neighbouring outputs whose index i (from
// `where(q, i)`) is a multiple of 4: one 16-byte load a split and group,
// the loads of 2 groups x 8 splits in flight before any is added.
template <typename AccT, typename F>
__device__ __forceinline__ void sum_partials4(const AccT* __restrict__ partial,
                                              void* __restrict__ out, int splits,
                                              int groups, int nthreads,
                                              size_t stride, int out_type,
                                              F where) {
  constexpr int OU = 2, SU = 8;
  for (int q0 = threadIdx.x; q0 < groups; q0 += OU * nthreads) {
    size_t idx[OU];
    bool in[OU];
    AccT sum[OU][4];
#pragma unroll
    for (int u = 0; u < OU; ++u) {
      const int q = q0 + u * nthreads;
      in[u] = q < groups && where(q, idx[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[u][e] = AccT(0);
    }
    for (int sp0 = 0; sp0 < splits; sp0 += SU) {
      uint4 v[OU][SU];
#pragma unroll
      for (int u = 0; u < OU; ++u)
#pragma unroll
        for (int j = 0; j < SU; ++j)
          v[u][j] = in[u] && sp0 + j < splits
              ? __ldcg(reinterpret_cast<const uint4*>(
                    partial + static_cast<size_t>(sp0 + j) * stride + idx[u]))
              : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < OU; ++u)
#pragma unroll
        for (int j = 0; j < SU; ++j)
          if (sp0 + j < splits) {
            sum[u][0] += from_bits(v[u][j].x, AccT());
            sum[u][1] += from_bits(v[u][j].y, AccT());
            sum[u][2] += from_bits(v[u][j].z, AccT());
            sum[u][3] += from_bits(v[u][j].w, AccT());
          }
    }
#pragma unroll
    for (int u = 0; u < OU; ++u)
      if (in[u])
#pragma unroll
        for (int e = 0; e < 4; ++e) store(out, idx[u] + e, out_type, sum[u][e]);
  }
}

// Let `kern` use all the dynamic shared memory a block may have beside its
// static shared memory, from the largest carveout.
template <typename Kern>
cudaError_t allow_smem(Kern kern) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// ==================================================== route 1: tma ring
namespace tma {

constexpr int CONSUMERS = 256;            // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int RING = 64 * 1024;           // bytes of W in the ring

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
// ring, never a slow one: trap, so the launch fails instead of hanging.
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// W elements of one shared-memory read in the row layout (8 bytes for
// int8, else 16).
template <typename TW> struct RowVec { static constexpr int n = 16 / sizeof(TW); };
template <> struct RowVec<int8_t> { static constexpr int n = 8; };
// CH rows of W (CH x VEC registers) are held at once: 16 (or 8) registers
// beside up to 32 accumulators, 8 beside 64, so that nothing spills.
template <typename TW, int RT> struct RowChunk {
  static constexpr int v = RowVec<TW>::n;
  static constexpr int n = (RT * v >= 64 ? 8 : 16) / v;
};

// Bytes of one staged x row: kx elements in x's dtype, 16-byte multiple,
// plus 16 so that rows read by neighbouring lanes start in other banks.
__host__ __device__ inline int x_row_bytes(int kx, int x_size) {
  return (kx * x_size + 15) / 16 * 16 + 16;
}

// The block's x rows [0, rows) x k [kb, kb + kx) into shared memory, zero
// beyond B and beyond the split's end.
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, unsigned char* xs,
                                        int rows, int B, int K, int kb, int kl,
                                        int kx, int xrow, bool vec) {
  constexpr int E = 16 / sizeof(TX);  // elements of a 16-byte vector
  const int per_row = kx / E;         // kx is a multiple of 32 >= E
  for (int i = threadIdx.x; i < rows * per_row; i += CONSUMERS) {
    const int r = i / per_row, k = (i - r * per_row) * E;
    TX* dst = reinterpret_cast<TX*>(xs + static_cast<size_t>(r) * xrow) + k;
    const TX* src = x + static_cast<size_t>(r) * K + kb + k;
    if (r < B && vec && k + E <= kl) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = (r < B && k + e < kl) ? src[e] : TX(0.0f);
    }
  }
}

struct Smem {
  unsigned char* ring;
  unsigned char* xs;
  uint32_t full, empty;  // mbarrier addresses, stages of each
};

__device__ __forceinline__ Smem carve(int rows, int xrow, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Smem s;
  s.ring = base;
  s.xs = base + RING;
  s.full = smem_u32(s.xs + static_cast<size_t>(rows) * xrow);
  s.empty = s.full + 8 * stages;
  return s;
}

// The ring's producer and the consumers' stage loop, shared by both
// layouts: `consume(slot_base, j)` reads stage j.
template <typename F>
__device__ __forceinline__ void run_ring(const Smem& sm, const CUtensorMap* map,
                                         int stages, int nst, int stage_bytes,
                                         bool col, int n0, int kb, int stage_k,
                                         F consume) {
  const int warp = threadIdx.x / 32;
  if (warp == CONSUMERS / 32) {
    if (threadIdx.x % 32 == 0) {
      for (int j = 0; j < nst; ++j) {
        const int s = j % stages;
        mbar_wait(sm.empty + 8 * s, ((j / stages) & 1) ^ 1);
        mbar_expect_tx(sm.full + 8 * s, stage_bytes);
        const uint32_t dst = smem_u32(sm.ring) + s * stage_bytes;
        const int k0 = kb + j * stage_k;
        if (col) tma_load(dst, map, sm.full + 8 * s, k0, n0);
        else tma_load(dst, map, sm.full + 8 * s, n0, k0);
      }
    }
    return;
  }
  for (int j = 0; j < nst; ++j) {
    const int s = j % stages;
    mbar_wait(sm.full + 8 * s, (j / stages) & 1);
    consume(sm.ring + static_cast<size_t>(s) * stage_bytes, j);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(sm.empty + 8 * s);
  }
}

__device__ __forceinline__ void init_barriers(const Smem& sm, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// After the ring is drained: the per-thread sums of (row, column) are in
// `red` as [KS][rows][bn]; sum the k-lanes in order and emit each output,
// straight to `out` or as this split's partial, then finish the splits.
template <typename AccT>
__device__ __forceinline__ void reduce_and_store(
    const AccT* red, int KS, int rows, void* __restrict__ out,
    AccT* __restrict__ partial, unsigned* __restrict__ tickets, int B, int N,
    int n0, int bn, int out_type) {
  __shared__ int last;
  const int splits = gridDim.y;
  for (int o = threadIdx.x; o < B * bn; o += CONSUMERS) {
    const int r = o / bn, c = o - r * bn, n = n0 + c;
    if (n >= N) continue;
    AccT sum = AccT(0);
    for (int s = 0; s < KS; ++s) sum += red[(s * rows + r) * bn + c];
    const size_t i = static_cast<size_t>(r) * N + n;
    if (splits == 1) store(out, i, out_type, sum);
    else partial[static_cast<size_t>(blockIdx.y) * B * N + i] = sum;
  }
  if (splits == 1) return;
  finish_splits(tickets, blockIdx.x, splits, CONSUMERS, 1, &last, [&] {
    if (N % 4 == 0) {  // 16-byte loads of 4 neighbouring outputs
      sum_partials4(partial, out, splits, B * bn / 4, CONSUMERS,
                    static_cast<size_t>(B) * N, out_type, [&](int q, size_t& i) {
                      const int r = 4 * q / bn, n = n0 + 4 * q - r * bn;
                      i = static_cast<size_t>(r) * N + n;
                      return n < N;
                    });
      return;
    }
    sum_partials(partial, out, splits, B * bn, CONSUMERS,
                 static_cast<size_t>(B) * N, out_type, [&](int o, size_t& i) {
                   const int r = o / bn, n = n0 + o - r * bn;
                   i = static_cast<size_t>(r) * N + n;
                   return n < N;
                 });
  });
}

// Row layout: W (K, N); a stage is stage_k rows of bn columns.
template <int RT, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS, 2)
gemv_tma_row(const __grid_constant__ CUtensorMap map, const TX* __restrict__ x,
             void* __restrict__ out, typename AccOf<TX>::type* __restrict__ partial,
             unsigned* __restrict__ tickets, int B, int K, int N, int bn,
             int k_per_split, int stage_k, int stages, int out_type, int x_vec) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = RowVec<TW>::n, CH = RowChunk<TW, RT>::n;
  const int CL = bn / VEC, P = CONSUMERS / CL;
  const int NG = (B + RT - 1) / RT, KS = P / NG, rows = NG * RT;
  const int kb = blockIdx.y * k_per_split, kl = min(k_per_split, K - kb);
  const int nst = (kl + stage_k - 1) / stage_k, kx = nst * stage_k;
  const int xrow = x_row_bytes(kx, sizeof(TX));
  const int n0 = blockIdx.x * bn;
  const int stage_bytes = stage_k * bn * static_cast<int>(sizeof(TW));
  const Smem sm = carve(rows, xrow, stages);
  init_barriers(sm, stages);

  const int t = threadIdx.x, c = t % CL, q = t / CL;
  const int g = q % NG, s = q / NG;
  const bool active = t < CONSUMERS && s < KS;
  AccT acc[RT][VEC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = AccT(0);

  if (t < CONSUMERS) {
    stage_x(x, sm.xs, rows, B, K, kb, kl, kx, xrow, x_vec != 0);
    consumers_sync();
  }
  const int wrow = bn * static_cast<int>(sizeof(TW));  // bytes of a stage row
  const int chunks = stage_k / CH;
  run_ring(sm, &map, stages, nst, stage_bytes, false, n0, kb, stage_k,
           [&](const unsigned char* st, int j) {
    if (!active) return;
    for (int ch = s; ch < chunks; ch += KS) {
      const int k = j * stage_k + ch * CH;  // within the split
      if (k >= kl) break;
      AccT wv[CH][VEC];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        load_n<VEC>(reinterpret_cast<const TW*>(st + (ch * CH + i) * wrow) + c * VEC, wv[i]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        AccT xv[CH];
        load_n<CH>(reinterpret_cast<const TX*>(sm.xs + (g * RT + r) * xrow) + k, xv);
#pragma unroll
        for (int i = 0; i < CH; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] += xv[i] * wv[i][v];
      }
    }
  });
  if (t >= CONSUMERS) return;

  consumers_sync();  // every stage read: the ring is free
  AccT* red = reinterpret_cast<AccT*>(sm.ring);  // [KS][rows][bn]
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        red[(s * rows + g * RT + r) * bn + c * VEC + v] = acc[r][v];
  }
  consumers_sync();
  reduce_and_store(red, KS, rows, out, partial, tickets, B, N, n0, bn, out_type);
}

// Col layout: W (N, K); a stage is bn rows of 128 bytes of K, 128-byte
// swizzled (16-byte chunk j of row n at chunk j ^ (n % 8)).
template <int RT, int CPT, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS, 2)
gemv_tma_col(const __grid_constant__ CUtensorMap map, const TX* __restrict__ x,
             void* __restrict__ out, typename AccOf<TX>::type* __restrict__ partial,
             unsigned* __restrict__ tickets, int B, int K, int N, int bn,
             int k_per_split, int stage_k, int stages, int out_type, int x_vec) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = 16 / sizeof(TW);  // K elements of a 16-byte chunk
  const int CLc = bn / CPT, NG = (B + RT - 1) / RT, rows = NG * RT;
  int KS = CONSUMERS / (CLc * NG);
  KS = KS >= 8 ? 8 : KS >= 4 ? 4 : KS >= 2 ? 2 : 1;
  const int kb = blockIdx.y * k_per_split, kl = min(k_per_split, K - kb);
  const int nst = (kl + stage_k - 1) / stage_k, kx = nst * stage_k;
  const int xrow = x_row_bytes(kx, sizeof(TX));
  const int n0 = blockIdx.x * bn;
  const int stage_bytes = bn * 128;
  const Smem sm = carve(rows, xrow, stages);
  init_barriers(sm, stages);

  const int t = threadIdx.x, cl = t % CLc, q = t / CLc;
  const int g = q % NG, s = q / NG;
  const bool active = t < CONSUMERS && s < KS;
  AccT acc[RT][CPT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[r][i] = AccT(0);

  if (t < CONSUMERS) {
    stage_x(x, sm.xs, rows, B, K, kb, kl, kx, xrow, x_vec != 0);
    consumers_sync();
  }
  run_ring(sm, &map, stages, nst, stage_bytes, true, n0, kb, stage_k,
           [&](const unsigned char* st, int j) {
    if (!active) return;
    for (int ch = s; ch < 8; ch += KS) {
      const int k = j * stage_k + ch * VEC;  // within the split
      if (k >= kl) break;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int nl = cl + i * CLc;
        AccT wv[VEC];
        load_n<VEC>(reinterpret_cast<const TW*>(st + nl * 128 + ((ch ^ (nl & 7)) << 4)), wv);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          AccT xv[VEC];
          load_n<VEC>(reinterpret_cast<const TX*>(sm.xs + (g * RT + r) * xrow) + k, xv);
          AccT d = AccT(0);
#pragma unroll
          for (int v = 0; v < VEC; ++v) d += xv[v] * wv[v];
          acc[r][i] += d;
        }
      }
    }
  });
  if (t >= CONSUMERS) return;

  consumers_sync();
  AccT* red = reinterpret_cast<AccT*>(sm.ring);  // [KS][rows][bn]
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        red[(s * rows + g * RT + r) * bn + cl + i * CLc] = acc[r][i];
  }
  consumers_sync();
  reduce_and_store(red, KS, rows, out, partial, tickets, B, N, n0, bn, out_type);
}


// Row layout on the tensor cores, bf16 x and 8 < B <= 16 MT <= 128: mma.sync
// m16n8k16 with f32 accumulators. A CUDA-core thread must read each W
// vector from shared memory once per group of rows it holds, which at
// B = 64 makes shared memory, not HBM, the bound; an mma tile reads W once
// for 16 rows and x through ldmatrix. Each warp owns bn / 8 / 8 column
// tiles of 8 (1 or 2) and walks the stage's K in steps of 16 for all MT
// row tiles. An f32 W element is cut into three bf16 terms by truncation
// (kernels/ref.py split_bf16x3: exact, and x is bf16, so the three
// products sum to the f32 product up to summation order); up to 4 row
// tiles the first term accumulates apart from the two small ones, so the
// tensor cores' truncating accumulation costs no more than one bf16 pass
// would.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The high bf16 halves of two 32-bit words, x0 in the low half.
__device__ __forceinline__ uint32_t hi2(uint32_t x0, uint32_t x1) {
  return __byte_perm(x0, x1, 0x7632);
}

// B fragment words of W elements (k, k + 1): one term for a bf16 W, the
// three truncated bf16 terms of an f32 W.
__device__ __forceinline__ void b_terms(float w0, float w1, uint32_t (&t)[3]) {
  uint32_t u[2], v[2], r[2];
  const float w[2] = {w0, w1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    u[j] = __float_as_uint(w[j]);
    const float r1 = __fsub_rn(w[j], __uint_as_float(u[j] & 0xFFFF0000u));
    v[j] = __float_as_uint(r1);
    r[j] = __float_as_uint(__fsub_rn(r1, __uint_as_float(v[j] & 0xFFFF0000u)));
  }
  t[0] = hi2(u[0], u[1]);
  t[1] = hi2(v[0], v[1]);
  t[2] = hi2(r[0], r[1]);
}
__device__ __forceinline__ void b_terms(__nv_bfloat16 w0, __nv_bfloat16 w1,
                                        uint32_t (&t)[3]) {
  t[0] = static_cast<uint32_t>(__bfloat16_as_ushort(w0)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(w1)) << 16);
}

template <int MT, typename TW>
__global__ void __launch_bounds__(THREADS, 2)
gemv_tma_mma(const __grid_constant__ CUtensorMap map,
             const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
             float* __restrict__ partial, unsigned* __restrict__ tickets, int B,
             int K, int N, int bn, int k_per_split, int stage_k, int stages,
             int out_type, int x_vec) {
  constexpr bool SPLIT = sizeof(TW) == 4;
  // 8 row tiles leave no registers for a second accumulator: there the
  // three terms share one, over a split the partition caps near 180 of K
  // (the x slice of 128 rows): 3 x 12 truncating steps, not 3 x 160.
  constexpr int NACC = SPLIT && MT <= 4 ? 2 : 1;
  const int rows = MT * 16;
  const int kb = blockIdx.y * k_per_split, kl = min(k_per_split, K - kb);
  const int nst = (kl + stage_k - 1) / stage_k, kx = nst * stage_k;
  const int xrow = x_row_bytes(kx, 2);
  const int n0 = blockIdx.x * bn;
  const int stage_bytes = stage_k * bn * static_cast<int>(sizeof(TW));
  const Smem sm = carve(rows, xrow, stages);
  init_barriers(sm, stages);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int NT = bn / 64;        // column tiles of 8 a warp owns (1 or 2)
  const int wn0 = warp * NT * 8; // the warp's first column in the block
  float acc[NACC][MT][2][4];
#pragma unroll
  for (int h = 0; h < NACC; ++h)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][m][nt][e] = 0.f;

  if (t < CONSUMERS) {
    stage_x(x, sm.xs, rows, B, K, kb, kl, kx, xrow, x_vec != 0);
    consumers_sync();
  }
  // ldmatrix: lane l gives the address of row (l % 8) + 8 ((l / 8) % 2)
  // and k offset 8 (l / 16) of its row tile
  const uint32_t a_base = smem_u32(sm.xs) +
                          ((lane % 8) + 8 * ((lane / 8) % 2)) * xrow + (lane / 16) * 16;
  run_ring(sm, &map, stages, nst, stage_bytes, false, n0, kb, stage_k,
           [&](const unsigned char* st, int j) {
    const TW* w = reinterpret_cast<const TW*>(st);
    for (int ks = 0; ks < stage_k; ks += 16) {
      const int k = j * stage_k + ks;  // within the split
      if (k >= kl) break;
      uint32_t b[2][2][3];  // [column tile][k half][term]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt >= NT) break;
        const TW* col = w + (ks + 2 * tq) * bn + wn0 + nt * 8 + g;
        b_terms(col[0], col[bn], b[nt][0]);
        b_terms(col[8 * bn], col[9 * bn], b[nt][1]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + m * 16 * xrow + k * 2);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt >= NT) break;
          mma_bf16(acc[0][m][nt], a, b[nt][0][0], b[nt][1][0]);
          if constexpr (SPLIT) {
            mma_bf16(acc[NACC - 1][m][nt], a, b[nt][0][1], b[nt][1][1]);
            mma_bf16(acc[NACC - 1][m][nt], a, b[nt][0][2], b[nt][1][2]);
          }
        }
      }
    }
  });
  if (t >= CONSUMERS) return;

  consumers_sync();
  float* red = reinterpret_cast<float*>(sm.ring);  // [rows][bn]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt >= NT) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m * 16 + g + 8 * (e / 2), c = wn0 + nt * 8 + 2 * tq + e % 2;
        red[r * bn + c] = NACC == 2 ? acc[0][m][nt][e] + acc[NACC - 1][m][nt][e]
                                    : acc[0][m][nt][e];
      }
    }
  consumers_sync();
  reduce_and_store(red, 1, rows, out, partial, tickets, B, N, n0, bn, out_type);
}

template <typename Kern, typename TX>
cudaError_t launch_kern(Kern kern, bool& attr_set, const Args& p, int rows,
                        int stage_k) {
  if (!attr_set) {
    cudaError_t e = allow_smem(kern);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int kx = (p.k_per_split + stage_k - 1) / stage_k * stage_k;
  const size_t smem = 1024 + RING +
                      static_cast<size_t>(rows) * x_row_bytes(kx, sizeof(TX)) +
                      16 * p.stages;
  dim3 grid((p.N + p.bn - 1) / p.bn, p.splits);
  using AccT = typename AccOf<TX>::type;
  kern<<<grid, THREADS, smem, p.stream>>>(
      *p.map, static_cast<const TX*>(p.x), p.out, static_cast<AccT*>(p.partial),
      p.tickets, p.B, p.K, p.N, p.bn, p.k_per_split, p.stage_k, p.stages,
      p.out_type, p.x_vec);
  return cudaGetLastError();
}

template <int RT, typename TX, typename TW>
cudaError_t launch_row(const Args& p) {
  static bool attr_set = false;
  const int rows = (p.B + RT - 1) / RT * RT;
  return launch_kern<decltype(&gemv_tma_row<RT, TX, TW>), TX>(
      gemv_tma_row<RT, TX, TW>, attr_set, p, rows, p.stage_k);
}

template <int RT, int CPT, typename TX, typename TW>
cudaError_t launch_col(const Args& p) {
  static bool attr_set = false;
  const int rows = (p.B + RT - 1) / RT * RT;
  return launch_kern<decltype(&gemv_tma_col<RT, CPT, TX, TW>), TX>(
      gemv_tma_col<RT, CPT, TX, TW>, attr_set, p, rows, p.stage_k);
}

template <int MT, typename TW>
cudaError_t launch_mma(const Args& p) {
  static bool attr_set = false;
  return launch_kern<decltype(&gemv_tma_mma<MT, TW>), __nv_bfloat16>(
      gemv_tma_mma<MT, TW>, attr_set, p, MT * 16, p.stage_k);
}

// mt: row tiles of 16 (kernels/decode_matvec.py tma_threads).
template <typename TW>
cudaError_t by_tiles_mma(const Args& p) {
  switch (p.mt) {
    case 1: return launch_mma<1, TW>(p);
    case 2: return launch_mma<2, TW>(p);
    case 4: return launch_mma<4, TW>(p);
    case 8: return launch_mma<8, TW>(p);
    default: return cudaErrorInvalidValue;
  }
}

// rt: rows a thread holds (kernels/decode_matvec.py tma_threads).
template <typename TX, typename TW>
cudaError_t by_rows_row(const Args& p) {
  switch (p.rt) {
    case 1: return launch_row<1, TX, TW>(p);
    case 2: return launch_row<2, TX, TW>(p);
    case 4: return launch_row<4, TX, TW>(p);
    case 8: return launch_row<8, TX, TW>(p);
    case 16:
      if constexpr (RowVec<TW>::n == 4) return launch_row<16, TX, TW>(p);
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// (rt, cpt): rows and columns a thread holds, rt * cpt <= 64.
template <typename TX, typename TW>
cudaError_t by_rows_col(const Args& p) {
  if (p.cpt == 1) {
    switch (p.rt) {
      case 1: return launch_col<1, 1, TX, TW>(p);
      case 2: return launch_col<2, 1, TX, TW>(p);
      case 4: return launch_col<4, 1, TX, TW>(p);
      case 8: return launch_col<8, 1, TX, TW>(p);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.rt != 8) return cudaErrorInvalidValue;
  switch (p.cpt) {
    case 2: return launch_col<8, 2, TX, TW>(p);
    case 4: return launch_col<8, 4, TX, TW>(p);
    case 8: return launch_col<8, 8, TX, TW>(p);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TW>
cudaError_t by_layout(const Args& p) {
  return p.w_col ? by_rows_col<TX, TW>(p) : by_rows_row<TX, TW>(p);
}

}  // namespace tma

// =============================================== route 2: CUDA cores
namespace core {

constexpr int THREADS = 256;

template <typename T> struct VecOf { static constexpr int n = 16 / sizeof(T); };
template <> struct VecOf<int8_t> { static constexpr int n = 8; };

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

// One block owns bn columns x ROWS rows x one K split; the split's partial
// goes to `partial` (splits > 1) and the tile's last block sums them.
template <int ROWS, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
gemv_core(const TX* __restrict__ x, const TW* __restrict__ w,
          void* __restrict__ out, typename AccOf<TX>::type* __restrict__ partial,
          unsigned* __restrict__ tickets, int B, int K, int N, int bk, int bn,
          int k_per_split, int out_type, int vec_ok, int w_col) {
  using AccT = typename AccOf<TX>::type;
  constexpr int VEC = VecOf<TW>::n;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  AccT* xs = reinterpret_cast<AccT*>(smem_raw);  // [ROWS][bk]
  AccT* red = xs + ROWS * bk;                    // row: [KS][ROWS][bn]

  const int splits = gridDim.y;
  const int r0 = blockIdx.z * ROWS, rb = min(ROWS, B - r0);
  const int n0 = blockIdx.x * bn;
  const int kb = blockIdx.y * k_per_split, ke = min(K, kb + k_per_split);
  auto put = [&](int r, int n, AccT v) {
    const size_t o = static_cast<size_t>(r0 + r) * N + n;
    if (splits > 1) partial[static_cast<size_t>(blockIdx.y) * B * N + o] = v;
    else store(out, o, out_type, v);
  };

  if (!w_col) {
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
      stage_x<ROWS>(x, xs, r0, rb, K, k0, kl, bk);
      __syncthreads();
      if (n < N) {
        const bool full = vec_ok && n + VEC <= N;
#pragma unroll 4
        for (int kk = s; kk < kl; kk += KS) {
          const TW* p = w + static_cast<size_t>(k0 + kk) * N + n;
          AccT wv[VEC];
          if (full) {
            load_n<VEC>(p, wv);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) wv[v] = (n + v < N) ? cvt(p[v]) : AccT(0);
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
      if (r >= rb || n0 + col >= N) continue;
      AccT sum = AccT(0);
      for (int ss = 0; ss < KS; ++ss) sum += red[(ss * ROWS + r) * bn + col];
      put(r, n0 + col, sum);
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int j = 0; j < bn; j += WARPS) {
      const int n = n0 + j + warp;
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
          if (vec_ok && kk + VEC <= kl) {
            AccT wv[VEC];
            load_n<VEC>(p + kk, wv);
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
      if (lane == 0 && n < N)
        for (int r = 0; r < rb; ++r) put(r, n, acc[r]);
    }
  }
  if (splits == 1) return;
  const unsigned tile = blockIdx.z * gridDim.x + blockIdx.x;
  finish_splits(tickets, tile, splits, THREADS, 0, &last, [&] {
    sum_partials(partial, out, splits, ROWS * bn, THREADS,
                 static_cast<size_t>(B) * N, out_type, [&](int o, size_t& i) {
                   const int r = o / bn, n = n0 + o - r * bn;
                   i = static_cast<size_t>(r0 + r) * N + n;
                   return r < rb && n < N;
                 });
  });
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
  auto kern = gemv_core<ROWS, TX, TW>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = allow_smem(kern);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((p.N + p.bn - 1) / p.bn, p.splits, (p.B + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, p.stream>>>(
      static_cast<const TX*>(p.x), static_cast<const TW*>(p.w), p.out,
      static_cast<AccT*>(p.partial), p.tickets, p.B, p.K, p.N, p.bk, p.bn,
      p.k_per_split, p.out_type, p.vec_ok, p.w_col);
  return cudaGetLastError();
}

// Rows one block keeps in registers (kernels/matmul.py rows_per_group);
// more rows go to further blockIdx.z groups, each streaming W again.
template <typename TX, typename TW>
cudaError_t by_rows(const Args& p) {
  if (p.B <= 1) return launch<1, TX, TW>(p);
  if (p.B <= 2) return launch<2, TX, TW>(p);
  if (p.B <= 4) return launch<4, TX, TW>(p);
  return launch<8, TX, TW>(p);
}

}  // namespace core

}  // namespace

#if REPRO_PART == 1
cudaError_t repro_mv::run_tma_bf16_row(const Args& p) {
  if (p.w_type == F32) return tma::by_rows_row<__nv_bfloat16, float>(p);
  if (p.w_type == BF16) return tma::by_rows_row<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 2
cudaError_t repro_mv::run_tma_bf16_col(const Args& p) {
  if (p.w_type == F32) return tma::by_rows_col<__nv_bfloat16, float>(p);
  if (p.w_type == BF16) return tma::by_rows_col<__nv_bfloat16, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 3
cudaError_t repro_mv::run_tma_f32(const Args& p) {
  if (p.w_type == F32) return tma::by_layout<float, float>(p);
  if (p.w_type == BF16) return tma::by_layout<float, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 4
cudaError_t repro_mv::run_tma_i8(const Args& p) {
  if (p.w_type == I8) return tma::by_layout<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 5
cudaError_t repro_mv::run_core(const Args& p) {
  if (p.x_type == BF16 && p.w_type == F32) return core::by_rows<__nv_bfloat16, float>(p);
  if (p.x_type == BF16 && p.w_type == BF16) return core::by_rows<__nv_bfloat16, __nv_bfloat16>(p);
  if (p.x_type == F32 && p.w_type == F32) return core::by_rows<float, float>(p);
  if (p.x_type == F32 && p.w_type == BF16) return core::by_rows<float, __nv_bfloat16>(p);
  if (p.x_type == I8 && p.w_type == I8) return core::by_rows<int8_t, int8_t>(p);
  return cudaErrorInvalidValue;
}
#elif REPRO_PART == 6
cudaError_t repro_mv::run_tma_mma(const Args& p) {
  if (p.w_type == F32) return tma::by_tiles_mma<float>(p);
  if (p.w_type == BF16) return tma::by_tiles_mma<__nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}
#else
namespace {

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

// W's map: a row-major (outer, inner) matrix, boxes of (box_outer,
// box_inner) elements, zero fill outside.
bool make_map(CUtensorMap* map, int w_type, const void* base, int inner,
              int outer, int box_inner, int box_outer, bool swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      w_type == repro_mv::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : w_type == repro_mv::BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int esize = w_type == repro_mv::F32 ? 4 : w_type == repro_mv::BF16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. The route and the
// partition are the wrapper's (kernels/decode_matvec.py route(),
// launch_plan()); this checks only what no kernel can take. `partial` is
// an (splits, B, N) f32 / i32 scratch buffer and `tickets` one zeroed
// counter per grid tile, both unused when splits == 1.
extern "C" int repro_decode_matvec(const void* x, const void* w, void* out,
                                   void* partial, void* tickets, int B, int K,
                                   int N, int bk, int bn, int splits,
                                   int k_per_split, int x_type, int w_type,
                                   int out_type, int w_col, int route,
                                   int vec_ok, int rt, int cpt, int stage_k,
                                   int stages, int x_vec, int mt, void* stream) {
  using namespace repro_mv;
  if (B <= 0 || B > 128 || K <= 0 || N <= 0 || splits <= 0 ||
      k_per_split <= 0 || k_per_split % 32 != 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      static_cast<long long>(splits) * k_per_split < K ||
      (splits > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  Args p{x, w, out, partial, static_cast<unsigned*>(tickets), nullptr,
         B, K, N, bk, bn, splits, k_per_split, x_type, w_type, out_type, w_col,
         vec_ok, rt, cpt, stage_k, stages, x_vec, mt, static_cast<cudaStream_t>(stream)};
  if (route == CUDA_CORE) {
    if (bk <= 0 || bk % 32 != 0) return cudaErrorInvalidValue;
    return run_core(p);
  }
  if (route != TMA) return cudaErrorInvalidValue;
  const int esize = w_type == F32 ? 4 : w_type == BF16 ? 2 : 1;
  // one stage of the 64 KB ring: row (stage_k, bn), col (bn, 128 bytes of K)
  const int stage_bytes = w_col ? bn * 128 : stage_k * bn * esize;
  // every row group must find a thread lane (kernels/decode_matvec.py
  // tma_threads picks rt and cpt so that it does)
  const int groups = (B + rt - 1) / (rt > 0 ? rt : 1);
  const int lanes = w_col ? (cpt > 0 && bn % cpt == 0 ? bn / cpt : 1 << 20)
                          : bn / (w_type == F32 ? 4 : 8);
  if (mt == 0 && (rt <= 0 || groups * lanes > 256)) return cudaErrorInvalidValue;
  if (mt != 0 && (w_col || x_type != BF16 || B > 16 * mt)) return cudaErrorInvalidValue;
  if ((bn != 64 && bn != 128) || stage_k <= 0 || stage_k > 256 ||
      stages * stage_bytes != 64 * 1024 || stages < 4 ||
      (w_col && stage_k * esize != 128) ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (static_cast<long long>(w_col ? K : N) * esize) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  const bool ok = w_col ? make_map(&map, w_type, w, K, N, stage_k, bn, true)
                        : make_map(&map, w_type, w, N, K, bn, stage_k, false);
  if (!ok) return cudaErrorInvalidValue;
  p.map = &map;
  if (mt != 0) return run_tma_mma(p);
  switch (x_type) {
    case BF16: return w_col ? run_tma_bf16_col(p) : run_tma_bf16_row(p);
    case F32: return run_tma_f32(p);
    case I8: return run_tma_i8(p);
    default: return cudaErrorInvalidValue;
  }
}
#endif

// RWKV-6 WKV recurrence in chunk-parallel form, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv.py :: wkv / _wkv_kernel
// (pl.pallas_call at wkv.py:86, the kernel body at wkv.py:28). Computes
// what the plain version repro_torch.layers.rwkv.wkv_chunk_parallel
// computes, for one (b, h) row:
//
//   per chunk of C = 32 steps, with cl the exclusive cumsum of the log
//   decay wl, ci = cl + wl, ce = ci[C-1], mid = cl[C/2]:
//     y  = (r e^cl) S  +  tril_{-1}(r e^(cl-mid) . (k e^min(mid-ci, 60))^T) v
//          + (sum_n r u k) v
//     S' = e^ce S + (k e^min(ce-ci, 0))^T v
//
// Inputs r, k, v (f32 or bf16, converted to f32 on load: exact) and wl
// (f32) are read in the caller's layout: element strides for (b, h, t),
// unit stride along N. u is (H, N) f32, the state (B, H, N, N) f32
// contiguous; y is written f32 in its own (b, h, t) strides, the final
// state (B, H, N, N). T % 32 == 0; N in {16, 32, 64, 128}.
//
// What bounds it on the H100, at the serving path's shape (B 4 x H 40,
// T 128, N 64): bytes. In the (B*H, T, N) f32 layout (kernels/wkv.py wkv)
// it reads 21 MB of r, k, v, wl, writes 5.2 MB of y and moves 5.2 MB of
// state: 31.5 MB, 9.4 us at 3.35 TB/s. In time_mix's own (B, T, H, N)
// layout with bf16 r, k, v (kernels/wkv.py wkv_heads) it moves 23.6 MB:
// 7.0 us. The products are 0.42 GFLOP of f32, 6.3 us at 67 TFLOP/s on the
// CUDA cores (not the tensor cores: TF32 would not hold rtol = 2e-4, and
// an exact three-term bf16 split costs more than it saves at this size).
//
// Measured on an H100 (chip_smoke.py phase 3b; PERF.md): 0.049 ms at the
// path shape in time_mix's layout, 7x the bytes bound. Clock stamps of the
// phases put a chunk at ~11K cycles for a block alone on an SM: the
// dependent chains of the busiest warps (A and y1, ~1,150 instructions on
// two warps each; A v on two warps after the barrier) set it, not issue
// slots or shared-memory bandwidth, and the SMs that hold 3 of the 320
// blocks set the launch. The same products on the tensor cores (mma.sync
// with operands split into two TF32 terms) measured no faster.
//
// The first version of this kernel (one block per (b, h) row, scalar
// shared-memory operands, the caller's tensors copied to its layout) took
// 14x its bound, and its layout copies 40% more; what this design does
// about each cause:
// 1. Too few blocks, uneven per SM: 160 rows on 132 SMs. The value
//    columns m of y and S' are independent, so a block owns (b, h, a slice
//    of MS value columns): it loads the full r, k, wl chunk tiles, its
//    slice of v and its (N, MS) slice of the state, recomputes what every
//    slice needs (cumsum, decay-scaled tiles, A, the bonus diagonal) and
//    writes only its columns of y and S'. Nothing crosses blocks: no
//    atomics, no second pass, deterministic. MS (16 or 32) and the grid
//    are the wrapper's choice (kernels/wkv.py partition); at the path
//    shape 320 blocks, 3 an SM by shared memory (bf16 inputs).
// 2. Shared-memory bound products. Each thread owns a 4 x 4 register tile
//    (S': SN x 4) and reads one float4 of each operand a step, so a load
//    feeds 16 FMAs, not half of one: the tiles a product reads along t are
//    stored transposed ([n][t]). The three products of step 3 run at once
//    on their own warps (A on warps 0-1, the tiles below the diagonal
//    only; y1 = (r e^cl) S on warps 2-3, which add A v in step 4; S' on
//    warps 4-7, held in registers until every read of S is done). The
//    cumsum of the log decay is a blocked warp scan (8 groups of 4 steps,
//    3 shuffles); the bonus diagonal is summed from 8 per-warp partials in
//    a fixed order.
// 3. Nothing overlapped. Chunk c + 1's r, k, wl and v slice are loaded
//    with 16-byte cp.async into one staging area while chunk c's products
//    run: the staging area is free once chunk c's decay-scaled tiles are
//    made from it. Four barriers a chunk. No mbarrier, so no wait can hang.
// 4. The layout was the kernel's: time_mix made five real copies around
//    every launch (r, k, v, the log decay to (B*H, T, N) f32, y back).
//    The kernel reads the caller's strides, so time_mix passes its
//    (B, T, H, N) views and reads y back as (B, T, H, N) in place.
// The route (16-byte cp.async, or plain element loads when a base or a
// row stride is not a 16-byte multiple) is the wrapper's, picked before
// the launch (kernels/wkv.py route).
//
// Shared memory (kernels/wkv.py smem_bytes mirrors Layout): the staging
// area (r, k in their own type with rows padded by 16 bytes, wl f32 with
// rows padded to N + 4, the v slice), the decay-scaled tiles (three
// transposed, k e^(ce-ci) with rows of N + 4), v as f32, the state slice,
// A^T, D and its partials, three (N,) vectors: 71.6 KB at N = 64, MS = 32,
// bf16 inputs (3 blocks an SM); 81.8 KB with f32 inputs (2).
//
// Build: kernels/build.py compiles this file once per part, in parallel:
// -DREPRO_PART=1..4 instantiate the kernels of one input type and load
// route each, 5..6 the backward's of one input type; part 0 holds the C
// entry points.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef REPRO_PART
#define REPRO_PART 0
#endif

namespace wkv_cu {

constexpr int C = 32;  // CHUNK, the reference's
constexpr int THREADS = 256;

struct Strides {
  long long b, h, t;  // elements
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* wl;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  float* states;  // (B, H, T / C, N, N) chunk-start states, or null
  int B, H, T;
  Strides sr, sk, sv, sw, sy;
  cudaStream_t stream;
};

// The backward (repro_wkv_bwd): one block per (b, h) row, walking the
// chunks in reverse.
struct BwdArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* wl;
  const float* u;
  const float* states;  // (B, H, T / C, N, N): the forward's chunk-start states
  const float* dy;
  const float* ds;      // (B, H, N, N) gradient of the final state, or null
  float* dr;
  float* dk;
  float* dv;
  float* dwl;
  float* du_rows;       // (B, H, N): this row's share of du
  float* ds0;           // (B, H, N, N) gradient of the initial state, or null
  int B, H, T;
  Strides sr, sk, sv, sw, sdy, sg;  // sg: the four (B, T, H, N)-like gradients
  cudaStream_t stream;
};

cudaError_t run_f32_vec(const Args& p, int N, int MS);
cudaError_t run_f32_scalar(const Args& p, int N, int MS);
cudaError_t run_bf16_vec(const Args& p, int N, int MS);
cudaError_t run_bf16_scalar(const Args& p, int N, int MS);
cudaError_t run_bwd_f32(const BwdArgs& p, int N);
cudaError_t run_bwd_bf16(const BwdArgs& p, int N);

}  // namespace wkv_cu

#if REPRO_PART != 0
namespace {

using wkv_cu::Args;
using wkv_cu::C;
using wkv_cu::THREADS;

// Offsets in 4-byte words of one block's dynamic shared memory; every
// region starts on a 16-byte boundary. Tiles whose columns a warp reads
// along t are stored transposed ([n][t]), so that a thread's 4 rows are
// one float4.
template <int N, int MS, int ISZ>
struct Layout {
  static constexpr int LDR = N + 16 / ISZ;  // staged r, k rows (elements)
  static constexpr int LDW = N + 4;         // staged wl (then cl) rows
  static constexpr int LDK = N + 4;         // k e^(ce-ci) rows
  static constexpr int R_RAW = 0;
  static constexpr int K_RAW = R_RAW + C * LDR * ISZ / 4;
  static constexpr int W_RAW = K_RAW + C * LDR * ISZ / 4;
  static constexpr int V_RAW = W_RAW + C * LDW;
  static constexpr int RET = V_RAW + C * MS * ISZ / 4;  // (r e^cl)^T        [N][C]
  static constexpr int RMT = RET + N * C;               // (r e^(cl-mid))^T  [N][C]
  static constexpr int KIT = RMT + N * C;               // (k e^(mid-ci))^T  [N][C]
  static constexpr int KD = KIT + N * C;                // k e^(ce-ci)       [C][LDK]
  static constexpr int VT = KD + C * LDK;               // v slice, f32      [C][MS]
  static constexpr int S = VT + C * MS;                 // state slice       [N][MS]
  static constexpr int AT = S + N * MS;                 // A^T               [C][C]
  static constexpr int DP = AT + C * C;                 // D's partials [8][C]
  static constexpr int D = DP + (THREADS / 32) * C;     // bonus diagonal
  static constexpr int CE = D + C;                      // chunk-end cl
  static constexpr int MID = CE + N;                    // cl[C/2]
  static constexpr int U = MID + N;
  static constexpr int WORDS = U + N;
};

// Thread roles in the products (a thread owns one register tile of each):
//   warps 0-1: A, 4 x 4 tiles of the 8 x 8 tile grid (upper tiles are 0);
//   warps 2-3: y, 4 rows x 4 value columns (2 MS threads);
//   warps 4-7: S', SN rows x 4 value columns (at most 128 threads).
template <int N, int MS>
struct Roles {
  static constexpr int SN = N * MS / 512 > 1 ? N * MS / 512 : 1;
  static constexpr int S_THREADS = (MS / 4) * (N / SN);
  static_assert(2 * MS <= 64 && S_THREADS <= 128, "roles exceed the block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Four consecutive elements of a staged tile, as f32 (exact).
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = ld4(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 shfl_up4(float4 x, int d) {
  return make_float4(__shfl_up_sync(0xffffffffu, x.x, d), __shfl_up_sync(0xffffffffu, x.y, d),
                     __shfl_up_sync(0xffffffffu, x.z, d), __shfl_up_sync(0xffffffffu, x.w, d));
}
__device__ __forceinline__ float4 shfl_down4(float4 x, int d) {
  return make_float4(__shfl_down_sync(0xffffffffu, x.x, d), __shfl_down_sync(0xffffffffu, x.y, d),
                     __shfl_down_sync(0xffffffffu, x.z, d), __shfl_down_sync(0xffffffffu, x.w, d));
}
__device__ __forceinline__ float4 shfl4(float4 x, int src) {
  return make_float4(__shfl_sync(0xffffffffu, x.x, src), __shfl_sync(0xffffffffu, x.y, src),
                     __shfl_sync(0xffffffffu, x.z, src), __shfl_sync(0xffffffffu, x.w, src));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float at(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// CNT consecutive f32 of a shared row (CNT 1, 2 or a multiple of 4).
template <int CNT>
__device__ __forceinline__ void load_row(const float* p, float out[CNT]) {
  if constexpr (CNT == 1) {
    out[0] = p[0];
  } else if constexpr (CNT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < CNT; i += 4) load4(p + i, out + i);
  }
}

// acc[4 i + j] += a[i] * b[j] for the float4s a and b.
__device__ __forceinline__ void outer4(float acc[16], float4 a, float4 b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[4 * i + j] += at(a, i) * at(b, j);
}

// Blocks an SM holds by shared memory (228 KB, 1 KB of it reserved a
// block), at most 3: the register budget of a thread is set for them.
template <typename Tin, int N, int MS>
constexpr int min_blocks() {
  const int bytes = 4 * Layout<N, MS, static_cast<int>(sizeof(Tin))>::WORDS + 1024;
  const int fit = 233472 / bytes;
  return fit < 1 ? 1 : fit > 3 ? 3 : fit;
}

template <typename Tin, bool VEC, int N, int MS>
__global__ void __launch_bounds__(THREADS, (min_blocks<Tin, N, MS>()))
wkv_kernel(const Args p) {
  using L = Layout<N, MS, static_cast<int>(sizeof(Tin))>;
  using R = Roles<N, MS>;
  constexpr int SN = R::SN;
  constexpr int EPV = 16 / static_cast<int>(sizeof(Tin));  // elements a 16-byte piece
  extern __shared__ __align__(16) float smem[];
  Tin* r_raw = reinterpret_cast<Tin*>(smem + L::R_RAW);
  Tin* k_raw = reinterpret_cast<Tin*>(smem + L::K_RAW);
  float* w_raw = smem + L::W_RAW;
  Tin* v_raw = reinterpret_cast<Tin*>(smem + L::V_RAW);
  float* RET = smem + L::RET;
  float* RMT = smem + L::RMT;
  float* KIT = smem + L::KIT;
  float* KD = smem + L::KD;
  float* VT = smem + L::VT;
  float* S = smem + L::S;
  float* AT = smem + L::AT;
  float* DP = smem + L::DP;
  float* D = smem + L::D;
  float* CE = smem + L::CE;
  float* MID = smem + L::MID;
  float* U = smem + L::U;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // slices of one (b, h) row are neighbours in the grid: they share its
  // r, k and wl reads through L2
  constexpr int SLICES = N / MS;
  const int slice = blockIdx.x % SLICES;
  const int row = blockIdx.x / SLICES;
  const int h = row % p.H, b = row / p.H;
  const int m0 = slice * MS;
  const size_t srow = (static_cast<size_t>(b) * p.H + h) * N * N + m0;

  // chunk t0's r, k, wl and v slice into the staging area (the row
  // pointers are recomputed from the parameters at each use: holding them
  // across the chunk loop costs registers the products need)
  auto stage = [&](int t0) {
    const Tin* rg = static_cast<const Tin*>(p.r) + b * p.sr.b + h * p.sr.h;
    const Tin* kg = static_cast<const Tin*>(p.k) + b * p.sk.b + h * p.sk.h;
    const Tin* vg = static_cast<const Tin*>(p.v) + b * p.sv.b + h * p.sv.h + m0;
    const float* wg = p.wl + b * p.sw.b + h * p.sw.h;
    if constexpr (VEC) {
      constexpr int PR = N / EPV, PW = N / 4, PV = MS / EPV;
      for (int i = tid; i < C * PR; i += THREADS) {
        const int t = i / PR, j = (i - t * PR) * EPV;
        cp_async16(r_raw + t * L::LDR + j, rg + (t0 + t) * p.sr.t + j);
        cp_async16(k_raw + t * L::LDR + j, kg + (t0 + t) * p.sk.t + j);
      }
      for (int i = tid; i < C * PW; i += THREADS) {
        const int t = i / PW, j = (i - t * PW) * 4;
        cp_async16(w_raw + t * L::LDW + j, wg + (t0 + t) * p.sw.t + j);
      }
      for (int i = tid; i < C * PV; i += THREADS) {
        const int t = i / PV, j = (i - t * PV) * EPV;
        cp_async16(v_raw + t * MS + j, vg + (t0 + t) * p.sv.t + j);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < C * N; i += THREADS) {
        const int t = i / N, n = i - t * N;
        r_raw[t * L::LDR + n] = rg[(t0 + t) * p.sr.t + n];
        k_raw[t * L::LDR + n] = kg[(t0 + t) * p.sk.t + n];
        w_raw[t * L::LDW + n] = wg[(t0 + t) * p.sw.t + n];
      }
      for (int i = tid; i < C * MS; i += THREADS) {
        const int t = i / MS, m = i - t * MS;
        v_raw[i] = vg[(t0 + t) * p.sv.t + m];
      }
    }
  };

  if (p.T > 0) stage(0);
  for (int i = tid; i < N; i += THREADS) U[i] = p.u[static_cast<size_t>(h) * N + i];
  for (int i = tid; i < N * MS; i += THREADS) {
    const int n = i / MS, m = i - n * MS;
    S[i] = p.s0[srow + static_cast<size_t>(n) * N + m];
  }

  // register-tile coordinates of the thread's role
  const int ta = tid / 8, sa = tid % 8;                   // A: tile (ta, sa)
  const int yth = tid - 64;                               // y: warps 2-3
  const int yt = 4 * (yth / (MS / 4)), ym = 4 * (yth % (MS / 4));
  const bool y_role = yth >= 0 && yth < 2 * MS;
  const int sth = tid - 128;                              // S': warps 4-7
  const int sn = SN * (sth / (MS / 4)), sm = 4 * (sth % (MS / 4));
  const bool s_role = sth >= 0 && sth < R::S_THREADS;
  // held across the barrier between steps 3 and 4: y1 (4 x 4) in the y
  // role, the new state (SN x 4) in the S' role; one array, so that the
  // two roles share registers
  constexpr int HOLD = 4 * (SN > 4 ? SN : 4);
  float hold[HOLD] = {};

  for (int t0 = 0; t0 < p.T; t0 += C) {
    if constexpr (VEC) cp_async_wait_all();
    __syncthreads();  // the chunk is staged; the last chunk's products are done
    if (p.states != nullptr) {  // the state this chunk starts from (training)
      float* sg = p.states +
                  ((static_cast<size_t>(b) * p.H + h) * (p.T / C) + t0 / C) * N * N + m0;
      for (int i = tid; i < N * MS; i += THREADS) {
        const int n = i / MS, m = i - n * MS;
        sg[static_cast<size_t>(n) * N + m] = S[i];
      }
    }

    // 1. exclusive cumsum of wl along t, in place: lane = 4 * tg + q owns 4
    //    columns and the 4 steps of group tg; 8 groups scanned by shuffles
    if (tid < 2 * N) {
      const int q = lane & 3, tg = lane >> 2;
      const int n = 4 * (4 * warp + q);
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ld4(w_raw + (4 * tg + i) * L::LDW + n);
      const float4 tot = add4(add4(add4(w[0], w[1]), w[2]), w[3]);
      float4 inc = tot;
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) {
        const float4 o = shfl_up4(inc, 4 * d);
        if (tg >= d) inc = add4(inc, o);
      }
      float4 run = shfl_up4(inc, 4);
      if (tg == 0) run = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 ce = shfl4(inc, 28 + q);
      const float4 mid = shfl4(run, 16 + q);  // cl[16]: group 4's start
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st4(w_raw + (4 * tg + i) * L::LDW + n, run);
        run = add4(run, w[i]);
      }
      if (tg == 0) {
        st4(CE + n, ce);
        st4(MID + n, mid);
      }
    }
    __syncthreads();

    // 2. the decay-scaled tiles: lane = step t, a warp 4 columns at a time;
    //    ci[t] = cl[t + 1] (the next lane's), ce for the last step; expf
    //    (not __expf) and the reference's clips at 60 and 0; and the
    //    warp's partial of the bonus diagonal sum_n r u k
    float dpart = 0.f;
    for (int n = 4 * warp; n < N; n += 4 * (THREADS / 32)) {
      const int t = lane;
      const float4 cl = ld4(w_raw + t * L::LDW + n);
      const float4 ce = ld4(CE + n), mid = ld4(MID + n);
      float4 ci = shfl_down4(cl, 1);
      if (t == C - 1) ci = ce;
      float rv[4], kv[4], re[4], rm[4], ki[4], kd[4];
      load4(r_raw + t * L::LDR + n, rv);
      load4(k_raw + t * L::LDR + n, kv);
      const float4 u = ld4(U + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dpart += rv[j] * at(u, j) * kv[j];
        const float c = at(cl, j), m = at(mid, j), e = at(ce, j), x = at(ci, j);
        re[j] = rv[j] * expf(c);
        rm[j] = rv[j] * expf(c - m);
        ki[j] = kv[j] * expf(fminf(m - x, 60.f));
        kd[j] = kv[j] * expf(fminf(e - x, 0.f));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        RET[(n + j) * C + t] = re[j];
        RMT[(n + j) * C + t] = rm[j];
        KIT[(n + j) * C + t] = ki[j];
      }
      st4(KD + t * L::LDK + n, make_float4(kd[0], kd[1], kd[2], kd[3]));
    }
    DP[warp * C + lane] = dpart;
    for (int i = tid; i < C * (MS / 4); i += THREADS) {
      float x[4];
      load4(v_raw + 4 * i, x);
      st4(VT + 4 * i, make_float4(x[0], x[1], x[2], x[3]));
    }
    __syncthreads();

    // the staging area is free: bring the next chunk while this one computes
    if (t0 + C < p.T) stage(t0 + C);

    // 3. Three products at once, each thread on its own register tile; a
    //    float4 of each operand feeds 16 FMAs (8 for S' at SN = 1-2). The
    //    loops load step n + 1 before they use step n: the last step's
    //    loads read the first row of the next region of the layout, whose
    //    values are never used.
    if (warp < 2) {
      // A[t][s] = sum_n r e^(cl-mid)[t,n] k e^(mid-ci)[s,n], s < t; kept
      // as A^T for y's reads
      float acc[16] = {};
      if (sa <= ta) {
        float4 x = ld4(RMT + 4 * ta), k = ld4(KIT + 4 * sa);
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 xn = ld4(RMT + (n + 1) * C + 4 * ta);
          const float4 kn = ld4(KIT + (n + 1) * C + 4 * sa);
          outer4(acc, x, k);
          x = xn;
          k = kn;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * sa + j;
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s < 4 * ta + i ? acc[4 * i + j] : 0.f;
        st4(AT + s * C + 4 * ta, make_float4(a[0], a[1], a[2], a[3]));
      }
    } else if (warp < 4) {
      // y1 = (r e^cl) S
      if (y_role) {
        float4 e = ld4(RET + yt), sv = ld4(S + ym);
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 en = ld4(RET + (n + 1) * C + yt);
          const float4 svn = ld4(S + (n + 1) * MS + ym);
          outer4(hold, e, sv);
          e = en;
          sv = svn;
        }
      }
    } else if (s_role) {
      if (sth < C) {  // the bonus diagonal, its 8 partials in warp order
        float d = 0.f;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) d += DP[w * C + sth];
        D[sth] = d;
      }
      // S' = e^ce S + (k e^(ce-ci))^T v, stored after the barrier
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const float4 s = ld4(S + (sn + i) * MS + sm);
        const float e = expf(CE[sn + i]);
        hold[4 * i] = e * s.x;
        hold[4 * i + 1] = e * s.y;
        hold[4 * i + 2] = e * s.z;
        hold[4 * i + 3] = e * s.w;
      }
      float acc[SN][4] = {};
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        float kd[SN];
        load_row<SN>(KD + s * L::LDK + sn, kd);
        const float4 v = ld4(VT + s * MS + sm);
#pragma unroll
        for (int i = 0; i < SN; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += kd[i] * at(v, j);
      }
#pragma unroll
      for (int i = 0; i < SN; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hold[4 * i + j] += acc[i][j];
    }
    __syncthreads();  // A is complete; every read of S is done

    // 4. y = y1 + (A v + D v), written once; the new state into place
    if (y_role) {
      float y2[16] = {};
      float4 a = ld4(AT + yt), v = ld4(VT + ym);
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float4 an = ld4(AT + (s + 1) * C + yt);
        const float4 vn = ld4(VT + (s + 1) * MS + ym);
        outer4(y2, a, v);
        a = an;
        v = vn;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = yt + i;
        const float4 v = ld4(VT + t * MS + ym);
        const float d = D[t];
        float4 out;
        out.x = hold[4 * i] + (y2[4 * i] + d * v.x);
        out.y = hold[4 * i + 1] + (y2[4 * i + 1] + d * v.y);
        out.z = hold[4 * i + 2] + (y2[4 * i + 2] + d * v.z);
        out.w = hold[4 * i + 3] + (y2[4 * i + 3] + d * v.w);
        float* yg = p.y + b * p.sy.b + h * p.sy.h + (t0 + t) * p.sy.t + m0 + ym;
        *reinterpret_cast<float4*>(yg) = out;
#pragma unroll
        for (int j = 0; j < 4; ++j) hold[4 * i + j] = 0.f;
      }
    } else if (s_role) {
#pragma unroll
      for (int i = 0; i < SN; ++i)
        st4(S + (sn + i) * MS + sm,
            make_float4(hold[4 * i], hold[4 * i + 1], hold[4 * i + 2], hold[4 * i + 3]));
    }
  }

  __syncthreads();
  for (int i = tid; i < N * MS; i += THREADS) {
    const int n = i / MS, m = i - n * MS;
    p.s_out[srow + static_cast<size_t>(n) * N + m] = S[i];
  }
}

template <typename Tin, bool VEC, int N, int MS>
cudaError_t launch(const Args& p) {
  using L = Layout<N, MS, static_cast<int>(sizeof(Tin))>;
  constexpr size_t smem = 4 * static_cast<size_t>(L::WORDS);
  static bool attr_set = false;  // one attribute call per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(wkv_kernel<Tin, VEC, N, MS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_kernel<Tin, VEC, N, MS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long blocks = static_cast<long long>(p.B) * p.H * (N / MS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_kernel<Tin, VEC, N, MS>
      <<<static_cast<unsigned>(blocks), THREADS, smem, p.stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin, bool VEC>
cudaError_t by_shape(const Args& p, int N, int MS) {
  if (MS == 16) {
    switch (N) {
      case 16: return launch<Tin, VEC, 16, 16>(p);
      case 32: return launch<Tin, VEC, 32, 16>(p);
      case 64: return launch<Tin, VEC, 64, 16>(p);
      case 128: return launch<Tin, VEC, 128, 16>(p);
    }
  } else if (MS == 32) {
    switch (N) {
      case 32: return launch<Tin, VEC, 32, 32>(p);
      case 64: return launch<Tin, VEC, 64, 32>(p);
      case 128: return launch<Tin, VEC, 128, 32>(p);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
#endif

// ---------------------------------------------------------------- backward
//
// repro_wkv_bwd: the gradient of what wkv_chunk_parallel computes, given
// dy (the gradient of y, f32) and dS' (of the final state; null: zero),
// from r, k, v (f32 or bf16), wl, u and the forward's chunk-start states
// (repro_wkv's `states` output). One block owns one (b, h) row and walks
// its chunks in reverse, carrying dS (N x N, f32) in shared memory. Per
// chunk, with everything below recomputed from the chunk's inputs (cl, ci,
// ce, mid, the four decay-scaled tiles re, rm, ki, kd, A and the bonus
// diagonal D):
//   dre = dy S^T      dA = tril_{-1}(dy v^T)     dkd = v dS'^T
//   drm = dA ki       dki = dA^T rm               dD = rowsum(dy . v)
//   dv  = A^T dy + D dy + kd dS'
//   dr  = dre e^cl + drm e^(cl-mid) + dD u k
//   dk  = dki e^min(mid-ci, 60) + dkd e^min(ce-ci, 0) + dD u r
//   du += sum_t dD r k
//   dS  = e^ce dS' + re^T dy                       (carried to chunk c - 1)
// and the log decay's: the clamps pass no gradient past 60 and 0 (a tie
// passes it, as torch.clamp's gradient does), ci = cl + wl, cl the
// exclusive cumsum, ce its total, mid = cl[C/2]:
//   dci = -dki ki [mid-ci <= 60] - dkd kd [ce-ci <= 0]
//   dce = e^ce sum_m S dS' + sum_t dkd kd [ce-ci <= 0]
//   dmid = sum_t (dki ki [mid-ci <= 60] - drm rm)
//   dwl[t] = dci[t] + sum_{t' > t} (dre re + drm rm + dci)[t'] + dce
//            + [t < C/2] dmid                   (a reverse exclusive cumsum)
//
// What bounds it at the training path's shape (B 8, T 128, H 40, N 64):
// bytes (counted as chip_smoke.py's _wkv_bwd_bound counts them). It reads
// r, k, v (bf16), wl, dy and the states (f32) and writes dr, dk, dv, dwl
// (f32), ~110 MB, 0.033 ms at 3.35 TB/s; its products are ~1.83 GFLOP of
// f32, 0.027 ms at 67 TFLOP/s on the CUDA cores. This
// first design is simple, not fast: each thread computes output elements
// one at a time from shared memory (two loads an FMA), so shared-memory
// bandwidth, not the FMA rate, sets its pace; the tiles are padded to odd
// row lengths so that a warp's loads fall in distinct banks. Nothing
// crosses blocks: du is written per row and summed over b by the wrapper
// in a fixed order, so the result is deterministic. N <= 64 (shared
// memory, kernels/wkv.bwd_smem_bytes: 142.5 KB at N = 64, one block an
// SM).
#if REPRO_PART >= 5
namespace {

using wkv_cu::BwdArgs;
using wkv_cu::C;
using wkv_cu::THREADS;

template <int N>
struct BwdLayout {
  static constexpr int LD = N + 1;   // [C][N] and [N][N] rows
  static constexpr int LC = C + 1;   // [C][C] rows
  static constexpr int TILE = C * LD;
  static constexpr int R = 0, K = R + TILE, V = K + TILE, W = V + TILE, DY = W + TILE;
  static constexpr int CL = DY + TILE;
  static constexpr int RE = CL + TILE, RM = RE + TILE, KI = RM + TILE, KD = KI + TILE;
  static constexpr int DRE = KD + TILE;  // dre, then dcl + dci
  static constexpr int DKD = DRE + TILE; // dkd, then dci
  static constexpr int S = DKD + TILE;   // the chunk-start state  [N][LD]
  static constexpr int DS = S + N * LD;  // dS, carried           [N][LD]
  static constexpr int A = DS + N * LD;  // [C][LC]
  static constexpr int DA = A + C * LC;  // [C][LC]
  static constexpr int CE = DA + C * LC, MID = CE + N, U = MID + N, DCE = U + N;
  static constexpr int D = DCE + N, DD = D + C;
  static constexpr int G = THREADS / N;  // thread groups of the pointwise pass
  static constexpr int PMID = DD + C, PCE = PMID + G * N, PDU = PCE + G * N;
  static constexpr int WORDS = PDU + G * N;
};

template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS, 1) wkv_bwd_kernel(const BwdArgs p) {
  using L = BwdLayout<N>;
  constexpr int LD = L::LD, LC = L::LC, G = L::G;
  extern __shared__ __align__(16) float smem[];
  float* R = smem + L::R;
  float* K = smem + L::K;
  float* V = smem + L::V;
  float* W = smem + L::W;
  float* DY = smem + L::DY;
  float* CL = smem + L::CL;
  float* RE = smem + L::RE;
  float* RM = smem + L::RM;
  float* KI = smem + L::KI;
  float* KD = smem + L::KD;
  float* DRE = smem + L::DRE;
  float* DKD = smem + L::DKD;
  float* S = smem + L::S;
  float* DS = smem + L::DS;
  float* A = smem + L::A;
  float* DA = smem + L::DA;
  float* CE = smem + L::CE;
  float* MID = smem + L::MID;
  float* U = smem + L::U;
  float* DCE = smem + L::DCE;
  float* D = smem + L::D;
  float* DD = smem + L::DD;
  float* PMID = smem + L::PMID;
  float* PCE = smem + L::PCE;
  float* PDU = smem + L::PDU;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int nc = p.T / C;
  const size_t row = static_cast<size_t>(b) * p.H + h;
  // the pointwise pass: thread (g, n) owns column n of rows g, g + G, ...
  const int pn = tid % N, pg = tid / N;
  float du_acc = 0.f;

  for (int i = tid; i < N; i += THREADS) U[i] = p.u[static_cast<size_t>(h) * N + i];
  for (int i = tid; i < N * N; i += THREADS) {
    const int n = i / N, m = i - n * N;
    DS[n * LD + m] = p.ds == nullptr ? 0.f : p.ds[row * N * N + i];
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C;
    __syncthreads();  // the last chunk's reads of the tiles are done
    {
      const Tin* rg = static_cast<const Tin*>(p.r) + b * p.sr.b + h * p.sr.h;
      const Tin* kg = static_cast<const Tin*>(p.k) + b * p.sk.b + h * p.sk.h;
      const Tin* vg = static_cast<const Tin*>(p.v) + b * p.sv.b + h * p.sv.h;
      const float* wg = p.wl + b * p.sw.b + h * p.sw.h;
      const float* dg = p.dy + b * p.sdy.b + h * p.sdy.h;
      for (int i = tid; i < C * N; i += THREADS) {
        const int t = i / N, n = i - t * N;
        R[t * LD + n] = to_f32(rg[(t0 + t) * p.sr.t + n]);
        K[t * LD + n] = to_f32(kg[(t0 + t) * p.sk.t + n]);
        V[t * LD + n] = to_f32(vg[(t0 + t) * p.sv.t + n]);
        W[t * LD + n] = wg[(t0 + t) * p.sw.t + n];
        DY[t * LD + n] = dg[(t0 + t) * p.sdy.t + n];
      }
      const float* sg = p.states + (row * nc + c) * N * N;
      for (int i = tid; i < N * N; i += THREADS) {
        const int n = i / N, m = i - n * N;
        S[n * LD + m] = sg[i];
      }
    }
    __syncthreads();

    // 1. the exclusive cumsum of wl along t, a thread a column
    for (int n = tid; n < N; n += THREADS) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        if (t == C / 2) MID[n] = run;
        CL[t * LD + n] = run;
        run += W[t * LD + n];
      }
      CE[n] = run;
    }
    __syncthreads();

    // 2. the tiles scaled by the decay (expf and the forward's clamps), the
    //    bonus diagonal D and its gradient dD, and e^ce sum_m S dS'
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, n = i - t * N, o = t * LD + n;
      const float cl = CL[o], ci = cl + W[o], mid = MID[n], ce = CE[n];
      RE[o] = R[o] * expf(cl);
      RM[o] = R[o] * expf(cl - mid);
      KI[o] = K[o] * expf(fminf(mid - ci, 60.f));
      KD[o] = K[o] * expf(fminf(ce - ci, 0.f));
    }
    for (int t = tid; t < C; t += THREADS) {
      float d = 0.f, dd = 0.f;
      for (int n = 0; n < N; ++n) {
        d += R[t * LD + n] * U[n] * K[t * LD + n];
        dd += DY[t * LD + n] * V[t * LD + n];
      }
      D[t] = d;
      DD[t] = dd;
    }
    for (int n = tid; n < N; n += THREADS) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc += S[n * LD + m] * DS[n * LD + m];
      DCE[n] = expf(CE[n]) * acc;
    }
    __syncthreads();

    // 3. A, dA (strictly lower), dre = dy S^T, dkd = v dS'^T
    for (int i = tid; i < C * C; i += THREADS) {
      const int t = i / C, s = i - t * C;
      float a = 0.f, da = 0.f;
      if (s < t) {
        for (int n = 0; n < N; ++n) {
          a += RM[t * LD + n] * KI[s * LD + n];
          da += DY[t * LD + n] * V[s * LD + n];
        }
      }
      A[t * LC + s] = a;
      DA[t * LC + s] = da;
    }
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      float dre = 0.f, dkd = 0.f;
      for (int m = 0; m < N; ++m) {
        dre += DY[t * LD + m] * S[n * LD + m];
        dkd += V[t * LD + m] * DS[n * LD + m];
      }
      DRE[t * LD + n] = dre;
      DKD[t * LD + n] = dkd;
    }
    __syncthreads();

    // 4. dv; then, a thread an element (t, n) of the pointwise pass, drm,
    //    dki, dr, dk, du's share and the log decay's per-step terms
    {
      float* dvg = p.dv + b * p.sg.b + h * p.sg.h;
      for (int i = tid; i < C * N; i += THREADS) {
        const int s = i / N, m = i - s * N;
        float acc = D[s] * DY[s * LD + m];
        for (int t = s + 1; t < C; ++t) acc += A[t * LC + s] * DY[t * LD + m];
        for (int n = 0; n < N; ++n) acc += KD[s * LD + n] * DS[n * LD + m];
        dvg[(t0 + s) * p.sg.t + m] = acc;
      }
    }
    {
      float* drg = p.dr + b * p.sg.b + h * p.sg.h;
      float* dkg = p.dk + b * p.sg.b + h * p.sg.h;
      float pmid = 0.f, pce = 0.f;
      const int n = pn;
      const float u = U[n], mid = MID[n], ce = CE[n];
      for (int t = pg; t < C; t += G) {
        const int o = t * LD + n;
        float drm = 0.f, dki = 0.f;
        for (int s = 0; s < t; ++s) drm += DA[t * LC + s] * KI[s * LD + n];
        for (int q = t + 1; q < C; ++q) dki += DA[q * LC + t] * RM[q * LD + n];
        const float cl = CL[o], ci = cl + W[o], r = R[o], k = K[o];
        const float xki = mid - ci, xkd = ce - ci;
        const float dre = DRE[o], dkd = DKD[o], dd = DD[t];
        drg[(t0 + t) * p.sg.t + n] = dre * expf(cl) + drm * expf(cl - mid) + dd * u * k;
        dkg[(t0 + t) * p.sg.t + n] =
            dki * expf(fminf(xki, 60.f)) + dkd * expf(fminf(xkd, 0.f)) + dd * u * r;
        du_acc += dd * r * k;
        const float gki = xki <= 60.f ? dki * KI[o] : 0.f;
        const float gkd = xkd <= 0.f ? dkd * KD[o] : 0.f;
        const float dci = -gki - gkd;
        DRE[o] = dre * RE[o] + drm * RM[o] + dci;  // d cl, with ci = cl + wl
        DKD[o] = dci;
        pmid += gki - drm * RM[o];
        pce += gkd;
      }
      PMID[pg * N + n] = pmid;
      PCE[pg * N + n] = pce;
    }
    __syncthreads();

    // 5. dwl by a reverse exclusive cumsum, a thread a column; the carried
    //    dS = e^ce dS' + re^T dy, in place (every read of dS' is done)
    {
      float* dwg = p.dwl + b * p.sg.b + h * p.sg.h;
      for (int n = tid; n < N; n += THREADS) {
        float dce = DCE[n], dmid = 0.f;
        for (int g = 0; g < G; ++g) {
          dce += PCE[g * N + n];
          dmid += PMID[g * N + n];
        }
        float acc = 0.f;
        for (int t = C - 1; t >= 0; --t) {
          const int o = t * LD + n;
          dwg[(t0 + t) * p.sg.t + n] = DKD[o] + acc + dce + (t < C / 2 ? dmid : 0.f);
          acc += DRE[o];
        }
      }
    }
    for (int i = tid; i < N * N; i += THREADS) {
      const int n = i / N, m = i - n * N;
      float acc = expf(CE[n]) * DS[n * LD + m];
      for (int t = 0; t < C; ++t) acc += RE[t * LD + n] * DY[t * LD + m];
      DS[n * LD + m] = acc;
    }
  }

  PDU[pg * N + pn] = du_acc;
  __syncthreads();
  if (p.ds0 != nullptr)
    for (int i = tid; i < N * N; i += THREADS) {
      const int n = i / N, m = i - n * N;
      p.ds0[row * N * N + i] = DS[n * LD + m];
    }
  for (int n = tid; n < N; n += THREADS) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += PDU[g * N + n];
    p.du_rows[row * N + n] = acc;
  }
}

template <typename Tin, int N>
cudaError_t launch_bwd(const BwdArgs& p) {
  constexpr size_t smem = 4 * static_cast<size_t>(BwdLayout<N>::WORDS);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const long long blocks = static_cast<long long>(p.B) * p.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_bwd_kernel<Tin, N><<<static_cast<unsigned>(blocks), THREADS, smem, p.stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t bwd_by_shape(const BwdArgs& p, int N) {
  switch (N) {
    case 16: return launch_bwd<Tin, 16>(p);
    case 32: return launch_bwd<Tin, 32>(p);
    case 64: return launch_bwd<Tin, 64>(p);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
#endif

#if REPRO_PART == 1
cudaError_t wkv_cu::run_f32_vec(const Args& p, int N, int MS) {
  return by_shape<float, true>(p, N, MS);
}
#elif REPRO_PART == 2
cudaError_t wkv_cu::run_f32_scalar(const Args& p, int N, int MS) {
  return by_shape<float, false>(p, N, MS);
}
#elif REPRO_PART == 3
cudaError_t wkv_cu::run_bf16_vec(const Args& p, int N, int MS) {
  return by_shape<__nv_bfloat16, true>(p, N, MS);
}
#elif REPRO_PART == 4
cudaError_t wkv_cu::run_bf16_scalar(const Args& p, int N, int MS) {
  return by_shape<__nv_bfloat16, false>(p, N, MS);
}
#elif REPRO_PART == 5
cudaError_t wkv_cu::run_bwd_f32(const BwdArgs& p, int N) {
  return bwd_by_shape<float>(p, N);
}
#elif REPRO_PART == 6
cudaError_t wkv_cu::run_bwd_bf16(const BwdArgs& p, int N) {
  return bwd_by_shape<__nv_bfloat16>(p, N);
}
#else
// Returns a cudaError_t: 0 when the launch was accepted. The value-column
// slice MS and the load route are the wrapper's (kernels/wkv.py partition,
// route); this checks only what no kernel can take. `strides` holds the
// (b, h, t) element strides of r, k, v, wl and y, in that order. `states`
// (null when serving) receives the (B, H, T / C, N, N) state each chunk
// starts from, which the backward reads.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const void* wl, const void* u, const void* s0,
                         void* y, void* s_out, void* states, int B, int H,
                         int T, int N, int ms, int in_bf16, int vec,
                         const long long* strides, void* stream) {
  using namespace wkv_cu;
  if (B <= 0 || H <= 0 || T < 0 || T % C != 0 || strides == nullptr ||
      (ms != 16 && ms != 32) || ms > N)
    return cudaErrorInvalidValue;
  Args p{r, k, v, static_cast<const float*>(wl), static_cast<const float*>(u),
         static_cast<const float*>(s0), static_cast<float*>(y),
         static_cast<float*>(s_out), static_cast<float*>(states), B, H, T,
         {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
         {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]},
         {strides[12], strides[13], strides[14]}, static_cast<cudaStream_t>(stream)};
  if (vec) {
    // 16-byte pieces: every base and row stride a 16-byte multiple
    const long long esz = in_bf16 ? 2 : 4;
    const void* bases[4] = {r, k, v, wl};
    for (int i = 0; i < 4; ++i) {
      const long long sz = i == 3 ? 4 : esz;
      if ((reinterpret_cast<uintptr_t>(bases[i]) & 15) != 0) return cudaErrorInvalidValue;
      for (int j = 0; j < 3; ++j)
        if ((strides[3 * i + j] * sz) % 16 != 0) return cudaErrorInvalidValue;
    }
  }
  if (in_bf16) return vec ? run_bf16_vec(p, N, ms) : run_bf16_scalar(p, N, ms);
  return vec ? run_f32_vec(p, N, ms) : run_f32_scalar(p, N, ms);
}

// The backward: a cudaError_t, 0 when the launch was accepted. `strides`
// holds the (b, h, t) element strides of r, k, v, wl, dy and of the four
// gradients dr, dk, dv, dwl (one layout), in that order; u, the states, ds,
// du_rows and ds0 are contiguous. ds and ds0 may be null.
extern "C" int repro_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* wl, const void* u, const void* states,
                             const void* dy, const void* ds, void* dr, void* dk,
                             void* dv, void* dwl, void* du_rows, void* ds0,
                             int B, int H, int T, int N, int in_bf16,
                             const long long* strides, void* stream) {
  using namespace wkv_cu;
  if (B <= 0 || H <= 0 || T <= 0 || T % C != 0 || strides == nullptr ||
      states == nullptr)
    return cudaErrorInvalidValue;
  const long long* s = strides;
  BwdArgs p{r, k, v, static_cast<const float*>(wl), static_cast<const float*>(u),
            static_cast<const float*>(states), static_cast<const float*>(dy),
            static_cast<const float*>(ds), static_cast<float*>(dr),
            static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<float*>(dwl), static_cast<float*>(du_rows),
            static_cast<float*>(ds0), B, H, T,
            {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
            {s[9], s[10], s[11]}, {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
            static_cast<cudaStream_t>(stream)};
  return in_bf16 ? run_bwd_bf16(p, N) : run_bwd_f32(p, N);
}
#endif

// Flash-attention backward for Hopper (sm_90a), written by hand: two kernels.
//
// Replaces hivedscheduler_tpu/ops/attention.py:_bwd_dkdv_kernel and
// :_bwd_dq_kernel, launched by _flash_bwd_bh through pl.pallas_call. Same
// function: with P = exp(scale * Q K^T - LSE) recomputed under the causal
// mask and Delta = rowsum(dO * O),
//   dK/dV kernel:  dV = P^T dO,  dS = P * (dO V^T - Delta),  dK = scale dS^T Q
//   dQ kernel:     dQ = scale dS K
// Delta is a small torch pre-pass in f32 (ops/attention.flash_bwd_delta), as
// the JAX package leaves it to XLA; LSE and Delta are plain [B*H, S] f32.
//
// What bounds it on an H100: at the training shape (B1 S8192 H32 Hkv8 D128,
// causal, bf16) the dK/dV kernel does 8*D FLOPs per kept (q, k) pair and the
// dQ kernel 6*D, against q/k/v/dO bytes some 1000x smaller: both are bound by
// operations (989 TFLOP/s dense bf16 tensor cores).
// Design, and how it differs from the Pallas kernels:
//   - Nothing is carried between blocks. The TPU kernels carry f32
//     accumulators across a sequential grid axis; here each block owns its
//     output tile and loops over the other axis itself, the accumulators in
//     registers:
//       dK/dV: one block per (b, KV head, 64-key tile). It sweeps every query
//              head of its KV head's group and every query tile that the
//              causal mask keeps, so the GQA group-sum of _flash_bwd is done
//              in registers: no atomics, no f32 [B*H, S, D] scratch.
//       dQ:    one block per (b, query head, 64-query tile), sweeping the key
//              tiles up to the diagonal.
//   - GQA reads KV head h / (H / Hkv) in place; no K/V repeat. All tensors
//     stay in the model's [B, S, H, D] layout.
//   - bf16: the products on the tensor cores with mma.sync m16n8k16 (f32
//     accumulate). S and dP fragments stay in registers and are repacked as
//     bf16 A operands, so P and dS are rounded to bf16 before P^T dO,
//     dS^T Q and dS K (as FlashAttention-2 does; the JAX kernels keep them in
//     f32). dK and dV are summed in f32 and written in k's dtype, dQ in q's.
//   - Registers bound the tiles at D = 128: the dK/dV block keeps 2 x 64 f32
//     accumulators a thread, so it takes 32-query steps (S^T and dP^T
//     fragments of 16 keys x 32 queries a warp); K, V, Q and dO tiles sit in
//     shared memory and the A fragments are read from it per product.
//     ptxas -v (nvcc 12.8, sm_90a): dK/dV bf16<128> 248 registers and dQ
//     bf16<128> 167, no spills; of all instances only the f32 dK/dV<32>
//     spills (4 bytes).
//   - The ragged last tile is masked (no (8, 128) alignment rule).
//   - f32: the same algorithm with scalar FMAs (four threads a row), so the
//     card can hold the algorithm itself against the plain version at f32
//     tolerance.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, at
// B1 S8192 H32 Hkv8 D128 causal bf16: dK/dV 7.405 ms (bound 1.112 ms, 15%),
// dQ 4.221 ms (bound 0.834 ms, 20%), against 2.598 ms for SDPA's whole
// backward. wgmma, TMA, ldmatrix and warp specialisation are left for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the mask value of the reference, not -inf
constexpr int kThreads = 128;

// ---------------------------------------------------------------- bf16 path
constexpr int kTile = 64;     // keys per dK/dV block; queries per dQ block and
                              // keys per dQ sweep step (16 rows a warp)
constexpr int kQStep = 32;    // queries per dK/dV sweep step
constexpr int kPad = 8;       // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to one register of two bf16; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The m16n8k16 A fragment of rows [r0, r0 + 8) and [r0 + 8, r0 + 16), columns
// [c0, c0 + 16) of a row-major tile in shared memory (tig: the thread's first
// column within an 8-column half).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile,
                                       int r0, int c0, int tig) {
  a[0] = ld32(tile + r0 * LD + c0 + tig);
  a[1] = ld32(tile + (r0 + 8) * LD + c0 + tig);
  a[2] = ld32(tile + r0 * LD + c0 + tig + 8);
  a[3] = ld32(tile + (r0 + 8) * LD + c0 + tig + 8);
}

// Four C fragments of 8 columns each, as the A fragments of two k-steps of
// 16: n-tiles 2*kk and 2*kk + 1 become k-step kk.
__device__ __forceinline__ void repack_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [row0, row0 + ROWS) of one head into shared memory, 16 bytes a
// thread; rows at or past S are filled with zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int row0, int S) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + kPad;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// acc[j] += A * B over k = 16 * KSTEPS rows of a row-major [k][D] tile B in
// shared memory (B's columns are the output columns): the B fragments are
// two strided pairs, gathered element by element.
template <int D, int KSTEPS>
__device__ __forceinline__ void mma_a_regs_b_rows(float acc[][4], const float c[][4],
                                                  const __nv_bfloat16* tile,
                                                  int grp, int tig) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    repack_a(a, c[2 * kk], c[2 * kk + 1]);
    const __nv_bfloat16* row = tile + (kk * 16 + tig) * kLd + grp;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* p = row + j * 8;
      mma_bf16_16816(acc[j], a, pack_raw(p[0], p[kLd]), pack_raw(p[8 * kLd], p[9 * kLd]));
    }
  }
}

// c[j] = A B^T for N columns, where A is rows r0.. of tile `a_tile` and B^T's
// columns are the rows of tile `b_tile` (both row-major [rows][D]).
template <int D, int N>
__device__ __forceinline__ void mma_rows_rows(float c[][4], const __nv_bfloat16* a_tile,
                                              const __nv_bfloat16* b_tile, int r0,
                                              int grp, int tig) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<kLd>(a, a_tile, r0, kk * 16, tig);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const __nv_bfloat16* brow = b_tile + (j * 8 + grp) * kLd + kk * 16 + tig;
      mma_bf16_16816(c[j], a, ld32(brow), ld32(brow + 8));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           int S, int H, int Hkv, int causal, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * kLd;
  __nv_bfloat16* sQ = sV + kTile * kLd;
  __nv_bfloat16* sdO = sQ + kQStep * kLd;
  float* sLse = reinterpret_cast<float*>(sdO + kQStep * kLd);
  float* sDelta = sLse + kQStep;

  const int k0 = blockIdx.x * kTile;  // the first key tile sweeps the most
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int groups = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int tig = (lane % 4) * 2;
  const int r0 = warp * 16 + grp;  // key row of fragment elements 0, 1
  const int kpos[2] = {k0 + r0, k0 + r0 + 8};

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  load_tile<D, kTile>(sK, k + ((size_t)b * S * Hkv + hk) * D, kv_stride, k0, S);
  load_tile<D, kTile>(sV, v + ((size_t)b * S * Hkv + hk) * D, kv_stride, k0, S);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  const int q_first = causal ? k0 / kQStep : 0;  // earlier queries see no key here
  const int n_steps = (S + kQStep - 1) / kQStep;
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const __nv_bfloat16* q_head = q + ((size_t)b * S * H + h) * D;
    const __nv_bfloat16* do_head = dout + ((size_t)b * S * H + h) * D;
    const float* lse_row = lse + ((size_t)b * H + h) * S;
    const float* delta_row = delta + ((size_t)b * H + h) * S;
    for (int qs = q_first; qs < n_steps; ++qs) {
      const int q0 = qs * kQStep;
      __syncthreads();  // every warp is done with the previous Q/dO step
      load_tile<D, kQStep>(sQ, q_head, q_stride, q0, S);
      load_tile<D, kQStep>(sdO, do_head, q_stride, q0, S);
      if (threadIdx.x < kQStep) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < S ? lse_row[qi] : 0.f;
        sDelta[threadIdx.x] = qi < S ? delta_row[qi] : 0.f;
      }
      __syncthreads();

      // P^T = exp(scale K Q^T - LSE): 16 keys x 32 queries a warp.
      float pt[kQStep / 8][4];
      mma_rows_rows<D, kQStep>(pt, sK, sQ, r0, grp, tig);
      const bool need_mask = (q0 + kQStep > S) || (causal && q0 < k0 + kTile - 1);
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + tig + (e & 1);
          float p = __expf(pt[j][e] * scale - sLse[col]);
          if (need_mask) {
            const int qi = q0 + col;
            if (qi >= S || (causal && qi < kpos[e >> 1])) p = 0.f;
          }
          pt[j][e] = p;
        }
      }
      // dV += P^T dO.
      mma_a_regs_b_rows<D, kQStep / 16>(acc_dv, pt, sdO, grp, tig);

      // dS^T = P^T * (V dO^T - Delta).
      float dst[kQStep / 8][4];
      mma_rows_rows<D, kQStep>(dst, sV, sdO, r0, grp, tig);
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[j][e] = pt[j][e] * (dst[j][e] - sDelta[j * 8 + tig + (e & 1)]);
        }
      }
      // dK += dS^T Q (times scale in the epilogue).
      mma_a_regs_b_rows<D, kQStep / 16>(acc_dk, dst, sQ, grp, tig);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= S) continue;
    const size_t off = ((size_t)b * S * Hkv + (size_t)kpos[i] * Hkv + hk) * D + tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          pack_bf16(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq,
                         int S, int H, int Hkv, int causal, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile * kLd;
  __nv_bfloat16* sK = sdO + kTile * kLd;
  __nv_bfloat16* sV = sK + kTile * kLd;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int tig = (lane % 4) * 2;
  const int r0 = warp * 16 + grp;  // query row of fragment elements 0, 1
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* k_head = k + ((size_t)b * S * Hkv + hk) * D;
  const __nv_bfloat16* v_head = v + ((size_t)b * S * Hkv + hk) * D;
  load_tile<D, kTile>(sQ, q + ((size_t)b * S * H + h) * D, q_stride, q0, S);
  load_tile<D, kTile>(sdO, dout + ((size_t)b * S * H + h) * D, q_stride, q0, S);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = qpos[i] < S ? lse[(size_t)bh * S + qpos[i]] : 0.f;
    delta_r[i] = qpos[i] < S ? delta[(size_t)bh * S + qpos[i]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kTile>(sK, k_head, kv_stride, k0, S);
    load_tile<D, kTile>(sV, v_head, kv_stride, k0, S);
    __syncthreads();

    // P = exp(scale Q K^T - LSE): 16 queries x 64 keys a warp.
    float p[kTile / 8][4];
    mma_rows_rows<D, kTile>(p, sQ, sK, r0, grp, tig);
    const bool need_mask = (k0 + kTile > S) || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __expf(p[j][e] * scale - lse_r[e >> 1]);
        if (need_mask) {
          const int col = k0 + j * 8 + tig + (e & 1);
          if (col >= S || (causal && col > qpos[e >> 1])) x = 0.f;
        }
        p[j][e] = x;
      }
    }
    // dS = P * (dO V^T - Delta).
    float ds[kTile / 8][4];
    mma_rows_rows<D, kTile>(ds, sdO, sV, r0, grp, tig);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]);
    }
    // dQ += dS K (times scale in the epilogue).
    mma_a_regs_b_rows<D, kTile / 16>(acc, ds, sK, grp, tig);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    __nv_bfloat16* row = dq + ((size_t)b * S * H + (size_t)qpos[i] * H + h) * D + tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kRowsF = 32;  // rows a block owns and rows a sweep step loads

// Sum over the four threads of a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                          int Hkv, int causal, float scale) {
  constexpr int kPer = D / 4;  // dims per thread: part, part + 4, ...
  __shared__ float sQ[kRowsF][D];
  __shared__ float sdO[kRowsF][D];
  __shared__ float sLse[kRowsF];
  __shared__ float sDelta[kRowsF];

  const int k0 = blockIdx.x * kRowsF;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int groups = H / Hkv;
  const int row = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int kpos = k0 + row;

  float kr[kPer], vr[kPer], adk[kPer], adv[kPer];
  const size_t kv_off = ((size_t)b * S * Hkv + (size_t)kpos * Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    kr[i] = kpos < S ? k[kv_off + part + 4 * i] : 0.f;
    vr[i] = kpos < S ? v[kv_off + part + 4 * i] : 0.f;
    adk[i] = adv[i] = 0.f;
  }

  const int q_first = causal ? k0 / kRowsF : 0;
  const int n_steps = (S + kRowsF - 1) / kRowsF;
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const float* lse_row = lse + ((size_t)b * H + h) * S;
    const float* delta_row = delta + ((size_t)b * H + h) * S;
    for (int qs = q_first; qs < n_steps; ++qs) {
      const int q0 = qs * kRowsF;
      __syncthreads();
      for (int i = threadIdx.x; i < kRowsF * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < S;
        const size_t off = ((size_t)b * S * H + (size_t)(q0 + r) * H + h) * D + c;
        sQ[r][c] = in ? q[off] : 0.f;
        sdO[r][c] = in ? dout[off] : 0.f;
      }
      if (threadIdx.x < kRowsF) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < S ? lse_row[qi] : 0.f;
        sDelta[threadIdx.x] = qi < S ? delta_row[qi] : 0.f;
      }
      __syncthreads();

      for (int j = 0; j < kRowsF; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          s = fmaf(kr[i], sQ[j][part + 4 * i], s);
          dp = fmaf(vr[i], sdO[j][part + 4 * i], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const int qi = q0 + j;
        float p = expf(s * scale - sLse[j]);
        if (qi >= S || (causal && qi < kpos)) p = 0.f;
        const float ds = p * (dp - sDelta[j]);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          adv[i] = fmaf(p, sdO[j][part + 4 * i], adv[i]);
          adk[i] = fmaf(ds, sQ[j][part + 4 * i], adk[i]);
        }
      }
    }
  }

  if (kpos < S) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      dk[kv_off + part + 4 * i] = adk[i] * scale;
      dv[kv_off + part + 4 * i] = adv[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int H, int Hkv, int causal,
                        float scale) {
  constexpr int kPer = D / 4;
  __shared__ float sK[kRowsF][D];
  __shared__ float sV[kRowsF][D];

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kRowsF;
  const int row = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int qpos = q0 + row;

  float qr[kPer], dor[kPer], acc[kPer];
  const size_t q_off = ((size_t)b * S * H + (size_t)qpos * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = qpos < S ? q[q_off + part + 4 * i] : 0.f;
    dor[i] = qpos < S ? dout[q_off + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  const float lse_q = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
  const float delta_q = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;

  int n_tiles = (S + kRowsF - 1) / kRowsF;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowsF - 1) / kRowsF + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kRowsF;
    __syncthreads();
    for (int i = threadIdx.x; i < kRowsF * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const size_t off = ((size_t)b * S * Hkv + (size_t)(k0 + r) * Hkv + hk) * D + c;
      sK[r][c] = in ? k[off] : 0.f;
      sV[r][c] = in ? v[off] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kRowsF; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s = fmaf(qr[i], sK[j][part + 4 * i], s);
        dp = fmaf(dor[i], sV[j][part + 4 * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const int col = k0 + j;
      float p = expf(s * scale - lse_q);
      if (col >= S || (causal && col > qpos)) p = 0.f;
      const float ds = p * (dp - delta_q);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(ds, sK[j][part + 4 * i], acc[i]);
    }
  }

  if (qpos < S) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) dq[q_off + part + 4 * i] = acc[i] * scale;
  }
}

// ---------------------------------------------------------------- launchers
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, S, H, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, int is_bf16) {
  const dim3 grid_bf16((a.S + kTile - 1) / kTile, a.B * a.Hkv);
  const dim3 grid_f32((a.S + kRowsF - 1) / kRowsF, a.B * a.Hkv);
  if (is_bf16) {
    const int smem = (2 * kTile + 2 * kQStep) * (D + kPad) * (int)sizeof(__nv_bfloat16) +
                     2 * kQStep * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_bf16_kernel<D><<<grid_bf16, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.S, a.H, a.Hkv,
        a.causal, a.scale);
  } else {
    flash_bwd_dkdv_f32_kernel<D><<<grid_f32, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(dk), static_cast<float*>(dv), a.S, a.H, a.Hkv, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, int is_bf16) {
  const dim3 grid_bf16((a.S + kTile - 1) / kTile, a.B * a.H);
  const dim3 grid_f32((a.S + kRowsF - 1) / kRowsF, a.B * a.H);
  if (is_bf16) {
    const int smem = 4 * kTile * (D + kPad) * (int)sizeof(__nv_bfloat16);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<grid_bf16, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<__nv_bfloat16*>(dq), a.S, a.H, a.Hkv, a.causal, a.scale);
  } else {
    flash_bwd_dq_f32_kernel<D><<<grid_f32, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(dq), a.S, a.H, a.Hkv, a.causal, a.scale);
  }
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int Hkv) {
  return B > 0 && S > 0 && Hkv > 0 && H % Hkv == 0;
}

}  // namespace

// q, dout: [B, S, H, D]; k, v: [B, S, Hkv, D]; lse, delta: [B*H, S] f32;
// dk, dv: [B, S, Hkv, D] in k's dtype. All contiguous, 16-byte aligned.
// is_bf16 selects bf16 (1) or f32 (0). Returns the launch's CUDA error.
extern "C" int hived_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S, int H, int Hkv,
                                    int D, int causal, float scale, int is_bf16,
                                    void* stream) {
  if (!valid(B, S, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, B, S, H, Hkv, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dkdv<32>(a, dk, dv, is_bf16);
    case 64: return (int)launch_dkdv<64>(a, dk, dv, is_bf16);
    case 128: return (int)launch_dkdv<128>(a, dk, dv, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq: [B, S, H, D] in q's dtype; the rest as above.
extern "C" int hived_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, int B, int S, int H, int Hkv, int D, int causal,
                                  float scale, int is_bf16, void* stream) {
  if (!valid(B, S, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, B, S, H, Hkv, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dq<32>(a, dq, is_bf16);
    case 64: return (int)launch_dq<64>(a, dq, is_bf16);
    case 128: return (int)launch_dq<128>(a, dq, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}

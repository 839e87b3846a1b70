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
// operations (989 TFLOP/s dense bf16 tensor cores), so the design is about
// keeping the tensor cores fed.
// Design, and how it differs from the Pallas kernels:
//   - Nothing is carried between blocks. The TPU kernels carry f32
//     accumulators across a sequential grid axis; here each block owns its
//     output tile and loops over the other axis itself, the accumulators in
//     registers:
//       dK/dV: one block per (b, KV head, 128-key tile). It sweeps every query
//              head of its KV head's group and every 64-query tile that the
//              causal mask keeps, so the GQA group-sum of _flash_bwd is done
//              in registers: no atomics, no f32 [B*H, S, D] scratch.
//       dQ:    one block per (b, query head, 128-query tile), sweeping the
//              64-key tiles up to the diagonal, heaviest tiles launched first.
//     Two kernels and no atomics keep the gradients bitwise reproducible.
//   - bf16 (warp-specialised): 384 threads. Two consumer warpgroups each own
//     64 of the block's rows and issue wgmma (m64nNk16, f32 accumulate); one
//     producer warp keeps a kStages-deep ring of the swept tiles (Q and dO,
//     or K and V) in flight with TMA, completion and release tracked by
//     mbarriers, and the dK/dV producer also copies each step's LSE and
//     Delta. setmaxnreg moves registers from the producer (24) to the
//     consumers (240). The block's own tiles (K and V, or Q and dO) arrive
//     once by TMA.
//   - Tiles sit in shared memory as TMA writes them and wgmma reads them:
//     the hardware swizzle over 128-byte rows (64-byte rows at D = 32), a
//     D = 128 tile as two 64-column boxes. A 4-D tensor map over
//     [B, S, heads, D] makes rows at or past S arrive as zeros, never as the
//     next batch's rows.
//   - Products: S (or S^T) and dP (dP^T) take both operands from shared
//     memory, K-major. dV += P^T dO, dK += dS^T Q and dQ += dS K take P and
//     dS from the accumulator registers, rounded to bf16 and repacked as the
//     A operand in registers, and read dO, Q or K MN-major through wgmma's
//     transpose flag. P and dS are thus rounded to bf16 before those three
//     products (as FlashAttention-2 does; the JAX kernels keep them in f32).
//     dK and dV are summed in f32 and written in k's dtype, dQ in q's.
//     No thread writes shared memory that wgmma reads, so no proxy fence is
//     needed; only LSE and Delta go through the generic proxy, ordered by the
//     ring's mbarriers.
//   - Masking: only tiles on the diagonal or the ragged edge pay for the
//     mask (-1e30 in the reference, here P = 0); a warpgroup whose 64 rows
//     see none of a step's columns skips the step's products.
//   - f32: the same algorithm with scalar FMAs (four threads a row), so the
//     card can hold the algorithm itself against the plain version at f32
//     tolerance.
// ptxas -v (nvcc 12.9, sm_90a): every bf16 instance enters with 168
// registers a thread (the bound for 384 threads) and no spills; setmaxnreg
// then gives the producer warpgroup 24 and the consumers 240. Of all
// instances only the f32 dK/dV<32> spills (4 bytes).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, at
// B1 S8192 H32 Hkv8 D128 causal bf16 (bounds 1.112 and 0.834 ms): dK/dV
// 1.815 ms (61% of its bound), dQ 1.513 ms (55%), against 2.613 ms for
// SDPA's whole backward. The previous mma.sync design (64-row blocks,
// synchronous loads, B fragments gathered element by element) took
// 7.445 ms and 4.179 ms.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // f32 path

// ---------------------------------------------------------------- bf16 path

// Shared memory of the dK/dV block, in bytes from a 1024-aligned base.
template <int D>
struct DkdvSmem {
  static constexpr int kKV = kBlockRows * D * 2;  // K or V
  static constexpr int kQ = kStepRows * D * 2;    // Q or dO of one stage
  static constexpr int kK = 0, kV = kKV;
  static constexpr int kRing = 2 * kKV;  // stage s: Q at kRing + 2 s kQ, dO after it
  static constexpr int kLse = kRing + kStages * 2 * kQ;  // [kStages][kStepRows] f32
  static constexpr int kDelta = kLse + kStages * kStepRows * 4;
  static constexpr int kBar = kDelta + kStages * kStepRows * 4;  // full, empty, K/V
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           int S, int H, int Hkv, int causal, float scale) {
  using M = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* s_lse = reinterpret_cast<float*>(smem + M::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + M::kDelta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_ready = empty + kStages;

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * kBlockRows;  // launched first, the first key tiles sweep the most
  const int groups = H / Hkv;
  const int q_first = causal ? k0 / kStepRows : 0;  // earlier queries see no key here
  const int n_q = (S + kStepRows - 1) / kStepRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; Q and dO add their bytes
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kv_ready, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // Producer: one warp keeps the ring full, Q and dO by TMA, LSE and Delta
    // by its lanes.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 2 * kWarpgroup + 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_ready, 2 * M::kKV);
      tma_tile<D, kBlockRows>(&tm_k, base + M::kK, kv_ready, hk, k0, b);
      tma_tile<D, kBlockRows>(&tm_v, base + M::kV, kv_ready, hk, k0, b);
    }
    int stage = 0, phase = 0;
    for (int g = 0; g < groups; ++g) {
      const int h = hk * groups + g;
      const float* lse_row = lse + ((size_t)b * H + h) * S;
      const float* delta_row = delta + ((size_t)b * H + h) * S;
      for (int qt = q_first; qt < n_q; ++qt) {
        const int q0 = qt * kStepRows;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * M::kQ);
          const uint32_t sq = base + M::kRing + stage * 2 * M::kQ;
          tma_tile<D, kStepRows>(&tm_q, sq, &full[stage], h, q0, b);
          tma_tile<D, kStepRows>(&tm_do, sq + M::kQ, &full[stage], h, q0, b);
        }
        for (int i = lane; i < kStepRows; i += 32) {
          const int qi = q0 + i;
          s_lse[stage * kStepRows + i] = qi < S ? lse_row[qi] : 0.f;
          s_delta[stage * kStepRows + i] = qi < S ? delta_row[qi] : 0.f;
        }
        mbar_arrive(&full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys [kw0, kw0 + 64).
    setmaxnreg_inc<kConsumerRegs>();
    const int row = (threadIdx.x % kWarpgroup) / 32 * 16 + lane / 4;  // of elements 0, 1
    const int col = (lane % 4) * 2;  // within each 8-column block
    const int kw0 = k0 + wg * 64;
    const int kpos[2] = {kw0 + row, kw0 + row + 8};

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    mbar_wait(kv_ready, 0);
    int stage = 0, phase = 0;
    for (int g = 0; g < groups; ++g) {
      for (int qt = q_first; qt < n_q; ++qt) {
        const int q0 = qt * kStepRows;
        mbar_wait(&full[stage], phase);
        if (kw0 < S && !(causal && q0 + kStepRows - 1 < kw0)) {
          const uint32_t sq = base + M::kRing + stage * 2 * M::kQ;
          const uint32_t sdo = sq + M::kQ;
          const float* lse_s = s_lse + stage * kStepRows;
          const float* delta_s = s_delta + stage * kStepRows;
          float st[32], dpt[32];
          wgmma_fence();
          gemm_abt<D>(st, base + M::kK, kBlockRows, wg * 64, sq);  // S^T = K Q^T
          wgmma_commit();
          gemm_abt<D>(dpt, base + M::kV, kBlockRows, wg * 64, sdo);  // dP^T = V dO^T
          wgmma_commit();
          wgmma_wait<1>();
          reg_fence(st);
          // P^T = exp(scale S^T - LSE), the column's query.
          const bool need_mask = q0 + kStepRows > S || (causal && q0 < kw0 + 63);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(lse_s + j * 8 + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = __expf(st[4 * j + e] * scale - ((e & 1) ? l.y : l.x));
              if (need_mask) {
                const int qi = q0 + j * 8 + col + (e & 1);
                if (qi >= S || (causal && qi < kpos[e >> 1])) p = 0.f;
              }
              st[4 * j + e] = p;
            }
          }
          wgmma_wait<0>();
          reg_fence(dpt);
          // dS^T = P^T * (dP^T - Delta).
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d = *reinterpret_cast<const float2*>(delta_s + j * 8 + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
            }
          }
          uint32_t pa[16], dsa[16];
          to_a_operand(pa, st);
          to_a_operand(dsa, dpt);
          reg_fence(acc_dv);
          reg_fence(acc_dk);
          wgmma_fence();
          gemm_rs<D>(acc_dv, pa, sdo);  // dV += P^T dO
          gemm_rs<D>(acc_dk, dsa, sq);  // dK += dS^T Q (times scale in the epilogue)
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(acc_dv);
          reg_fence(acc_dk);
          reg_fence(pa);
          reg_fence(dsa);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kpos[i] >= S) continue;
      const size_t off = ((size_t)b * S * Hkv + (size_t)kpos[i] * Hkv + hk) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
            pack_bf16(acc_dk[4 * j + 2 * i] * scale, acc_dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
            pack_bf16(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Shared memory of the dQ block, in bytes from a 1024-aligned base.
template <int D>
struct DqSmem {
  static constexpr int kQ = kBlockRows * D * 2;  // Q or dO
  static constexpr int kKV = kStepRows * D * 2;  // K or V of one stage
  static constexpr int kQo = 0, kDo = kQ;
  static constexpr int kRing = 2 * kQ;  // stage s: K at kRing + 2 s kKV, V after it
  static constexpr int kBar = kRing + kStages * 2 * kKV;  // full, empty, Q/dO
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq,
                         int S, int H, int Hkv, int causal, float scale) {
  using M = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_ready = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest causal tile first
  int n_k = (S + kStepRows - 1) / kStepRows;
  if (causal) n_k = min(n_k, (q0 + kBlockRows - 1) / kStepRows + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_ready, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // Producer: one thread keeps the ring of K and V tiles full by TMA.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 2 * kWarpgroup) return;
    mbar_arrive_expect_tx(q_ready, 2 * M::kQ);
    tma_tile<D, kBlockRows>(&tm_q, base + M::kQo, q_ready, h, q0, b);
    tma_tile<D, kBlockRows>(&tm_do, base + M::kDo, q_ready, h, q0, b);
    int stage = 0, phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], 2 * M::kKV);
      const uint32_t sk = base + M::kRing + stage * 2 * M::kKV;
      tma_tile<D, kStepRows>(&tm_k, sk, &full[stage], hk, kt * kStepRows, b);
      tma_tile<D, kStepRows>(&tm_v, sk + M::kKV, &full[stage], hk, kt * kStepRows, b);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // Consumers: warpgroup wg owns queries [qw0, qw0 + 64).
    setmaxnreg_inc<kConsumerRegs>();
    const int row = (threadIdx.x % kWarpgroup) / 32 * 16 + lane / 4;  // of elements 0, 1
    const int col = (lane % 4) * 2;  // within each 8-column block
    const int qw0 = q0 + wg * 64;
    const int qpos[2] = {qw0 + row, qw0 + row + 8};
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = qpos[i] < S ? lse[(size_t)bh * S + qpos[i]] : 0.f;
      delta_r[i] = qpos[i] < S ? delta[(size_t)bh * S + qpos[i]] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_ready, 0);
    int stage = 0, phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * kStepRows;
      mbar_wait(&full[stage], phase);
      if (qw0 < S && !(causal && k0 > qw0 + 63)) {
        const uint32_t sk = base + M::kRing + stage * 2 * M::kKV;
        const uint32_t sv = sk + M::kKV;
        float s[32], dp[32];
        wgmma_fence();
        gemm_abt<D>(s, base + M::kQo, kBlockRows, wg * 64, sk);  // S = Q K^T
        wgmma_commit();
        gemm_abt<D>(dp, base + M::kDo, kBlockRows, wg * 64, sv);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(s);
        // P = exp(scale S - LSE), the row's query.
        const bool need_mask = k0 + kStepRows > S || (causal && k0 + kStepRows - 1 > qw0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __expf(s[4 * j + e] * scale - lse_r[e >> 1]);
            if (need_mask) {
              const int kj = k0 + j * 8 + col + (e & 1);
              if (kj >= S || (causal && kj > qpos[e >> 1])) x = 0.f;
            }
            s[4 * j + e] = x;
          }
        }
        wgmma_wait<0>();
        reg_fence(dp);
        // dS = P * (dP - Delta).
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);
        uint32_t dsa[16];
        to_a_operand(dsa, dp);
        reg_fence(acc);
        wgmma_fence();
        gemm_rs<D>(acc, dsa, sk);  // dQ += dS K (times scale in the epilogue)
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qpos[i] >= S) continue;
      __nv_bfloat16* out = dq + ((size_t)b * S * H + (size_t)qpos[i] * H + h) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
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

// Tensor maps of q, dout (H heads) and k, v (Hkv heads), with q_rows and
// kv_rows rows a box.
template <int D>
cudaError_t make_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap* tm) {
  cudaError_t err = make_map<D>(&tm[0], a.q, a.B, a.S, a.H, q_rows);
  if (err == cudaSuccess) err = make_map<D>(&tm[1], a.dout, a.B, a.S, a.H, q_rows);
  if (err == cudaSuccess) err = make_map<D>(&tm[2], a.k, a.B, a.S, a.Hkv, kv_rows);
  if (err == cudaSuccess) err = make_map<D>(&tm[3], a.v, a.B, a.S, a.Hkv, kv_rows);
  return err;
}

template <int D>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, int is_bf16) {
  if (is_bf16) {
    CUtensorMap tm[4];
    cudaError_t err = make_maps<D>(a, kStepRows, kBlockRows, tm);
    if (err != cudaSuccess) return err;
    const int smem = DkdvSmem<D>::kBytes + 1024;  // + alignment of the base
    err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hkv, (a.S + kBlockRows - 1) / kBlockRows);
    flash_bwd_dkdv_bf16_kernel<D><<<grid, kBf16Threads, smem, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), a.S, a.H, a.Hkv, a.causal, a.scale);
  } else {
    const dim3 grid((a.S + kRowsF - 1) / kRowsF, a.B * a.Hkv);
    flash_bwd_dkdv_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
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
  if (is_bf16) {
    CUtensorMap tm[4];
    cudaError_t err = make_maps<D>(a, kBlockRows, kStepRows, tm);
    if (err != cudaSuccess) return err;
    const int smem = DqSmem<D>::kBytes + 1024;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.S + kBlockRows - 1) / kBlockRows);
    flash_bwd_dq_bf16_kernel<D><<<grid, kBf16Threads, smem, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dq), a.S, a.H, a.Hkv,
        a.causal, a.scale);
  } else {
    const dim3 grid((a.S + kRowsF - 1) / kRowsF, a.B * a.H);
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
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

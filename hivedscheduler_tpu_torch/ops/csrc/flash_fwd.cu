// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces hivedscheduler_tpu/ops/attention.py:_fwd_kernel, launched by
// _flash_fwd_bh through pl.pallas_call. Same function: causal or full
// attention with scale `scale`, an online softmax in f32 (running max m,
// running sum l, f32 accumulator), P cast to the V dtype before PV, O written
// in the input dtype and LSE = m + log(max(l, 1e-30)) as a plain [B*H, S] f32.
//
// What bounds it on an H100: the work is 4*D FLOPs per kept (q, k) pair, about
// 800 FLOPs per byte of q, k, v and o at the prefill shape (B4 S2048 H32
// Hkv8 D128, causal) and 3,300 at the training shape (B1 S8192), against the
// card's 295 (989 TFLOP/s dense bf16 over 3.35 TB/s): it is bound by
// operations, so the design is about keeping the tensor cores fed.
// Design, and how it differs from the Pallas kernel:
//   - Blocks run in parallel and in no order, so each block owns one
//     (b, query head, 128-query tile) and sweeps the 128-key tiles itself, up
//     to the diagonal under the causal mask; the running m, l and the
//     accumulator live in registers, never in device memory. The heaviest
//     causal tiles are launched first.
//   - bf16 (warp-specialised, the shape of flash_bwd.cu's dQ kernel, with
//     the building blocks of hopper.cuh): 384 threads. Two consumer
//     warpgroups each own 64 of the block's queries and issue wgmma
//     (m64nNk16, f32 accumulate); one producer warp loads Q once and keeps a
//     kStages-deep ring of K and V tiles in flight with TMA, completion and
//     release tracked by mbarriers. setmaxnreg moves registers from the
//     producer (24) to the consumers (240).
//   - Tiles sit in shared memory as TMA writes them and wgmma reads them:
//     the hardware swizzle over 128-byte rows (64-byte rows at D = 32). A
//     4-D tensor map over [B, S, heads, D] makes rows at or past S arrive as
//     zeros, never as the next batch's rows; GQA reads KV head
//     h / (H / Hkv) through a map over the Hkv heads, so K/V are never
//     repeated. q, k, v and o stay in the model's [B, S, H, D] layout.
//   - S = Q K^T takes both operands from shared memory, K-major. The online
//     softmax runs on the m64n128 accumulator in registers (a row's keys lie
//     on the four threads of a quad: two shuffles reduce the max and the
//     sum); the max is kept over unscaled scores, so each P is one FMA and
//     one ex2. P is rounded to bf16 and repacked in registers as the A
//     operand of O += P V, which reads V MN-major through the transpose
//     flag. No thread writes shared memory that wgmma reads.
//   - The softmax is hidden behind the tensor cores twice over: a warpgroup
//     issues the next tile's S = Q K^T together with this tile's O += P V
//     and runs the softmax while the latter is in flight, and the two
//     warpgroups take turns to issue (named barriers), so that one's
//     softmax runs under the other's products.
//   - Masking: only tiles on the diagonal or the ragged edge pay for the
//     mask (-1e30, as in the reference); a warpgroup whose 64 rows see none
//     of a tile's keys skips its products but still waits for and releases
//     its stage, so the ring's phases never drift.
//   - f32: the same algorithm with scalar FMAs (four threads per query row),
//     so the card can hold the algorithm itself at f32 tolerance.
// ptxas -v (sm_90a): each bf16 instance enters with 168 registers
// a thread (the bound for 384 threads), no spills; setmaxnreg then gives the
// producer warpgroup 24 and the consumers 240.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.332 ms
// at B4 S2048 (42% of its 0.139 ms bound; SDPA 0.251 ms) and 1.039 ms at
// B1 S8192 (54% of 0.556 ms; SDPA 0.872 ms). The previous mma.sync design
// (64 x 64 tiles, synchronous loads) took 0.912 ms at B4 S2048.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the mask value of the reference, not -inf
constexpr int kThreads = 128;      // f32 path

// ---------------------------------------------------------------- bf16 path
constexpr int kKeys = 128;  // keys a ring stage holds

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared memory of the forward block, in bytes from a 1024-aligned base.
template <int D>
struct FwdSmem {
  static constexpr int kQ = kBlockRows * D * 2;  // the block's queries
  static constexpr int kKV = kKeys * D * 2;      // K or V of one stage
  static constexpr int kRing = kQ;  // stage s: K at kRing + 2 s kKV, V after it
  static constexpr int kBar = kRing + kStages * 2 * kKV;  // full, empty, Q
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
};

// 2^x by the special-function unit, as __expf computes e^x.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One step of the online softmax on a 64 x kKeys tile of scores S = Q K^T in
// registers (element 4j + 2i + e at query qpos[i], key k0 + 8j + col + e):
// masks it, updates the running max m (of the unscaled scores) and sum l,
// leaves P = exp(scale (s - m)) in s, and returns in alpha the factor
// exp(scale (m_old - m)) that rescales the accumulator. With scale_log2 =
// scale log2(e), each P is one FMA and one ex2. A row's keys lie on the four
// threads of a quad.
__device__ __forceinline__ void online_softmax(float (&s)[kKeys / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2],
                                               const int (&qpos)[2], int col, int k0,
                                               bool need_mask, int S, int causal,
                                               float scale_log2) {
  float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (need_mask) {
        const int kj = k0 + j * 8 + col + (e & 1);
        if (kj >= S || (causal && kj > qpos[e >> 1])) s[4 * j + e] = kNegInf;
      }
      m_new[e >> 1] = fmaxf(m_new[e >> 1], s[4 * j + e]);
    }
  }
  float m_scaled[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    alpha[i] = exp2_approx((m_run[i] - m_new[i]) * scale_log2);
    m_scaled[i] = m_new[i] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -m_scaled[e >> 1]));
      row_sum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
    l_run[i] = l_run[i] * alpha[i] + row_sum[i];
    m_run[i] = m_new[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int H, int Hkv, int causal, float scale) {
  using M = FwdSmem<D>;
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
  int n_k = (S + kKeys - 1) / kKeys;
  if (causal) n_k = min(n_k, (q0 + kBlockRows - 1) / kKeys + 1);

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
    // Producer: one thread loads Q, then keeps the ring of K and V tiles
    // full by TMA.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 2 * kWarpgroup) return;
    mbar_arrive_expect_tx(q_ready, M::kQ);
    tma_tile<D, kBlockRows>(&tm_q, base, q_ready, h, q0, b);
    int stage = 0, phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], 2 * M::kKV);
      const uint32_t sk = base + M::kRing + stage * 2 * M::kKV;
      tma_tile<D, kKeys>(&tm_k, sk, &full[stage], hk, kt * kKeys, b);
      tma_tile<D, kKeys>(&tm_v, sk + M::kKV, &full[stage], hk, kt * kKeys, b);
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
    // The key tiles these 64 rows see: all of them, or up to their diagonal.
    auto tiles_seen = [&](int qw) {
      return qw >= S ? 0 : causal ? min(n_k, (qw + 63) / kKeys + 1) : n_k;
    };
    const int n_mine = tiles_seen(qw0);
    // Ping-pong: the two warpgroups take turns to issue their products, so
    // that one's softmax runs under the other's. Only where both sweep the
    // same tiles, so that each turn has its partner: not in a last tile whose
    // second 64 rows all lie past S.
    const bool pingpong = tiles_seen(q0) == tiles_seen(q0 + 64) && n_mine > 0;
    auto turn_begin = [&]() {
      if (pingpong) named_bar_sync(1 + wg, 2 * kWarpgroup);
    };
    auto turn_end = [&](bool last) {
      if (pingpong && !(wg == 1 && last)) named_bar_arrive(2 - wg, 2 * kWarpgroup);
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    const float scale_log2 = scale * 1.44269504088896341f;
    auto k_tile = [&](int kt) { return base + M::kRing + (kt % kStages) * 2 * M::kKV; };
    auto wait_full = [&](int kt) { mbar_wait(&full[kt % kStages], (kt / kStages) & 1); };
    auto release = [&](int kt) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[kt % kStages]);
    };
    // The softmax of tile kt's scores, once they are in s: P left in s.
    auto softmax = [&](float (&s)[kKeys / 2], float (&alpha)[2], int kt) {
      const int k0 = kt * kKeys;
      const bool need_mask = k0 + kKeys > S || (causal && k0 + kKeys - 1 > qw0);
      reg_fence(s);
      online_softmax(s, m_run, l_run, alpha, qpos, col, k0, need_mask, S, causal, scale_log2);
    };

    // Each turn issues the next tile's S = Q K^T together with this tile's
    // O += P V, so that the next softmax runs while the tensor cores work.
    mbar_wait(q_ready, 0);
    if (pingpong && wg == 1) named_bar_arrive(1, 2 * kWarpgroup);  // warpgroup 0 goes first
    uint32_t pa[kKeys / 4];
    float alpha[2];
    if (n_mine > 0) {
      float s[kKeys / 2];
      wait_full(0);
      turn_begin();
      wgmma_fence();
      gemm_abt<D, kKeys>(s, base, kBlockRows, wg * 64, k_tile(0));
      wgmma_commit();
      turn_end(false);
      wgmma_wait<0>();
      softmax(s, alpha, 0);  // alpha is 0: the accumulator holds nothing yet
      to_a_operand(pa, s);
    }
    for (int kt = 1; kt < n_mine; ++kt) {
      float s[kKeys / 2];
      wait_full(kt);
      turn_begin();
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      gemm_abt<D, kKeys>(s, base, kBlockRows, wg * 64, k_tile(kt));
      wgmma_commit();
      gemm_rs<D, kKeys>(acc, pa, k_tile(kt - 1) + M::kKV);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();  // the scores are done; O += P V may still run
      softmax(s, alpha, kt);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      release(kt - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_a_operand(pa, s);
    }
    if (n_mine > 0) {
      turn_begin();
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      gemm_rs<D, kKeys>(acc, pa, k_tile(n_mine - 1) + M::kKV);
      wgmma_commit();
      turn_end(true);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      release(n_mine - 1);
    }
    // Tiles past these rows' diagonal: wait for them and release them.
    for (int kt = n_mine; kt < n_k; ++kt) {
      wait_full(kt);
      release(kt);
    }

    // O = acc / max(l, 1e-30), LSE = scale m + log(max(l, 1e-30)); rows >= S
    // are not written.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qpos[i] >= S) continue;
      const float l = fmaxf(l_run[i], 1e-30f);
      const float inv = 1.f / l;
      __nv_bfloat16* out = o + ((size_t)b * S * H + (size_t)qpos[i] * H + h) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
      if (lane % 4 == 0) lse[(size_t)bh * S + qpos[i]] = m_run[i] * scale + logf(l);
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kBlockMF = 32;  // q rows per block: four threads per row
constexpr int kBlockNF = 32;  // keys per k tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv, int causal,
                     float scale) {
  constexpr int kPer = D / 4;  // dims per thread: part, part + 4, ...
  __shared__ float sK[kBlockNF][D];
  __shared__ float sV[kBlockNF][D];

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kBlockMF;
  const int row = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int qpos = q0 + row;

  const size_t kv_stride = (size_t)Hkv * D;
  const float* k_head = k + ((size_t)b * S * Hkv + hk) * D;
  const float* v_head = v + ((size_t)b * S * Hkv + hk) * D;

  float qr[kPer], acc[kPer];
  const float* qrow = q + ((size_t)b * S * H + (size_t)qpos * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = qpos < S ? qrow[part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;

  int n_tiles = (S + kBlockNF - 1) / kBlockNF;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockMF - 1) / kBlockNF + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockNF;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockNF * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      sK[r][c] = in ? k_head[(size_t)(k0 + r) * kv_stride + c] : 0.f;
      sV[r][c] = in ? v_head[(size_t)(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[kBlockNF];
    float m_new = m_run;
#pragma unroll
    for (int j = 0; j < kBlockNF; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) dot = fmaf(qr[i], sK[j][part + 4 * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = k0 + j;
      float x = dot * scale;
      if (col >= S || (causal && col > qpos)) x = kNegInf;
      s[j] = x;
      m_new = fmaxf(m_new, x);
    }
    const float alpha = __expf(m_run - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockNF; ++j) {
      s[j] = __expf(s[j] - m_new);
      row_sum += s[j];
    }
    l_run = l_run * alpha + row_sum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < kBlockNF; ++j) a = fmaf(s[j], sV[j][part + 4 * i], a);
      acc[i] = a;
    }
  }

  if (qpos < S) {
    const float l = fmaxf(l_run, 1e-30f);
    float* orow = o + ((size_t)b * S * H + (size_t)qpos * H + h) * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[part + 4 * i] = acc[i] / l;
    if (part == 0) lse[(size_t)bh * S + qpos] = m_run + logf(l);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int H, int Hkv, int causal,
                        float scale, cudaStream_t stream) {
  CUtensorMap tm[3];
  cudaError_t err = make_map<D>(&tm[0], q, B, S, H, kBlockRows);
  if (err == cudaSuccess) err = make_map<D>(&tm[1], k, B, S, Hkv, kKeys);
  if (err == cudaSuccess) err = make_map<D>(&tm[2], v, B, S, Hkv, kKeys);
  if (err != cudaSuccess) return err;
  const int smem = FwdSmem<D>::kBytes + 1024;  // + alignment of the base
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBlockRows - 1) / kBlockRows);
  flash_fwd_bf16_kernel<D><<<grid, kBf16Threads, smem, stream>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(o), lse, S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int Hkv, int causal,
                       float scale, cudaStream_t stream) {
  dim3 grid((S + kBlockMF - 1) / kBlockMF, B * H);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, S, H, D]; k, v: [B, S, Hkv, D]; o: [B, S, H, D]; lse: [B*H, S] f32.
// All contiguous, 16-byte aligned. is_bf16 selects bf16 (1) or f32 (0).
// Returns the CUDA error of the launch (0 on success).
extern "C" int hived_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               void* lse, int B, int S, int H, int Hkv, int D,
                               int causal, float scale, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (is_bf16) {
    switch (D) {
      case 32: err = launch_bf16<32>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      case 64: err = launch_bf16<64>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      case 128: err = launch_bf16<128>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 32: err = launch_f32<32>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      case 64: err = launch_f32<64>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      case 128: err = launch_f32<128>(q, k, v, o, l, B, S, H, Hkv, causal, scale, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}

// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces hivedscheduler_tpu/ops/attention.py:_fwd_kernel, launched by
// _flash_fwd_bh through pl.pallas_call. Same function: causal or full
// attention with scale `scale`, an online softmax in f32 (running max m,
// running sum l, f32 accumulator), P cast to the V dtype before PV, O written
// in the input dtype and LSE = m + log(max(l, 1e-30)) as a plain [B*H, S] f32.
//
// What bounds it on an H100: at the prefill shapes (S = 2048, D = 128) the
// work is 2*D*S*(S+1)*B*H causal FLOPs against q/k/v/o bytes that are ~800x
// smaller, so it is compute-bound (989 TFLOP/s dense bf16 tensor cores).
// Design, and how it differs from the Pallas kernel:
//   - Blocks run in parallel and in no order, so each thread block owns one
//     (b*h, 64-row q tile) and loops over the k tiles itself; the running
//     m/l/accumulator live in registers, never in device memory.
//   - 64 x 64 tiles with D in shared memory (the TPU's 512 x 1024 VMEM tiles
//     do not fit 227 KB). Four warps, sixteen q rows each.
//   - bf16: QK^T and PV on the tensor cores with mma.sync m16n8k16 (f32
//     accumulate). The S fragment is reused in registers as the A operand of
//     PV, so P never touches shared memory. f32: the same algorithm with
//     scalar FMAs (four threads per query row), for checks at full precision.
//   - k tiles wholly above the diagonal are skipped; the last q block of a
//     causal sweep (the heaviest) is scheduled first.
//   - The ragged last tile is masked here (no (8, 128) alignment rule).
//   - GQA reads KV head h / (H / Hkv) directly instead of repeating K/V.
//   - q, k, v and o stay in the model's [B, S, H, D] layout: no transposes.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the mask value of the reference, not -inf
constexpr int kThreads = 128;

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per k tile
constexpr int kPad = 8;      // bf16 elements of row padding in shared memory

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int H, int Hkv, int causal, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLd;
  __nv_bfloat16* sV = sK + kBlockN * kLd;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;      // mma groupID: row within an 8-row half
  const int tig = (lane % 4) * 2;  // first of the thread's two columns

  const size_t q_stride = (size_t)H * D;  // between sequence positions
  const size_t kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* q_head = q + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* k_head = k + ((size_t)b * S * Hkv + hk) * D;
  const __nv_bfloat16* v_head = v + ((size_t)b * S * Hkv + hk) * D;

  load_tile<D, kBlockM>(sQ, q_head, q_stride, q0, S);
  __syncthreads();

  // This warp's 16 q rows as mma A fragments, kept for the whole sweep.
  const int r0 = warp * 16 + grp;  // tile row of fragment elements 0, 1
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(sQ + r0 * kLd + kk * 16 + tig);
    qf[kk][1] = ld32(sQ + (r0 + 8) * kLd + kk * 16 + tig);
    qf[kk][2] = ld32(sQ + r0 * kLd + kk * 16 + tig + 8);
    qf[kk][3] = ld32(sQ + (r0 + 8) * kLd + kk * 16 + tig + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  int n_tiles = (S + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kBlockN>(sK, k_head, kv_stride, k0, S);
    load_tile<D, kBlockN>(sV, v_head, kv_stride, k0, S);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: eight n-tiles of 8 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sK + (j * 8 + grp) * kLd + tig;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16_16816(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
    }

    const bool need_mask = (k0 + kBlockN > S) || (causal && k0 + kBlockN - 1 > q0);
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (need_mask) {
          const int col = k0 + j * 8 + tig + (e & 1);
          if (col >= S || (causal && col > qpos[e >> 1])) x = kNegInf;
        }
        s[j][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
    // A row is spread over the four threads of a quad.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    }
    const float alpha[2] = {__expf(m_run[0] - m_new[0]), __expf(m_run[1] - m_new[1])};
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_new[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
      row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + row_sum[i];
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P (cast to bf16) is the A operand straight from registers.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = sV + (kk * 16 + tig) * kLd + grp;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* p = vrow + j * 8;
        const uint32_t b0 = pack_raw(p[0], p[kLd]);
        const uint32_t b1 = pack_raw(p[8 * kLd], p[9 * kLd]);
        mma_bf16_16816(acc[j], pa, b0, b1);
      }
    }
  }

  // Epilogue: O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const float inv = 1.f / l;
    __nv_bfloat16* orow = o + ((size_t)b * S * H + (size_t)qpos[i] * H + h) * D + tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
    if (lane % 4 == 0) lse[(size_t)bh * S + qpos[i]] = m_run[i] + logf(l);
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
  const int smem = 3 * kBlockM * (D + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, H,
      Hkv, causal, scale);
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

// Flash-attention forward for Hopper (sm_90a), fp32 and bf16, head_dim 32/64/128.
//
// Replaces the TPU kernel `flash_attention` / `_attn_kernel` in
// src/repro/kernels/flash_attention.py (a Pallas kernel): causal and
// sliding-window GQA attention with the FlashAttention-2 online softmax.
// Semantics are those of that kernel, not its block structure:
//   * running max m, denominator l and accumulator acc are fp32;
//   * masked scores are set to -1e30, and their probabilities are zeroed
//     after the exp; the denominator is clamped at 1e-30;
//   * query head h reads KV head h / (Hq / Hkv): GQA by index, KV heads are
//     never repeated.
//
// What bounds it on this card.  Attention at training shapes is bound by
// operations: at q (8,1024,32,64), k/v (8,1024,4,64), causal, it does about
// 34 GFLOP against about 76 MB of inputs and outputs, ~450 FLOP per byte,
// above the H100's ~295 FLOP/byte bf16 ridge.  The card's full rate needs
// the tensor cores (wgmma); this first kernel uses CUDA-core FMAs, so it is
// bound by the FP32 FMA pipe and by shared-memory reads feeding it.
//
// What the design does about it.
//   * One block per (64-row q tile, q head, batch row), 256 threads; the
//     Pallas kernel's sequential kv-block grid axis becomes a loop inside
//     the block, and nothing is carried between blocks.
//   * KV tiles that lie wholly above the causal diagonal or wholly outside
//     the sliding window are skipped.  This is exact: in the TPU kernel
//     such tiles leave m, l and acc unchanged.
//   * Scores and the P.V product are register-tiled (4x4 scores and
//     4 x D/16 outputs per thread), so each shared-memory read feeds
//     several FMAs; the score row max and sum reduce across the 16 lanes
//     that share a row with warp shuffles.
//   * Tiles are staged in shared memory as fp32 (bf16 is widened on load);
//     q and k are stored d-major with padded rows, so the inner products
//     read q as float4 and k as scalars without bank conflicts, and each
//     thread's output columns are float4 groups 16 lanes apart.  Above
//     48 KB the dynamic shared-memory limit is raised with
//     cudaFuncSetAttribute.
// Later work (ROADMAP): wgmma + TMA pipelines, and an FA-2 backward kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int NT = 256;           // threads per block: 16 (tx) x 16 (ty)
constexpr int LD = BQ + 4;        // padded row of qt and P (float4-aligned)
constexpr int LDK = BK + 1;       // padded row of kt (scalar reads, no conflicts)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // qt [D][LD] + kt [D][LDK] + v [BK][D] + pt [BK][LD]
  return D * LD + D * LDK + BK * D + BK * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int L,
              int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int CD = D / 16;      // output columns per thread
  constexpr int VW = CD < 4 ? CD : 4;   // vector width of a column group
  constexpr int G = CD / VW;      // column groups; col(g, e) = g*16*VW + tx*VW + e
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;               // q tile, d-major: qt[c * LD + r]
  float* kt = qt + D * LD;        // k tile, d-major: kt[c * LDK + j]
  float* vs = kt + D * LDK;       // v tile, row-major: vs[j * D + c]
  float* pt = vs + BK * D;        // probabilities, key-major: pt[j * LD + r]

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // score columns tx + 16*jj; output cols col(g, e)
  const int ty = tid >> 4;        // rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const long q_stride = (long)Hq * D;     // between consecutive positions
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * S * Hq + h) * D;
  const T* kb = k + ((long)b * L * Hkv + hk) * D;
  const T* vb = v + ((long)b * L * Hkv + hk) * D;
  T* ob = o + ((long)b * S * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    qt[c * LD + r] = s < S ? to_float(qb[s * q_stride + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + BQ - 1;
  for (int k0 = 0; k0 < L; k0 += BK) {
    if (causal && k0 > q_last) break;                 // wholly above diagonal
    if (window && k0 + BK - 1 <= q0 - window) continue;  // wholly outside
    __syncthreads();              // previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, c = i % D;
      const int t = k0 + j;
      const bool in = t < L;
      kt[c * LDK + j] = in ? to_float(kb[t * kv_stride + c]) : 0.f;
      vs[j * D + c] = in ? to_float(vb[t * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[c * LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = kt[c * LDK + jj * 16 + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + jj * 16 + tx;
        ok[jj] = kp < L && (!causal || kp <= qp) &&
                 (!window || kp > qp - window);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p[i][jj] = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sum += p[i][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(&pt[(jj * 16 + tx) * LD + ty * 4]) =
          make_float4(p[0][jj], p[1][jj], p[2][jj], p[3][jj]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[j * LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[CD];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* src = &vs[j * D + g * 16 * VW + tx * VW];
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          bv[g * 4 + 0] = t.x; bv[g * 4 + 1] = t.y;
          bv[g * 4 + 2] = t.z; bv[g * 4 + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          bv[g * 2 + 0] = t.x; bv[g * 2 + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(&ob[s * q_stride + g * 16 * VW + tx * VW + e],
              acc[i][g * VW + e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int L, int Hq, int Hkv, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  fa_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, L, Hq, Hkv, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int L, int Hq, int Hkv, int D,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, L, Hq, Hkv, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, L, Hq, Hkv, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, L, Hq, Hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,Hq,D), k/v (B,L,Hkv,D), o (B,S,Hq,D), all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int L, int Hq, int Hkv, int D,
                                         int dtype, int causal, int window,
                                         void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, S, L, Hq, Hkv, D, causal, window, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, L, Hq, Hkv, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

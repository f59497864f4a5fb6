// RWKV6 WKV forward for Hopper (sm_90a), fp32 and bf16 r/k/v, head dims
// N, M in {16, 32, 64}.
//
// Replaces the TPU kernel `wkv6` / `_wkv_kernel` in src/repro/kernels/wkv6.py
// (a Pallas kernel): per head, with a data-dependent decay per channel,
//   out_t = r_t (diag(u) k_t v_t^T + S_{t-1}),
//   S_t   = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T,
// from an optional fp32 initial state, returning the fp32 final state.
// r, k, v are in the compute dtype, log_w, u and the state are fp32, and
// every sum is taken in fp32.  u is read per batch row: row b uses
// u[b / (B / U)], so N clients folded into the batch keep their own u.
//
// What bounds it on this card.  WKV6 at training shapes is bound by bytes:
// at r/k/v (8,1024,32,64) bf16 with fp32 log_w it moves about 206 MB for
// about 4.3 GFLOP (4 N M per step and head), ~21 FLOP per byte, far below
// the H100's ~295 FLOP/byte bf16 ridge.  The recurrence is sequential in
// time, so what this first kernel meets first is latency: each (b, h) walks
// S steps, one after the other.
//
// What the design does about it.
//   * The Pallas grid carries the state across a sequential chunk axis in
//     VMEM; here one block owns one (b, h) and loops over the sequence, and
//     the N x M state never leaves the registers: thread (m, g) holds the
//     16 rows n = j * G + g (j < 16) of column m, with G = N / 16 threads
//     to a column.  A step's output is a shuffle reduction over those G
//     lanes.
//   * It runs the recurrence itself rather than the chunked form: it only
//     ever multiplies the state by exp(log_w) <= 1, so no decay, however
//     strong, can overflow (the chunked form has to mask log differences
//     before its exp for the same guarantee), and it takes any S and has
//     no minimum chunk.
//   * Tiles of 32 steps of r, k, exp(log_w) and v are staged in shared
//     memory as fp32 with coalesced loads (exp taken once per element),
//     so a block synchronises twice per 32 steps, not per step; the
//     interleaved row mapping makes the G lanes of a column read G
//     different banks.
// Later work (ROADMAP): the chunked form on the tensor cores, which trades
// this sequential walk for (Q x Q) products per chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TT = 32;            // time steps staged per tile
constexpr int R = 16;             // state rows per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N, int M>
__global__ void __launch_bounds__(M * (N / R))
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ out, float* __restrict__ sfin, int S, int H,
                int u_div) {
  constexpr int G = N / R;        // threads sharing one state column
  constexpr int NT = M * G;
  __shared__ float rs[TT][N];
  __shared__ float ks[TT][N];
  __shared__ float ws[TT][N];     // exp(log_w)
  __shared__ float vs[TT][M];

  const int tid = threadIdx.x;
  const int g = tid % G;          // rows n = j * G + g
  const int m = tid / G;          // state column
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long bh = (long)b * H + h;
  const long stride_n = (long)H * N;      // between consecutive positions
  const long stride_m = (long)H * M;
  const long base_n = (long)b * S * stride_n + (long)h * N;
  const long base_m = (long)b * S * stride_m + (long)h * M;

  float st[R], uu[R];
  const float* ub = u + ((long)(b / u_div) * H + h) * N;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = j * G + g;
    uu[j] = ub[n];
    st[j] = s0 ? s0[(bh * N + n) * M + m] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int len = min(TT, S - t0);
    __syncthreads();              // the previous tile's readers are done
    for (int i = tid; i < TT * N; i += NT) {
      const int t = i / N, n = i % N;
      if (t < len) {
        const long off = base_n + (long)(t0 + t) * stride_n + n;
        rs[t][n] = to_float(r[off]);
        ks[t][n] = to_float(k[off]);
        ws[t][n] = expf(lw[off]);
      }
    }
    for (int i = tid; i < TT * M; i += NT) {
      const int t = i / M, c = i % M;
      if (t < len) vs[t][c] = to_float(v[base_m + (long)(t0 + t) * stride_m + c]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float vt = vs[t][m];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int n = j * G + g;
        const float kv = ks[t][n] * vt;
        acc = fmaf(rs[t][n], fmaf(uu[j], kv, st[j]), acc);
        st[j] = fmaf(ws[t][n], st[j], kv);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) store(&out[base_m + (long)(t0 + t) * stride_m + m], acc);
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j)
    sfin[(bh * N + j * G + g) * M + m] = st[j];
}

template <typename T, int N, int M>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* out,
                   void* sfin, int B, int S, int H, int U,
                   cudaStream_t stream) {
  wkv6_fwd_kernel<T, N, M><<<B * H, M * (N / R), 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sfin), S, H, B / U);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t dispatch_m(const void* r, const void* k, const void* v,
                       const void* lw, const void* u, const void* s0,
                       void* out, void* sfin, int B, int S, int H, int M,
                       int U, cudaStream_t st) {
  switch (M) {
    case 16: return launch<T, N, 16>(r, k, v, lw, u, s0, out, sfin, B, S, H, U, st);
    case 32: return launch<T, N, 32>(r, k, v, lw, u, s0, out, sfin, B, S, H, U, st);
    case 64: return launch<T, N, 64>(r, k, v, lw, u, s0, out, sfin, B, S, H, U, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* lw, const void* u, const void* s0, void* out,
                     void* sfin, int B, int S, int H, int N, int M, int U,
                     cudaStream_t st) {
  switch (N) {
    case 16: return dispatch_m<T, 16>(r, k, v, lw, u, s0, out, sfin, B, S, H, M, U, st);
    case 32: return dispatch_m<T, 32>(r, k, v, lw, u, s0, out, sfin, B, S, H, M, U, st);
    case 64: return dispatch_m<T, 64>(r, k, v, lw, u, s0, out, sfin, B, S, H, M, U, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/lw (B,S,H,N), v/out (B,S,H,M), u (U,H,N) with U dividing B, s0 (B,H,N,M)
// or null, sfin (B,H,N,M); all contiguous.  dtype of r/k/v/out: 0 = float32,
// 1 = bfloat16; lw, u, s0 and sfin are float32.  Returns the launch's
// cudaError_t.
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                              const void* lw, const void* u, const void* s0,
                              void* out, void* sfin, int B, int S, int H,
                              int N, int M, int U, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || U <= 0 || B % U != 0 ||
      (long)B * H > 2147483647L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(r, k, v, lw, u, s0, out, sfin, B, S, H, N, M, U, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(r, k, v, lw, u, s0, out, sfin, B, S, H, N, M, U, st);
  return (int)cudaErrorInvalidValue;
}

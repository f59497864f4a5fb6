// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a): fp32 and bf16
// x/b/c, head dim P and state size N in {16, 32, 64}.
//
// Replaces the TPU kernel `ssd` / `_ssd_kernel` in src/repro/kernels/ssd_scan.py
// (a Pallas kernel).  Per head h, with a scalar decay a_t = log_decay_t <= 0
// and b/c shared over heads (ngroups = 1), for each chunk of Q steps:
//   intra:  y_t  = sum_{s<=t} (c_t . b_s) exp(acum_t - acum_s) x_s
//   inter:  y_t += exp(acum_t) (c_t . S)          S is (P, N), the carry
//   state:  S    = exp(a_tot) S + sum_s (x_s exp(a_tot - acum_s)) b_s^T
// from an optional fp32 initial state, returning the fp32 final state.
// log_decay and the state are fp32; x, b, c are widened to fp32 on load and
// every sum is taken in fp32.
//
// What bounds it on this card.  At x (8,1024,64,64) bf16, b/c (8,1024,64) the
// scan moves about 146 MB (x in, y out, the fp32 final state) for 4 P N
// FLOP per step and head (8.6 GFLOP) of recurrence, ~59 FLOP per byte: it is
// bound by bytes.  The chunked form does about 3x that arithmetic
// (3 Q P N + Q Q N multiply-adds per chunk) to turn the sequential walk
// into products of (Q x N) and (Q x Q) tiles; on the CUDA cores, as here,
// that arithmetic and the shared-memory reads feeding it are what this
// first kernel meets first.
//
// What the design does about it.
//   * The Pallas grid carries the state across a sequential chunk axis in
//     VMEM; here one block owns one (b, h) and loops over the chunks, and
//     the (P x N) state stays on chip: in registers (a 4 x 4 or smaller tile
//     per thread) with a copy in shared memory for the inter-chunk term.
//   * Q = 64 steps per chunk, whatever S: rows past S are staged as zeros
//     with zero decay, which leaves the state as it is, so any S works and
//     the result does not depend on a chunk size.  Exponentials are taken
//     of differences acum_t - acum_s <= 0 only, so none overflows.
//   * The (Q x Q) scores, the (Q x P) output and the (P x N) state update
//     are register-tiled over 16 x 16 threads, so each shared-memory read
//     feeds several FMAs; c and the scores are stored t-major-last so rows
//     are read as float4, and b with a padded row so it reads without
//     bank conflicts both along s (scores) and along n (state update).
//     The tiles take up to 86 KB, above the 48 KB default, so the dynamic
//     shared-memory limit is raised with cudaFuncSetAttribute.
// Later work (ROADMAP): the three products on the tensor cores (wgmma).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int Q = 64;             // steps per chunk
constexpr int NT = 256;           // threads per block: 16 (tx) x 16 (ty)
constexpr int LDT = Q + 4;        // padded row of ct and pt (float4 reads)
constexpr int LDB = Q + 1;        // padded row of bt (scalar reads, no conflicts)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int P, int N>
constexpr int smem_floats() {
  // xs [Q][P] + ct [N][LDT] + bt [N][LDB] + pt [Q][LDT] + ss [N][P + 4]
  // + acum, ea, ed [Q] each
  return Q * P + N * LDT + N * LDB + Q * LDT + N * (P + 4) + 3 * Q;
}

// Reads W consecutive floats at p (aligned to W floats) into v.
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ld,
               const T* __restrict__ bmat, const T* __restrict__ cmat,
               const float* __restrict__ s0, T* __restrict__ y,
               float* __restrict__ sfin, int S, int H) {
  constexpr int CP = P / 16;      // output columns per thread: p = tx*CP + e
  constexpr int RP = P / 16;      // state rows per thread: p = ty*RP + i
  constexpr int CN = N / 16;      // state columns per thread: n = tx + 16*jj
  constexpr int LDS = P + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;               // x tile: xs[s * P + p]
  float* ct = xs + Q * P;         // c tile, n-major: ct[n * LDT + t]
  float* bt = ct + N * LDT;       // b tile, n-major: bt[n * LDB + s]
  float* pt = bt + N * LDB;       // masked scores, s-major: pt[s * LDT + t]
  float* ss = pt + Q * LDT;       // state at the chunk start: ss[n * LDS + p]
  float* acum = ss + N * LDS;     // inclusive cumsum of the log decay
  float* ea = acum + Q;           // exp(acum[t])
  float* ed = ea + Q;             // exp(a_tot - acum[s])

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long bh = (long)b * H + h;
  const long x_stride = (long)H * P;      // between consecutive positions
  const T* xb = x + (long)b * S * x_stride + (long)h * P;
  T* yb = y + (long)b * S * x_stride + (long)h * P;
  const float* ldb = ld + (long)b * S * H + h;
  const T* bb = bmat + (long)b * S * N;
  const T* cb = cmat + (long)b * S * N;

  float sreg[RP][CN];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int jj = 0; jj < CN; ++jj)
      sreg[i][jj] = s0 ? s0[(bh * P + ty * RP + i) * N + tx + 16 * jj] : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();              // the previous chunk's readers are done
    for (int i = tid; i < Q * P; i += NT) {
      const int s = i / P, p = i % P;
      xs[i] = t0 + s < S ? to_float(xb[(long)(t0 + s) * x_stride + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int s = i / N, n = i % N;
      const bool in = t0 + s < S;
      const long off = (long)(t0 + s) * N + n;
      bt[n * LDB + s] = in ? to_float(bb[off]) : 0.f;
      ct[n * LDT + s] = in ? to_float(cb[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj)
        ss[(tx + 16 * jj) * LDS + ty * RP + i] = sreg[i][jj];
    if (tid < 32) {               // warp 0: cumsum of the chunk's decay
      const int s = 2 * tid;
      const float a0 = t0 + s < S ? ldb[(long)(t0 + s) * H] : 0.f;
      const float a1 = t0 + s + 1 < S ? ldb[(long)(t0 + s + 1) * H] : 0.f;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
      const float c0 = before + a0, c1 = c0 + a1;
      const float tot = __shfl_sync(0xffffffffu, c1, 31);
      acum[s] = c0;
      acum[s + 1] = c1;
      ea[s] = expf(c0);
      ea[s + 1] = expf(c1);
      ed[s] = expf(tot - c0);
      ed[s + 1] = expf(tot - c1);
    }
    __syncthreads();

    // scores[t][s] = (c_t . b_s) exp(acum_t - acum_s) for s <= t, else 0;
    // t = ty*4 + i, s = tx + 16*jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float av[4], bv[4];
      load_vec<4>(&ct[n * LDT + ty * 4], av);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = bt[n * LDB + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(av[i], bv[jj], sc[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int s = tx + 16 * jj;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        p[i] = s <= t ? sc[i][jj] * expf(acum[t] - acum[s]) : 0.f;
      }
      *reinterpret_cast<float4*>(&pt[s * LDT + ty * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }

    // inter-chunk term: y[t][p] = exp(acum_t) (c_t . S[p]); p = tx*CP + e
    float acc[4][CP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < CP; ++e) acc[i][e] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float av[4], bv[CP];
      load_vec<4>(&ct[n * LDT + ty * 4], av);
      load_vec<CP>(&ss[n * LDS + tx * CP], bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CP; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = ea[ty * 4 + i];
#pragma unroll
      for (int e = 0; e < CP; ++e) acc[i][e] *= d;
    }
    __syncthreads();              // pt is complete

    // intra-chunk term: y[t][p] += sum_s scores[t][s] x[s][p]
#pragma unroll 4
    for (int s = 0; s < Q; ++s) {
      float av[4], bv[CP];
      load_vec<4>(&pt[s * LDT + ty * 4], av);
      load_vec<CP>(&xs[s * P + tx * CP], bv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CP; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= S) continue;
#pragma unroll
      for (int e = 0; e < CP; ++e)
        store(&yb[(long)t * x_stride + tx * CP + e], acc[i][e]);
    }

    // state: S[p][n] = exp(a_tot) S[p][n] + sum_s x[s][p] exp(a_tot - acum_s) b[s][n];
    // p = ty*RP + i, n = tx + 16*jj
    const float etot = ea[Q - 1];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) sreg[i][jj] *= etot;
#pragma unroll 4
    for (int s = 0; s < Q; ++s) {
      const float d = ed[s];
      float xv[RP], bv[CN];
      load_vec<RP>(&xs[s * P + ty * RP], xv);
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) bv[jj] = bt[(tx + 16 * jj) * LDB + s];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float xd = xv[i] * d;
#pragma unroll
        for (int jj = 0; jj < CN; ++jj) sreg[i][jj] = fmaf(xd, bv[jj], sreg[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int jj = 0; jj < CN; ++jj)
      sfin[(bh * P + ty * RP + i) * N + tx + 16 * jj] = sreg[i][jj];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* ld, const void* b,
                   const void* c, const void* s0, void* y, void* sfin, int B,
                   int S, int H, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<T, P, N><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ld),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(sfin), S, H);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const void* x, const void* ld, const void* b,
                       const void* c, const void* s0, void* y, void* sfin,
                       int B, int S, int H, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, ld, b, c, s0, y, sfin, B, S, H, st);
    case 32: return launch<T, P, 32>(x, ld, b, c, s0, y, sfin, B, S, H, st);
    case 64: return launch<T, P, 64>(x, ld, b, c, s0, y, sfin, B, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* ld, const void* b,
                     const void* c, const void* s0, void* y, void* sfin,
                     int B, int S, int H, int P, int N, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(x, ld, b, c, s0, y, sfin, B, S, H, N, st);
    case 32: return dispatch_n<T, 32>(x, ld, b, c, s0, y, sfin, B, S, H, N, st);
    case 64: return dispatch_n<T, 64>(x, ld, b, c, s0, y, sfin, B, S, H, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x/y (B,S,H,P), ld (B,S,H), b/c (B,S,N), s0 (B,H,P,N) or null, sfin
// (B,H,P,N); all contiguous.  dtype of x/b/c/y: 0 = float32, 1 = bfloat16;
// ld, s0 and sfin are float32.  Returns the launch's cudaError_t.
extern "C" int repro_ssd_fwd(const void* x, const void* ld, const void* b,
                             const void* c, const void* s0, void* y,
                             void* sfin, int B, int S, int H, int P, int N,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long)B * H > 2147483647L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, ld, b, c, s0, y, sfin, B, S, H, P, N, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, ld, b, c, s0, y, sfin, B, S, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

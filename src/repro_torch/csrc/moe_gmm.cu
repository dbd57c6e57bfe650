// Ragged grouped GEMM (MoE expert compute) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/moe_gmm/kernel.py:
//   moe_gmm  <- moe_gmm_pallas  (_gmm_kernel)
//
// What it computes
//   out[r, :] = x[r, :] @ w[tile_expert[r / tile_m]]     for every row r
//   x (M, K) is sorted by expert and padded per expert to tile_m rows;
//   w (E, K, N); x and w both float32 or both bfloat16; out (M, N) float32.
//   A tile whose expert is outside [0, E) reads nothing and is written as
//   NaN (the planner rejects such tiles on the host before launching).
//
// What bounds it on this card
//   Decode (a few tokens): the weight bytes. Every expert owns at least one
//   tile_m row tile (the host pads empty experts too), so all of w, 3.22 GB
//   at mixtral-8x22b width, is read once: 0.96 ms at 3.35 TB/s. Prefill
//   (thousands of tokens): fp32 operations, 2*M*K*N.
//
// What the design does about it
//   The TPU grid keeps the output tile in VMEM across a sequential K axis;
//   here one CTA owns a (BM-row sub-tile, 128-column strip) of out and loops
//   over K itself, sums in registers (a 4x8 micro-tile per thread), so every
//   output element is written exactly once: no atomics, deterministic. BM is
//   64 or 32 and divides tile_m, so a CTA's rows share one expert. x and w
//   strips stream through shared memory in 32-deep K chunks, converted to
//   fp32 on load; the products are fp32 FMAs on CUDA cores (TF32 would miss
//   the reference's tolerance). Row sub-tiles run fastest on the grid, so
//   the CTAs that read one expert's w strip run together and share it in
//   L2: at decode each w strip comes from HBM about once. N and K edges
//   that the tile does not divide are masked. Offsets are 64-bit: w is
//   3.22 GB at mixtral width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;   // output columns per CTA
constexpr int kBK = 32;    // K chunk through shared memory
constexpr int kTM = 4;     // rows per thread
constexpr int kTN = 8;     // columns per thread: two groups of 4, 64 apart

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int BM>
__global__ void __launch_bounds__((BM / kTM) * (kBN / kTN))
moe_gmm_kernel(const int* __restrict__ tile_expert,   // (M / tile_m,)
               const T* __restrict__ x,               // (M, K)
               const T* __restrict__ w,               // (E, K, N)
               float* __restrict__ out,               // (M, N)
               long long E, long long K, long long N, int tile_m) {
  constexpr int kThreads = (BM / kTM) * (kBN / kTN);
  // x strip row-major with one pad column (conflict-free stores, broadcast
  // reads); w strip row-major, read as float4.
  __shared__ float xs[BM][kBK + 1];
  __shared__ __align__(16) float ws[kBK][kBN];

  const long long row0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * kBN;
  const long long e = tile_expert[row0 / tile_m];
  if (e < 0 || e >= E) {   // uniform over the CTA: no read out of bounds
    for (int q = threadIdx.x; q < BM * kBN; q += kThreads) {
      const long long n = n0 + q % kBN;
      if (n < N) out[(row0 + q / kBN) * N + n] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const T* x_t = x + row0 * K;
  const T* w_e = w + e * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);   // 16 column groups
  const int ty = tid / (kBN / kTN);   // BM / 4 row groups

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < K; k0 += kBK) {
    for (int q = tid; q < BM * kBK; q += kThreads) {
      const int m = q / kBK, kk = q % kBK;
      const long long k = k0 + kk;
      xs[m][kk] = k < K ? to_float(x_t[m * K + k]) : 0.f;
    }
    for (int q = tid; q < kBK * kBN; q += kThreads) {
      const int kk = q / kBN, nn = q % kBN;
      const long long k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N) ? to_float(w_e[k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty * kTM + i][kk];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][kBN / 2 + tx * 4]);
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* o = out + (row0 + ty * kTM + i) * N;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long n = n0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + j - 4);
      if (n < N) o[n] = acc[i][j];
    }
  }
}

template <typename T, int BM>
int launch(const int* tile_expert, const void* x, const void* w, float* out,
           long long M, long long E, long long K, long long N, int tile_m,
           cudaStream_t stream) {
  const dim3 grid((unsigned)(M / BM), (unsigned)((N + kBN - 1) / kBN));
  moe_gmm_kernel<T, BM><<<grid, (BM / kTM) * (kBN / kTN), 0, stream>>>(
      tile_expert, static_cast<const T*>(x), static_cast<const T*>(w), out,
      E, K, N, tile_m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w alike). Returns
// cudaGetLastError() after the launch (0 = launched).
int moe_gmm(const int* tile_expert, const void* x, const void* w, float* out,
            long long M, long long E, long long K, long long N, int tile_m,
            int dtype, cudaStream_t stream) {
  if (M <= 0 || E <= 0 || K <= 0 || N <= 0 || tile_m <= 0 ||
      M % tile_m != 0 || tile_m % 32 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int bm = tile_m % 64 == 0 ? 64 : 32;
  if (M / bm > 2147483647LL || (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  auto fn = bm == 64 ? (dtype == 0 ? launch<float, 64>
                                    : launch<__nv_bfloat16, 64>)
                     : (dtype == 0 ? launch<float, 32>
                                    : launch<__nv_bfloat16, 32>);
  return fn(tile_expert, x, w, out, M, E, K, N, tile_m, stream);
}

}  // extern "C"

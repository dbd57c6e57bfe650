// Block SpGEMM numeric phase (Gustavson at block granularity) for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/bsr_spgemm/kernel.py:
//   bsr_spgemm_pairs  <- bsr_spgemm_pallas        (_spgemm_kernel)
//   bsr_spgemm_cells  <- bsr_spgemm_cells_pallas  (_spgemm_cells_kernel)
//
// What it computes
//   pairs: c[m, k] = sum_p a[m, pair_a[m, k, p]] @ b[m, pair_b[m, k, p]]
//          (p < max_pairs; pad slots point at the all-zeros sentinel tile)
//   cells: c[m, k] = sum_{t in cell_ptr[m, k] .. cell_ptr[m, k+1])
//                    a[m, cell_a[m, t]] @ b[m, cell_b[m, t]]
//   with bs x bs fp32 tiles; m is the member of a stacked bucket (one
//   member for a single plan). cell_ptr is built on the host over the live
//   cells only, so bucket pad cells belong to no output block.
//
// What bounds it on this card
//   Operations at large tiles, bytes at small ones: each pair is 2*bs^3
//   FLOP on 8*bs^2 bytes of tiles, so bs = 128 does 32 FLOP per byte
//   (above the H100's ~20 FLOP/byte fp32 ridge, 67 TFLOP/s over
//   3.35 TB/s), bs = 32 does 8. The least time is the larger of
//   2*bs^3*(real pairs) / 67 TFLOP/s and (C written + the A and B tiles
//   read once + the index arrays) / 3.35 TB/s.
//
// What the design does about it
//   The TPU kernel keeps the C tile resident in VMEM across the sequential
//   pair axis. GPU blocks run in no order, so one CTA owns one (output
//   block, T x T output sub-tile, member) and loops over that block's pair
//   slots or cell range itself, keeping the sub-tile's sums in registers
//   (4 x 4 per thread). No atomics, no second pass: the result is
//   deterministic. At bs = 256 a C tile is 256 KB, above one SM's registers
//   and its 227 KB of shared memory, so the tile is split into T = 64
//   sub-tiles (T = 32 for bs <= 32); the A row-strip and the B
//   column-strip stream through shared memory in 32-deep k-chunks
//   (17 KB at T = 64), A stored transposed so both operands are read as
//   16-byte vectors. The products are CUDA-core fp32 FMAs: TF32 tensor
//   cores would miss the reference's 2e-4 tolerance. Partial sub-tiles
//   (bs = 96) and short k-chunks (bs = 8, 16) are zero-filled. Every
//   output element is written once, including blocks that own no cells.
//   All offsets are 64-bit: tile index * bs * bs passes 2^31 at bs = 128
//   beyond 131,072 tiles, and member offsets sooner.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // k-depth staged per step
constexpr int kPad = 4;      // keeps 16-byte rows, spreads banks

template <int T, bool kCells>
__global__ void __launch_bounds__((T / 4) * (T / 4))
bsr_spgemm_kernel(const int* __restrict__ list_a,    // pairs (B, n_c, mp) | cells (B, n_cells)
                  const int* __restrict__ list_b,    // same shape
                  const int* __restrict__ cell_ptr,  // cells (B, n_c + 1)
                  const float* __restrict__ a,       // (B, n_a, bs, bs)
                  const float* __restrict__ b,       // (B, n_b, bs, bs)
                  float* __restrict__ c,             // (B, n_c, bs, bs)
                  long long n_c, long long n_list, long long n_a,
                  long long n_b, int bs, int n_sub) {
  constexpr int TD = T / 4;            // threads per sub-tile edge
  constexpr int NT = TD * TD;
  __shared__ __align__(16) float a_s[kChunk][T + kPad];   // a_s[k][i]
  __shared__ __align__(16) float b_s[kChunk][T + kPad];   // b_s[k][j]

  const long long m = blockIdx.z;
  const long long k_out = blockIdx.x;
  const int i0 = (blockIdx.y / n_sub) * T;
  const int j0 = (blockIdx.y % n_sub) * T;
  const int tid = threadIdx.x;
  const int tx = tid % TD, ty = tid / TD;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  long long lo, hi, base;
  if (kCells) {
    const int* ptr = cell_ptr + m * (n_c + 1);
    lo = ptr[k_out];
    hi = ptr[k_out + 1];
    base = m * n_list;
  } else {
    lo = 0;
    hi = n_list;
    base = (m * n_c + k_out) * n_list;
  }

  const long long tile = (long long)bs * bs;
  for (long long s = lo; s < hi; ++s) {
    const float* a_g = a + (m * n_a + list_a[base + s]) * tile;
    const float* b_g = b + (m * n_b + list_b[base + s]) * tile;
    for (int k0 = 0; k0 < bs; k0 += kChunk) {
      __syncthreads();
      // A rows i0 .. i0+T, columns k0 .. k0+kChunk, stored transposed
      for (int e = tid; e < T * (kChunk / 4); e += NT) {
        const int ii = e / (kChunk / 4);
        const int kk = (e % (kChunk / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i0 + ii < bs && k0 + kk < bs)
          v = *reinterpret_cast<const float4*>(
              a_g + (long long)(i0 + ii) * bs + k0 + kk);
        a_s[kk][ii] = v.x;
        a_s[kk + 1][ii] = v.y;
        a_s[kk + 2][ii] = v.z;
        a_s[kk + 3][ii] = v.w;
      }
      // B rows k0 .. k0+kChunk, columns j0 .. j0+T
      for (int e = tid; e < kChunk * (T / 4); e += NT) {
        const int kk = e / (T / 4);
        const int jj = (e % (T / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < bs && j0 + jj < bs)
          v = *reinterpret_cast<const float4*>(
              b_g + (long long)(k0 + kk) * bs + j0 + jj);
        *reinterpret_cast<float4*>(&b_s[kk][jj]) = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
      }
    }
  }

  const int j = j0 + tx * 4;
  float* c_t = c + (m * n_c + k_out) * tile;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i < bs && j < bs)   // bs % 4 == 0: the 4 columns are all in range
      *reinterpret_cast<float4*>(c_t + (long long)i * bs + j) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <bool kCells>
int launch(const int* list_a, const int* list_b, const int* cell_ptr,
           const float* a, const float* b, float* c, int n_members,
           long long n_c, long long n_list, long long n_a, long long n_b,
           int bs, cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_c <= 0 || n_c > 2147483647LL ||
      n_list < 0 || n_members <= 0 || n_members > 65535 ||
      (kCells && cell_ptr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bs <= 32) {
    const dim3 grid((unsigned)n_c, 1, n_members);
    bsr_spgemm_kernel<32, kCells><<<grid, 64, 0, stream>>>(
        list_a, list_b, cell_ptr, a, b, c, n_c, n_list, n_a, n_b, bs, 1);
  } else {
    const int n_sub = (bs + 63) / 64;
    const dim3 grid((unsigned)n_c, n_sub * n_sub, n_members);
    bsr_spgemm_kernel<64, kCells><<<grid, 256, 0, stream>>>(
        list_a, list_b, cell_ptr, a, b, c, n_c, n_list, n_a, n_b, bs, n_sub);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// n_list is max_pairs (pairs) or n_cells (cells); cell_ptr is unused by
// the pairs kernel.
int bsr_spgemm_pairs(const int* pair_a, const int* pair_b,
                     const int* cell_ptr, const float* a, const float* b,
                     float* c, int n_members, long long n_c,
                     long long max_pairs, long long n_a, long long n_b,
                     int bs, cudaStream_t stream) {
  (void)cell_ptr;
  return launch<false>(pair_a, pair_b, nullptr, a, b, c, n_members, n_c,
                       max_pairs, n_a, n_b, bs, stream);
}

int bsr_spgemm_cells(const int* cell_a, const int* cell_b,
                     const int* cell_ptr, const float* a, const float* b,
                     float* c, int n_members, long long n_c,
                     long long n_cells, long long n_a, long long n_b, int bs,
                     cudaStream_t stream) {
  return launch<true>(cell_a, cell_b, cell_ptr, a, b, c, n_members, n_c,
                      n_cells, n_a, n_b, bs, stream);
}

}  // extern "C"

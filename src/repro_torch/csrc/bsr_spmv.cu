// ELL/SELL-BSR SpMV and multi-RHS SpMM for Hopper (sm_90a), CUDA C++.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/bsr_spmv/kernel.py:
//   bsr_spmv_ell   <- bsr_spmv_pallas       (_ell_kernel)
//   bsr_spmm_ell   <- bsr_spmm_pallas       (_ell_kernel)
//   bsr_spmv_sell  <- bsr_spmv_sell_pallas  (_sell_kernel)
//   bsr_spmm_sell  <- bsr_spmm_sell_pallas  (_sell_kernel)
//
// What it computes
//   ELL:  y[b, r] = sum_j blocks[b, idx[b, r, j]] @ x[b, cols[b, r, j]]
//   SELL: y[b, row_perm[b, r]] = sum_{t in cell_ptr[b, r] .. cell_ptr[b, r+1])
//                                blocks[b, cell_block[b, t]] @ x[b, cell_col[b, t]]
//   b is the member of a stacked bucket (B = 1 for a single plan); x is
//   (n_bc, bs) for SpMV and (n_bc, bs, k) for SpMM, k a multiple of 8.
//
// What bounds it on this card
//   Bytes. Every stored tile is read once per RHS tile and used for
//   bs*bs*KT multiply-adds, KT = 1 (SpMV) or 8 (SpMM): at most 2 FLOP per
//   4-byte element for SpMV and 16 for SpMM, far below the H100's
//   ~20 FLOP/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s). The least time is
//   (blocks.nbytes + indices + x + y) / 3.35 TB/s.
//
// What the design does about it
//   The TPU grid runs its slot axis in order and keeps the output tile
//   resident between steps; GPU blocks run in parallel in no order, so one
//   CTA owns one (block-row, RHS tile, member) and loops over that row's
//   slots (ELL) or cells (SELL) itself, keeping its rows x KT fp32 sums in
//   registers. No atomics, no second pass: the result is deterministic.
//   When there are too few block-rows to fill the card (gen_zipf at
//   bs = 128 has 64), the wrapper splits each tile's rows over up to 8
//   CTAs (rows_per_cta >= 16): A is still read once, only x is re-read.
//   A tiles are streamed through shared memory in 32-column chunks with
//   16-byte coalesced loads, so bs = 256 (a 256 KB tile, above the 227 KB a
//   block may use) needs only 34 KB; the x segment is staged beside it.
//   Small per-CTA shared memory keeps up to 8 CTAs per SM in flight, which
//   is what hides the load latency. Sums use CUDA-core fp32 FMAs (no TF32),
//   matching the reference's fp32 accumulation. When one output needs fewer
//   than 256 threads (SpMV, small bs) the column sum is split over G lanes
//   and reduced with warp shuffles once, after the last slot.
//   SELL rows are located through a row pointer (cell_ptr, derived on the
//   host from the nondecreasing cell_row), and each CTA writes its result
//   straight to y[row_perm[r]]: the scatter the JAX path does afterwards is
//   fused, and sorted rows that own no cells (bucket padding) write zeros.
//   All element offsets are 64-bit: idx * bs * bs passes 2^31 at bs = 128
//   beyond 131,072 blocks, and member offsets in a bucket sooner.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;     // A-tile columns staged per step
constexpr int kMaxOut = 8;     // outputs per thread: bs <= 256, KT <= 8

template <bool kSell, int KT>
__global__ void __launch_bounds__(kThreads)
bsr_matvec_kernel(const int* __restrict__ slot_block,  // ELL (B,n_br,mb) | SELL (B,n_cells)
                  const int* __restrict__ slot_col,    // same shape
                  const int* __restrict__ cell_ptr,    // SELL (B, n_br+1)
                  const int* __restrict__ row_perm,    // SELL (B, n_br)
                  const float* __restrict__ blocks,    // (B, nb, bs, bs)
                  const float* __restrict__ x,         // (B, n_bc, bs, k)
                  float* __restrict__ y,               // (B, n_br, bs, k)
                  int n_br, long long n_slots, long long nb, int bs,
                  int n_bc, int k, int rows_per_cta) {
  extern __shared__ float smem[];
  float* a_s = smem;                              // [rows_per_cta][kChunk + 1]
  float* x_s = smem + rows_per_cta * (kChunk + 1);  // [kChunk][KT]
  const int r = blockIdx.x;
  const int n_kt = k / KT;
  const int k0 = (blockIdx.y % n_kt) * KT;
  const int i0 = (blockIdx.y / n_kt) * rows_per_cta;   // first tile row
  const int rb = min(rows_per_cta, bs - i0);
  const long long b = blockIdx.z;
  const int t = threadIdx.x;
  const int n_out = rb * KT;

  // G lanes share one output when there are fewer outputs than threads.
  int g = 1;
  while (g < kChunk && 2 * g * n_out <= kThreads) g *= 2;
  const int workers = kThreads / g;
  const int lane_s = t % g;
  const int o_base = t / g;

  float acc[kMaxOut];
#pragma unroll
  for (int q = 0; q < kMaxOut; ++q) acc[q] = 0.f;

  long long lo, hi, base;
  if (kSell) {
    const int* ptr = cell_ptr + b * (n_br + 1);
    lo = ptr[r];
    hi = ptr[r + 1];
    base = b * n_slots;
  } else {
    lo = 0;
    hi = n_slots;
    base = (b * n_br + r) * n_slots;
  }

  const long long tile = (long long)bs * bs;
  for (long long s = lo; s < hi; ++s) {
    const long long blk = slot_block[base + s];
    const long long col = slot_col[base + s];
    const float* a_g = blocks + (b * nb + blk) * tile;
    const float* x_g = x + ((b * n_bc + col) * bs) * k + k0;
    for (int c0 = 0; c0 < bs; c0 += kChunk) {
      const int cw = min(kChunk, bs - c0);
      __syncthreads();
      for (int e = t; e < rb * (kChunk / 4); e += kThreads) {
        const int i = e / (kChunk / 4);
        const int c4 = (e % (kChunk / 4)) * 4;
        if (c4 < cw) {
          const float4 v = *reinterpret_cast<const float4*>(
              a_g + (long long)(i0 + i) * bs + c0 + c4);
          float* dst = a_s + i * (kChunk + 1) + c4;
          dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        }
      }
      for (int e = t; e < kChunk * KT; e += kThreads) {
        const int cc = e / KT;
        const int kk = e % KT;
        x_s[e] = cc < cw ? x_g[(long long)(c0 + cc) * k + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxOut; ++q) {
        const int o = o_base + q * workers;
        if (o < n_out) {
          const float* a_row = a_s + (o / KT) * (kChunk + 1);
          const float* x_col = x_s + (o % KT);
          float sum = acc[q];
          for (int cc = lane_s; cc < cw; cc += g)
            sum = fmaf(a_row[cc], x_col[cc * KT], sum);
          acc[q] = sum;
        }
      }
    }
  }

  const long long out_r = kSell ? (long long)row_perm[b * n_br + r] : r;
  float* y_row = y + ((b * n_br + out_r) * bs) * k + k0;
#pragma unroll
  for (int q = 0; q < kMaxOut; ++q) {
    float v = acc[q];
    for (int off = g / 2; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off, g);
    const int o = o_base + q * workers;
    if (lane_s == 0 && o < n_out)
      y_row[(long long)(i0 + o / KT) * k + (o % KT)] = v;
  }
}

template <bool kSell, int KT>
int launch(const int* slot_block, const int* slot_col, const int* cell_ptr,
           const int* row_perm, const float* blocks, const float* x, float* y,
           int n_members, int n_br, long long n_slots, long long nb, int bs,
           int n_bc, int k, int rows_per_cta, cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || k <= 0 || k % KT != 0 ||
      n_br <= 0 || n_members <= 0 || n_members > 65535 ||
      rows_per_cta <= 0 || rows_per_cta > bs)
    return (int)cudaErrorInvalidValue;
  const int n_split = (bs + rows_per_cta - 1) / rows_per_cta;
  if ((long long)(k / KT) * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_br, (k / KT) * n_split, n_members);
  const size_t shmem =
      sizeof(float) * (rows_per_cta * (kChunk + 1) + kChunk * KT);
  bsr_matvec_kernel<kSell, KT><<<grid, kThreads, shmem, stream>>>(
      slot_block, slot_col, cell_ptr, row_perm, blocks, x, y, n_br, n_slots,
      nb, bs, n_bc, k, rows_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int bsr_spmv_ell(const int* idx, const int* cols, const float* blocks,
                 const float* x, float* y, int n_members, int n_br, int mb,
                 long long nb, int bs, int n_bc, int rows_per_cta,
                 cudaStream_t stream) {
  return launch<false, 1>(idx, cols, nullptr, nullptr, blocks, x, y,
                          n_members, n_br, mb, nb, bs, n_bc, 1, rows_per_cta,
                          stream);
}

int bsr_spmm_ell(const int* idx, const int* cols, const float* blocks,
                 const float* x, float* y, int n_members, int n_br, int mb,
                 long long nb, int bs, int n_bc, int k, int rows_per_cta,
                 cudaStream_t stream) {
  return launch<false, 8>(idx, cols, nullptr, nullptr, blocks, x, y,
                          n_members, n_br, mb, nb, bs, n_bc, k, rows_per_cta,
                          stream);
}

int bsr_spmv_sell(const int* cell_block, const int* cell_col,
                  const int* cell_ptr, const int* row_perm,
                  const float* blocks, const float* x, float* y,
                  int n_members, int n_br, long long n_cells, long long nb,
                  int bs, int n_bc, int rows_per_cta, cudaStream_t stream) {
  return launch<true, 1>(cell_block, cell_col, cell_ptr, row_perm, blocks, x,
                         y, n_members, n_br, n_cells, nb, bs, n_bc, 1,
                         rows_per_cta, stream);
}

int bsr_spmm_sell(const int* cell_block, const int* cell_col,
                  const int* cell_ptr, const int* row_perm,
                  const float* blocks, const float* x, float* y,
                  int n_members, int n_br, long long n_cells, long long nb,
                  int bs, int n_bc, int k, int rows_per_cta,
                  cudaStream_t stream) {
  return launch<true, 8>(cell_block, cell_col, cell_ptr, row_perm, blocks, x,
                         y, n_members, n_br, n_cells, nb, bs, n_bc, k,
                         rows_per_cta, stream);
}

}  // extern "C"

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
//   (n_bc, bs) for SpMV and (n_bc, bs, k) for SpMM, k a multiple of 8. The
//   host builds cell_ptr so that a member's last sorted row owns one of
//   the bucket-pad cells (zero block, column 0) appended to its stream:
//   the TPU kernel adds every one of them to that row, and they are all
//   the same product.
//
// What bounds it on this card
//   Bytes. Every stored tile is read once per RHS tile and used for
//   bs*bs*KT multiply-adds, KT = 1 (SpMV) or 8 (SpMM): at most 2 FLOP per
//   4-byte element for SpMV and 16 for SpMM, far below the H100's
//   ~20 FLOP/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s). The least time is
//   (blocks.nbytes + indices + x + y) / 3.35 TB/s.
//
// What the SpMV design does about it (bsr_spmv_ell, bsr_spmv_sell)
//   One template, bsr_spmv_counted_kernel, for both layouts: only where a
//   row's slots come from differs (ELL: row r of the slot table; SELL: the
//   cells cell_ptr assigns to sorted row r, the result stored to
//   row_perm[r]). One CTA owns one (row, strip of tile rows, member). The
//   row's real slots lead it and a count (valid_counts for ELL, cell_valid
//   for SELL) says how many; the slots after them hold the all-zeros block
//   and column 0 (ELL pad slots, SELL slice-width and bucket-pad cells).
//   The TPU kernel multiplies every slot, so a pad slot adds
//   0 * x_blocks[0]: +0 for a finite x, NaN where x_blocks[0] holds an Inf
//   or a NaN. The kernel sums the real slots and then exactly one pad
//   slot, the one right after them, when the row has one: every pad slot
//   of a row is the same product, so this is the all-slot sum (up to the
//   sign of an exact zero) while the dead tiles are never read. Rows that
//   own no slot (SELL bucket-pad rows) write zeros.
//   The row's slot indices are staged in shared memory in batches of 256
//   before its slot loop, so no tile address waits on an index load. The
//   strips (contiguous in the tile, at most kEllStrip floats) and their x
//   segments stream through a kEllStages-deep ring of shared memory filled
//   by 16-byte cp.async copies, one barrier per slot: three strips are in
//   flight while one is summed. g lanes (a power of two up to 32) share
//   each output row and are reduced with warp shuffles once, after the
//   last slot.
//
// What the SpMM design does (bsr_spmm_ell, bsr_spmm_sell)
//   One CTA per (block-row, RHS tile, member) loops over the row's slots
//   (ELL) or cells (SELL), keeping its rows x KT fp32 sums in registers. No
//   atomics, no second pass: every result is deterministic. When there are
//   too few block-rows to fill the card (gen_zipf at bs = 128 has 64), the
//   wrapper splits each tile's rows over up to 8 CTAs (rows_per_cta >= 16):
//   A is still read once, only x is re-read. A tiles are streamed through
//   shared memory in 32-column chunks with 16-byte coalesced loads, so
//   bs = 256 (a 256 KB tile, above the 227 KB a block may use) needs only
//   34 KB; the x segment is staged beside it. Small per-CTA shared memory
//   keeps up to 8 CTAs per SM in flight, which is what hides the load
//   latency. Sums use CUDA-core fp32 FMAs (no TF32), matching the
//   reference's fp32 accumulation. When one output needs fewer than 256
//   threads (small bs) the column sum is split over G lanes and reduced
//   with warp shuffles once, after the last slot.
//   SELL rows are located through the row pointer (cell_ptr, derived on the
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

// ------------------------------------------- ELL and SELL SpMV

constexpr int kEllStages = 4;     // ring depth
constexpr int kEllStrip = 2048;   // floats of one stage's A strip, at most
constexpr int kEllRows = 4;       // output rows per thread, at most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// CTA (r, strip, b) computes y[b, out_r, i0 : i0 + rb], i0 = strip * rows;
// out_r = r (ELL) or row_perm[b, r] (SELL). Its slots: ELL row r of
// member b, n_slots wide; SELL cells cell_ptr[b, r] .. cell_ptr[b, r+1] of
// member b's stream of n_slots cells. Shared memory: kEllStages stages of
// [rows x bs strip | bs x segment], then one batch of kThreads slot
// indices (block, column).
template <bool kSell>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_counted_kernel(const int* __restrict__ slot_block,  // ELL (B,n_br,mb) | SELL (B,n_cells)
                        const int* __restrict__ slot_col,    // same shape
                        const int* __restrict__ cell_ptr,    // SELL (B, n_br+1)
                        const int* __restrict__ valid,       // (B, n_br)
                        const int* __restrict__ row_perm,    // SELL (B, n_br)
                        const float* __restrict__ blocks,    // (B, nb, bs, bs)
                        const float* __restrict__ x,         // (B, n_bc, bs)
                        float* __restrict__ y,               // (B, n_br, bs)
                        int n_br, long long n_slots, long long nb, int bs,
                        int n_bc, int rows, int g) {
  extern __shared__ __align__(16) float smem[];
  const int stage = rows * bs + bs;
  int* s_blk = reinterpret_cast<int*>(smem + kEllStages * stage);
  int* s_col = s_blk + kThreads;
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * rows;
  const int rb = min(rows, bs - i0);
  const long long b = blockIdx.z;
  const long long row = b * n_br + blockIdx.x;
  long long first;   // the row's first slot
  int len;           // its slots
  if (kSell) {
    const int* ptr = cell_ptr + b * (n_br + 1) + blockIdx.x;
    first = b * n_slots + ptr[0];
    len = max(ptr[1] - ptr[0], 0);
  } else {
    first = row * n_slots;
    len = (int)n_slots;
  }
  const int n_real = min(max(valid[row], 0), len);
  const int n = n_real < len ? n_real + 1 : len;   // + one pad slot, if any
  const int q = bs / 4;                          // 16-byte vectors per row
  const int n_vec = rb * q;
  const long long tile = (long long)bs * bs;
  const float* a_b = blocks + b * nb * tile + (long long)i0 * bs;
  const float* x_b = x + b * n_bc * (long long)bs;
  const int lane_s = t % g, o_base = t / g, workers = kThreads / g;

  float acc[kEllRows];
#pragma unroll
  for (int u = 0; u < kEllRows; ++u) acc[u] = 0.f;

  for (int s0 = 0; s0 < n; s0 += kThreads) {
    const int nn = min(kThreads, n - s0);
    __syncthreads();   // the last batch is summed and its indices unread
    if (t < nn) {
      s_blk[t] = slot_block[first + s0 + t];
      s_col[t] = slot_col[first + s0 + t];
    }
    __syncthreads();
    auto produce = [&](int j) {   // slot s0 + j into stage j % kEllStages
      if (j < nn) {
        float* as = smem + (j % kEllStages) * stage;
        const float* ag = a_b + s_blk[j] * tile;
        for (int e = t; e < n_vec; e += kThreads)
          cp_async16(as + 4 * e, ag + 4 * e);
        if (t < q)
          cp_async16(as + rows * bs + 4 * t,
                     x_b + (long long)s_col[j] * bs + 4 * t);
      }
      cp_async_commit();   // one group per call, empty or not
    };
#pragma unroll
    for (int j = 0; j < kEllStages - 1; ++j) produce(j);
    for (int j = 0; j < nn; ++j) {
      cp_async_wait<kEllStages - 2>();
      __syncthreads();   // slot j landed; every thread is done with j - 1
      produce(j + kEllStages - 1);
      const float* as = smem + (j % kEllStages) * stage;
      const float* xs = as + rows * bs;
#pragma unroll
      for (int u = 0; u < kEllRows; ++u) {
        const int o = o_base + u * workers;
        if (o < rb) {
          const float* ar = as + o * bs;
          float sum = acc[u];
          for (int c4 = lane_s; c4 < q; c4 += g) {
            const float4 av = *reinterpret_cast<const float4*>(ar + 4 * c4);
            const float4 xv = *reinterpret_cast<const float4*>(xs + 4 * c4);
            sum = fmaf(av.x, xv.x, sum);
            sum = fmaf(av.y, xv.y, sum);
            sum = fmaf(av.z, xv.z, sum);
            sum = fmaf(av.w, xv.w, sum);
          }
          acc[u] = sum;
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long out_r = kSell ? b * n_br + row_perm[row] : row;
  float* y_r = y + out_r * bs + i0;
#pragma unroll
  for (int u = 0; u < kEllRows; ++u) {
    float v = acc[u];
    for (int off = g / 2; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off, g);
    const int o = o_base + u * workers;
    if (lane_s == 0 && o < rb) y_r[o] = v;
  }
}

template <bool kSell>
int launch_spmv_counted(const int* slot_block, const int* slot_col,
                        const int* cell_ptr, const int* valid,
                        const int* row_perm, const float* blocks,
                        const float* x, float* y, int n_members, int n_br,
                        long long n_slots, long long nb, int bs, int n_bc,
                        int rows_per_cta, cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_br <= 0 || n_slots < 0 ||
      (!kSell && n_slots > 2147483647LL) || n_members <= 0 ||
      n_members > 65535 || rows_per_cta <= 0 || rows_per_cta > bs ||
      valid == nullptr || (kSell && (cell_ptr == nullptr ||
                                     row_perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  // g: the power of two up to 32 that a row's bs / 4 vectors fill; a
  // strip holds at most kEllStrip floats and kEllRows rows per thread
  int g = 1;
  while (g < 32 && 2 * g <= bs / 4) g *= 2;
  int rows = min(rows_per_cta, max(1, kEllStrip / bs));
  rows = min(rows, kEllRows * (kThreads / g));
  const int n_split = (bs + rows - 1) / rows;
  const dim3 grid(n_br, n_split, n_members);
  const int shmem = (int)(sizeof(float) * kEllStages * (rows * bs + bs) +
                          sizeof(int) * 2 * kThreads);
  auto kernel = bsr_spmv_counted_kernel<kSell>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, shmem, stream>>>(
      slot_block, slot_col, cell_ptr, valid, row_perm, blocks, x, y, n_br,
      n_slots, nb, bs, n_bc, rows, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// valid_counts (n_members, n_br): the real slots that lead each ELL row
// (the container's valid_counts).
int bsr_spmv_ell(const int* idx, const int* cols, const int* valid_counts,
                 const float* blocks, const float* x, float* y,
                 int n_members, int n_br, int mb, long long nb, int bs,
                 int n_bc, int rows_per_cta, cudaStream_t stream) {
  return launch_spmv_counted<false>(idx, cols, nullptr, valid_counts,
                                    nullptr, blocks, x, y, n_members, n_br,
                                    mb, nb, bs, n_bc, rows_per_cta, stream);
}

int bsr_spmm_ell(const int* idx, const int* cols, const float* blocks,
                 const float* x, float* y, int n_members, int n_br, int mb,
                 long long nb, int bs, int n_bc, int k, int rows_per_cta,
                 cudaStream_t stream) {
  return launch<false, 8>(idx, cols, nullptr, nullptr, blocks, x, y,
                          n_members, n_br, mb, nb, bs, n_bc, k, rows_per_cta,
                          stream);
}

// cell_valid (n_members, n_br): the real cells that lead each sorted row.
int bsr_spmv_sell(const int* cell_block, const int* cell_col,
                  const int* cell_ptr, const int* cell_valid,
                  const int* row_perm, const float* blocks, const float* x,
                  float* y, int n_members, int n_br, long long n_cells,
                  long long nb, int bs, int n_bc, int rows_per_cta,
                  cudaStream_t stream) {
  return launch_spmv_counted<true>(cell_block, cell_col, cell_ptr,
                                   cell_valid, row_perm, blocks, x, y,
                                   n_members, n_br, n_cells, nb, bs, n_bc,
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

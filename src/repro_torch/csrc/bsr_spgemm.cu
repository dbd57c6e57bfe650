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
//          (p < max_pairs; pad slots point at the all-zeros sentinel tiles)
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
// What the design does about it (both, one template: bsr_spgemm_kernel)
//   Only the index source differs. pairs: the real pairs lead each row of
//   pair_a / pair_b (the symbolic phase fills them from slot 0) and
//   pair_counts[m, k] says how many; every later slot is (A sentinel,
//   B sentinel), two all-zero tiles whose product is exactly 0 whatever
//   the operands hold. So the kernel stops at the count: the result is the
//   all-slot sum (up to the sign of an exact zero), and the sentinel slots
//   (5.5x the real pairs on gen_spatial(65536)^2, 3.8x on
//   gen_zipf(8192)^2) cost nothing. cells: block k's list is the cells
//   cell_ptr[m, k] .. cell_ptr[m, k+1] of the flat stream; bucket pad
//   cells pair the two sentinels and belong to no block, so skipping them
//   is exact too.
//   One CTA owns one (output block, T x T sub-tile, member): T = 32 with
//   one warp at bs <= 32 (4 x 8 sums per thread), T = 128 with 256 threads
//   when 128 divides bs, else T = 64 with 64 threads (8 x 8 sums each).
//   The block's pair indices are staged in shared memory in batches, then
//   its (pair, KC-deep k chunk) steps stream through a ring of S stages
//   filled by 16-byte cp.async copies, one barrier per step. At T = 32 a
//   C block averages 1.4 pairs (gen_spatial), so the first copy's latency
//   is hidden by other warps, not by the ring: KC = 16 and S = 2 keep a
//   one-warp CTA at 9.5 KB of shared memory and 96 registers, 20 CTAs per
//   SM. Above, KC = 32 and S = 3. A is kept row-major (pitch KC + 4
//   floats, so the 2-8 rows a warp reads at one k fall in distinct banks)
//   and read as scalars; B rows as 16-byte vectors. Sub-tiles past bs and
//   k past bs are zero-filled by the copy (0 * 0 adds nothing). The
//   products are CUDA-core fp32 FMAs: TF32 tensor cores would miss the
//   reference's 2e-4 tolerance. Every output element is written once,
//   blocks with no pairs too. All offsets are 64-bit: tile index * bs * bs
//   passes 2^31 at bs = 128 beyond 131,072 tiles, and member offsets
//   sooner.
//
// What the cells layout allows besides (bsr_spgemm_cells_run_kernel)
//   Consecutive output blocks are adjacent in the cell stream, as in the
//   TPU kernel's schedule (it flushes the C tile when cell_c advances). At
//   bs <= 32, where a block has so few cells that a one-warp CTA spends
//   most of its life waiting on its first copy, one CTA walks the cells of
//   kCellsRun = 6 consecutive blocks as one stream through one ring of
//   kCellsStages = 2 stages and stores each block's sums when the stream
//   passes the block's end (blocks with no cells write zeros). Six blocks
//   through two stages were the fastest of the run lengths and stage
//   counts timed (PERF.md): shorter runs leave the start-up of each CTA
//   exposed, runs of 8 and more lose what they gained.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  // full = false zero-fills the 16 bytes and reads nothing
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// T x T sub-tile, TM x TN sums per thread, S ring stages of KC-deep k.
template <int T, int TM, int TN, int S, int KC>
struct PairsTile {
  static constexpr int NTX = T / TN;               // threads along columns
  static constexpr int NTY = T / TM;               // threads along rows
  static constexpr int NT = NTX * NTY;
  static constexpr int A_PITCH = KC + 4;           // A stage [T][KC + 4]
  static constexpr int STAGE = T * A_PITCH + KC * T;       // + B [KC][T]
  static constexpr int SMEM = (int)(sizeof(float) * S * STAGE +
                                    sizeof(int) * 2 * NT);
  // k steps unrolled: at T = 128 the 64 sums must fit 128 registers
  static constexpr int UNROLL = T == 128 ? 1 : 4;
};

// Step j of a batch of np (A, B) tile pairs whose indices are staged in
// s_a / s_b: pair j / nk, k chunk j % nk, into ring stage j % S. Sub-tile
// rows past bs and k past bs are zero-filled (0 * 0 adds nothing).
template <int T, int TM, int TN, int S, int KC>
__device__ __forceinline__ void produce_step(
    float* smem, const int* s_a, const int* s_b, int j, int steps, int nk,
    const float* a_m, const float* b_m, long long tile, int bs, int i0,
    int j0, int tid) {
  using P = PairsTile<T, TM, TN, S, KC>;
  if (j < steps) {
    const int p = j / nk;
    const int k0 = (j - p * nk) * KC;
    float* as = smem + (j % S) * P::STAGE;
    float* bsm = as + T * P::A_PITCH;
    const float* ag = a_m + s_a[p] * tile;
    const float* bg = b_m + s_b[p] * tile;
    for (int e = tid; e < T * (KC / 4); e += P::NT) {
      const int i = e / (KC / 4);
      const int kk = (e % (KC / 4)) * 4;
      const bool ok = i0 + i < bs && k0 + kk < bs;
      cp_async16(as + i * P::A_PITCH + kk,
                 ok ? ag + (long long)(i0 + i) * bs + k0 + kk : ag, ok);
    }
    for (int e = tid; e < KC * (T / 4); e += P::NT) {
      const int kk = e / (T / 4);
      const int jj = (e % (T / 4)) * 4;
      const bool ok = k0 + kk < bs && j0 + jj < bs;
      cp_async16(bsm + kk * T + jj,
                 ok ? bg + (long long)(k0 + kk) * bs + j0 + jj : bg, ok);
    }
  }
  cp_async_commit();   // one group per call, empty or not
}

// acc += the KC-deep product held in ring stage `stage`.
template <int T, int TM, int TN, int S, int KC>
__device__ __forceinline__ void consume_step(const float* smem, int stage,
                                             int tx, int ty,
                                             float (&acc)[TM][TN]) {
  using P = PairsTile<T, TM, TN, S, KC>;
  const float* as = smem + stage * P::STAGE + ty * P::A_PITCH;
  const float* bsm = smem + stage * P::STAGE + T * P::A_PITCH + tx * 4;
#pragma unroll P::UNROLL
  for (int kk = 0; kk < KC; ++kk) {
    float ar[TM], br[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) ar[r] = as[r * P::NTY * P::A_PITCH + kk];
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(bsm + kk * T + h * 4 * P::NTX);
      br[4 * h] = v.x;
      br[4 * h + 1] = v.y;
      br[4 * h + 2] = v.z;
      br[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
  }
}

// Writes a thread's TM x TN sums into C tile c_t and zeroes them.
template <int T, int TM, int TN, int S, int KC>
__device__ __forceinline__ void store_tile(float* c_t, int bs, int i0,
                                           int j0, int tx, int ty,
                                           float (&acc)[TM][TN]) {
  using P = PairsTile<T, TM, TN, S, KC>;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + r * P::NTY;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int jc = j0 + tx * 4 + h * 4 * P::NTX;
      if (i < bs && jc < bs)   // bs % 4 == 0: the 4 columns are all in range
        *reinterpret_cast<float4*>(c_t + (long long)i * bs + jc) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;
  }
}

// One CTA per (output block, T x T sub-tile, member). kCells = false: the
// block's pairs are pair_a/pair_b row `row` (n_list wide), the first
// counts[row] of them; kCells = true: cells ptr[k] .. ptr[k+1] of member
// m's flat stream of n_list cells.
template <bool kCells, int T, int TM, int TN, int S, int KC, int kMinBlocks>
__global__ void __launch_bounds__((T / TM) * (T / TN), kMinBlocks)
bsr_spgemm_kernel(const int* __restrict__ list_a,   // (B, n_c, mp) | (B, n_cells)
                  const int* __restrict__ list_b,   // same shape
                  const int* __restrict__ count,    // (B, n_c) | ptr (B, n_c + 1)
                  const float* __restrict__ a,      // (B, n_a, bs, bs)
                  const float* __restrict__ b,      // (B, n_b, bs, bs)
                  float* __restrict__ c,            // (B, n_c, bs, bs)
                  long long n_c, long long n_list, long long n_a,
                  long long n_b, int bs, int n_sub) {
  using P = PairsTile<T, TM, TN, S, KC>;
  extern __shared__ __align__(16) float smem[];
  int* s_a = reinterpret_cast<int*>(smem + S * P::STAGE);
  int* s_b = s_a + P::NT;
  const long long m = blockIdx.z;
  const long long row = m * n_c + blockIdx.x;
  const int i0 = (blockIdx.y / n_sub) * T;
  const int j0 = (blockIdx.y % n_sub) * T;
  const int tid = threadIdx.x;
  const int tx = tid % P::NTX, ty = tid / P::NTX;
  const int* la;   // the block's (A, B) index lists
  const int* lb;
  int n;           // and their length
  if (kCells) {
    const int* ptr = count + m * (n_c + 1) + blockIdx.x;
    la = list_a + m * n_list + ptr[0];
    lb = list_b + m * n_list + ptr[0];
    n = max(ptr[1] - ptr[0], 0);
  } else {
    la = list_a + row * n_list;
    lb = list_b + row * n_list;
    n = (int)min(max((long long)count[row], 0LL), n_list);
  }
  const int nk = (bs + KC - 1) / KC;
  const long long tile = (long long)bs * bs;
  const float* a_m = a + m * n_a * tile;
  const float* b_m = b + m * n_b * tile;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (int p0 = 0; p0 < n; p0 += P::NT) {
    const int np = min(P::NT, n - p0);
    __syncthreads();   // the last batch is summed and its indices unread
    if (tid < np) {
      s_a[tid] = la[p0 + tid];
      s_b[tid] = lb[p0 + tid];
    }
    __syncthreads();
    const int steps = np * nk;
#pragma unroll
    for (int j = 0; j < S - 1; ++j)
      produce_step<T, TM, TN, S, KC>(smem, s_a, s_b, j, steps, nk, a_m, b_m,
                                     tile, bs, i0, j0, tid);
    for (int j = 0; j < steps; ++j) {
      cp_async_wait<S - 2>();
      __syncthreads();   // step j landed; every thread is done with j - 1
      produce_step<T, TM, TN, S, KC>(smem, s_a, s_b, j + S - 1, steps, nk,
                                     a_m, b_m, tile, bs, i0, j0, tid);
      consume_step<T, TM, TN, S, KC>(smem, j % S, tx, ty, acc);
    }
  }
  cp_async_wait<0>();
  store_tile<T, TM, TN, S, KC>(c + row * tile, bs, i0, j0, tx, ty, acc);
}

// One CTA per run of G consecutive output blocks of member m (bs <= T,
// one sub-tile per block): it walks the run's cells ptr[k_lo] ..
// ptr[k_hi] as one stream through one ring, and stores each block's sums
// when the stream passes the block's end (blocks with no cells too).
template <int G, int T, int TM, int TN, int S, int KC, int kMinBlocks>
__global__ void __launch_bounds__((T / TM) * (T / TN), kMinBlocks)
bsr_spgemm_cells_run_kernel(const int* __restrict__ list_a,  // (B, n_cells)
                            const int* __restrict__ list_b,  // same shape
                            const int* __restrict__ cell_ptr,  // (B, n_c + 1)
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ c,
                            long long n_c, long long n_list, long long n_a,
                            long long n_b, int bs) {
  using P = PairsTile<T, TM, TN, S, KC>;
  extern __shared__ __align__(16) float smem[];
  int* s_a = reinterpret_cast<int*>(smem + S * P::STAGE);
  int* s_b = s_a + P::NT;
  static_assert(G + 1 <= P::NT, "one thread stages each pointer entry");
  __shared__ int s_ptr[G + 1];
  const long long m = blockIdx.z;
  const long long k_lo = (long long)blockIdx.x * G;
  const int nblk = (int)min((long long)G, n_c - k_lo);
  const int tid = threadIdx.x;
  const int tx = tid % P::NTX, ty = tid / P::NTX;
  const int* ptr = cell_ptr + m * (n_c + 1) + k_lo;
  if (tid <= nblk) s_ptr[tid] = ptr[tid];
  __syncthreads();
  const int* la = list_a + m * n_list + s_ptr[0];
  const int* lb = list_b + m * n_list + s_ptr[0];
  const int n = max(s_ptr[nblk] - s_ptr[0], 0);
  const int nk = (bs + KC - 1) / KC;
  const long long tile = (long long)bs * bs;
  const float* a_m = a + m * n_a * tile;
  const float* b_m = b + m * n_b * tile;
  float* c_m = c + (m * n_c + k_lo) * tile;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  int blk = 0;   // the block the next cell adds to
  for (int p0 = 0; p0 < n; p0 += P::NT) {
    const int np = min(P::NT, n - p0);
    __syncthreads();   // the last batch is summed and its indices unread
    if (tid < np) {
      s_a[tid] = la[p0 + tid];
      s_b[tid] = lb[p0 + tid];
    }
    __syncthreads();
    const int steps = np * nk;
#pragma unroll
    for (int j = 0; j < S - 1; ++j)
      produce_step<T, TM, TN, S, KC>(smem, s_a, s_b, j, steps, nk, a_m, b_m,
                                     tile, bs, 0, 0, tid);
    for (int j = 0; j < steps; ++j) {
      cp_async_wait<S - 2>();
      __syncthreads();   // step j landed; every thread is done with j - 1
      produce_step<T, TM, TN, S, KC>(smem, s_a, s_b, j + S - 1, steps, nk,
                                     a_m, b_m, tile, bs, 0, 0, tid);
      if (j % nk == 0) {   // a new cell: flush the blocks it has passed
        const int t = s_ptr[0] + p0 + j / nk;
        while (t >= s_ptr[blk + 1]) {
          store_tile<T, TM, TN, S, KC>(c_m + blk * tile, bs, 0, 0, tx, ty,
                                       acc);
          ++blk;
        }
      }
      consume_step<T, TM, TN, S, KC>(smem, j % S, tx, ty, acc);
    }
  }
  cp_async_wait<0>();
  for (; blk < nblk; ++blk)
    store_tile<T, TM, TN, S, KC>(c_m + blk * tile, bs, 0, 0, tx, ty, acc);
}

template <bool kCells, int T, int TM, int TN, int S, int KC, int kMinBlocks>
int launch_tiles(const int* list_a, const int* list_b, const int* count,
                 const float* a, const float* b, float* c, int n_members,
                 long long n_c, long long n_list, long long n_a,
                 long long n_b, int bs, cudaStream_t stream) {
  using P = PairsTile<T, TM, TN, S, KC>;
  auto kernel = bsr_spgemm_kernel<kCells, T, TM, TN, S, KC, kMinBlocks>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_sub = (bs + T - 1) / T;
  const dim3 grid((unsigned)n_c, n_sub * n_sub, n_members);
  kernel<<<grid, P::NT, P::SMEM, stream>>>(list_a, list_b, count, a, b, c,
                                           n_c, n_list, n_a, n_b, bs, n_sub);
  return (int)cudaGetLastError();
}

// The cells run kernel's run length and ring depth (bs <= 32).
constexpr int kCellsRun = 6;
constexpr int kCellsStages = 2;

int launch_cells_run(const int* cell_a, const int* cell_b,
                     const int* cell_ptr, const float* a, const float* b,
                     float* c, int n_members, long long n_c, long long n_list,
                     long long n_a, long long n_b, int bs,
                     cudaStream_t stream) {
  using P = PairsTile<32, 4, 8, kCellsStages, 16>;
  auto kernel =
      bsr_spgemm_cells_run_kernel<kCellsRun, 32, 4, 8, kCellsStages, 16, 20>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_c + kCellsRun - 1) / kCellsRun), 1,
                  n_members);
  kernel<<<grid, P::NT, P::SMEM, stream>>>(cell_a, cell_b, cell_ptr, a, b,
                                           c, n_c, n_list, n_a, n_b, bs);
  return (int)cudaGetLastError();
}

template <bool kCells>
int launch_spgemm(const int* list_a, const int* list_b, const int* count,
                  const float* a, const float* b, float* c, int n_members,
                  long long n_c, long long n_list, long long n_a,
                  long long n_b, int bs, cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_c <= 0 || n_c > 2147483647LL ||
      n_list < 0 || n_members <= 0 || n_members > 65535 || count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bs <= 32) {
    if constexpr (kCells)
      return launch_cells_run(list_a, list_b, count, a, b, c, n_members, n_c,
                              n_list, n_a, n_b, bs, stream);
    else
      return launch_tiles<false, 32, 4, 8, 2, 16, 20>(
          list_a, list_b, count, a, b, c, n_members, n_c, n_list, n_a, n_b,
          bs, stream);
  }
  if (bs % 128 == 0)
    return launch_tiles<kCells, 128, 8, 8, 3, 32, 2>(
        list_a, list_b, count, a, b, c, n_members, n_c, n_list, n_a, n_b, bs,
        stream);
  return launch_tiles<kCells, 64, 8, 8, 3, 32, 1>(
      list_a, list_b, count, a, b, c, n_members, n_c, n_list, n_a, n_b, bs,
      stream);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// pair_counts (n_members, n_c): the real pairs that lead each row of
// pair_a / pair_b; the kernel sums those pairs only.
int bsr_spgemm_pairs(const int* pair_a, const int* pair_b,
                     const int* pair_counts, const float* a, const float* b,
                     float* c, int n_members, long long n_c,
                     long long max_pairs, long long n_a, long long n_b,
                     int bs, cudaStream_t stream) {
  return launch_spgemm<false>(pair_a, pair_b, pair_counts, a, b, c,
                              n_members, n_c, max_pairs, n_a, n_b, bs,
                              stream);
}

// cell_ptr (n_members, n_c + 1): output block k of member m sums cells
// cell_ptr[m, k] .. cell_ptr[m, k+1] of that member's n_cells.
int bsr_spgemm_cells(const int* cell_a, const int* cell_b,
                     const int* cell_ptr, const float* a, const float* b,
                     float* c, int n_members, long long n_c,
                     long long n_cells, long long n_a, long long n_b, int bs,
                     cudaStream_t stream) {
  return launch_spgemm<true>(cell_a, cell_b, cell_ptr, a, b, c, n_members,
                             n_c, n_cells, n_a, n_b, bs, stream);
}

}  // extern "C"

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
// What the pairs design does about it (bsr_spgemm_pairs)
//   The real pairs lead each row of pair_a / pair_b (the symbolic phase
//   fills them from slot 0) and pair_counts[m, k] says how many; every
//   later slot is (A sentinel, B sentinel), two all-zero tiles whose
//   product is exactly 0 whatever the operands hold. So the kernel stops
//   at the count: the result is the all-slot sum (up to the sign of an
//   exact zero), and the sentinel slots (5.5x the real pairs on
//   gen_spatial(65536)^2, 3.8x on gen_zipf(8192)^2) cost nothing.
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
//   blocks with no pairs too. All offsets are 64-bit.
//
// What the cells design does about it (bsr_spgemm_cells)
//   The TPU kernel keeps the C tile resident in VMEM across the sequential
//   pair axis. GPU blocks run in no order, so one CTA owns one (output
//   block, T x T output sub-tile, member) and loops over that block's cell
//   range itself, keeping the sub-tile's sums in registers (4 x 4 per
//   thread). No atomics, no second pass: the result is deterministic. At
//   bs = 256 a C tile is 256 KB, above one SM's registers and its 227 KB
//   of shared memory, so the tile is split into T = 64 sub-tiles (T = 32
//   for bs <= 32); the A row-strip and the B column-strip stream through
//   shared memory in 32-deep k-chunks (17 KB at T = 64), A stored
//   transposed so both operands are read as 16-byte vectors. Partial
//   sub-tiles (bs = 96) and short k-chunks (bs = 8, 16) are zero-filled.
//   Every output element is written once, including blocks that own no
//   cells. All offsets are 64-bit: tile index * bs * bs passes 2^31 at
//   bs = 128 beyond 131,072 tiles, and member offsets sooner.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;   // k-depth staged per step
constexpr int kPad = 4;      // keeps 16-byte rows, spreads banks

template <int T>
__global__ void __launch_bounds__((T / 4) * (T / 4))
bsr_spgemm_cells_kernel(const int* __restrict__ list_a,    // (B, n_cells)
                        const int* __restrict__ list_b,    // same shape
                        const int* __restrict__ cell_ptr,  // (B, n_c + 1)
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

  const int* ptr = cell_ptr + m * (n_c + 1);
  const long long lo = ptr[k_out];
  const long long hi = ptr[k_out + 1];
  const long long base = m * n_list;

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

int launch_cells(const int* list_a, const int* list_b, const int* cell_ptr,
                 const float* a, const float* b, float* c, int n_members,
                 long long n_c, long long n_list, long long n_a,
                 long long n_b, int bs, cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_c <= 0 || n_c > 2147483647LL ||
      n_list < 0 || n_members <= 0 || n_members > 65535 ||
      cell_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bs <= 32) {
    const dim3 grid((unsigned)n_c, 1, n_members);
    bsr_spgemm_cells_kernel<32><<<grid, 64, 0, stream>>>(
        list_a, list_b, cell_ptr, a, b, c, n_c, n_list, n_a, n_b, bs, 1);
  } else {
    const int n_sub = (bs + 63) / 64;
    const dim3 grid((unsigned)n_c, n_sub * n_sub, n_members);
    bsr_spgemm_cells_kernel<64><<<grid, 256, 0, stream>>>(
        list_a, list_b, cell_ptr, a, b, c, n_c, n_list, n_a, n_b, bs, n_sub);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ pairs

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

template <int T, int TM, int TN, int S, int KC, int kMinBlocks>
__global__ void __launch_bounds__((T / TM) * (T / TN), kMinBlocks)
bsr_spgemm_pairs_kernel(const int* __restrict__ pair_a,   // (B, n_c, mp)
                        const int* __restrict__ pair_b,   // (B, n_c, mp)
                        const int* __restrict__ counts,   // (B, n_c)
                        const float* __restrict__ a,      // (B, n_a, bs, bs)
                        const float* __restrict__ b,      // (B, n_b, bs, bs)
                        float* __restrict__ c,            // (B, n_c, bs, bs)
                        long long n_c, long long mp, long long n_a,
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
  const long long n =
      min(max((long long)counts[row], 0LL), mp);   // the real pairs
  const int nk = (bs + KC - 1) / KC;
  const long long tile = (long long)bs * bs;
  const float* a_m = a + m * n_a * tile;
  const float* b_m = b + m * n_b * tile;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  for (long long p0 = 0; p0 < n; p0 += P::NT) {
    const int np = (int)min((long long)P::NT, n - p0);
    __syncthreads();   // the last batch is summed and its indices unread
    if (tid < np) {
      s_a[tid] = pair_a[row * mp + p0 + tid];
      s_b[tid] = pair_b[row * mp + p0 + tid];
    }
    __syncthreads();
    const int steps = np * nk;
    auto produce = [&](int j) {   // step j = (pair j / nk, k chunk j % nk)
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
    };
#pragma unroll
    for (int j = 0; j < S - 1; ++j) produce(j);
    for (int j = 0; j < steps; ++j) {
      cp_async_wait<S - 2>();
      __syncthreads();   // step j landed; every thread is done with j - 1
      produce(j + S - 1);
      const float* as = smem + (j % S) * P::STAGE + ty * P::A_PITCH;
      const float* bsm = smem + (j % S) * P::STAGE + T * P::A_PITCH + tx * 4;
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
          for (int q = 0; q < TN; ++q)
            acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
      }
    }
  }
  cp_async_wait<0>();

  float* c_t = c + row * tile;
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
  }
}

template <int T, int TM, int TN, int S, int KC, int kMinBlocks>
int launch_pairs(const int* pair_a, const int* pair_b, const int* counts,
                 const float* a, const float* b, float* c, int n_members,
                 long long n_c, long long mp, long long n_a, long long n_b,
                 int bs, cudaStream_t stream) {
  using P = PairsTile<T, TM, TN, S, KC>;
  auto kernel = bsr_spgemm_pairs_kernel<T, TM, TN, S, KC, kMinBlocks>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_sub = (bs + T - 1) / T;
  const dim3 grid((unsigned)n_c, n_sub * n_sub, n_members);
  kernel<<<grid, P::NT, P::SMEM, stream>>>(pair_a, pair_b, counts, a, b, c,
                                           n_c, mp, n_a, n_b, bs, n_sub);
  return (int)cudaGetLastError();
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
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_c <= 0 || n_c > 2147483647LL ||
      max_pairs < 0 || n_members <= 0 || n_members > 65535 ||
      pair_counts == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bs <= 32)
    return launch_pairs<32, 4, 8, 2, 16, 20>(
        pair_a, pair_b, pair_counts, a, b, c, n_members, n_c, max_pairs,
        n_a, n_b, bs, stream);
  if (bs % 128 == 0)
    return launch_pairs<128, 8, 8, 3, 32, 2>(
        pair_a, pair_b, pair_counts, a, b, c, n_members, n_c, max_pairs,
        n_a, n_b, bs, stream);
  return launch_pairs<64, 8, 8, 3, 32, 1>(
      pair_a, pair_b, pair_counts, a, b, c, n_members, n_c, max_pairs, n_a,
      n_b, bs, stream);
}

// n_list is n_cells; cell_ptr (n_members, n_c + 1) is the cell pointer.
int bsr_spgemm_cells(const int* cell_a, const int* cell_b,
                     const int* cell_ptr, const float* a, const float* b,
                     float* c, int n_members, long long n_c,
                     long long n_cells, long long n_a, long long n_b, int bs,
                     cudaStream_t stream) {
  return launch_cells(cell_a, cell_b, cell_ptr, a, b, c, n_members, n_c,
                      n_cells, n_a, n_b, bs, stream);
}

}  // extern "C"

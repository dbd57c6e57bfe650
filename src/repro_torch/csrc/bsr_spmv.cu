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
//   (n_bc, bs) for SpMV and (n_bc, bs, k) for SpMM, k a multiple of 8, per
//   member x_stride floats apart (0: one x that every member reads, the
//   row shards of one matrix). The
//   host builds cell_ptr so that a member's last sorted row owns one of
//   the bucket-pad cells (zero block, column 0) appended to its stream:
//   the TPU kernel adds every one of them to that row, and they are all
//   the same product.
//
// What bounds it on this card
//   Bytes. Every stored tile is read once per RHS tile and used for
//   bs*bs*KT multiply-adds, KT = 1 (SpMV) or 8 (SpMM): at most 2 FLOP per
//   4-byte element for SpMV and 16 for SpMM, below the H100's ~20
//   FLOP/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s). The least time is
//   (blocks.nbytes + indices + x + y) / 3.35 TB/s.
//
// What the design does about it (all four kernels)
//   Two kernels, one per width, share one slot loop (stream_slots) and
//   both layouts: only where a row's slots come from differs (ELL: row r
//   of the slot table; SELL: the cells cell_ptr assigns to sorted row r,
//   the result stored to row_perm[r], so the scatter the JAX path does
//   afterwards is fused). One CTA owns one (row, strip of tile rows, RHS
//   tile, member). The row's real slots lead it and a count (valid_counts
//   for ELL, cell_valid for SELL) says how many; the slots after them hold
//   the all-zeros block and column 0 (ELL pad slots, SELL slice-width and
//   bucket-pad cells). The TPU kernel multiplies every slot, so a pad slot
//   adds 0 * x_blocks[0]: +0 for a finite x, NaN where x_blocks[0] holds an
//   Inf or a NaN. The kernels sum the real slots and then exactly one pad
//   slot, the one right after them, when the row has one: every pad slot
//   of a row is the same product, so this is the all-slot sum (up to the
//   sign of an exact zero) while the dead tiles are never read. Rows that
//   own no slot (SELL bucket-pad rows) write zeros.
//   The row's slot indices are staged in shared memory in batches of 256
//   before its slot loop, so no tile address waits on an index load. The
//   strips (contiguous in the tile, at most kStrip floats) and their x
//   segments stream through a kStages-deep ring of shared memory filled by
//   16-byte cp.async copies, one barrier per slot: three slots are in
//   flight while one is summed. Sums are CUDA-core fp32 FMAs (TF32 misses
//   the reference's tolerances), kept in registers; no atomics, so every
//   result is deterministic. All element offsets are 64-bit.
//   SpMV: g lanes (a power of two up to 32) share each output row and are
//   reduced with warp shuffles once, after the last slot.
//   SpMM: each thread keeps R rows x 8 columns of sums (R up to 8) over
//   one P-th of the tile's columns (P the largest power of two up to bs,
//   or up to bs / 2 at bs <= 32):
//   per column c it reads 8 x values (two 16-byte loads, reused over its R
//   rows) and R strip values, for 8R FMAs. The lanes of a warp read
//   consecutive columns, so the strip loads are conflict-free, and x is
//   stored with its two 16-byte halves swapped on every other group of 4
//   columns, so the x loads are too. After the last slot the P lanes of
//   an output are reduced once: a reduce-scatter over the warp's lanes
//   (each shuffle level halves the values a lane holds), then, when P >
//   32, a sum over the warps through shared memory. The kernel is bound
//   by how many loads are in flight more than by its FMAs or shared-memory
//   loads, so the registers a thread may use are capped to fit more CTAs
//   on an SM (spmm_min_blocks). At k = 8, gen_spatial bs = 32 runs whole
//   tiles with P = 16 and R = 2 (48 registers, 5 CTAs an SM); gen_zipf
//   bs = 128 runs 16-row strips (the wrapper splits its 64 block-rows over
//   8 CTAs) with P = 128 and R = 8 (119 registers, 2 CTAs an SM). Wider k
//   puts further RHS tiles on blockIdx.y.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;       // ring depth
constexpr int kStrip = 2048;     // floats of one stage's A strip, at most
constexpr int kSpmvRows = 4;     // SpMV: output rows per thread, at most
constexpr int kRhs = 8;          // SpMM: RHS columns per CTA
constexpr int kSpmmRows = 8;     // SpMM: output rows per thread, at most

// SpMM: the CTAs of R rows per thread an SM must hold, at least (the
// registers each thread may use follow: 48, 64, and 119 at R = 8, which
// needs no cap)
constexpr int spmm_min_blocks(int R) { return R <= 2 ? 5 : R <= 4 ? 4 : 1; }

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

// The slots CTA row r of member b sums: its first slot and how many.
struct Slots {
  long long first;
  int n;
};

// ELL: row r of member b, n_slots wide. SELL: cells cell_ptr[b, r] ..
// cell_ptr[b, r+1] of member b's stream of n_slots cells. The real slots
// (valid[b, r]) and one pad slot when the row has one.
template <bool kSell>
__device__ __forceinline__ Slots row_slots(const int* __restrict__ cell_ptr,
                                           const int* __restrict__ valid,
                                           int n_br, long long n_slots,
                                           long long b, int r) {
  const long long row = b * n_br + r;
  long long first;
  int len;
  if (kSell) {
    const int* ptr = cell_ptr + b * (n_br + 1) + r;
    first = b * n_slots + ptr[0];
    len = max(ptr[1] - ptr[0], 0);
  } else {
    first = row * n_slots;
    len = (int)n_slots;
  }
  const int n_real = min(max(valid[row], 0), len);
  return {first, n_real < len ? n_real + 1 : len};
}

// The slot loop both kernels share. Stages the slots' (block, column)
// indices in s_blk / s_col, kThreads at a time, and streams the slots
// through a kStages-deep ring of `stage` floats each: fill(stage, block,
// column) issues one slot's cp.async copies, sum(stage) adds a landed slot
// into the thread's registers. One barrier per slot.
template <class Fill, class Sum>
__device__ __forceinline__ void stream_slots(
    const int* __restrict__ slot_block, const int* __restrict__ slot_col,
    Slots s, float* ring, int stage, int* s_blk, int* s_col, Fill fill,
    Sum sum) {
  const int t = threadIdx.x;
  for (int s0 = 0; s0 < s.n; s0 += kThreads) {
    const int nn = min(kThreads, s.n - s0);
    __syncthreads();   // the last batch is summed and its indices unread
    if (t < nn) {
      s_blk[t] = slot_block[s.first + s0 + t];
      s_col[t] = slot_col[s.first + s0 + t];
    }
    __syncthreads();
    auto produce = [&](int j) {   // slot s0 + j into stage j % kStages
      if (j < nn) fill(ring + (j % kStages) * stage, s_blk[j], s_col[j]);
      cp_async_commit();   // one group per call, empty or not
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) produce(j);
    for (int j = 0; j < nn; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // slot j landed; every thread is done with j - 1
      produce(j + kStages - 1);
      sum(ring + (j % kStages) * stage);
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ ELL and SELL SpMV

// CTA (r, strip, b) computes y[b, out_r, i0 : i0 + rb], i0 = strip * rows;
// out_r = r (ELL) or row_perm[b, r] (SELL). Shared memory: kStages stages
// of [rows x bs strip | bs x segment], then one batch of kThreads slot
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
                        long long x_stride, int rows, int g) {
  extern __shared__ __align__(16) float smem[];
  const int stage = rows * bs + bs;
  int* s_blk = reinterpret_cast<int*>(smem + kStages * stage);
  int* s_col = s_blk + kThreads;
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * rows;
  const int rb = min(rows, bs - i0);
  const long long b = blockIdx.z;
  const long long row = b * n_br + blockIdx.x;
  const Slots s = row_slots<kSell>(cell_ptr, valid, n_br, n_slots, b,
                                   blockIdx.x);
  const int q = bs / 4;                          // 16-byte vectors per row
  const int n_vec = rb * q;
  const long long tile = (long long)bs * bs;
  const float* a_b = blocks + b * nb * tile + (long long)i0 * bs;
  const float* x_b = x + b * x_stride;
  const int lane_s = t % g, o_base = t / g, workers = kThreads / g;

  float acc[kSpmvRows];
#pragma unroll
  for (int u = 0; u < kSpmvRows; ++u) acc[u] = 0.f;

  auto fill = [&](float* as, int blk, int col) {
    const float* ag = a_b + blk * tile;
    for (int e = t; e < n_vec; e += kThreads)
      cp_async16(as + 4 * e, ag + 4 * e);
    if (t < q)
      cp_async16(as + rows * bs + 4 * t, x_b + (long long)col * bs + 4 * t);
  };
  auto sum = [&](const float* as) {
    const float* xs = as + rows * bs;
#pragma unroll
    for (int u = 0; u < kSpmvRows; ++u) {
      const int o = o_base + u * workers;
      if (o < rb) {
        const float* ar = as + o * bs;
        float v = acc[u];
        for (int c4 = lane_s; c4 < q; c4 += g) {
          const float4 av = *reinterpret_cast<const float4*>(ar + 4 * c4);
          const float4 xv = *reinterpret_cast<const float4*>(xs + 4 * c4);
          v = fmaf(av.x, xv.x, v);
          v = fmaf(av.y, xv.y, v);
          v = fmaf(av.z, xv.z, v);
          v = fmaf(av.w, xv.w, v);
        }
        acc[u] = v;
      }
    }
  };
  stream_slots(slot_block, slot_col, s, smem, stage, s_blk, s_col, fill,
               sum);

  const long long out_r = kSell ? b * n_br + row_perm[row] : row;
  float* y_r = y + out_r * bs + i0;
#pragma unroll
  for (int u = 0; u < kSpmvRows; ++u) {
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
                        long long n_slots, long long nb, int bs,
                        long long x_stride, int rows_per_cta,
                        cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_br <= 0 || n_slots < 0 ||
      (!kSell && n_slots > 2147483647LL) || n_members <= 0 ||
      n_members > 65535 || rows_per_cta <= 0 || rows_per_cta > bs ||
      valid == nullptr || (kSell && (cell_ptr == nullptr ||
                                     row_perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  // g: the power of two up to 32 that a row's bs / 4 vectors fill; a
  // strip holds at most kStrip floats and kSpmvRows rows per thread
  int g = 1;
  while (g < 32 && 2 * g <= bs / 4) g *= 2;
  int rows = min(rows_per_cta, max(1, kStrip / bs));
  rows = min(rows, kSpmvRows * (kThreads / g));
  const int n_split = (bs + rows - 1) / rows;
  const dim3 grid(n_br, n_split, n_members);
  const int shmem = (int)(sizeof(float) * kStages * (rows * bs + bs) +
                          sizeof(int) * 2 * kThreads);
  auto kernel = bsr_spmv_counted_kernel<kSell>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, shmem, stream>>>(
      slot_block, slot_col, cell_ptr, valid, row_perm, blocks, x, y, n_br,
      n_slots, nb, bs, x_stride, rows, g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ ELL and SELL SpMM

// Sums v over the `width` lanes (a power of two up to 32) of each aligned
// lane group, as a reduce-scatter: level L (lanes 2^L apart) halves the
// values a lane holds, the lane whose bit L is set keeping the upper half;
// once a lane holds one value, the levels left add it over the lanes.
template <int N, int L = 0>
__device__ __forceinline__ void reduce_lanes(float (&v)[N], int lane,
                                             int width) {
  if constexpr (L < 5) {
    constexpr int o = 1 << L;
    constexpr int n = (N >> L) > 1 ? (N >> L) : 1;
    if (o < width) {
      if constexpr (n >= 2) {
        constexpr int h = n / 2;
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const float send = up ? v[i] : v[i + h];
          const float keep = up ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      }
      reduce_lanes<N, L + 1>(v, lane, width);
    }
  }
}

// CTA (r, strip x RHS tile, b) computes y[b, out_r, i0 : i0 + rb, k0 : k0
// + 8]. Thread t = q * P + p sums rows q * R .. q * R + R - 1 of the strip
// over columns p, p + P, ... of the tile. Shared memory: kStages stages of
// [Q * R rows x bs strip (rows past rb unused) | bs x 8 segment, halves
// swizzled], then one batch of kThreads slot indices.
template <bool kSell, int R>
__global__ void __launch_bounds__(kThreads, spmm_min_blocks(R))
bsr_spmm_counted_kernel(const int* __restrict__ slot_block,  // ELL (B,n_br,mb) | SELL (B,n_cells)
                        const int* __restrict__ slot_col,    // same shape
                        const int* __restrict__ cell_ptr,    // SELL (B, n_br+1)
                        const int* __restrict__ valid,       // (B, n_br)
                        const int* __restrict__ row_perm,    // SELL (B, n_br)
                        const float* __restrict__ blocks,    // (B, nb, bs, bs)
                        const float* __restrict__ x,         // (B, n_bc, bs, k)
                        float* __restrict__ y,               // (B, n_br, bs, k)
                        int n_br, long long n_slots, long long nb, int bs,
                        long long x_stride, int k, int rows, int P) {
  constexpr int N = R * kRhs;   // sums per thread
  extern __shared__ __align__(16) float smem[];
  const int Q = kThreads / P;
  const int a_floats = Q * R * bs;
  const int stage = a_floats + kRhs * bs;
  int* s_blk = reinterpret_cast<int*>(smem + kStages * stage);
  int* s_col = s_blk + kThreads;
  const int t = threadIdx.x;
  const int p = t % P, q = t / P;
  const int n_kt = k / kRhs;
  const int k0 = (blockIdx.y % n_kt) * kRhs;
  const int i0 = (blockIdx.y / n_kt) * rows;
  const int rb = min(rows, bs - i0);
  const long long b = blockIdx.z;
  const long long row = b * n_br + blockIdx.x;
  const Slots s = row_slots<kSell>(cell_ptr, valid, n_br, n_slots, b,
                                   blockIdx.x);
  const int n_vec = rb * (bs / 4);
  const long long tile = (long long)bs * bs;
  const float* a_b = blocks + b * nb * tile + (long long)i0 * bs;
  const float* x_b = x + b * x_stride + k0;

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;

  auto fill = [&](float* st, int blk, int col) {
    const float* ag = a_b + blk * tile;
    for (int e = t; e < n_vec; e += kThreads)
      cp_async16(st + 4 * e, ag + 4 * e);
    const float* xg = x_b + (long long)col * bs * k;
    float* xs = st + a_floats;
    for (int e = t; e < 2 * bs; e += kThreads) {   // (column, half)
      const int c = e >> 1, h = e & 1;
      cp_async16(xs + 8 * c + 4 * (h ^ ((c >> 2) & 1)),
                 xg + (long long)c * k + 4 * h);
    }
  };
  auto sum = [&](const float* st) {
    const float* as = st + q * R * bs;
    const float* xs = st + a_floats;
    for (int c = p; c < bs; c += P) {
      const int sw = 4 * ((c >> 2) & 1);
      const float4 xl = *reinterpret_cast<const float4*>(xs + 8 * c + sw);
      const float4 xh =
          *reinterpret_cast<const float4*>(xs + 8 * c + (4 - sw));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = as[r * bs + c];
        float* o = acc + r * kRhs;
        o[0] = fmaf(a, xl.x, o[0]);
        o[1] = fmaf(a, xl.y, o[1]);
        o[2] = fmaf(a, xl.z, o[2]);
        o[3] = fmaf(a, xl.w, o[3]);
        o[4] = fmaf(a, xh.x, o[4]);
        o[5] = fmaf(a, xh.y, o[5]);
        o[6] = fmaf(a, xh.z, o[6]);
        o[7] = fmaf(a, xh.w, o[7]);
      }
    }
  };
  stream_slots(slot_block, slot_col, s, smem, stage, s_blk, s_col, fill,
               sum);

  // Reduce the P lanes of each output: over the warp's lanes first. The
  // lane then holds n sums, of outputs base .. base + n - 1 (r * 8 + kk);
  // lanes that differ only in the bits of `dup` hold the same ones.
  const int width = min(P, 32);
  reduce_lanes(acc, p, width);
  int n = N, base = 0, dup = 0;
  for (int o = 1; o < width; o *= 2) {
    if (n >= 2) {
      n /= 2;
      if (p & o) base += n;
    } else {
      dup |= o;
    }
  }
  const long long out_r = kSell ? b * n_br + row_perm[row] : row;
  float* y_r = y + out_r * bs * k + k0;
  if (P <= 32) {
    if ((p & dup) == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int e = base + j, o = q * R + e / kRhs;
        if (j < n && o < rb) y_r[(long long)(i0 + o) * k + e % kRhs] = acc[j];
      }
    }
    return;
  }
  // then over the P / 32 warps of each row group, through shared memory
  const int warps = P / 32;
  float* red = smem;                      // [Q][warps][N]; the ring is free
  __syncthreads();
  if ((p & dup) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) red[(q * warps + p / 32) * N + base + j] = acc[j];
  }
  __syncthreads();
  for (int e = t; e < Q * N; e += kThreads) {
    const int qq = e / N, i = e % N, o = qq * R + i / kRhs;
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += red[(qq * warps + w) * N + i];
    if (o < rb) y_r[(long long)(i0 + o) * k + i % kRhs] = v;
  }
}

template <bool kSell>
int launch_spmm_counted(const int* slot_block, const int* slot_col,
                        const int* cell_ptr, const int* valid,
                        const int* row_perm, const float* blocks,
                        const float* x, float* y, int n_members, int n_br,
                        long long n_slots, long long nb, int bs,
                        long long x_stride, int k, int rows_per_cta,
                        cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || k <= 0 || k % kRhs != 0 ||
      n_br <= 0 || n_slots < 0 || (!kSell && n_slots > 2147483647LL) ||
      n_members <= 0 || n_members > 65535 || rows_per_cta <= 0 ||
      rows_per_cta > bs || valid == nullptr ||
      (kSell && (cell_ptr == nullptr || row_perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  // P: the largest power of two up to bs (bs / 2 for tiles of 32 columns
  // or fewer, so each thread holds fewer rows and more CTAs fit) splits the
  // tile's columns; Q = kThreads / P row groups of R rows cover the strip
  const int max_p = bs <= 32 ? bs / 2 : bs;
  int P = 1;
  while (2 * P <= max_p && 2 * P <= kThreads) P *= 2;
  const int Q = kThreads / P;
  int rows = min(rows_per_cta, max(1, kStrip / bs));
  rows = min(rows, Q * kSpmmRows);
  const int need = (rows + Q - 1) / Q;
  const int R = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int n_split = (bs + rows - 1) / rows;
  if ((long long)(k / kRhs) * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_br, (k / kRhs) * n_split, n_members);
  const int shmem =
      (int)(sizeof(float) * kStages * (Q * R * bs + kRhs * bs) +
            sizeof(int) * 2 * kThreads);
  auto kernel = R == 1   ? bsr_spmm_counted_kernel<kSell, 1>
                : R == 2 ? bsr_spmm_counted_kernel<kSell, 2>
                : R == 4 ? bsr_spmm_counted_kernel<kSell, 4>
                         : bsr_spmm_counted_kernel<kSell, 8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, shmem, stream>>>(
      slot_block, slot_col, cell_ptr, valid, row_perm, blocks, x, y, n_br,
      n_slots, nb, bs, x_stride, k, rows, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// valid_counts (n_members, n_br): the real slots that lead each ELL row
// (the container's valid_counts). x_stride: the floats between two
// members' x (0: all members read one x).
int bsr_spmv_ell(const int* idx, const int* cols, const int* valid_counts,
                 const float* blocks, const float* x, float* y,
                 int n_members, int n_br, int mb, long long nb, int bs,
                 long long x_stride, int rows_per_cta, cudaStream_t stream) {
  return launch_spmv_counted<false>(idx, cols, nullptr, valid_counts,
                                    nullptr, blocks, x, y, n_members, n_br,
                                    mb, nb, bs, x_stride, rows_per_cta,
                                    stream);
}

int bsr_spmm_ell(const int* idx, const int* cols, const int* valid_counts,
                 const float* blocks, const float* x, float* y,
                 int n_members, int n_br, int mb, long long nb, int bs,
                 long long x_stride, int k, int rows_per_cta,
                 cudaStream_t stream) {
  return launch_spmm_counted<false>(idx, cols, nullptr, valid_counts,
                                    nullptr, blocks, x, y, n_members, n_br,
                                    mb, nb, bs, x_stride, k, rows_per_cta,
                                    stream);
}

// cell_valid (n_members, n_br): the real cells that lead each sorted row.
int bsr_spmv_sell(const int* cell_block, const int* cell_col,
                  const int* cell_ptr, const int* cell_valid,
                  const int* row_perm, const float* blocks, const float* x,
                  float* y, int n_members, int n_br, long long n_cells,
                  long long nb, int bs, long long x_stride, int rows_per_cta,
                  cudaStream_t stream) {
  return launch_spmv_counted<true>(cell_block, cell_col, cell_ptr,
                                   cell_valid, row_perm, blocks, x, y,
                                   n_members, n_br, n_cells, nb, bs, x_stride,
                                   rows_per_cta, stream);
}

int bsr_spmm_sell(const int* cell_block, const int* cell_col,
                  const int* cell_ptr, const int* cell_valid,
                  const int* row_perm, const float* blocks, const float* x,
                  float* y, int n_members, int n_br, long long n_cells,
                  long long nb, int bs, long long x_stride, int k,
                  int rows_per_cta, cudaStream_t stream) {
  return launch_spmm_counted<true>(cell_block, cell_col, cell_ptr,
                                   cell_valid, row_perm, blocks, x, y,
                                   n_members, n_br, n_cells, nb, bs, x_stride,
                                   k, rows_per_cta, stream);
}

}  // extern "C"

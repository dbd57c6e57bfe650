// Block-union SpADD for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/bsr_spadd/kernel.py:
//   bsr_spadd  <- bsr_spadd_pallas  (_spadd_kernel)
//
// What it computes
//   c[m, k] = a[m, ia[m, k]] + b[m, ib[m, k]]   (whole bs x bs tiles)
//   m is the member of a stacked bucket (one member for a single plan).
//   The host symbolic phase points ia (ib) at a member's zero sentinel,
//   sentinels[m, 0] (sentinels[m, 1]), where only B (only A) has the
//   block; every tile at or past a member's sentinel is +0.0 (the sentinel
//   and the bucket-pad tiles after it).
//
// What bounds it on this card
//   Bytes: one fp32 add per 12 bytes moved (two reads, one write). The
//   least time is (C written + the real A and B tiles read once + ia/ib)
//   / 3.35 TB/s.
//
// What the design does about it
//   On a scattered union nearly every C tile has one operand on the
//   sentinel (gen_spatial seeds 0 + 1: 0.1% of C tiles hold both). The
//   kernel never reads a sentinel tile: an index at or past the member's
//   sentinel gives +0.0f in registers, which is still added (x + 0.0f,
//   never a copy: a copy would keep a -0.0 that the plain version turns
//   into +0.0). A C tile whose two indices are both sentinels is written
//   +0.0 without any tile read. So the kernel moves exactly the bytes of
//   the bound: each real tile once, C once.
//   One CTA of 256 threads owns one C tile (bs >= 32: 256 or more float4,
//   looped) or several whole tiles (bs < 32), so ia/ib are read once per
//   tile and no thread divides; consecutive threads touch consecutive
//   float4. The member is blockIdx.z, so a bucket is one launch. Other
//   grids were tried on the card (PERF.md) and none beat this one:
//   persistent grids that walk the tiles (a warp a tile, its next indices
//   prefetched), groups of tiles a CTA, one loop per case of which
//   operands a tile reads, unrolled loops, and evict-first loads with
//   streaming stores (__ldcs / __stcs). So the grid stays the one that
//   was there, minus the sentinel reads.
//   The add is a plain IEEE fp32 add (no fast-math), so the result is bit
//   for bit the plain PyTorch version's and the JAX jnp path's, -0.0, NaN
//   and Inf included. All offsets are 64-bit: a member of 1.3M tiles at
//   bs = 32 already passes 2^31 elements of output.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

__global__ void __launch_bounds__(kThreads)
bsr_spadd_kernel(const int* __restrict__ ia,         // (B, n_c)
                 const int* __restrict__ ib,         // (B, n_c)
                 const int* __restrict__ sentinels,  // (B, 2)
                 const float4* __restrict__ a,       // (B, n_a, bs*bs/4)
                 const float4* __restrict__ b,       // (B, n_b, bs*bs/4)
                 float4* __restrict__ c,             // (B, n_c, bs*bs/4)
                 long long n_c, long long n_a, long long n_b, int per_tile) {
  const long long m = blockIdx.z;
  const int zero_a = sentinels[2 * m], zero_b = sentinels[2 * m + 1];
  const float4* a_m = a + m * n_a * per_tile;
  const float4* b_m = b + m * n_b * per_tile;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (per_tile >= kThreads) {
    const long long k = blockIdx.x;
    const int sa = ia[m * n_c + k], sb = ib[m * n_c + k];
    const bool has_a = sa < zero_a, has_b = sb < zero_b;
    const float4* a_t = a_m + (long long)sa * per_tile;
    const float4* b_t = b_m + (long long)sb * per_tile;
    float4* c_t = c + (m * n_c + k) * per_tile;
    for (int q = threadIdx.x; q < per_tile; q += kThreads)
      c_t[q] = add4(has_a ? a_t[q] : zero, has_b ? b_t[q] : zero);
  } else {
    const int tiles_per_cta = kThreads / per_tile;
    const int local = threadIdx.x / per_tile;
    const int q = threadIdx.x - local * per_tile;
    const long long k = (long long)blockIdx.x * tiles_per_cta + local;
    if (local < tiles_per_cta && k < n_c) {
      const int sa = ia[m * n_c + k], sb = ib[m * n_c + k];
      const float4 x = sa < zero_a ? a_m[(long long)sa * per_tile + q] : zero;
      const float4 y = sb < zero_b ? b_m[(long long)sb * per_tile + q] : zero;
      c[(m * n_c + k) * per_tile + q] = add4(x, y);
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int bsr_spadd(const int* ia, const int* ib, const int* sentinels,
              const float* a, const float* b, float* c, int n_members,
              long long n_c, long long n_a, long long n_b, int bs,
              cudaStream_t stream) {
  if (bs <= 0 || bs > 256 || bs % 4 != 0 || n_c <= 0 || n_members <= 0 ||
      n_members > 65535)
    return (int)cudaErrorInvalidValue;
  const int per_tile = bs * bs / 4;
  const long long tiles_per_cta =
      per_tile >= kThreads ? 1 : kThreads / per_tile;
  const long long n_ctas = (n_c + tiles_per_cta - 1) / tiles_per_cta;
  if (n_ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_ctas, 1, n_members);
  bsr_spadd_kernel<<<grid, kThreads, 0, stream>>>(
      ia, ib, sentinels, reinterpret_cast<const float4*>(a),
      reinterpret_cast<const float4*>(b), reinterpret_cast<float4*>(c), n_c,
      n_a, n_b, per_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"

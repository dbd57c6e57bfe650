// Ragged grouped GEMM (MoE expert compute) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/moe_gmm/kernel.py:
//   moe_gmm  <- moe_gmm_pallas  (_gmm_kernel)
//
// What it computes
//   out[r, :] = x[r, :] @ w[tile_expert[r / tile_m]]     for every row r
//   x (M, K) is sorted by expert and padded per expert to tile_m rows;
//   w (E, K, N); x and w both float32 or both bfloat16; out (M, N) float32.
//   Every row is a product, whatever it holds: a pad row that a caller
//   filled with values or NaN is computed like a token. A tile whose
//   expert is outside [0, E) reads nothing and is written as NaN (the
//   planner rejects such tiles on the host before launching).
//
// What bounds it on this card
//   Decode (a few tokens): the weight bytes. Every expert owns at least one
//   tile (the host pads empty experts too), so all of w, 3.22 GB at
//   mixtral-8x22b width, is read once: 0.96 ms at 3.35 TB/s, while the
//   real products are 0.81 GFLOP. Prefill (thousands of tokens):
//   operations, 2 * rows * K * N, three TF32 tensor-core products per fp32
//   product (below).
//
// What the design does about it
//   The exactness rule. live_end[t] is 1 + the last row of tile t that
//   holds an element other than +-0 (NaN counts); 0 for an all-zero tile.
//   The rows at or past it are all +-0, so each of their outputs is the
//   zero-row product of the tile's expert, z_e[n] = sum_k 0 * w_e[k, n]:
//   NaN in a column where w_e holds a NaN or +-Inf, zero elsewhere. So
//   only rows [0, live_end) are products; z_e is worked out once per
//   (tile, column strip) and written into the dead rows. w_e's strip is
//   still read once for every tile, an empty expert's too, so its NaN and
//   Inf reach its pad rows as in the plain version. Three launches on the
//   caller's stream, no host read-back:
//   1. live_rows_kernel: one warp per row reads x once (16-byte loads,
//      stops at the row's first non-zero) and raises live_end[t] with an
//      atomicMax (live_end is zeroed by a memset just before).
//   2. moe_skinny_kernel (tiles with live_end <= 16, and invalid experts):
//      a 256-thread CTA per (tile, 128-column strip) streams its w_e strip
//      through a 4-stage cp.async ring, 16 bytes a thread, with the live
//      rows' K chunks of x beside it; fp32 FMAs on CUDA cores (exact fp32)
//      for 4, 8 or 16 rows (rows past live_end are zero rows, whose
//      products are z_e) and one zero-row accumulator fma(0, w, z) for
//      z_e. Each warp takes 4 of every 32 K rows; the 8 partial sums are
//      added in shared memory in a fixed order.
//   3. moe_wgmma_kernel (tiles with live_end > 16): a CTA owns 128 rows of
//      one tile x 128 columns, 2 warpgroups of 64 rows, and walks K in
//      32-deep chunks. Each chunk arrives as two TMA boxes (x: 128 rows x
//      32, w: 32 x 128) in a 3-stage ring counted on mbarriers, issued by
//      one thread two chunks ahead. All 256 threads split each chunk into
//      TF32 hi + lo (hi = x rounded to TF32 to nearest, lo = the rest
//      rounded so) in K-major core matrices (w transposed: tf32 wgmma takes
//      only K-major operands), double-buffered, so the split of chunk j + 1
//      overlaps the wgmma of chunk j. A product is lo_a.hi_b + hi_a.lo_b +
//      hi_a.hi_b, small terms first (wgmma m64n128k8). wgmma's accumulator
//      does not round its adds to nearest, an error that grows with K; so
//      every 4 chunks the accumulator is added into an fp32 total.
//      bfloat16 is exact in TF32: one pass.
//      A warpgroup wholly at or past live_end issues no product; a CTA
//      wholly past it exits at once. The CTA that holds row live_end - 1
//      writes z_e (from a per-column non-finite flag it keeps while it
//      splits w) into every dead row of the tile in its strip.
//      Non-finite operands: under the split, Inf - hi is NaN and 0 * Inf
//      in a small term is NaN where fp32 gives +-Inf. So a chunk that holds
//      a NaN or Inf (in x's live rows or in w) is not run on the tensor
//      cores: the CTA adds that chunk with fp32 FMAs from the raw stage
//      into the accumulators (uniform over the CTA; only such chunks).
//      Rows whose strides are not 16-byte multiples (no tensor map) are
//      copied element by element instead of by TMA.
//   Tiles go to path 2 or 3 on the device: both grids are launched and
//   each CTA exits when its tile belongs to the other. The wgmma grid is
//   rastered in groups of 16 strips, tile within a group, so that the
//   CTAs in flight share x rows and w strips in L2. Offsets are 64-bit: w
//   is 3.22 GB at mixtral width. K and N edges are masked; x and w rows
//   are copied 16 bytes at a time when their strides allow it, else one
//   element at a time.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 128;        // output columns per CTA, both paths
constexpr int kSkinnyRows = 16;    // live_end <= this: CUDA-core path
constexpr int kSkK = 32;           // skinny: K rows per ring stage
constexpr int kSkStages = 4;       // skinny: ring depth
constexpr int kBM = 128;           // wgmma: rows per CTA (2 warpgroups)
constexpr int kBK = 32;            // wgmma: K chunk
constexpr int kKc = kBK / 4;       // core columns per row of a split tile
constexpr int kGroupStrips = 16;   // wgmma raster: strips per group
constexpr int kPromote = 4;        // wgmma: chunks per promotion group
constexpr int kRawStages = 3;      // wgmma: raw chunk ring (TMA boxes)
constexpr int kSplitBufs = 2;      // wgmma: split tile buffers

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ bool sum_finite4(float4 v) {
  return fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w) <= 3.402823466e38f;
}
__device__ __forceinline__ bool finite4(float4 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}

// Element (r, c) of a K-major tile in core matrices of 8 rows x 4 floats
// (16 bytes), kc core columns a row of cores. A wgmma descriptor of such a
// tile takes LBO = 128 bytes (the next core along K) and SBO = kc * 128
// bytes (the next 8 rows).
__device__ __forceinline__ int core_at(int r, int c, int kc) {
  return ((r >> 3) * kc + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

__device__ __forceinline__ uint64_t smem_desc(const float* p, int kc) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((kc * 128) >> 4) << 32);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// 16 bytes from global into shared memory, zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One group of vec_elems<T>() elements of a row into shared memory, of
// which the first `valid` are real (the rest zero-filled). With `vec` the
// group is one 16-byte cp.async (valid is 0 or the whole group, since the
// row stride and the base are 16-byte aligned); without, element by
// element through registers.
template <typename T>
__device__ __forceinline__ void stage_group(T* dst, const T* src, int valid,
                                            bool vec) {
  constexpr int V = vec_elems<T>();
  if (vec) {
    cp_async16(dst, src, valid > 0);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = i < valid ? src[i] : zero_of<T>();
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma m64n128k8, TF32 in, fp32 accumulate, A and B in shared memory:
// d = A B + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------- 1. live rows

// The magnitude bits of 16 bytes of x (sign bits dropped), OR-ed
__device__ __forceinline__ uint32_t magnitude_bits(uint4 v, int elem_bytes) {
  const uint32_t m = elem_bytes == 4 ? 0x7fffffffu : 0x7fff7fffu;
  return (v.x | v.y | v.z | v.w) & m;
}
__device__ __forceinline__ uint32_t magnitude_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ uint32_t magnitude_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v) & 0x7fffu;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
live_rows_kernel(const T* __restrict__ x, int* __restrict__ live_end,
                 long long M, long long K, int tile_m, int vec) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;                          // uniform over the warp
  const T* xr = x + row * K;
  bool live = false;
  if (vec) {
    const long long n16 = K / vec_elems<T>();
    const uint4* p = reinterpret_cast<const uint4*>(xr);
    for (long long b = 0; b < n16 && !live; b += 4 * 32) {
      uint32_t bits = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long j = b + u * 32 + lane;
        if (j < n16) bits |= magnitude_bits(p[j], (int)sizeof(T));
      }
      live = __any_sync(0xffffffffu, bits != 0);
    }
  } else {
    for (long long b = 0; b < K && !live; b += 32) {
      const long long k = b + lane;
      live = __any_sync(0xffffffffu, k < K && magnitude_bits(xr[k]) != 0);
    }
  }
  if (live && lane == 0)
    atomicMax(live_end + row / tile_m, (int)(row % tile_m) + 1);
}

// ------------------------------------------------------ 2. skinny path

template <typename T>
struct Skinny {
  static constexpr int kWs = kSkK * kStrip;                 // w elements
  static constexpr int kXs = kSkinnyRows * kSkK;            // x elements
  static constexpr int kStageBytes = (kWs + kXs) * (int)sizeof(T);
  static constexpr int kRedBytes = 8 * 4 * kStrip * 4 + kStrip * 4;
  static constexpr int kSmemBytes = kSkStages * kStageBytes > kRedBytes
      ? kSkStages * kStageBytes : kRedBytes;
};

// The copies of K chunk j (rows k0 .. k0 + kSkK) of w_e's strip and of
// x's first `rows` rows into ring stage `st`; x rows at or past live_end
// are zero-filled (they are zero rows).
template <typename T, int LIVE>
__device__ __forceinline__ void skinny_issue(
    unsigned char* st, const T* x_t, const T* w_e, long long K, long long N,
    long long n0, long long k0, int live, bool vec_x, bool vec_w) {
  constexpr int V = vec_elems<T>();
  T* ws = reinterpret_cast<T*>(st);
  T* xs = ws + Skinny<T>::kWs;
  for (int u = threadIdx.x; u < kSkK * (kStrip / V); u += kThreads) {
    const int kk = u / (kStrip / V), c = (u % (kStrip / V)) * V;
    const long long k = k0 + kk, n = n0 + c;
    const int valid = k < K ? (int)max(0LL, min((long long)V, N - n)) : 0;
    stage_group(ws + kk * kStrip + c,
                valid > 0 ? w_e + k * N + n : w_e, valid, vec_w);
  }
  for (int u = threadIdx.x; u < LIVE * (kSkK / V); u += kThreads) {
    const int r = u / (kSkK / V), c = (u % (kSkK / V)) * V;
    const long long k = k0 + c;
    const int valid = r < live ? (int)max(0LL, min((long long)V, K - k)) : 0;
    stage_group(xs + r * kSkK + c, valid > 0 ? x_t + r * K + k : x_t, valid,
                vec_x);
  }
}

template <typename T, int LIVE>
__device__ __forceinline__ void skinny_body(
    unsigned char* smem, const T* x_t, const T* w_e, float* out_t,
    long long K, long long N, long long n0, int tile_m, int live, bool vec_x,
    bool vec_w) {
  const int cg = threadIdx.x & 31;      // columns 4 cg .. 4 cg + 3
  const int kg = threadIdx.x >> 5;      // K rows 4 kg .. 4 kg + 3 a chunk
  const long long n_chunks = (K + kSkK - 1) / kSkK;
  float acc[LIVE][4], z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < LIVE; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < n_chunks)
      skinny_issue<T, LIVE>(smem + s * Skinny<T>::kStageBytes, x_t, w_e, K,
                            N, n0, (long long)s * kSkK, live, vec_x, vec_w);
    cp_async_commit();
  }
  for (long long j = 0; j < n_chunks; ++j) {
    cp_async_wait<kSkStages - 2>();
    __syncthreads();   // chunk j landed everywhere; stage (j - 1) is free
    const long long nxt = j + kSkStages - 1;
    if (nxt < n_chunks)
      skinny_issue<T, LIVE>(
          smem + (int)(nxt % kSkStages) * Skinny<T>::kStageBytes, x_t, w_e,
          K, N, n0, nxt * kSkK, live, vec_x, vec_w);
    cp_async_commit();
    const T* ws = reinterpret_cast<const T*>(
        smem + (int)(j % kSkStages) * Skinny<T>::kStageBytes);
    const T* xs = ws + Skinny<T>::kWs;
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = load4(ws + (kg * 4 + i) * kStrip + cg * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[0] = fmaf(0.f, wv[i].x, z[0]);
      z[1] = fmaf(0.f, wv[i].y, z[1]);
      z[2] = fmaf(0.f, wv[i].z, z[2]);
      z[3] = fmaf(0.f, wv[i].w, z[3]);
    }
#pragma unroll
    for (int r = 0; r < LIVE; ++r) {
      const float4 xv = load4(xs + r * kSkK + kg * 4);
      const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[r][0] = fmaf(xk[i], wv[i].x, acc[r][0]);
        acc[r][1] = fmaf(xk[i], wv[i].y, acc[r][1]);
        acc[r][2] = fmaf(xk[i], wv[i].z, acc[r][2]);
        acc[r][3] = fmaf(xk[i], wv[i].w, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: it becomes the reduction buffer

  // the 8 warps' partial sums, added in warp order, 4 rows at a time
  float* red = reinterpret_cast<float*>(smem);       // [8][4][kStrip]
  float* zs = red + 8 * 4 * kStrip;                  // [kStrip]
#pragma unroll
  for (int r0 = 0; r0 < LIVE; r0 += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red + (kg * 4 + i) * kStrip + cg * 4) =
          make_float4(acc[r0 + i][0], acc[r0 + i][1], acc[r0 + i][2],
                      acc[r0 + i][3]);
    __syncthreads();
    for (int q = threadIdx.x; q < 4 * kStrip; q += kThreads) {
      const int i = q / kStrip, c = q % kStrip;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) s += red[(g * 4 + i) * kStrip + c];
      if (n0 + c < N) out_t[(long long)(r0 + i) * N + n0 + c] = s;
    }
    __syncthreads();
  }
  *reinterpret_cast<float4*>(red + kg * 4 * kStrip + cg * 4) =
      make_float4(z[0], z[1], z[2], z[3]);
  __syncthreads();
  if (threadIdx.x < kStrip) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) s += red[g * 4 * kStrip + threadIdx.x];
    zs[threadIdx.x] = s;
  }
  __syncthreads();
  // rows LIVE .. tile_m are zero rows: z_e
  for (long long q = threadIdx.x; q < (long long)(tile_m - LIVE) * kStrip;
       q += kThreads) {
    const int c = (int)(q % kStrip);
    if (n0 + c < N) out_t[(LIVE + q / kStrip) * N + n0 + c] = zs[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
moe_skinny_kernel(const int* __restrict__ tile_expert,
                  const int* __restrict__ live_end, const T* __restrict__ x,
                  const T* __restrict__ w, float* __restrict__ out,
                  long long E, long long K, long long N, int tile_m,
                  int n_strips, int vec_x, int vec_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long tile = blockIdx.x / (unsigned)n_strips;
  const long long n0 = (long long)(blockIdx.x % (unsigned)n_strips) * kStrip;
  const long long e = tile_expert[tile];
  const int live = live_end[tile];
  const bool valid = e >= 0 && e < E;
  if (valid && live > kSkinnyRows) return;        // the wgmma path's tile
  float* out_t = out + tile * tile_m * N;
  if (!valid) {   // uniform over the CTA: no read out of bounds
    for (long long q = threadIdx.x; q < (long long)tile_m * kStrip;
         q += kThreads) {
      const long long n = n0 + q % kStrip;
      if (n < N) out_t[(q / kStrip) * N + n] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const T* x_t = x + tile * tile_m * K;
  const T* w_e = w + e * K * N;
  if (live <= 4)
    skinny_body<T, 4>(smem, x_t, w_e, out_t, K, N, n0, tile_m, live, vec_x,
                      vec_w);
  else if (live <= 8)
    skinny_body<T, 8>(smem, x_t, w_e, out_t, K, N, n0, tile_m, live, vec_x,
                      vec_w);
  else
    skinny_body<T, 16>(smem, x_t, w_e, out_t, K, N, n0, tile_m, live,
                       vec_x, vec_w);
}

// ------------------------------------------------------- 3. wgmma path

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// a TMA copy of the 2-D box at (c0 innermost, c1) of `map` into shared
// memory, counted on `bar`; the box's parts outside the tensor are zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
struct Wg {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr int kTile = kBM * kBK;            // floats of a split tile
  static constexpr int kParts = kSplit ? 4 : 2;      // a hi (lo), b hi (lo)
  static constexpr int kBufBytes = kParts * kTile * 4;
  static constexpr int kRawA = kBM * kBK;            // x box, row-major
  static constexpr int kRawB = kBK * kStrip;         // w box, row-major
  static constexpr int kRawBytes = (kRawA + kRawB) * (int)sizeof(T);
  static constexpr int kSmemBytes = kSplitBufs * kBufBytes +
                                    kRawStages * kRawBytes +
                                    8 * kRawStages + 4 * kStrip;
};

// K chunk j into raw stage j % kRawStages: with tensor maps, one thread
// issues two TMA boxes (x: 128 rows x kBK from the CTA's first row; w:
// kBK rows x kStrip columns of expert e) counted on `full`; without (rows
// whose strides are not 16-byte multiples), every thread copies elements
// and arrives. Rows, columns and K past the CTA's live rows, N and K are
// masked by the split, never trusted.
template <typename T>
__device__ __forceinline__ void wg_load(
    unsigned char* raw, uint64_t* full, long long j, bool tma,
    const CUtensorMap* map_x, const CUtensorMap* map_w, int x_row,
    int w_row, const T* x_c, const T* w_e, long long K, long long N,
    long long n0, int nl) {
  using L = Wg<T>;
  const int st = (int)(j % kRawStages);
  T* ra = reinterpret_cast<T*>(raw + st * L::kRawBytes);
  T* rb = ra + L::kRawA;
  const int k0 = (int)(j * kBK);
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + st, (uint32_t)L::kRawBytes);
      tma_load(ra, map_x, k0, x_row, full + st);
      tma_load(rb, map_w, (int)n0, w_row + k0, full + st);
    }
    return;
  }
  const int ka = (int)min((long long)kBK, K - k0);
  const int nb = (int)min((long long)kStrip, N - n0);
  for (int q = threadIdx.x; q < nl * ka; q += kThreads)
    ra[(q / ka) * kBK + q % ka] = x_c[(long long)(q / ka) * K + k0 + q % ka];
  for (int q = threadIdx.x; q < ka * nb; q += kThreads)
    rb[(q / nb) * kStrip + q % nb] =
        w_e[(long long)(k0 + q / nb) * N + n0 + q % nb];
  mbar_arrive(full + st);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
moe_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, int tma,
                 const int* __restrict__ tile_expert,
                 const int* __restrict__ live_end, const T* __restrict__ x,
                 const T* __restrict__ w, float* __restrict__ out,
                 long long E, long long K, long long N, int tile_m,
                 int n_rb, int n_strips) {
  using L = Wg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  // raster: groups of kGroupStrips strips; row blocks within a group
  const long long b = blockIdx.x;
  const long long per_group = (long long)n_rb * kGroupStrips;
  const long long full_groups = n_strips / kGroupStrips;
  long long g = b / per_group, rem = b - g * per_group;
  int width = kGroupStrips;
  if (g >= full_groups) {
    g = full_groups;
    rem = b - full_groups * per_group;
    width = n_strips - (int)(full_groups * kGroupStrips);
  }
  const long long rb = rem / width;
  const long long n0 = (g * kGroupStrips + rem % width) * kStrip;
  const int cpt = (tile_m + kBM - 1) / kBM;          // CTAs per tile
  const long long tile = rb / cpt;
  const int r0 = (int)(rb % cpt) * kBM;              // first row in the tile
  const long long e = tile_expert[tile];
  const int live = live_end[tile];
  if (e < 0 || e >= E || live <= kSkinnyRows || r0 >= live) return;
  const int rows = min(kBM, tile_m - r0);
  const int nl = min(live - r0, rows);               // live rows here, >= 1
  const bool z_owner = live - 1 < r0 + rows && live < tile_m;

  float* buf = reinterpret_cast<float*>(smem);
  unsigned char* raw = smem + kSplitBufs * L::kBufBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw +
                                               kRawStages * L::kRawBytes);
  int* colbad = reinterpret_cast<int*>(full + kRawStages);
  const T* x_c = x + (tile * tile_m + r0) * K;
  const T* w_e = w + e * K * N;
  const int x_row = (int)(tile * tile_m + r0), w_row = (int)(e * K);
  const long long n_chunks = (K + kBK - 1) / kBK;
  const int nb = (int)min((long long)kStrip, N - n0);
  if (threadIdx.x < kStrip) colbad[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawStages; ++s) mbar_init(full + s, tma ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (long long j = 0; j < kRawStages - 1 && j < n_chunks; ++j)
    wg_load(raw, full, j, tma, &map_x, &map_w, x_row, w_row, x_c, w_e, K, N,
            n0, nl);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const bool wg_live = 64 * wg < nl;
  const int a_rows = 64 * ((nl + 63) / 64);          // rows some wgmma reads
  // this thread's split items: x row sr, 4 of its 8 groups of 4 K columns
  // (taken in an order rotated by the row, so that the 8 rows of a
  // shared-memory phase read 8 different banks), and w column sn, 16 of
  // its 32 K rows; the same in every chunk
  const int sr = threadIdx.x % kBM, sn = threadIdx.x % kStrip;
  const int half = threadIdx.x / kBM;                // 0 or 1
  bool bad = false;                                  // non-finite in w[:, sn]

  // acc: the products of the current promotion group (wgmma's own
  // accumulator, which does not round its adds to nearest); total: the
  // sum of the finished groups, in fp32 adds
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;

  for (long long j = 0; j < n_chunks; ++j) {
    const int st = (int)(j % kRawStages), s = (int)(j & 1);
    const T* ra = reinterpret_cast<const T*>(raw + st * L::kRawBytes);
    const T* rbw = ra + L::kRawA;
    float* a_hi = buf + s * (L::kBufBytes / 4);
    float* a_lo = a_hi + L::kTile;
    float* b_hi = a_hi + (L::kSplit ? 2 : 1) * L::kTile;
    float* b_lo = b_hi + L::kTile;
    const int kv = (int)min((long long)kBK, K - j * kBK);   // real K rows
    mbar_wait(full + st, (uint32_t)((j / kRawStages) & 1));
    __syncthreads();   // every warpgroup is done with the tiles of j - 2,
                       // and every thread with raw stage j - 1
    const long long nxt = j + kRawStages - 1;        // into stage j - 1's
    if (nxt < n_chunks)
      wg_load(raw, full, nxt, tma, &map_x, &map_w, x_row, w_row, x_c, w_e, K,
              N, n0, nl);
    bool nf = false;
    if (sr < a_rows) {
      float4 v[kBK / 8];
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        const int c = 4 * ((2 * i + half + sr) & (kBK / 4 - 1));
        v[i] = sr < nl ? load4(ra + sr * kBK + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        if (c + 4 > kv) {              // past K (the last chunk)
          if (c >= kv) v[i].x = 0.f;
          if (c + 1 >= kv) v[i].y = 0.f;
          if (c + 2 >= kv) v[i].z = 0.f;
          v[i].w = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        const int c = 4 * ((2 * i + half + sr) & (kBK / 4 - 1));
        nf |= !sum_finite4(v[i]);
        const int at = core_at(sr, c, kKc);
        if constexpr (L::kSplit) {
          uint32_t h[4], l[4];
          split_tf32(v[i].x, h[0], l[0]);
          split_tf32(v[i].y, h[1], l[1]);
          split_tf32(v[i].z, h[2], l[2]);
          split_tf32(v[i].w, h[3], l[3]);
          *reinterpret_cast<uint4*>(a_hi + at) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(a_lo + at) =
              make_uint4(l[0], l[1], l[2], l[3]);
        } else {
          *reinterpret_cast<float4*>(a_hi + at) = v[i];
        }
      }
    }
    {
      // w column sn, K rows 4 (2 i + half) .., transposed into K-major
      // core matrices
      float bv[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * (2 * i + half) + q;
          bv[4 * i + q] = sn < nb && kk < kv
              ? to_float(rbw[kk * kStrip + sn]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        const float4 v = make_float4(bv[4 * i], bv[4 * i + 1], bv[4 * i + 2],
                                     bv[4 * i + 3]);
        if (!sum_finite4(v)) {
          nf = true;
          bad |= !finite4(v);
        }
        const int at = core_at(sn, 4 * (2 * i + half), kKc);
        if constexpr (L::kSplit) {
          uint32_t h[4], l[4];
          split_tf32(v.x, h[0], l[0]);
          split_tf32(v.y, h[1], l[1]);
          split_tf32(v.z, h[2], l[2]);
          split_tf32(v.w, h[3], l[3]);
          *reinterpret_cast<uint4*>(b_hi + at) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(b_lo + at) =
              make_uint4(l[0], l[1], l[2], l[3]);
        } else {
          *reinterpret_cast<float4*>(b_hi + at) = v;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const bool any_nf = __syncthreads_or(nf) != 0;   // chunk j is split
    if (!any_nf) {
      if (wg_live) {
        // a new promotion group: the last one's sum joins total, and the
        // group's first product overwrites acc
        const bool fresh = j % kPromote == 0;
        if (fresh && j > 0) {
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 64; ++i) total[i] += acc[i];
        }
        const uint64_t da_hi = smem_desc(a_hi + 64 * wg * kBK, kKc);
        const uint64_t db_hi = smem_desc(b_hi, kKc);
        const uint64_t da_lo = smem_desc(a_lo + 64 * wg * kBK, kKc);
        const uint64_t db_lo = smem_desc(b_lo, kKc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 8; ++ks) {
          const uint64_t step = (uint64_t)(16 * ks);    // 256 bytes >> 4
          const int keep = !(fresh && ks == 0);
          if constexpr (L::kSplit) {
            wgmma_ss(acc, da_lo + step, db_hi + step, keep);
            wgmma_ss(acc, da_hi + step, db_lo + step, 1);
            wgmma_ss(acc, da_hi + step, db_hi + step, 1);
          } else {
            wgmma_ss(acc, da_hi + step, db_hi + step, keep);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();   // chunk j - 1's products are done
      }
    } else {
      // a NaN or Inf in this chunk: add it with fp32 FMAs from the raw
      // stage, as the plain version does. acc[4 q + i] is row 16 warp +
      // gq (+ 8 for i >= 2) of the warpgroup, column 8 q + 2 t + (i & 1);
      // rows past live_end, columns past N and K past K count as zeros
      // (their raw values are not those of x and w).
      if (wg_live) {
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 64 * wg + 16 * warp + gq + 8 * (i >> 1);
            const int col = 8 * q + 2 * t + (i & 1);
            const bool real = r < nl && col < nb;
            float sum = acc[4 * q + i];
            for (int kk = 0; kk < kv; ++kk)
              sum = fmaf(real ? to_float(ra[r * kBK + kk]) : 0.f,
                         real ? to_float(rbw[kk * kStrip + col]) : 0.f, sum);
            acc[4 * q + i] = sum;
          }
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] += acc[i];
  if (bad) colbad[sn] = 1;
  __syncthreads();

  float* out_t = out + tile * tile_m * N;
  if (wg_live) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 64 * wg + 16 * warp + gq + 8 * (i >> 1);
        const long long n = n0 + 8 * q + 2 * t + (i & 1);
        if (r < live && n < N) out_t[(long long)r * N + n] = total[4 * q + i];
      }
  }
  if (z_owner) {   // rows live .. tile_m are zero rows: z_e
    for (long long q = threadIdx.x; q < (long long)(tile_m - live) * kStrip;
         q += kThreads) {
      const int c = (int)(q % kStrip);
      if (n0 + c < N)
        out_t[(live + q / kStrip) * N + n0 + c] =
            colbad[c] ? __int_as_float(0x7fc00000) : 0.f;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor map with (box_rows, box_cols) boxes;
// false when the driver refuses it
template <typename T>
bool make_map(CUtensorMap* map, const T* base, long long rows,
              long long cols, int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * (long long)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<T*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch(const int* tile_expert, int* live_end, const void* xv,
           const void* wv, float* out, long long M, long long E, long long K,
           long long N, int tile_m, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const long long n_tiles = M / tile_m;
  const long long n_strips = (N + kStrip - 1) / kStrip;
  const long long cpt = (tile_m + kBM - 1) / kBM;
  const long long scan_grid = (M + kThreads / 32 - 1) / (kThreads / 32);
  if (scan_grid > 2147483647LL || n_tiles * n_strips > 2147483647LL ||
      n_tiles * cpt * n_strips > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int vec_x = (K * (long long)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (N * (long long)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err;
  if ((err = allow_smem(moe_skinny_kernel<T>, Skinny<T>::kSmemBytes)) !=
          cudaSuccess ||
      (err = allow_smem(moe_wgmma_kernel<T>, Wg<T>::kSmemBytes)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(live_end, 0, n_tiles * sizeof(int), stream)) !=
          cudaSuccess)
    return (int)err;
  live_rows_kernel<T><<<(unsigned)scan_grid, kThreads, 0, stream>>>(
      x, live_end, M, K, tile_m, vec_x);
  moe_skinny_kernel<T><<<(unsigned)(n_tiles * n_strips), kThreads,
                         Skinny<T>::kSmemBytes, stream>>>(
      tile_expert, live_end, x, w, out, E, K, N, tile_m, (int)n_strips,
      vec_x, vec_w);
  CUtensorMap map_x{}, map_w{};
  const int tma = vec_x && vec_w && M < 2147483647LL &&
                  E * K < 2147483647LL && make_map(&map_x, x, M, K, kBM, kBK) &&
                  make_map(&map_w, w, E * K, N, kBK, kStrip);
  moe_wgmma_kernel<T><<<(unsigned)(n_tiles * cpt * n_strips), kThreads,
                        Wg<T>::kSmemBytes, stream>>>(
      map_x, map_w, tma, tile_expert, live_end, x, w, out, E, K, N, tile_m,
      (int)(n_tiles * cpt), (int)n_strips);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w alike). live_end: (M /
// tile_m,) int32 scratch on the device, written here. Returns
// cudaGetLastError() after the launches (0 = launched).
int moe_gmm(const int* tile_expert, int* live_end, const void* x,
            const void* w, float* out, long long M, long long E, long long K,
            long long N, int tile_m, int dtype, cudaStream_t stream) {
  if (M <= 0 || E <= 0 || K <= 0 || N <= 0 || tile_m <= 0 ||
      M % tile_m != 0 || tile_m % 32 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dtype == 0
      ? launch<float>(tile_expert, live_end, x, w, out, M, E, K, N, tile_m,
                      stream)
      : launch<__nv_bfloat16>(tile_expert, live_end, x, w, out, M, E, K, N,
                              tile_m, stream);
}

}  // extern "C"

// Online-softmax attention (FlashAttention-2 dataflow) on the TF32 tensor
// cores of Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:
//   flash_attention  <- flash_attention_pallas  (_flash_kernel)
//
// What it computes
//   out[b] = softmax(q[b] k[b]^T * scale [causal mask]) v[b]
//   q, k, v (BH, S, D) float32 or bfloat16, out (BH, S, D) float32,
//   scale = 1/sqrt(D). The JAX kernel's numerics are kept: scores are
//   scaled, then masked with NEG_INF = -1e30 where col > row; a running
//   max m, sum-exp l and accumulator per row in fp32; out = acc / max(l,
//   1e-30).
//
// What bounds it on this card
//   Tensor-core operations. Both products, S = Q K^T and O += P V, run as
//   wgmma m64nNk8 TF32 with fp32 accumulators. TF32 keeps 10 mantissa
//   bits, which misses the reference's 1e-4 * max|ref| for float32
//   operands, so each float32 operand x is split once into x = hi + lo
//   (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)) and a product a.b
//   is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms accumulated
//   first: three TF32 products per fp32 product. bfloat16 q, k and v are
//   exact in TF32, so a bf16 Q K^T is one product and a bf16 P V two (P
//   split, V exact). At S=4096, D=128, causal, that is 3 x 4*S*S*D/2 per
//   (b, h): 1.25 ms for 48 heads at the card's 494.7 TFLOP/s dense TF32,
//   against 0.04 ms for the bytes of q, k, v and out.
//
// What the design does about it
//   A CTA is kWgs warpgroups of 4 warps; each warpgroup owns 64 q rows of
//   one (b, h) and issues wgmma over them, so the tensor cores read a K or
//   V tile from shared memory once per 64 rows (mma.sync reads it once
//   per 16-row warp). Each warp keeps its 16 rows' scores S, softmax
//   statistics and output accumulator in registers (wgmma accumulator
//   fragments), so the row max is a max over the four lanes of a quad.
//   Every operand is split once, where it is staged: the q tile at the
//   start, K and V per chunk of kKv rows, P in registers. The tiles sit in
//   shared memory K-major, in 8-row x 16-byte core matrices (the layout
//   wgmma reads without a swizzle), hi and lo apart. tf32 wgmma takes only
//   K-major operands, so V is stored transposed (d rows, kv along K).
//   K and V chunks come by 16-byte (float32) or 8-byte (bfloat16) cp.async
//   copies, zero-filled past S and D, into a row-major raw stage; the next
//   chunk's copy is issued as soon as the current one is split, so it
//   overlaps the chunk's products. Two barriers a chunk: the raw chunk
//   has landed and every warpgroup is done with the last tiles; the new
//   tiles are split (after a proxy fence, since wgmma reads shared memory
//   through the async proxy).
//   P never leaves registers: the kv order inside each 8-column step is
//   relabelled so that step k = t of the P V product is kv column 2t and
//   k = t + 4 is column 2t + 1. A lane's accumulator fragment of S
//   (columns 2t, 2t + 1 of rows g and g + 8) then is its A fragment of P,
//   and the split writes V's rows in the same order. The small terms of S
//   have an accumulator of their own, added to the big one after the last
//   d step.
//   Shared memory at D <= 128: 225 KB for 128 q rows (2 warpgroups, one
//   CTA an SM) over 32-row chunks; D = 256 runs 64 q rows (1 warpgroup)
//   over 16-row chunks.
//   What holds it back (PERF.md): S. Its wgmma are 64 x 32, one chunk
//   wide, and each reads its q tile from shared memory again; leaving out
//   the products of S saves more time than leaving out P V (64 x D, A in
//   registers) or the split of each chunk, which sits between the two
//   barriers. Larger chunks need the shared memory that the split q tile
//   holds; q hi in registers with two tile buffers, to overlap the split
//   with the products, took 254 registers a thread and gained nothing.
//   Causal: a warpgroup skips the chunks wholly above its 64 rows, and a
//   CTA stops at its last row. That is exact: every score of such a chunk
//   is -1e30, whose exp(-1e30 - m) is 0 in fp32 for the finite m that the
//   first chunk (column 0 is always visible) already set, so it leaves m,
//   l and acc unchanged. The heaviest q tiles (last rows) are launched
//   first, on one flat grid over (q tile, bh), bh fastest, so BH is not
//   held to gridDim.y's 65535.
//   Ragged S and D: rows past S are zero-filled and not stored, columns
//   past S score -inf; D is a multiple of 4 and the columns past it are
//   zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

template <typename T, int DMAX, int WGS, int KV>
struct Tile {
  static constexpr int kWgs = WGS;             // warpgroups
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kRows = 64 * WGS;       // q rows per CTA
  static constexpr int kKv = KV;               // K/V rows per chunk
  static constexpr int kKc = DMAX / 4;         // core columns of a q, K row
  static constexpr int kKcV = KV / 4;          // core columns of a V^T row
  static constexpr int kLdRaw = DMAX + 16 / (int)sizeof(T);  // raw row
  static constexpr bool kSplit = std::is_same<T, float>::value;
  // shared memory: q hi, q lo (kRows x DMAX floats); K hi, K lo (KV x
  // DMAX); V^T hi, V^T lo (DMAX x KV); the raw stage, K then V rows of
  // kLdRaw elements of T
  static constexpr int kQ = kRows * DMAX;
  static constexpr int kK = KV * DMAX;
  static constexpr int kSmemBytes =
      4 * (2 * kQ + 4 * kK) + 2 * KV * kLdRaw * (int)sizeof(T);
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo, both TF32; exact (lo = 0) for a bfloat16 x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void store_split(float* hi, float* lo, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
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

// 4 elements from global memory into shared memory, zeros when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma m64nNk8, TF32 in, fp32 accumulate: S (A and B in shared memory,
// scale_d = 0 overwrites d) and P V (A in registers, B in shared memory)

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// The copies of one K/V chunk (rows k0 .. k0 + kKv) into the raw stage,
// 4 elements of one row each, consecutive threads on consecutive columns;
// columns past D and rows past S are zero-filled.
template <class L, int DMAX, typename T>
__device__ __forceinline__ void issue_chunk(T* raw, const T* k, const T* v,
                                            int k0, int S, int D) {
  constexpr int kC4 = DMAX / 4;
#pragma unroll
  for (int u = threadIdx.x; u < 2 * L::kKv * kC4; u += L::kThreads) {
    const int row = u / kC4, c = (u % kC4) * 4;
    const int r = row % L::kKv;
    const bool ok = k0 + r < S && c < D;
    const T* src = (row < L::kKv ? k : v) +
                   (ok ? (long long)(k0 + r) * D + c : 0);
    cp_async4(raw + row * L::kLdRaw + c, src, ok);
  }
}

// The raw chunk into the split tiles: K (kv rows, d along K) and V^T (d
// rows, kv along K in the order 0, 2, 4, 6, 1, 3, 5, 7 of each 8-step).
// Consecutive threads take consecutive rows of a tile, so the 16-byte
// stores into a core matrix are free of bank conflicts.
template <class L, int DMAX, typename T>
__device__ __forceinline__ void split_chunk(const T* raw, float* k_hi,
                                            float* k_lo, float* v_hi,
                                            float* v_lo) {
  constexpr int kC4 = DMAX / 4;
#pragma unroll
  for (int u = threadIdx.x; u < L::kKv * kC4; u += L::kThreads) {
    const int r = u % L::kKv, c = (u / L::kKv) * 4;
    const int at = core_at(r, c, L::kKc);
    store_split(k_hi + at, k_lo + at, load4(raw + r * L::kLdRaw + c));
  }
  const T* rv = raw + L::kKv * L::kLdRaw;
#pragma unroll
  for (int u = threadIdx.x; u < DMAX * (L::kKv / 4); u += L::kThreads) {
    const int d = u % DMAX, p = (u / DMAX) * 4;    // positions p .. p + 3
    const int r0 = (p & ~7) + ((p >> 2) & 1);      // kv of position p
    const T* col = rv + r0 * L::kLdRaw + d;
    const float4 x = make_float4(
        to_float(col[0]), to_float(col[2 * L::kLdRaw]),
        to_float(col[4 * L::kLdRaw]), to_float(col[6 * L::kLdRaw]));
    const int at = core_at(d, p, L::kKcV);
    store_split(v_hi + at, v_lo + at, x);
  }
}

template <typename T, int DMAX, int WGS, int KV>
__global__ void __launch_bounds__(128 * WGS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out,
                       int bh, int S, int D, float scale, int causal) {
  using L = Tile<T, DMAX, WGS, KV>;
  constexpr int kNs = KV / 8;        // 8-column blocks of S = kv steps
  constexpr int kNo = DMAX / 8;      // 8-column blocks of O
  extern __shared__ __align__(128) float smem[];
  float* q_hi = smem;
  float* q_lo = q_hi + L::kQ;
  float* k_hi = q_lo + L::kQ;
  float* k_lo = k_hi + L::kK;
  float* v_hi = k_lo + L::kK;
  float* v_lo = v_hi + L::kK;
  T* raw = reinterpret_cast<T*>(v_lo + L::kK);

  const int n_tiles = (S + L::kRows - 1) / L::kRows;
  const int tile = (int)(blockIdx.x / (unsigned)bh);
  const int q0 = (n_tiles - 1 - tile) * L::kRows;
  const long long base =
      (long long)(blockIdx.x - (unsigned)tile * (unsigned)bh) * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const int k_end = causal ? min(S, q0 + L::kRows) : S;
  const int n_chunks = (k_end + KV - 1) / KV;
  const int n_steps = (D + 7) / 8;                   // 8-wide d steps

  issue_chunk<L, DMAX>(raw, kb, vb, 0, S, D);
  cp_async_commit();

  // the q tile, split once; rows past S and columns past D are zeros
  for (int u = threadIdx.x; u < L::kRows * (DMAX / 4); u += L::kThreads) {
    const int r = u % L::kRows, c = (u / L::kRows) * 4;
    const float4 x = q0 + r < S && c < D
        ? load4(q + base + (long long)(q0 + r) * D + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const int at = core_at(r, c, L::kKc);
    store_split(q_hi + at, q_lo + at, x);
  }

  // warpgroup w owns rows q0 + 64w ..; its warp i rows + 16i + g (+ 8)
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const bool wg_live = wg_first < S;
  const int row0 = wg_first + 16 * warp + g, row1 = row0 + 8;
  const uint64_t dq_hi = smem_desc(q_hi + 64 * wg * DMAX, L::kKc);
  const uint64_t dq_lo = smem_desc(q_lo + 64 * wg * DMAX, L::kKc);
  const uint64_t dk_hi = smem_desc(k_hi, L::kKc);
  const uint64_t dk_lo = smem_desc(k_lo, L::kKc);
  const uint64_t dv_hi = smem_desc(v_hi, L::kKcV);
  const uint64_t dv_lo = smem_desc(v_lo, L::kKcV);

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;

  for (int j = 0; j < n_chunks; ++j) {
    cp_async_wait_all();
    __syncthreads();   // chunk j has landed; every warpgroup is done with
                       // the tiles of chunk j - 1
    split_chunk<L, DMAX>(raw, k_hi, k_lo, v_hi, v_lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // chunk j is split, the raw stage is free
    if (j + 1 < n_chunks)
      issue_chunk<L, DMAX>(raw, kb, vb, (j + 1) * KV, S, D);
    cp_async_commit();
    const int k0 = j * KV;
    if (!wg_live || (causal && k0 > wg_last)) continue;

    // S = Q K^T, one d step (two core columns, 256 bytes) at a time; the
    // small terms (lo.hi + hi.lo) in an accumulator of their own, added to
    // the big one (hi.hi) after the last step
    float s[KV / 2], s_small[KV / 2];
    wgmma_fence();
    for (int ks = 0; ks < n_steps; ++ks) {
      const uint64_t step = (uint64_t)(16 * ks);    // 256 bytes >> 4
      if constexpr (L::kSplit) {
        wgmma_ss(s_small, dq_lo + step, dk_hi + step, ks > 0);
        wgmma_ss(s_small, dq_hi + step, dk_lo + step, 1);
      }
      wgmma_ss(s, dq_hi + step, dk_hi + step, ks > 0);
    }
    wgmma_commit_wait();
    if constexpr (L::kSplit) {
#pragma unroll
      for (int i = 0; i < KV / 2; ++i) s[i] += s_small[i];
    }

    // scale, then mask; online softmax over the chunk. s[4n + e] is row
    // (e < 2 ? row0 : row1), column k0 + 8n + 2t + (e & 1).
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float val = s[4 * n + e] * scale;
        if (causal && col > row) val = kNegInf;
        if (col >= S) val = -INFINITY;
        s[4 * n + e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      s[4 * n] = expf(s[4 * n] - mn0);
      s[4 * n + 1] = expf(s[4 * n + 1] - mn0);
      s[4 * n + 2] = expf(s[4 * n + 2] - mn1);
      s[4 * n + 3] = expf(s[4 * n + 3] - mn1);
      sum0 += s[4 * n] + s[4 * n + 1];
      sum1 += s[4 * n + 2] + s[4 * n + 3];
    }
    // l stays a per-lane partial sum (alpha is the same on the quad); the
    // quad's partials are added once, at the end
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      o[4 * n] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }

    // O += P V. kv step n: k = t is column 8n + 2t, k = t + 4 column
    // 8n + 2t + 1, so the A fragment of P is S's accumulator fragment as it
    // stands: (row0, k=t), (row1, k=t), (row0, k=t+4), (row1, k=t+4).
    // The A registers of every step are set before the first wgmma reads
    // them and stay untouched until the last one is done.
    uint32_t ph[kNs][4], pl[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      split_tf32(s[4 * n], ph[n][0], pl[n][0]);
      split_tf32(s[4 * n + 2], ph[n][1], pl[n][1]);
      split_tf32(s[4 * n + 1], ph[n][2], pl[n][2]);
      split_tf32(s[4 * n + 3], ph[n][3], pl[n][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < kNs; ++n) {
      const uint64_t step = (uint64_t)(16 * n);     // 256 bytes >> 4
      wgmma_rs(o, pl[n], dv_hi + step);
      if constexpr (L::kSplit) wgmma_rs(o, ph[n], dv_lo + step);
      wgmma_rs(o, ph[n], dv_hi + step);
    }
    wgmma_commit_wait();
  }

  if (!wg_live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kNo; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < D) {
      if (row0 < S)
        *reinterpret_cast<float2*>(out + base + (long long)row0 * D + col) =
            make_float2(o[4 * n] / den0, o[4 * n + 1] / den0);
      if (row1 < S)
        *reinterpret_cast<float2*>(out + base + (long long)row1 * D + col) =
            make_float2(o[4 * n + 2] / den1, o[4 * n + 3] / den1);
    }
  }
}

template <typename T, int DMAX, int WGS, int KV>
int launch(const void* q, const void* k, const void* v, float* out, int bh,
           int S, int D, float scale, int causal, cudaStream_t stream) {
  using L = Tile<T, DMAX, WGS, KV>;
  auto* kernel = flash_attention_kernel<T, DMAX, WGS, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)((S + L::kRows - 1) / L::kRows) * bh;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, bh, S, D, scale, causal);
  return (int)cudaGetLastError();
}

// D <= 128: 128 q rows (2 warpgroups) over 32-row chunks; D = 256: 64 q
// rows (1 warpgroup) over 16-row chunks, to fit the split q tile in shared
// memory. The wrapper's cta_rows(D) mirrors this.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* out, int bh,
             int S, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 2, 32>(q, k, v, out, bh, S, D, scale, causal,
                                stream);
  if (D <= 64)
    return launch<T, 64, 2, 32>(q, k, v, out, bh, S, D, scale, causal,
                                stream);
  if (D <= 128)
    return launch<T, 128, 2, 32>(q, k, v, out, bh, S, D, scale, causal,
                                 stream);
  return launch<T, 256, 1, 16>(q, k, v, out, bh, S, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention(const void* q, const void* k, const void* v, float* out,
                    int bh, int S, int D, float scale, int causal, int dtype,
                    cudaStream_t stream) {
  if (bh <= 0 || S <= 0 || D < 4 || D > 256 || D % 4 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dtype == 0
      ? dispatch<float>(q, k, v, out, bh, S, D, scale, causal, stream)
      : dispatch<__nv_bfloat16>(q, k, v, out, bh, S, D, scale, causal,
                                stream);
}

}  // extern "C"

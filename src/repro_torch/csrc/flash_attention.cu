// Online-softmax attention (FlashAttention dataflow) for Hopper (sm_90a),
// CUDA C++.
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
//   Operations: 4*S*S*D per (b, h) (half of it under the causal mask)
//   against 4*S*D*4 bytes of q, k, v and out. At S=4096, D=128 that is
//   ~1,000 FLOP per byte, far above the fp32 ridge (67 TFLOP/s over
//   3.35 TB/s = 20), so fp32 FMAs on CUDA cores are the limit.
//
// What the design does about it
//   The TPU grid walks K/V tiles as a sequential axis with the running
//   statistics in VMEM scratch; here one CTA of 256 threads owns one
//   64-row q tile of one (b, h) and loops over the 64-row K/V chunks
//   itself. The q tile stays in shared memory; each K and V chunk is
//   loaded once per CTA (converted to fp32) and used by all 64 rows. The
//   (64 x 64) score tile is a 4x4 micro-tile per thread (rows ty + 16 i,
//   columns tx + 16 j), so each row's 64 scores sit in 16 lanes of one warp
//   and the row max and sum are warp shuffles. The probabilities go
//   through shared memory into P.V; each thread keeps 4 rows x 4*NJ
//   columns of the accumulator in registers (NJ = ceil(D / 64)), so D=128
//   needs 32 accumulators a thread and D=256 64. Rows are padded to D + 4
//   floats so float4 reads of 8 neighbouring rows hit distinct banks.
//   Shared memory: 3 * 64 * (D + 4) * 4 + 64 * 68 * 4 bytes, 212 KB at
//   D = 256.
//   Causal: K chunks that lie wholly above the diagonal are skipped. That
//   is exact: every one of their scores is -1e30, whose exp(-1e30 - m) is
//   0 in fp32 for the finite m that the first chunk (column 0 is always
//   visible) already set, so they leave m, l and acc unchanged. The
//   heaviest q tiles (last rows) are launched first.
//   A ragged S edge is masked: rows past S are not stored, columns past S
//   score -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // q rows per CTA and K/V rows per chunk
constexpr int kThreads = 256;
constexpr int kPs = kTile + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;

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

// rows [r0, r0 + 64) of a (S, D) matrix into a (64, ld) fp32 tile; rows
// past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int D, int ld) {
  const int per_row = D / 4;
  for (int q = threadIdx.x; q < kTile * per_row; q += kThreads) {
    const int r = q / per_row, c = (q - r * per_row) * 4;
    const float4 v = r0 + r < S
        ? load4(src + (long long)(r0 + r) * D + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out,
                       int bh, int S, int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 4;
  float* qs = smem;                    // (64, ld)
  float* ks = qs + kTile * ld;         // (64, ld)
  float* vs = ks + kTile * ld;         // (64, ld)
  float* ps = vs + kTile * ld;         // (64, kPs)

  // one flat grid over (q tile, bh) with bh fastest, so batch x heads is
  // not held to gridDim.y's 65535. Tiles run from the last (the longest
  // causal rows) to the first, across every bh.
  const int n_tiles = (S + kTile - 1) / kTile;
  const int tile = (int)(blockIdx.x / (unsigned)bh);
  const int q0 = (n_tiles - 1 - tile) * kTile;
  const long long base =
      (long long)(blockIdx.x - (unsigned)tile * (unsigned)bh) * S * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(qs, q + base, q0, S, D, ld);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the previous chunk's P.V is done with ks, vs, ps
    load_tile(ks, k + base, k0, S, D, ld);
    load_tile(vs, v + base, k0, S, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = load4(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float val = s[i][j] * scale;            // scale, then mask
        if (causal && c > r) val = kNegInf;
        if (c >= S) val = -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kTile; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = load4(ps + (ty + 16 * i) * kPs + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NJ; ++g) {
          const int c = 64 * g + tx * 4;
          if (c < D) {
            const float4 b = load4(vs + (j + jj) * ld + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pv = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                             : jj == 2 ? p[i].z : p[i].w;
              acc[i][4 * g + 0] = fmaf(pv, b.x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = fmaf(pv, b.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(pv, b.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(pv, b.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + base + (long long)r * D;
#pragma unroll
    for (int g = 0; g < NJ; ++g) {
      const int c = 64 * g + tx * 4;
      if (c < D)
        *reinterpret_cast<float4*>(o + c) = make_float4(
            acc[i][4 * g + 0] / denom, acc[i][4 * g + 1] / denom,
            acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, float* out, int bh,
           int S, int D, float scale, int causal, cudaStream_t stream) {
  const int smem = (3 * kTile * (D + 4) + kTile * kPs) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((S + kTile - 1) / kTile) * (unsigned)bh;
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, bh, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* out, int bh,
             int S, int D, float scale, int causal, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, bh, S, D, scale, causal, stream);
    case 2: return launch<T, 2>(q, k, v, out, bh, S, D, scale, causal, stream);
    case 3: return launch<T, 3>(q, k, v, out, bh, S, D, scale, causal, stream);
    default:
      return launch<T, 4>(q, k, v, out, bh, S, D, scale, causal, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike). Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention(const void* q, const void* k, const void* v, float* out,
                    int bh, int S, int D, float scale, int causal, int dtype,
                    cudaStream_t stream) {
  // the flat grid holds at most 2^31 - 1 CTAs
  if (bh <= 0 || S <= 0 || D < 4 || D > 256 || D % 4 != 0 ||
      (long long)((S + kTile - 1) / kTile) * bh > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dtype == 0
      ? dispatch<float>(q, k, v, out, bh, S, D, scale, causal, stream)
      : dispatch<__nv_bfloat16>(q, k, v, out, bh, S, D, scale, causal,
                                stream);
}

}  // extern "C"

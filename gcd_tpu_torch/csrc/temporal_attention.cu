// K2: frame-axis (temporal) self-attention on the natural (B*T, S, C)
// layout, for Hopper (sm_90a).
//
// Replaces gcd_tpu/ops/temporal_attention.py::_kernel (pallas_call in
// _pallas_fwd, entry temporal_attention). For every video b, spatial
// position s and head h, the T frames attend to each other:
//     s_tt' = (q_t . k_t') * scale          in fp32
//     p_tt' = exp(s_tt' - max_t' s_tt')     (fp32, unnormalised)
//     o_t   = (sum_t' bf16(p_tt') v_t') / sum_t' p_tt'
// with the exact fp32 softmax of the reference.
//
// What bounds it: memory. Each (b, s, h) item is a 14 x 14 x 64 problem --
// 25 KFLOP against 5.4 KB of q/k/v/o traffic, about 5 FLOP per byte, far
// below the H100's ridge point -- so the design goal is to read q/k/v once
// and write o once, without the (B*T,S,C) <-> (B*S,T,C) relayouts of the
// plain version. One warp owns one (b, s, h) item: lanes read each frame's
// D channels as bf16 pairs (a 128-byte coalesced row per frame), stage them
// in shared memory as fp32 rows padded to D+1 floats (conflict-free column
// walks), compute the T x T scores with lane pair (2t, 2t+1) owning query
// frame t, and write the output back as coalesced bf16 pairs. Consecutive
// warps take consecutive heads of one position, so a block reads 4*D
// contiguous channels of every frame. The TPU's 8-position striped-mask
// packing and head-pair packing were MXU-shape workarounds and are not
// carried over.
//
// Requires T <= 16, D = C / H even and <= 128 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int MAXT = 16;

__host__ __device__ inline int floats_per_warp(int T, int D) {
  return 3 * T * (D + 1) + MAXT * MAXT + MAXT;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int B, int T, int S, int C, int H, float scale) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = C / H;
  const int LDD = D + 1;
  const long item = (long)blockIdx.x * WARPS + warp;
  if (item >= (long)B * S * H) return;  // no block-wide barriers below
  const int h = (int)(item % H);
  const int s = (int)((item / H) % S);
  const int b = (int)(item / ((long)H * S));

  float* qs = sm + warp * floats_per_warp(T, D);
  float* ks = qs + T * LDD;
  float* vs = ks + T * LDD;
  float* P = vs + T * LDD;    // MAXT x MAXT
  float* den = P + MAXT * MAXT;

  const size_t frame_stride = (size_t)S * C;
  const size_t base = ((size_t)b * T * S + s) * C + (size_t)h * D;

  for (int t = 0; t < T; ++t) {
    const size_t off = base + t * frame_stride;
    for (int dd = 2 * lane; dd < D; dd += 64) {
      const float2 fq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + off + dd));
      const float2 fk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + off + dd));
      const float2 fv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + off + dd));
      qs[t * LDD + dd] = fq.x; qs[t * LDD + dd + 1] = fq.y;
      ks[t * LDD + dd] = fk.x; ks[t * LDD + dd + 1] = fk.y;
      vs[t * LDD + dd] = fv.x; vs[t * LDD + dd + 1] = fv.y;
    }
  }
  __syncwarp();

  // Scores: lane pair (2t, 2t+1) owns query frame t; the lane with parity
  // `half` takes key frames half, half+2, ...
  const int t = lane >> 1;
  const int half = lane & 1;
  const bool active = t < T;
  float sc[MAXT / 2];
  float mx = -3.4e38f;
#pragma unroll
  for (int j = 0; j < MAXT / 2; ++j) {
    const int tp = half + 2 * j;
    sc[j] = -3.4e38f;
    if (active && tp < T) {
      float dot = 0.0f;
      for (int dd = 0; dd < D; ++dd) dot += qs[t * LDD + dd] * ks[tp * LDD + dd];
      sc[j] = dot * scale;
      mx = fmaxf(mx, sc[j]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXT / 2; ++j) {
    const int tp = half + 2 * j;
    if (active && tp < T) {
      const float p = expf(sc[j] - mx);
      sum += p;
      P[t * MAXT + tp] = bf16_round(p);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (active && half == 0) den[t] = sum;
  __syncwarp();

  // Output: each lane owns channel pairs (2*lane + 64*i) of every frame.
  for (int tq = 0; tq < T; ++tq) {
    const float denom = den[tq];
    const size_t off = base + tq * frame_stride;
    for (int dd = 2 * lane; dd < D; dd += 64) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int tp = 0; tp < T; ++tp) {
        const float p = P[tq * MAXT + tp];
        a0 += p * vs[tp * LDD + dd];
        a1 += p * vs[tp * LDD + dd + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(o + off + dd) =
          __floats2bfloat162_rn(a0 / denom, a1 / denom);
    }
  }
}

}  // namespace

extern "C" int gcd_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                      int BT, int T, int S, int C, int H, float scale,
                                      void* stream) {
  if (T <= 0 || T > MAXT || H <= 0 || C % H || BT % T || S <= 0) return (int)cudaErrorInvalidValue;
  const int D = C / H;
  if (D % 2 || D > 128) return (int)cudaErrorInvalidValue;
  const int B = BT / T;
  const size_t smem = (size_t)WARPS * floats_per_warp(T, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long items = (long)B * S * H;
  const unsigned blocks = (unsigned)((items + WARPS - 1) / WARPS);
  temporal_attention_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, B, T, S, C, H, scale);
  return (int)cudaGetLastError();
}

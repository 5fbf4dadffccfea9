// K3: fused GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces gcd_tpu/ops/fused_mlp.py::_kernel (pallas_call in _fused_forward,
// entry geglu_mlp). Computes, for x (M, C), W1 (2I, C) = [value ; gate] rows,
// b1 (2I), W2 (Cout, I), b2 (Cout), all bf16, torch Linear layouts:
//     a = bf16(bf16(x @ Wv^T) + bv)          g = bf16(bf16(x @ Wg^T) + bg)
//     h = bf16(a * gelu_erf(g))              out = bf16(h @ W2^T + b2)
// with fp32 accumulation in every product -- the rounding points of the TPU
// kernel (fused_mlp.py:116-121), with exact erf GELU.
//
// What bounds it: the two products are tensor-core work above the H100's
// ridge point; the traffic the fusion removes is the (M, 2I) bf16
// up-projection (440 MB written and read back per ds1 call at M = 43008).
// On the TPU one grid step carried the (tokens x C_out) fp32 accumulator in
// VMEM across the inner-tile axis. A 64 x 1280 fp32 accumulator is 320 KB,
// more than an SM has, so here the inner dimension I is split across blocks
// instead: block (r, s) owns 64 token rows and the inner slice
// [256 s, 256 s + 256). It computes its h slice (64 x 256 bf16) into shared
// memory -- the up-projection never leaves the SM -- then multiplies it by
// the matching W2 columns one 128-wide C_out tile at a time, and adds each
// fp32 partial into an (M, C_out) fp32 workspace with float4 atomics. A
// second small kernel adds b2 and rounds once to bf16. No product is
// recomputed; the only extra traffic is the fp32 partials (4 bytes per
// output per slice, L2-resident at these sizes). Operand tiles stream
// through a two-stage cp.async ring so loads overlap the WMMA bf16 products.
// The fp32 sum over slices is taken in atomic order, so the last bits of
// the output may differ from run to run.
//
// Requires C % 64 == 0, I % 256 == 0, Cout % 16 == 0 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;          // token rows per block
constexpr int IS = 256;         // inner slice per block
constexpr int BK = 64;          // depth of one staged operand tile
constexpr int BN = 128;         // C_out tile of the down product
constexpr int LDT = BK + 8;     // leading dim of staged tiles (bf16)
constexpr int LDH = IS + 8;     // leading dim of the h slice (bf16)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

constexpr int H_BYTES = BM * LDH * 2;                    // 33,792
constexpr int UP_STAGE = 3 * BM * LDT * 2;               // x, Wv, Wg: 27,648
constexpr int DOWN_STAGE = BN * LDT * 2;                 // W2: 18,432
constexpr int RING_BYTES = 2 * UP_STAGE;                 // >= 2 * DOWN_STAGE
constexpr int EPI_BYTES = NWARPS * 2 * 256 * 4;          // 16,384
constexpr int SMEM_BYTES = H_BYTES + RING_BYTES + EPI_BYTES;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy a (rows x 64) bf16 tile starting at src (row stride ld) into dst
// (row stride LDT); rows at or past `valid` are zero-filled.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int rows, int valid,
                                           size_t ld) {
  for (int e = threadIdx.x; e < rows * (BK / 8); e += NTHREADS) {
    const int r = e / (BK / 8), c = e % (BK / 8);
    const bool ok = r < valid;
    cp_async16(dst + r * LDT + c * 8, ok ? src + (size_t)r * ld + c * 8 : src, ok);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
geglu_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 float* __restrict__ ws, int M, int C, int I, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + H_BYTES;
  float* epi = reinterpret_cast<float*>(smem + H_BYTES + RING_BYTES);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  const int i0 = blockIdx.y * IS;
  const int rt = warp % 4;           // 16-row tile of this warp
  const int cg = warp / 4;           // column group of this warp
  float* sa = epi + warp * 512;
  float* sg = sa + 256;
  const int valid_rows = M - row0;

  // ---- Phase 1: h[:, 0:IS] = bf16(a * gelu(g)) in shared memory ----------
  const int nk = C / BK;
  for (int sub = 0; sub < IS / 64; ++sub) {
    const int ib = i0 + sub * 64;  // first inner column of this 64-wide step
    auto stage_up = [&](int buf, int kc) {
      bf16* xs = reinterpret_cast<bf16*>(ring + buf * UP_STAGE);
      bf16* wv = xs + BM * LDT;
      bf16* wg = wv + BM * LDT;
      const int k0 = kc * BK;
      stage_tile(xs, x + (size_t)row0 * C + k0, BM, valid_rows, C);
      stage_tile(wv, w1 + (size_t)ib * C + k0, 64, 64, C);
      stage_tile(wg, w1 + (size_t)(I + ib) * C + k0, 64, 64, C);
      cp_async_commit();
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fa[2], fg[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      wmma::fill_fragment(fa[u], 0.0f);
      wmma::fill_fragment(fg[u], 0.0f);
    }
    stage_up(0, 0);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        stage_up((kc + 1) & 1, kc + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* xs = reinterpret_cast<const bf16*>(ring + (kc & 1) * UP_STAGE);
      const bf16* wv = xs + BM * LDT;
      const bf16* wg = wv + BM * LDT;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fx;
        wmma::load_matrix_sync(fx, xs + rt * 16 * LDT + kk, LDT);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ct = 2 * cg + u;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fw;
          wmma::load_matrix_sync(fw, wv + ct * 16 * LDT + kk, LDT);
          wmma::mma_sync(fa[u], fx, fw, fa[u]);
          wmma::load_matrix_sync(fw, wg + ct * 16 * LDT + kk, LDT);
          wmma::mma_sync(fg[u], fx, fw, fg[u]);
        }
      }
      __syncthreads();
    }
    // Bias + GELU, rounded where the TPU kernel rounds.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ct = 2 * cg + u;
      wmma::store_matrix_sync(sa, fa[u], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(sg, fg[u], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        const int i = ib + ct * 16 + c;
        const float a = bf16_round(bf16_round(sa[e]) + __bfloat162float(b1[i]));
        const float g = bf16_round(bf16_round(sg[e]) + __bfloat162float(b1[I + i]));
        const float gelu = 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
        hs[(rt * 16 + r) * LDH + sub * 64 + ct * 16 + c] = __float2bfloat16(a * gelu);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // h slice complete

  // ---- Phase 2: ws[:, o-tile] += h @ W2[o-tile, i0:i0+IS]^T --------------
  const int n_ot = (Cout + BN - 1) / BN;
  const int nkd = IS / BK;
  const int n_iter = n_ot * nkd;
  auto stage_down = [&](int buf, int it) {
    bf16* w2s = reinterpret_cast<bf16*>(ring + buf * DOWN_STAGE);
    const int o0 = (it / nkd) * BN;
    const int k0 = i0 + (it % nkd) * BK;
    stage_tile(w2s, w2 + (size_t)o0 * I + k0, BN, Cout - o0, I);
    cp_async_commit();
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  stage_down(0, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int kc = it % nkd;
    const int o0 = (it / nkd) * BN;
    if (kc == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) wmma::fill_fragment(acc[u], 0.0f);
    }
    if (it + 1 < n_iter) {
      stage_down((it + 1) & 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w2s = reinterpret_cast<const bf16*>(ring + (it & 1) * DOWN_STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fh;
      wmma::load_matrix_sync(fh, hs + rt * 16 * LDH + kc * BK + kk, LDH);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ct = 4 * cg + u;
        if (o0 + ct * 16 < Cout) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fw;
          wmma::load_matrix_sync(fw, w2s + ct * 16 * LDT + kk, LDT);
          wmma::mma_sync(acc[u], fh, fw, acc[u]);
        }
      }
    }
    __syncthreads();
    if (kc == nkd - 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int o = o0 + (4 * cg + u) * 16;
        if (o >= Cout) continue;
        wmma::store_matrix_sync(sa, acc[u], 16, wmma::mem_row_major);
        __syncwarp();
        for (int v = lane; v < 64; v += 32) {
          const int r = v / 4, c4 = (v % 4) * 4;
          const int gr = row0 + rt * 16 + r;
          if (gr < M) {
            const float* p = sa + r * 16 + c4;
            atomicAdd(reinterpret_cast<float4*>(ws + (size_t)gr * Cout + o + c4),
                      make_float4(p[0], p[1], p[2], p[3]));
          }
        }
        __syncwarp();
      }
    }
  }
}

// out = bf16(ws + b2), two outputs per thread.
__global__ void bias_round_kernel(const float* __restrict__ ws, const bf16* __restrict__ b2,
                                  bf16* __restrict__ out, long n2, int Cout) {
  for (long p = blockIdx.x * (long)blockDim.x + threadIdx.x; p < n2;
       p += (long)gridDim.x * blockDim.x) {
    const long e = 2 * p;
    const int o = (int)(e % Cout);
    const float2 v = *reinterpret_cast<const float2*>(ws + e);
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(
        v.x + __bfloat162float(b2[o]), v.y + __bfloat162float(b2[o + 1]));
  }
}

}  // namespace

extern "C" int gcd_geglu_mlp(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* workspace, void* out,
                             int M, int C, int I, int Cout, void* stream) {
  if (M <= 0 || C % BK || I % IS || Cout % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(workspace, 0, (size_t)M * Cout * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, I / IS);
  geglu_mlp_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
      (float*)workspace, M, C, I, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n2 = (long)M * Cout / 2;
  const int blocks = (int)((n2 + 255) / 256 < 4096 ? (n2 + 255) / 256 : 4096);
  bias_round_kernel<<<blocks, 256, 0, s>>>((const float*)workspace, (const bf16*)b2,
                                           (bf16*)out, n2, Cout);
  return (int)cudaGetLastError();
}

extern "C" const char* gcd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

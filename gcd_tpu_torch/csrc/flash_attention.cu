// K1: multi-head self-attention on the natural (B, S, H*D) layout, for
// Hopper (sm_90a).
//
// Replaces gcd_tpu/ops/flash_attention.py::_mh_kernel (pallas_call in
// _flash_fwd, entry flash_attention). Per (batch, head, query row):
//     s_j = (q . k_j) * scale  in fp32, s_j = -1e30 for j >= Skv
//     p_j = exp(s_j - max_j s_j)                    (fp32, unnormalised)
//     o   = (sum_j bf16(p_j) * v_j) / sum_j p_j     (fp32 accumulation)
// -- the TPU kernel's numerics: exact full-row softmax, P cast to bf16 for
// the PV product, division after PV (flash_attention.py:43-52,113-127).
//
// What bounds it: at the UNet's shapes (S 24..1536, D 64, 5..20 heads) the
// QK^T and PV products are tensor-core work; the S x S score matrix is the
// traffic to avoid (1.3 GB fp32 per ds1 call in the plain version). This
// kernel never writes scores to HBM. A block owns 64 query rows of one
// (batch, head): 4 warps, 16 rows each, Q held in WMMA fragments. It walks
// the keys twice in tiles of 32: pass 1 keeps the running row max and the
// rescaled row sum; pass 2 recomputes the scores, forms P = exp(s - max)
// against the final max (so P, and its bf16 rounding, are exactly the
// reference's) and accumulates P V in fp32 fragments. The extra QK^T pass
// costs 1.5x the minimal FLOPs and buys bit-faithful P. q/k/v are read in
// place with the head offset h*D; there are no head transposes, and the
// ragged Sq/Skv edges are zero-filled in shared memory and masked here
// rather than padded in HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QROWS = 64;   // query rows per block (4 warps x 16)
constexpr int KT = 32;      // keys per staged tile
constexpr int LDS = KT + 4; // fp32 score tile leading dim
constexpr int LDP = KT + 8; // bf16 P tile leading dim
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(QROWS + 2 * KT) * (D + 8) * sizeof(bf16) +
         4 * 16 * LDS * sizeof(float) + 4 * 16 * LDP * sizeof(bf16);
}

// Copy `rows` rows of D bf16 (row stride `ld_src` elements) into shared
// memory (row stride D + 8), zero-filling rows at or past `valid`.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows,
                                           int valid, int ld_src) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < rows * V; e += blockDim.x) {
    const int r = e / V, c = e % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld_src + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int Sq, int Skv, int H, float scale) {
  constexpr int LDQ = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + QROWS * LDQ;
  bf16* Vs = Ks + KT * LDQ;
  float* Sall = reinterpret_cast<float*>(Vs + KT * LDQ);
  bf16* Pall = reinterpret_cast<bf16*>(Sall + 4 * 16 * LDS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = Sall + warp * 16 * LDS;
  bf16* Pw = Pall + warp * 16 * LDP;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int HD = H * D;
  const bf16* qb = q + (size_t)b * Sq * HD + h * D;
  const bf16* kb = k + (size_t)b * Skv * HD + h * D;
  const bf16* vb = v + (size_t)b * Skv * HD + h * D;
  bf16* ob = o + (size_t)b * Sq * HD + h * D;

  stage_rows<D>(Qs, qb + (size_t)q0 * HD, QROWS, Sq - q0, HD);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::load_matrix_sync(fq[j], Qs + warp * 16 * LDQ + j * 16, LDQ);

  // Scaled, masked 16 x KT score tile of this warp into Sw.
  auto scores = [&]() {
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
      wmma::fill_fragment(fs, 0.0f);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + n * 16 * LDQ + j * 16, LDQ);
        wmma::mma_sync(fs, fq[j], fk, fs);
      }
      wmma::store_matrix_sync(Sw + n * 16, fs, LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // Lane pair (2r, 2r+1) owns query row r of the warp's 16; each lane half
  // of the tile's columns.
  const int row = lane >> 1;
  const int c0 = (lane & 1) * (KT / 2);
  float m = -3.4e38f, l = 0.0f;

  // Pass 1: row max and row sum of exp(s - max).
  for (int kv0 = 0; kv0 < Skv; kv0 += KT) {
    __syncthreads();
    stage_rows<D>(Ks, kb + (size_t)kv0 * HD, KT, Skv - kv0, HD);
    __syncthreads();
    scores();
    float tmax = -3.4e38f;
#pragma unroll
    for (int c = 0; c < KT / 2; ++c) {
      float s = Sw[row * LDS + c0 + c] * scale;
      if (kv0 + c0 + c >= Skv) s = NEG_INF;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mnew = fmaxf(m, tmax);
    float tsum = 0.0f;
#pragma unroll
    for (int c = 0; c < KT / 2; ++c) {
      float s = Sw[row * LDS + c0 + c] * scale;
      if (kv0 + c0 + c >= Skv) s = NEG_INF;
      tsum += expf(s - mnew);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - mnew) + tsum;
    m = mnew;
    __syncwarp();
  }

  // Pass 2: P = bf16(exp(s - max)), O += P V.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(fo[j], 0.0f);
  for (int kv0 = 0; kv0 < Skv; kv0 += KT) {
    __syncthreads();
    stage_rows<D>(Ks, kb + (size_t)kv0 * HD, KT, Skv - kv0, HD);
    stage_rows<D>(Vs, vb + (size_t)kv0 * HD, KT, Skv - kv0, HD);
    __syncthreads();
    scores();
#pragma unroll
    for (int c = 0; c < KT / 2; ++c) {
      float s = Sw[row * LDS + c0 + c] * scale;
      if (kv0 + c0 + c >= Skv) s = NEG_INF;
      Pw[row * LDP + c0 + c] = __float2bfloat16(expf(s - m));
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, Pw + n * 16, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + n * 16 * LDQ + j * 16, LDQ);
        wmma::mma_sync(fo[j], fp, fv, fo[j]);
      }
    }
    __syncwarp();
  }

  // O / l, one rounding to bf16, written in place at the head's offset.
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(Sw, fo[j], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      const float lr = __shfl_sync(0xffffffffu, l, 2 * r);
      const int gq = q0 + warp * 16 + r;
      if (gq < Sq) ob[(size_t)gq * HD + j * 16 + c] = __float2bfloat16(Sw[r * LDS + c] / lr);
    }
    __syncwarp();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + QROWS - 1) / QROWS, H, B);
  flash_attention_kernel<D><<<grid, 128, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Skv, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcd_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int D, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch<64>(q, k, v, o, B, Sq, Skv, H, scale, (cudaStream_t)stream);
  if (D == 128) return launch<128>(q, k, v, o, B, Sq, Skv, H, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

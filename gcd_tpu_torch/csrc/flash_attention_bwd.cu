// K6: the backward of multi-head self-attention on the natural (B, S, H*D)
// layout, for Hopper (sm_90a).
//
// Replaces gcd_tpu/ops/flash_attention.py::_bwd_kernel (pallas_call in
// _flash_bwd_rows, entry flash_attention_bwd). Per (batch, head), with
// s = (q k^T) scale in fp32 and dO the output's gradient:
//     P     = exp(s - rowmax) / rowsum         exact, normalised, fp32
//     dV    = P^T dO                           fp32
//     dP    = dO V^T                           fp32
//     delta = rowsum(dP * P)                   from the fp32 P
//     dS    = bf16(P (dP - delta) scale)
//     dQ    = dS K,  dK = dS^T Q               fp32 accumulation
// and dQ, dK, dV are rounded once to bf16 (flash_attention.py:240-261,
// 327-329). The forward's bf16 P is never used: the JAX backward recomputes.
//
// What bounds it: five S x S x D products per head (QK^T, dO V^T, P^T dO,
// dS K, dS^T Q) are tensor-core work; the S x S matrices are the traffic to
// avoid (several GB of fp32 per ds1 call in the plain version). Nothing
// S x S is written to HBM.
//
// Design. The TPU kernel carries dK / dV in VMEM from one grid step to the
// next; blocks on Hopper run in no order, so the work is split into three
// kernels, each looping inside the block, with no atomics (the result is
// bit-identical from call to call):
//   (a) stats: per 64 query rows, loop over key tiles: the row max and the
//       rescaled row sum of exp(s - max), and delta accumulated online
//       against the running max; written to a (3, B*H*S) fp32 scratch.
//   (b) dq:    per 64 query rows, loop over key tiles: P, dP, dS, dQ += dS K.
//   (c) dkdv:  per 64 keys, loop over query tiles: P^T and dP^T from K Q^T
//       and V dO^T, dV += P^T dO, dK += dS^T Q.
// Products run on WMMA bf16 fragments with fp32 accumulators (mma.sync).
// Q, K, V, dO and dS are bf16, so those products are exact in fp32 but for
// the order of the sums. P enters P^T dO as the sum of two bf16 terms,
// hi = bf16(P) and lo = bf16(P - hi), which carries 16 mantissa bits of the
// fp32 P (relative error below 2^-16) at twice the tensor-core work of that
// one product. q/k/v/dO are read in place at head offset h*D; ragged edges
// are zero-filled in shared memory and masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;     // query rows (a, b) or keys (c) per block: 4 warps x 16
constexpr int TILE = 32;     // keys (a, b) or queries (c) per staged tile
constexpr int LDS = TILE + 4;  // fp32 per-warp tile leading dim
constexpr int LDP = TILE + 8;  // bf16 per-warp tile leading dim
constexpr float NEG_INF = -1e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// out (16 x TILE fp32, leading dim LDS) = A (16 x D rows at a, ld D + 8) times
// the transpose of B (TILE x D rows at b, ld D + 8).
template <int D>
__device__ __forceinline__ void product_abt(float* out, const bf16* a, const bf16* b) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + j * 16, LD);
      wmma::load_matrix_sync(fb, b + n * 16 * LD + j * 16, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[j] (16 x D) += A (16 x TILE bf16, ld LDP) times B (TILE x D rows at b,
// ld D + 8).
template <int D>
__device__ __forceinline__ void product_ab(FragC* acc, const bf16* a, const bf16* b) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + n * 16, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LD + j * 16, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Round the warp's 16 x D accumulator to bf16 and write rows < valid to
// dst (row stride ld_dst), through the warp's fp32 tile.
template <int D>
__device__ __forceinline__ void write_rows(bf16* dst, FragC* acc, float* tile, int valid,
                                           int ld_dst, int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(tile, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      if (r < valid) dst[(size_t)r * ld_dst + j * 16 + c] = __float2bfloat16(tile[r * LDS + c]);
    }
    __syncwarp();
  }
}

template <int D>
constexpr size_t smem_rows_kernel(bool ds) {  // (a) and (b)
  return (size_t)(2 * ROWS + 2 * TILE) * (D + 8) * sizeof(bf16) +
         4 * (2 * 16 * LDS * sizeof(float) + (ds ? 16 * LDP * sizeof(bf16) : 0));
}

template <int D>
constexpr size_t smem_dkdv() {  // (c)
  return (size_t)(2 * ROWS + 2 * TILE) * (D + 8) * sizeof(bf16) + 3 * TILE * sizeof(float) +
         4 * (2 * 16 * LDS * sizeof(float) + 3 * 16 * LDP * sizeof(bf16));
}

// (a) and (b): a block owns 64 query rows of one (batch, head). Lane pair
// (2r, 2r+1) owns row r of its warp's 16, each lane half of a tile's
// columns. With DQ false it writes the row statistics; with DQ true it reads
// them and accumulates dQ.
template <int D, bool DQ>
__global__ void __launch_bounds__(128)
rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            bf16* __restrict__ dq, float* __restrict__ stats, int S, int H, int BHS,
            float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + ROWS * LD;  // dO rows
  bf16* Ks = Os + ROWS * LD;
  bf16* Vs = Ks + TILE * LD;
  float* tiles = reinterpret_cast<float*>(Vs + TILE * LD);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = tiles + warp * 2 * 16 * LDS;  // scores
  float* Pw = Sw + 16 * LDS;                // dP
  bf16* DSw = reinterpret_cast<bf16*>(tiles + 4 * 2 * 16 * LDS) + warp * 16 * LDP;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int HD = H * D;
  const size_t head = (size_t)b * S * HD + h * D;
  stage_rows<D>(Qs, q + head + (size_t)q0 * HD, ROWS, S - q0, HD);
  stage_rows<D>(Os, dout + head + (size_t)q0 * HD, ROWS, S - q0, HD);

  const int row = lane >> 1, c0 = (lane & 1) * (TILE / 2);
  const int grow = q0 + warp * 16 + row;  // this lane pair's query row
  const size_t srow = ((size_t)b * H + h) * S + grow;
  float m = -3.4e38f, l = 0.0f, acc = 0.0f;  // (a): running max, sum, delta
  float inv_l = 0.0f, delta = 0.0f;          // (b)
  if (DQ && grow < S) {
    m = stats[srow];
    inv_l = 1.0f / stats[BHS + srow];
    delta = stats[2 * BHS + srow];
  }
  FragC fdq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(fdq[j], 0.0f);

  for (int kv0 = 0; kv0 < S; kv0 += TILE) {
    __syncthreads();
    stage_rows<D>(Ks, k + head + (size_t)kv0 * HD, TILE, S - kv0, HD);
    stage_rows<D>(Vs, v + head + (size_t)kv0 * HD, TILE, S - kv0, HD);
    __syncthreads();
    product_abt<D>(Sw, Qs + warp * 16 * LD, Ks);
    product_abt<D>(Pw, Os + warp * 16 * LD, Vs);
    __syncwarp();
    if (!DQ) {
      float tmax = -3.4e38f;
#pragma unroll
      for (int c = 0; c < TILE / 2; ++c) {
        const float s = kv0 + c0 + c < S ? Sw[row * LDS + c0 + c] * scale : NEG_INF;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float mnew = fmaxf(m, tmax);
      float tsum = 0.0f, tdot = 0.0f;
#pragma unroll
      for (int c = 0; c < TILE / 2; ++c) {
        const float s = kv0 + c0 + c < S ? Sw[row * LDS + c0 + c] * scale : NEG_INF;
        const float e = expf(s - mnew);
        tsum += e;
        tdot += e * Pw[row * LDS + c0 + c];
      }
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
      tdot += __shfl_xor_sync(0xffffffffu, tdot, 1);
      const float r = expf(m - mnew);
      l = l * r + tsum;
      acc = acc * r + tdot;
      m = mnew;
    } else {
#pragma unroll
      for (int c = 0; c < TILE / 2; ++c) {
        const int col = c0 + c;
        float ds = 0.0f;
        if (kv0 + col < S && grow < S) {
          const float p = expf(Sw[row * LDS + col] * scale - m) * inv_l;
          ds = p * (Pw[row * LDS + col] - delta) * scale;
        }
        DSw[row * LDP + col] = __float2bfloat16(ds);
      }
      __syncwarp();
      product_ab<D>(fdq, DSw, Ks);
    }
    __syncwarp();
  }

  if (!DQ) {
    if ((lane & 1) == 0 && grow < S) {
      stats[srow] = m;
      stats[BHS + srow] = l;
      stats[2 * BHS + srow] = acc / l;
    }
  } else {
    write_rows<D>(dq + head + (size_t)(q0 + warp * 16) * HD, fdq, Sw,
                  S - (q0 + warp * 16), HD, lane);
  }
}

// (c): a block owns 64 keys of one (batch, head); lane pair (2r, 2r+1) owns
// key r of its warp's 16, each lane half of a query tile's columns.
template <int D>
__global__ void __launch_bounds__(128)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ stats,
            int S, int H, int BHS, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + ROWS * LD;
  bf16* Qs = Vs + ROWS * LD;
  bf16* Os = Qs + TILE * LD;  // dO rows
  float* st = reinterpret_cast<float*>(Os + TILE * LD);  // max, 1/sum, delta per query
  float* tiles = st + 3 * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = tiles + warp * 2 * 16 * LDS;  // scores, transposed
  float* Pw = Sw + 16 * LDS;                // dP, transposed
  bf16* bt = reinterpret_cast<bf16*>(tiles + 4 * 2 * 16 * LDS) + warp * 3 * 16 * LDP;
  bf16* DSw = bt;                           // dS^T
  bf16* PHw = bt + 16 * LDP;                // bf16(P^T)
  bf16* PLw = bt + 2 * 16 * LDP;            // bf16(P^T - bf16(P^T))

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int HD = H * D;
  const size_t head = (size_t)b * S * HD + h * D;
  const size_t shead = ((size_t)b * H + h) * S;
  stage_rows<D>(Ks, k + head + (size_t)k0 * HD, ROWS, S - k0, HD);
  stage_rows<D>(Vs, v + head + (size_t)k0 * HD, ROWS, S - k0, HD);

  const int row = lane >> 1, c0 = (lane & 1) * (TILE / 2);
  FragC fdk[D / 16], fdv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(fdk[j], 0.0f);
    wmma::fill_fragment(fdv[j], 0.0f);
  }

  for (int q0 = 0; q0 < S; q0 += TILE) {
    __syncthreads();
    stage_rows<D>(Qs, q + head + (size_t)q0 * HD, TILE, S - q0, HD);
    stage_rows<D>(Os, dout + head + (size_t)q0 * HD, TILE, S - q0, HD);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const bool ok = q0 + i < S;
      st[i] = ok ? stats[shead + q0 + i] : 0.0f;
      st[TILE + i] = ok ? 1.0f / stats[BHS + shead + q0 + i] : 0.0f;
      st[2 * TILE + i] = ok ? stats[2 * BHS + shead + q0 + i] : 0.0f;
    }
    __syncthreads();
    product_abt<D>(Sw, Ks + warp * 16 * LD, Qs);
    product_abt<D>(Pw, Vs + warp * 16 * LD, Os);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < TILE / 2; ++c) {
      const int col = c0 + c;
      float p = 0.0f, ds = 0.0f;
      if (q0 + col < S) {
        p = expf(Sw[row * LDS + col] * scale - st[col]) * st[TILE + col];
        ds = p * (Pw[row * LDS + col] - st[2 * TILE + col]) * scale;
      }
      const bf16 hi = __float2bfloat16(p);
      PHw[row * LDP + col] = hi;
      PLw[row * LDP + col] = __float2bfloat16(p - __bfloat162float(hi));
      DSw[row * LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    product_ab<D>(fdv, PHw, Os);
    product_ab<D>(fdv, PLw, Os);
    product_ab<D>(fdk, DSw, Qs);
    __syncwarp();
  }

  const int kw = k0 + warp * 16;
  write_rows<D>(dk + head + (size_t)kw * HD, fdk, Sw, S - kw, HD, lane);
  write_rows<D>(dv + head + (size_t)kw * HD, fdv, Sw, S - kw, HD, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, void* stats, int B, int S, int H, float scale,
           cudaStream_t stream) {
  const size_t s_stats = smem_rows_kernel<D>(false), s_dq = smem_rows_kernel<D>(true);
  const size_t s_dkdv = smem_dkdv<D>();
  cudaError_t err = allow_smem(rows_kernel<D, false>, s_stats);
  if (err == cudaSuccess) err = allow_smem(rows_kernel<D, true>, s_dq);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<D>, s_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int BHS = B * H * S;
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *ob = (const bf16*)dout;
  float* st = (float*)stats;
  rows_kernel<D, false><<<grid, 128, s_stats, stream>>>(qb, kb, vb, ob, nullptr, st, S, H,
                                                        BHS, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rows_kernel<D, true><<<grid, 128, s_dq, stream>>>(qb, kb, vb, ob, (bf16*)dq, st, S, H,
                                                    BHS, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<grid, 128, s_dkdv, stream>>>(qb, kb, vb, ob, (bf16*)dk, (bf16*)dv, st, S,
                                                H, BHS, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcd_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int B, int S, int H, int D, float scale,
                                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, dout, dq, dk, dv, stats, B, S, H, scale, st);
  if (D == 128) return launch<128>(q, k, v, dout, dq, dk, dv, stats, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

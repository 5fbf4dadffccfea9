// K6: the backward of multi-head self-attention on the natural (B, S, H*D)
// layout, for Hopper (sm_90a), on wgmma.
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
// 327-329). The forward's bf16 P is never used: the JAX backward recomputes,
// and delta is not rowsum(dO * O), since K1's O carries P rounded against
// the running max.
//
// What bounds it: operations. The bound counts five S x S x D products per
// head (QK^T, dO V^T, P^T dO, dS K, dS^T Q); at the training step's ds1
// shape (28, 1536, 5x64) they are 211 GFLOP against 38 MB of q, k, v, dO and
// dQ, dK, dV. Nothing S x S is written to device memory.
//
// Design. Blocks on Hopper run in no order, so the work is two kernels, each
// looping inside the block, with no atomics (bit-identical from call to
// call): every sum over key tiles (dQ, the row statistics) or query tiles
// (dK, dV) is taken in tile order inside one block.
//   rows: a block owns 128 query rows of one (batch, head), two
//         warpgroups of 64 rows. Its thread 0 loads the block's Q and dO
//         tiles once and streams the head's 64-key K / V tiles through a
//         4-stage ring twice. Pass 1 (per key tile):
//         S = Q K^T and dP = dO V^T, the row max in the log2 domain and,
//         against it, the rescaled row sum of exp and delta's numerator,
//         sum exp(s - max) dP. Then per row lse = max + log2(sum) and delta;
//         both go to a per-row (lse, delta) float2 scratch. Pass 2 (per key
//         tile): S and dP again, P = exp2(s log2(e) scale - lse) in fp32,
//         dS = bf16(P (dP - delta) scale) in registers as a wgmma A operand,
//         dQ += dS K with K the MN-major B operand. 5 products.
//   dkdv: a block owns 128 keys of one (batch, head), two warpgroups of 64
//         keys. Its thread 0 loads the block's K and V tiles once and streams
//         64-query Q / dO tiles and their 64 (lse, delta) rows (a bulk copy)
//         through a 4-stage ring.
//         Per query tile: S^T = K Q^T and dP^T = V dO^T (both operands
//         K-major), P^T and dS^T in registers, dV += P^T dO and
//         dK += dS^T Q with dO and Q the MN-major B operands. P enters P^T dO
//         as the sum of two bf16 terms, hi = bf16(P) and lo = bf16(P - hi)
//         (16 mantissa bits of the fp32 P, relative error below 2^-16): two
//         register-A products into one accumulator. 5 products.
// So 10 S x S x D products per head against the bound's 5 (QK^T and dO V^T
// three times, P^T dO twice). Operands come in through TMA 3D tensor maps
// over (H*D, S, B): 64-column x 64-row boxes at column h*D, 128-byte
// swizzle, rows past S zero-filled (so one batch never reads the next
// one's rows). P and dS are turned from the accumulator layout into the
// m16n8k16 A-fragment layout in registers, as K1 turns S into P.
//
// Overlap. The warpgroups of an SM drift apart freely, so that one's softmax
// arithmetic runs under another's products: the rows pass runs two blocks
// an SM at D = 64 (four warpgroups, 128 registers a thread), the dkdv pass
// one. Inside a dkdv warpgroup, tile t + 1's S^T and dP^T products go out in
// one commit group with tile t's dV and dK products, back to back on the
// tensor cores. Every accumulator is read or written, and every
// barrier waited on, only after wgmma.wait_group 0: ptxas serialises every
// wgmma of a kernel in which a non-wgmma instruction touches an accumulator
// inside an open pipeline stage (C7514, C7515), and it does not follow
// wait_group 1 through the loop, so a second S buffer (one tile's softmax
// under the next tile's products) serialises the whole kernel. Per element
// the arithmetic is kept short: the max over raw scores (scale > 0), exp2 of
// one fma, masks only on a tile that crosses S, and no zeroing of a
// product's accumulator (its first k-step overwrites it).
//
// Ragged edges (S = 96 and S = 24 in the UNet, a tile of 64): keys at or past
// S are masked to -inf before the max (P = 0 there); padded query rows have
// zero dO, hence dP = 0 and delta = 0, and their scratch rows are written as
// (lse = +inf, delta = 0), so the dkdv pass sees P = 0 for them; a row of
// keys at or past S (zero K and V) only feeds its own rows of dK and dV,
// which are not stored; stores are masked to rows < S. The scratch is
// (B*H, Sp) float2 with Sp = S rounded up to 64 (the dkdv pass's bulk copy
// reads whole 64-row tiles).
//
// A block is two warpgroups and nothing else (256 threads), so that ptxas
// may give a thread up to 255 registers: the dkdv pass holds its dK and dV
// accumulators beside a tile's products and three sets of fragments (176
// values at D = 64), more than the 168 registers ptxas compiles a block of
// 288 or 384 threads to, with a producer warpgroup's setmaxnreg or without
// (at 168 it spilled and serialised the products). There is no producer
// warp: thread 0 refills the ring itself:
// once its warp has released ring position r, it waits for the other warps'
// release of position r - 1 and loads position r + 3 into that stage, so
// the two warpgroups may drift a tile apart without waiting on each other.
// D = 128 takes two 64-column sub-tiles of every operand and accumulator.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TR = 64;                 // rows of a tile (queries or keys)
constexpr int CWG = 2;                 // warpgroups a block, 64 rows each
constexpr int BROWS = TR * CWG;        // rows a block owns
constexpr int THREADS = 128 * CWG;
constexpr int STAGES = 4;
constexpr int TILE = 64 * 64 * 2;      // one 64 x 64 bf16 swizzled tile
constexpr int STATS_BYTES = TR * 8;    // 64 (lse, delta) float2

template <int D>
constexpr size_t smem_bytes(bool stats) {
  return 1024 + (size_t)(2 * CWG + 2 * STAGES) * (D / 64) * TILE +
         (stats ? STAGES * STATS_BYTES : 0) + 64 * sizeof(uint64_t);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x 64 fp32) = A B^T over D: A and B are [D/64] K-major tiles of 64
// rows at a and b. The first k-step overwrites acc.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k / 4) * TILE + (k % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a + off, 0, 1024), desc_sw128(b + off, 0, 1024),
                       k > 0);
  }
}

// acc[d] (64 x 64 fp32, columns 64 d ...) += A B: A (64 x 64) from registers
// in fragments af[t] (its columns 16 t ... 16 t + 15), B the [D/64] tiles at
// b read MN-major (row r of a tile is row r of B).
template <int D>
__device__ __forceinline__ void product_ab(float (&acc)[D / 64][32], const uint32_t (&af)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int d = 0; d < D / 64; ++d)
      wgmma_m64n64k16_rs_tb(acc[d], af[t], desc_sw128(b + d * TILE + t * 2048, TILE, 1024));
}

// The accumulator fragment of a 64 x 64 fp32 tile as the A fragments of the
// next product (16 columns a fragment), each value rounded to bf16.
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[t][i] = pack_bf16(v[8 * t + 2 * i], v[8 * t + 2 * i + 1]);
}

// P's hi = bf16(P) and lo = bf16(P - hi) fragments.
__device__ __forceinline__ void to_frags_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                               const float (&v)[32]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = v[8 * t + 2 * i], b = v[8 * t + 2 * i + 1];
      hi[t][i] = pack_bf16(a, b);
      const float2 h = unpack_bf16(hi[t][i]);
      lo[t][i] = pack_bf16(a - h.x, b - h.y);
    }
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) fence_regs(f[t]);
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int d = 0; d < D / 64; ++d) fence_regs(acc[d]);
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int d = 0; d < D / 64; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.0f;
}

// Round a warpgroup's 64-row accumulator to bf16 and store rows < S at the
// head's offset (row stride HD).
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[D / 64][32], int row0,
                                           int S, int HD, int cq) {
  bf16* p0 = base + (size_t)row0 * HD + cq;
  bf16* p1 = p0 + (size_t)8 * HD;
#pragma unroll
  for (int d = 0; d < D / 64; ++d)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = d * 64 + 8 * c;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(p0 + col) = pack_bf16(acc[d][4 * c], acc[d][4 * c + 1]);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(p1 + col) =
            pack_bf16(acc[d][4 * c + 2], acc[d][4 * c + 3]);
    }
}

// Row statistics and dQ (see the header). grid (ceil(S / 128), H, B). Two
// blocks an SM at D = 64 (at most 128 registers a thread).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_bwd_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, bf16* __restrict__ dq,
                      float2* __restrict__ stats, int S, int Sp, int H, float scale,
                      float scale_log2) {
  constexpr int DS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;                     // [CWG][DS] Q tiles
  unsigned char* os = qs + CWG * DS * TILE;     // [CWG][DS] dO tiles
  unsigned char* kv = os + CWG * DS * TILE;     // [STAGES][K: DS tiles, V: DS tiles]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + STAGES * 2 * DS * TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BROWS;
  const int ntiles = (S + TR - 1) / TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Ring position j (0 <= j < 2 ntiles) holds key tile j % ntiles; thread 0
  // loads it once the stage's previous position is released by every warp.
  auto produce = [&](int j) {
    if (j >= 2 * ntiles) return;
    const int st = j % STAGES, kt = j % ntiles;
    mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[st], 2 * DS * TILE);
    unsigned char* ks = kv + st * 2 * DS * TILE;
    for (int s = 0; s < DS; ++s) {
      tma_load_3d(ks + s * TILE, &kmap, &full[st], h * D + s * 64, kt * TR, b);
      tma_load_3d(ks + (DS + s) * TILE, &vmap, &full[st], h * D + s * 64, kt * TR, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qbar, 2 * CWG * DS * TILE);
    for (int g = 0; g < CWG; ++g)
      for (int s = 0; s < DS; ++s) {
        tma_load_3d(qs + (g * DS + s) * TILE, &qmap, qbar, h * D + s * 64, q0 + g * TR, b);
        tma_load_3d(os + (g * DS + s) * TILE, &omap, qbar, h * D + s * 64, q0 + g * TR, b);
      }
    for (int j = 0; j < STAGES; ++j) produce(j);
  }

  // Warpgroup g, warp wi of it: rows 16 wi + lane / 4 (+ 8) of its 64.
  const int g = warp / 4, wi = warp % 4;
  const int cq = 2 * (lane & 3);
  const uint32_t qaddr = smem_u32(qs + g * DS * TILE), oaddr = smem_u32(os + g * DS * TILE);
  auto kaddr = [&](int j) { return smem_u32(kv + (j % STAGES) * 2 * DS * TILE); };
  float sc[32], dp[32];
  // This warp is done with ring position j; thread 0 then refills the stage
  // of position j - 1.
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % STAGES]);
    if (threadIdx.x == 0 && j >= 1) produce(j - 1 + STAGES);
    __syncwarp();
  };
  // S = Q K^T and dP = dO V^T of ring position j (into the open commit
  // group).
  auto products = [&](int j) {
    product_abt<D>(sc, qaddr, kaddr(j));
    product_abt<D>(dp, oaddr, kaddr(j) + DS * TILE);
  };
  mbar_wait(qbar, 0);

  // Pass 1: the row max m (log2 domain), the sum l of exp2(s' - m) and
  // delta's numerator a = sum exp2(s' - m) dP, rescaled as m grows.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, a0 = 0.0f, a1 = 0.0f;
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    wgmma_fence();
    products(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    release(j);
    const int kv0 = j * TR;
    const bool ragged = kv0 + TR > S;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float v = ragged && kv0 + 8 * (i / 4) + cq + (i & 1) >= S ? -INFINITY : sc[i];
      if (i % 4 < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
    const float r0 = ex2(m0 - n0), r1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float t0 = 0.0f, t1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lo = i % 4 < 2;
      float e = ex2(fmaf(sc[i], scale_log2, lo ? -n0 : -n1));
      if (ragged && kv0 + 8 * (i / 4) + cq + (i & 1) >= S) e = 0.0f;
      if (lo) {
        t0 += e;
        u0 = fmaf(e, dp[i], u0);
      } else {
        t1 += e;
        u1 = fmaf(e, dp[i], u1);
      }
    }
    l0 = fmaf(l0, r0, t0);
    l1 = fmaf(l1, r1, t1);
    a0 = fmaf(a0, r0, u0);
    a1 = fmaf(a1, r1, u1);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    a0 += __shfl_xor_sync(0xffffffffu, a0, o);
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
  }
  const float lse0 = m0 + log2f(l0), lse1 = m1 + log2f(l1);
  const float delta0 = a0 / l0, delta1 = a1 / l1;
  const int row0 = q0 + g * TR + wi * 16 + lane / 4, row1 = row0 + 8;
  float2* srow = stats + ((size_t)b * H + h) * Sp;
  if ((lane & 3) == 0) {
    if (row0 < Sp)
      srow[row0] = row0 < S ? make_float2(lse0, delta0) : make_float2(INFINITY, 0.0f);
    if (row1 < Sp)
      srow[row1] = row1 < S ? make_float2(lse1, delta1) : make_float2(INFINITY, 0.0f);
  }

  // Pass 2 (ring positions ntiles + t): dQ += dS K.
  float acc[DS][32];
  uint32_t dsf[4][4] = {};
  zero<D>(acc);
  fence_acc<D>(acc);
  fence_frags(dsf);
  for (int t = 0; t < ntiles; ++t) {
    const int j = ntiles + t;
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    wgmma_fence();
    products(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int kv0 = t * TR;
    const bool ragged = kv0 + TR > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool r0 = i % 4 < 2;
      float p = ex2(fmaf(sc[i], scale_log2, r0 ? -lse0 : -lse1));
      if (ragged && kv0 + 8 * (i / 4) + cq + (i & 1) >= S) p = 0.0f;
      sc[i] = p * (dp[i] - (r0 ? delta0 : delta1)) * scale;
    }
    to_frags(dsf, sc);
    wgmma_fence();
    product_ab<D>(acc, dsf, kaddr(j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<D>(acc);
    fence_frags(dsf);
    release(j);
  }
  store_rows<D>(dq + (size_t)b * S * H * D + h * D, acc, row0, S, H * D, cq);
}

// dK and dV (see the header). grid (ceil(S / 128), H, B).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float2* __restrict__ stats, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int Sp, int H, float scale,
                      float scale_log2) {
  constexpr int DS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = base;                     // [CWG][DS] K tiles
  unsigned char* vs = ks + CWG * DS * TILE;     // [CWG][DS] V tiles
  unsigned char* qo = vs + CWG * DS * TILE;     // [STAGES][Q: DS tiles, dO: DS tiles]
  float2* sst = reinterpret_cast<float2*>(qo + STAGES * 2 * DS * TILE);  // [STAGES][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sst + STAGES * TR);
  uint64_t* kbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BROWS;
  const int ntiles = (S + TR - 1) / TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2* shead = stats + ((size_t)b * H + h) * Sp;

  if (threadIdx.x == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Ring position j (0 <= j < ntiles) holds query tile j and its (lse,
  // delta) rows; thread 0 loads it once the stage's previous position is
  // released by every warp.
  auto produce = [&](int j) {
    if (j >= ntiles) return;
    const int st = j % STAGES;
    mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[st], 2 * DS * TILE + STATS_BYTES);
    unsigned char* qs = qo + st * 2 * DS * TILE;
    for (int s = 0; s < DS; ++s) {
      tma_load_3d(qs + s * TILE, &qmap, &full[st], h * D + s * 64, j * TR, b);
      tma_load_3d(qs + (DS + s) * TILE, &omap, &full[st], h * D + s * 64, j * TR, b);
    }
    bulk_load(sst + st * TR, shead + j * TR, STATS_BYTES, &full[st]);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(kbar, 2 * CWG * DS * TILE);
    for (int g = 0; g < CWG; ++g)
      for (int s = 0; s < DS; ++s) {
        tma_load_3d(ks + (g * DS + s) * TILE, &kmap, kbar, h * D + s * 64, k0 + g * TR, b);
        tma_load_3d(vs + (g * DS + s) * TILE, &vmap, kbar, h * D + s * 64, k0 + g * TR, b);
      }
    for (int j = 0; j < STAGES; ++j) produce(j);
  }

  // Warpgroup g, warp wi of it: keys 16 wi + lane / 4 (+ 8) of its 64.
  const int g = warp / 4, wi = warp % 4;
  const int cq = 2 * (lane & 3);
  const int key0 = k0 + g * TR + wi * 16 + lane / 4;
  const uint32_t kaddr = smem_u32(ks + g * DS * TILE), vaddr = smem_u32(vs + g * DS * TILE);
  auto qaddr = [&](int j) { return smem_u32(qo + (j % STAGES) * 2 * DS * TILE); };
  // This warp is done with ring position j; thread 0 then refills the stage
  // of position j - 1.
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % STAGES]);
    if (threadIdx.x == 0 && j >= 1) produce(j - 1 + STAGES);
    __syncwarp();
  };
  float accK[DS][32], accV[DS][32], sc[32], dp[32];
  uint32_t ph[4][4] = {}, pl[4][4] = {}, dsf[4][4] = {};
  zero<D>(accK);
  zero<D>(accV);
  fence_acc<D>(accK);
  fence_acc<D>(accV);
  fence_frags(ph);
  fence_frags(pl);
  fence_frags(dsf);
  mbar_wait(kbar, 0);

  // S^T = K Q^T and dP^T = V dO^T of query tile 0; then per tile, this
  // tile's dV / dK products and the next tile's S^T / dP^T in one group.
  mbar_wait(&full[0], 0);
  wgmma_fence();
  product_abt<D>(sc, kaddr, qaddr(0));
  product_abt<D>(dp, vaddr, qaddr(0) + DS * TILE);
  wgmma_commit();
  for (int j = 0; j < ntiles; ++j) {
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    fence_acc<D>(accK);
    fence_acc<D>(accV);
    fence_frags(ph);
    fence_frags(pl);
    fence_frags(dsf);
    if (j > 0) release(j - 1);
    // Column i's query: 8 (i / 4) + cq + (i & 1) of the tile.
    const float2* sl = sst + (j % STAGES) * TR;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 ld = sl[8 * (i / 4) + cq + (i & 1)];
      const float p = ex2(fmaf(sc[i], scale_log2, -ld.x));
      sc[i] = p;
      dp[i] = p * (dp[i] - ld.y) * scale;
    }
    to_frags_split(ph, pl, sc);
    to_frags(dsf, dp);
    const uint32_t qa = qaddr(j), oa = qa + DS * TILE;
    if (j + 1 < ntiles) {
      mbar_wait(&full[(j + 1) % STAGES], ((j + 1) / STAGES) & 1);
      wgmma_fence();
      product_ab<D>(accV, ph, oa);
      product_ab<D>(accV, pl, oa);
      product_ab<D>(accK, dsf, qa);
      product_abt<D>(sc, kaddr, qaddr(j + 1));
      product_abt<D>(dp, vaddr, qaddr(j + 1) + DS * TILE);
      wgmma_commit();
    } else {
      wgmma_fence();
      product_ab<D>(accV, ph, oa);
      product_ab<D>(accV, pl, oa);
      product_ab<D>(accK, dsf, qa);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_acc<D>(accK);
  fence_acc<D>(accV);
  fence_frags(ph);
  fence_frags(pl);
  fence_frags(dsf);
  release(ntiles - 1);
  const size_t head = (size_t)b * S * H * D + h * D;
  store_rows<D>(dk + head, accK, key0, S, H * D, cq);
  store_rows<D>(dv + head, accV, key0, S, H * D, cq);
}

// A 3D map over the (B, S, H*D) tensor: 64-column x 64-row boxes.
bool bshd_map(CUtensorMap* map, const void* p, int B, int S, int HD) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)S * HD * 2};
  const uint32_t box[3] = {64, 64, 1};
  return cached_bf16_map(map, p, 3, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, void* stats, int B, int S, int H, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  if (!bshd_map(&qm, q, B, S, H * D) || !bshd_map(&km, k, B, S, H * D) ||
      !bshd_map(&vm, v, B, S, H * D) || !bshd_map(&om, dout, B, S, H * D))
    return (int)cudaErrorInvalidValue;
  const size_t s_rows = smem_bytes<D>(false), s_dkdv = smem_bytes<D>(true);
  static std::atomic<uint64_t> rows_set{0}, dkdv_set{0};  // one per D
  cudaError_t err = smem_limit_once(flash_bwd_rows_kernel<D>, (int)s_rows, rows_set);
  if (err == cudaSuccess) err = smem_limit_once(flash_bwd_dkdv_kernel<D>, (int)s_dkdv, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  const int Sp = (S + TR - 1) / TR * TR;
  const float sl2 = scale * 1.4426950408889634f;
  const dim3 grid((S + BROWS - 1) / BROWS, H, B);
  flash_bwd_rows_kernel<D><<<grid, THREADS, s_rows, stream>>>(qm, km, vm, om, (bf16*)dq,
                                                              (float2*)stats, S, Sp, H, scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, s_dkdv, stream>>>(
      qm, km, vm, om, (const float2*)stats, (bf16*)dk, (bf16*)dv, S, Sp, H, scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, S, H*D) bf16, 16-byte aligned, D in {64,
// 128}, B and H at most 65535. stats: scratch of B * H * Sp float2, Sp = S
// rounded up to 64, 16-byte aligned.
extern "C" int gcd_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int B, int S, int H, int D, float scale,
                                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, dout, dq, dk, dv, stats, B, S, H, scale, st);
  if (D == 128) return launch<128>(q, k, v, dout, dq, dk, dv, stats, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

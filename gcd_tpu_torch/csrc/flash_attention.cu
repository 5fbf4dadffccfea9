// K1: multi-head self-attention on the natural (B, S, H*D) layout, for
// Hopper (sm_90a), on wgmma.
//
// Replaces gcd_tpu/ops/flash_attention.py::_mh_kernel (pallas_call in
// _flash_fwd, entry flash_attention). Per (batch, head, query row):
//     s_j = (q . k_j) * scale  in fp32, keys j >= Skv masked out
//     o   = (sum_j bf16(p_j) * v_j) / sum_j p_j     (fp32 accumulation)
// with p unnormalised and the division after PV, as the TPU kernel does
// (flash_attention.py:43-52,113-127). The TPU kernel takes p_j =
// exp(s_j - max_j s_j) against the row's final max; this kernel walks the
// keys once with the online softmax: p_j = exp(s_j - m) against the running
// max m of the keys seen so far, and rescales the fp32 sums by
// exp(m_old - m_new) when m grows. The function is the same; the point
// where p is rounded to bf16 moves (p is rounded relative to the running
// max, then scaled in fp32), which chip_smoke.py measures against the
// plain version's exact-max P (PERF.md).
//
// What bounds it: operations. At the UNet's ds1 shape (28, 1536, 5x64) the
// QK^T and PV products are 42 GFLOP against 28 MB of q/k/v/o; one
// exponential per score (330 M at ds1) costs the H100's MUFU about what the
// tensor cores need for the products at D = 64, so the kernel computes each
// score and its exponential once, never stages scores in shared memory,
// and leaves the products to wgmma.
//
// Design. A block owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows and one producer warp (288 threads). The producer
// loads the block's Q tile once and streams 64-key K/V tiles through a
// 3-stage ring of shared memory with TMA (3D tensor maps over
// (H*D, S, B), boxes of 64 columns x 64 rows at column h*D, 128-byte
// swizzle, rows past S zero-filled), each stage guarded by a full and an
// empty mbarrier. Per key tile a consumer warpgroup
//   - computes S = Q K^T (64 x 64, fp32) with wgmma m64n64k16, both operands
//     from shared memory (K-major descriptors), into registers;
//   - masks keys >= Skv, updates its rows' running max and sum with quad
//     shuffles, and rescales its O accumulator;
//   - converts P to bf16 in registers, in the A-fragment layout of the next
//     product (the accumulator's n8 pairs are the m16n8k16 A layout), and
//     adds P V with wgmma m64n64k16, A from registers, V from shared memory
//     in its natural (key, d) layout as an MN-major B (the transpose bit);
//   - releases the stage to the producer.
// O is divided by the row sum and written as bf16 pairs in place at the
// head's offset; there are no head transposes and nothing S x S in device
// memory. D = 128 takes two 64-column sub-tiles of Q, K, V and O.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KT = 64;                 // keys per stage
constexpr int CWG = 2;                 // consumer warpgroups, 64 query rows each
constexpr int QROWS = 64 * CWG;        // query rows per block
constexpr int THREADS = 128 * CWG + 32;
constexpr int STAGES = 3;
constexpr int TILE = 64 * 64 * 2;      // one 64 x 64 bf16 swizzled tile

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(CWG + 2 * STAGES) * (D / 64) * TILE + 64 * sizeof(uint64_t);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int Sq,
                       int Skv, int H, float scale_log2) {
  constexpr int DS = D / 64;  // 64-column sub-tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;                       // [CWG][DS] tiles
  unsigned char* kv = qs + CWG * DS * TILE;       // [STAGES][K: DS tiles, V: DS tiles]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + STAGES * 2 * DS * TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int ntiles = (Skv + KT - 1) / KT;
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

  if (warp == CWG * 4) {
    // Producer: Q once, then the K/V ring.
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, CWG * DS * TILE);
      for (int g = 0; g < CWG; ++g)
        for (int s = 0; s < DS; ++s)
          tma_load_3d(qs + (g * DS + s) * TILE, &qmap, qbar, h * D + s * 64, q0 + g * 64, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES, round = j / STAGES;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * DS * TILE);
        unsigned char* ks = kv + st * 2 * DS * TILE;
        for (int s = 0; s < DS; ++s) {
          tma_load_3d(ks + s * TILE, &kmap, &full[st], h * D + s * 64, j * KT, b);
          tma_load_3d(ks + (DS + s) * TILE, &vmap, &full[st], h * D + s * 64, j * KT, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup g, warp wi of it: rows 16 wi + lane / 4 (+ 8).
  const int g = warp / 4, wi = warp % 4;
  const int cq = 2 * (lane & 3);
  float acc[DS][32];
#pragma unroll
  for (int s = 0; s < DS; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const uint32_t qaddr = smem_u32(qs + g * DS * TILE);

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, round = j / STAGES;
    const uint32_t kaddr = smem_u32(kv + st * 2 * DS * TILE);
    const uint32_t vaddr = kaddr + DS * TILE;
    mbar_wait(&full[st], round & 1);

    // S = Q K^T.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const uint32_t off = (k / 4) * TILE + (k % 4) * 32;
      wgmma_m64n64k16_ss(s, desc_sw128(qaddr + off, 0, 1024), desc_sw128(kaddr + off, 0, 1024),
                         1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax in the log2 domain: s * scale * log2(e).
    const int kv0 = j * KT;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[4 * c + e] * scale_log2, v1 = s[4 * c + 2 + e] * scale_log2;
        if (kv0 + 8 * c + cq + e >= Skv) v0 = v1 = -INFINITY;
        s[4 * c + e] = v0;
        s[4 * c + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i % 4 < 2) {
        s[i] = ex2(s[i] - n0);
        r0 += s[i];
      } else {
        s[i] = ex2(s[i] - n1);
        r1 += s[i];
      }
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int d = 0; d < DS; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[d][i] *= (i % 4 < 2) ? a0 : a1;

    // P (bf16, registers) x V.
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int d = 0; d < DS; ++d)
        wgmma_m64n64k16_rs_tb(acc[d], pa[t],
                              desc_sw128(vaddr + d * TILE + t * 2048, TILE, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < DS; ++d) fence_regs(acc[d]);
#pragma unroll
    for (int t = 0; t < 4; ++t) fence_regs(pa[t]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // O / l, one rounding to bf16, in place at the head's offset.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int HD = H * D;
  const int row0 = q0 + g * 64 + wi * 16 + lane / 4, row1 = row0 + 8;
  bf16* o0 = o + ((size_t)b * Sq + row0) * HD + h * D + cq;
  bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
  for (int d = 0; d < DS; ++d)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = d * 64 + 8 * c;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(acc[d][4 * c] / l0, acc[d][4 * c + 1] / l0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(acc[d][4 * c + 2] / l1, acc[d][4 * c + 3] / l1);
    }
}

// A 3D map over the (B, S, H*D) tensor: 64-column x 64-row boxes.
bool qkv_map(CUtensorMap* map, const void* p, int B, int S, int HD) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)S * HD * 2};
  const uint32_t box[3] = {64, 64, 1};
  return cached_bf16_map(map, p, 3, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!qkv_map(&qm, q, B, Sq, H * D) || !qkv_map(&km, k, B, Skv, H * D) ||
      !qkv_map(&vm, v, B, Skv, H * D))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  static std::atomic<uint64_t> smem_set{0};  // one per D
  cudaError_t err = smem_limit_once(flash_attention_kernel<D>, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + QROWS - 1) / QROWS, H, B);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, (bf16*)o, Sq, Skv, H, scale * 1.4426950408889634f);
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

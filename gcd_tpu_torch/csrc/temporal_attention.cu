// K2: frame-axis (temporal) self-attention on the natural (B*T, S, C)
// layout, for Hopper (sm_90a): TMA-fed, on mma.sync tensor cores.
//
// Replaces gcd_tpu/ops/temporal_attention.py::_kernel (pallas_call in
// _pallas_fwd, entry temporal_attention). For every video b, spatial
// position s and head h, the T frames attend to each other:
//     s_tt' = (q_t . k_t') * scale                     fp32
//     p_tt' = exp(s_tt' - max_t' s_tt')                fp32, unnormalised
//     o_t   = (sum_t' bf16(p_tt') v_t') / sum_t' p_tt'  fp32 sums
// and o is rounded once to bf16: the TPU kernel's rounding points (P to
// bf16 before PV, the fp32 row sum of the unrounded P, the division after
// PV), which temporal_attention_plain repeats.
//
// What bounds it: bytes. q, k, v are read once and o written once, 8 bytes
// a value: 110 MB at the UNet's ds1 shape (28, 1536, 320), 0.033 ms at 3.35
// TB/s. The products are 4 T^2 D flops a (b, s, h), 0.77 GFLOP at ds1, well
// under a microsecond of the tensor cores. So the design keeps many loads
// in flight on every SM to cover the memory's latency, and keeps the little
// arithmetic on the tensor cores, out of the loads' way.
//
// Design.
//  - A unit of work is one (video b, position s, head h). Each tensor is
//    read through a 4D TMA map over (C, S, T, B) -- innermost first, strides
//    2, 2 C, 2 S C and 2 T S C bytes -- and one box (64, 1, 16 MT, 1) at
//    (h D + 64 j, s, 0, b) brings channels h D + 64 j .. + 63 of all the
//    video's frames at s: 16 MT rows of 128 bytes, 128-byte swizzled. Frames
//    t >= T lie outside the map's T dimension and are zero-filled, so T is
//    padded to MT row tiles of 16 (the m16 of mma.sync) without reading the
//    next video: MT = 1 for T <= 16, MT = 2 for T = 17 .. 32. D = 128 takes
//    two boxes; a D below 64 uses the first D channels of its box (channels
//    past C are zero-filled too).
//  - Every warp owns a ring of STAGES units (q, k and v of one unit a stage)
//    with a full mbarrier a stage. The grid is persistent: warp w of the
//    grid's N takes units w, w + N, ...; unit u is head u % H of position
//    (u / H) % S of video u / (H S), so neighbouring warps read neighbouring
//    128-byte pieces of the same frame rows. When the warp is done with a
//    stage, its lane 0 loads the unit STAGES rounds ahead into it. There is
//    no producer warp and no empty barrier, and no warp ever waits for
//    another: each keeps one unit's loads (5.25 KB of HBM at D = 64) in
//    flight while it computes another, 16 warps an SM (four blocks of WARPS,
//    49 KB of shared memory each). What a warp waits on is the chain of its
//    unit's arithmetic rather than the loads: on the H100 rings of 3 or 4
//    units at 8 to 12 warps an SM ran slower than 2 units at 15 or 16.
//  - Products with mma.sync m16n8k16, bf16 in, fp32 accumulate, one warp a
//    unit, which takes its MT query strips of 16 rows one after the other.
//    A strip's S = Q K^T is 16 x 16 MT (D / 16 k-steps, 2 MT n-tiles; Q and
//    K through ldmatrix). Key columns >= T get -inf before the row max (quad
//    shuffles); P = exp(s - max) in fp32, the row sums from that fp32 P, and
//    P rounded to bf16 straight into the A fragments of PV (the accumulator
//    layout of two n-tiles of S is the m16n8k16 A layout of one k-step). V
//    comes through ldmatrix.trans; O = P V takes D / 8 n-tiles of MT
//    k-steps.
//  - O is divided by the row sum (one rounded reciprocal a row and a
//    residual step, the same bits as a division: `div_by`), rounded to bf16
//    and written over the strip's own Q rows in the same swizzle (the next
//    strip reads only its own Q rows), then, once every strip is done, read
//    back 16 bytes a lane and stored: 8 lanes write one frame's 128
//    contiguous bytes of the head; rows t >= T are not stored.
//  - The swizzle puts chunk j of frame row t at chunk j ^ (t % 8), so the
//    eight rows one ldmatrix matrix reads (frames 8 i .. 8 i + 7 of a
//    chunk), and the output's writes and read-back, fall in distinct banks.
//  - At MT = 2 a stage is twice the bytes, so an SM holds half the warps
//    (8 at D <= 64, 4 at D = 80 .. 128) with the same bytes in flight.
//  - No atomics and nothing shared between warps: bit-identical from call
//    to call.
// The TPU's 8-position striped mask and head-pair packing fitted the MXU's
// 128-wide tiles; a 16-row mma.sync tile needs neither.
//
// Wide heads (D = 192 .. 512, a multiple of 64: the VAE decoder's
// VideoAttnBlock, one head of width 128 to 512) take a second family,
// temporal_attention_wide_kernel, reached by the same C entry and the same
// maps. A unit's stage is 3 D / 64 boxes (48 KB at D = 512), and O = P V
// over all D / 8 n-tiles would need 4 D / 8 fp32 accumulators a lane (256
// at D = 512). So S = Q K^T runs as above over D / 16 k-steps (one 16 x 16
// tile), P stays in registers as the A fragment, and PV, the division and
// the write over the Q rows go 64 channels (8 n-tiles, 32 accumulators) at
// a time; a block is one warp with a ring of two units, so an SM holds two
// to five blocks as D falls from 512 to 192. Each output value is computed
// by the same instructions as in the narrow family. At the decoder's
// (14, 1536, 512), H = 1, q, k, v and o are 88 MB: 0.026 ms at 3.35 TB/s.
//
// Requires D = C / H a multiple of 16 up to 128 with T <= 32 (the narrow
// family), or of 64 from 192 up to 512 with T <= 16 (the wide family), and
// q, k, v, o 16-byte aligned (the wrapper checks).

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;           // warps a block, each with its own ring
constexpr int STAGES = 2;          // units a warp's ring holds
constexpr int ROWS = 16;           // frames a row tile holds (the m16 of mma.sync)
constexpr int MAX_ROW_TILES = 2;   // row tiles a narrow unit takes: T <= 32
constexpr int BOX = ROWS * 128;    // one row tile's box: 16 frames x 64 bf16 channels

template <int DC, int MT = 1>
__host__ __device__ constexpr int stage_bytes() {
  return 3 * DC * MT * BOX;  // q, k, v
}

template <int DC, int MT = 1>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + WARPS * STAGES * (stage_bytes<DC, MT>() + (int)sizeof(uint64_t));
}

// Blocks an SM holds: its 233,472 bytes of shared memory, 1 KB of them
// reserved a block.
template <int DC, int MT = 1>
__host__ __device__ constexpr int blocks_per_sm() {
  return 233472 / (smem_bytes<DC, MT>() + 1024);
}

constexpr int WIDE_WARPS = 1;      // warps a block of the wide family
constexpr int WIDE_STAGES = 2;     // units its ring holds

template <int DC>
__host__ __device__ constexpr int wide_smem_bytes() {
  return 1024 + WIDE_WARPS * WIDE_STAGES * (stage_bytes<DC>() + (int)sizeof(uint64_t));
}

template <int DC>
__host__ __device__ constexpr int wide_blocks_per_sm() {
  return 233472 / (wide_smem_bytes<DC>() + 1024);
}

// Shared address of 16-byte chunk c (of the head's channels) of frame row r
// in a tensor's boxes of MT row tiles at `tile`.
template <int MT = 1>
__device__ __forceinline__ uint32_t chunk_at(uint32_t tile, int r, int c) {
  return tile + (c >> 3) * (MT * BOX) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a / b rounded to nearest, as a division gives it, from r = 1 / b rounded
// to nearest: q = a r, then q + r (a - q b) with fused multiply-adds
// (Markstein: exact rounding for quotients of normal range). One rounded
// reciprocal a row replaces a div.rn for each of the row's values.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <int KC, int MT>  // D = 16 KC, T padded to 16 MT rows
__global__ void __launch_bounds__(WARPS * 32, blocks_per_sm<(KC + 3) / 4, MT>())
temporal_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                          int T, int S, int H, long long units, float scale) {
  constexpr int D = 16 * KC;
  constexpr int DC = (D + 63) / 64;  // boxes a tensor
  constexpr int CHUNKS = D / 8;      // 16-byte chunks of a frame's head
  constexpr int TBOX = MT * BOX;     // one box of all the unit's rows
  constexpr int STAGE = stage_bytes<DC, MT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = base + warp * STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + WARPS * STAGES * STAGE) + warp * STAGES;
  const long long step = (long long)gridDim.x * WARPS;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const size_t C = (size_t)H * D;

  auto load = [&](long long u, int st) {
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    unsigned char* dst = ring + st * STAGE;
    mbar_arrive_expect_tx(&full[st], STAGE);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      tma_load_4d(dst + j * TBOX, &qmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (DC + j) * TBOX, &kmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (2 * DC + j) * TBOX, &vmap, &full[st], h * D + 64 * j, s, 0, b);
    }
  };
  if (lane == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int st = 0; st < STAGES; ++st)
      if (first + st * step < units) load(first + st * step, st);
  }
  __syncwarp();

  // ldmatrix rows: Q (A) and V (B, transposed) take frame lane % 16 of chunk
  // pair lane / 16 (of their row tile); K (B) takes key frame lane % 8 + 8
  // (lane / 16) of chunk (lane / 8) % 2.
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);  // accumulator row and column
  int i = 0;
  for (long long u = first; u < units; u += step, ++i) {
    const int st = i % STAGES;
    const uint32_t qs = smem_u32(ring + st * STAGE), ks = qs + DC * TBOX, vs = ks + DC * TBOX;
    mbar_wait(&full[st], (i / STAGES) & 1);

#pragma unroll 1
    for (int m = 0; m < MT; ++m) {  // query strip m: rows 16 m .. 16 m + 15
      const int row0 = ROWS * m;
      float sc[2 * MT][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, chunk_at<MT>(qs, row0 + a_row, 2 * kc + a_chunk));
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          uint32_t kb[4];
          ldsm_x4(kb, chunk_at<MT>(ks, ROWS * n + k_row, 2 * kc + k_chunk));
          mma_bf16_16816(sc[2 * n], a, kb[0], kb[1]);
          mma_bf16_16816(sc[2 * n + 1], a, kb[2], kb[3]);
        }
      }
      // sc[n][0..1]: row g, key columns 8 n + cq + {0, 1}; sc[n][2..3]: row g + 8.
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 8 * n + cq + (e & 1) < T ? sc[n][e] * scale : -INFINITY;
          sc[n][e] = x;
          if (e < 2) m0 = fmaxf(m0, x);
          else m1 = fmaxf(m1, x);
        }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[n][e] - (e < 2 ? m0 : m1));
          sc[n][e] = p;
          if (e < 2) l0 += p;
          else l1 += p;
        }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      uint32_t pa[MT][4];  // k-step n: key columns 16 n .. 16 n + 15
#pragma unroll
      for (int n = 0; n < MT; ++n) {
        pa[n][0] = pack_bf16(sc[2 * n][0], sc[2 * n][1]);
        pa[n][1] = pack_bf16(sc[2 * n][2], sc[2 * n][3]);
        pa[n][2] = pack_bf16(sc[2 * n + 1][0], sc[2 * n + 1][1]);
        pa[n][3] = pack_bf16(sc[2 * n + 1][2], sc[2 * n + 1][3]);
      }
      float acc[CHUNKS][4] = {};
#pragma unroll
      for (int j = 0; j < CHUNKS; j += 2)
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, chunk_at<MT>(vs, ROWS * n + a_row, j + a_chunk));
          mma_bf16_16816(acc[j], pa[n], vb[0], vb[1]);
          mma_bf16_16816(acc[j + 1], pa[n], vb[2], vb[3]);
        }

      // O / rowsum over this strip's Q rows (every lane's ldmatrix of them
      // is done).
      __syncwarp();
      const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        st_shared_u32(chunk_at<MT>(qs, row0 + g, j) + 2 * cq,
                      pack_bf16(div_by(acc[j][0], l0, r0), div_by(acc[j][1], l0, r0)));
        st_shared_u32(chunk_at<MT>(qs, row0 + g + 8, j) + 2 * cq,
                      pack_bf16(div_by(acc[j][2], l1, r1), div_by(acc[j][3], l1, r1)));
      }
    }
    // 16-byte stores of frames t < T.
    __syncwarp();
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    bf16* out = o + ((size_t)b * T * S + s) * C + (size_t)h * D;
#pragma unroll
    for (int idx = lane; idx < MT * ROWS * CHUNKS; idx += 32) {
      const int t = idx / CHUNKS, c = idx % CHUNKS;
      if (t < T)
        *reinterpret_cast<uint4*>(out + (size_t)t * S * C + 8 * c) =
            ld_shared_v4(chunk_at<MT>(qs, t, c));
    }
    // This warp's reads and writes of the stage come before the TMA refill.
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && u + STAGES * step < units) load(u + STAGES * step, st);
  }
}

// The wide family (D = 64 DC, DC = 3 .. 8): the narrow kernel's schedule
// with one warp a block, and PV in 64-channel chunks.
template <int DC>
__global__ void __launch_bounds__(WIDE_WARPS * 32, wide_blocks_per_sm<DC>())
temporal_attention_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               bf16* __restrict__ o, int T, int S, int H, long long units,
                               float scale) {
  constexpr int D = 64 * DC;
  constexpr int KC = D / 16;       // k-steps of S = Q K^T
  constexpr int CHUNKS = D / 8;    // 16-byte chunks of a frame's head
  constexpr int STAGE = stage_bytes<DC>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = base + warp * WIDE_STAGES * STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + WIDE_WARPS * WIDE_STAGES * STAGE) + warp * WIDE_STAGES;
  const long long step = (long long)gridDim.x * WIDE_WARPS;
  const long long first = (long long)blockIdx.x * WIDE_WARPS + warp;
  const size_t C = (size_t)H * D;

  auto load = [&](long long u, int st) {
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    unsigned char* dst = ring + st * STAGE;
    mbar_arrive_expect_tx(&full[st], STAGE);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      tma_load_4d(dst + j * BOX, &qmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (DC + j) * BOX, &kmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (2 * DC + j) * BOX, &vmap, &full[st], h * D + 64 * j, s, 0, b);
    }
  };
  if (lane == 0) {
    for (int st = 0; st < WIDE_STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int st = 0; st < WIDE_STAGES; ++st)
      if (first + st * step < units) load(first + st * step, st);
  }
  __syncwarp();

  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  int i = 0;
  for (long long u = first; u < units; u += step, ++i) {
    const int st = i % WIDE_STAGES;
    const uint32_t qs = smem_u32(ring + st * STAGE), ks = qs + DC * BOX, vs = ks + DC * BOX;
    mbar_wait(&full[st], (i / WIDE_STAGES) & 1);

    float sc[2][4] = {};
#pragma unroll 8
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, chunk_at(qs, a_row, 2 * kc + a_chunk));
      ldsm_x4(kb, chunk_at(ks, k_row, 2 * kc + k_chunk));
      mma_bf16_16816(sc[0], a, kb[0], kb[1]);
      mma_bf16_16816(sc[1], a, kb[2], kb[3]);
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * n + cq + (e & 1) < T ? sc[n][e] * scale : -INFINITY;
        sc[n][e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - (e < 2 ? m0 : m1));
        sc[n][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

    // Every lane's ldmatrix of the Q rows is done: each 64-channel chunk of
    // O / rowsum goes over them as soon as it is summed.
    __syncwarp();
#pragma unroll 1
    for (int cb = 0; cb < DC; ++cb) {
      float acc[8][4] = {};
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, chunk_at(vs, a_row, 8 * cb + j + a_chunk));
        mma_bf16_16816(acc[j], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[j + 1], pa, vb[2], vb[3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st_shared_u32(chunk_at(qs, g, 8 * cb + j) + 2 * cq,
                      pack_bf16(div_by(acc[j][0], l0, r0), div_by(acc[j][1], l0, r0)));
        st_shared_u32(chunk_at(qs, g + 8, 8 * cb + j) + 2 * cq,
                      pack_bf16(div_by(acc[j][2], l1, r1), div_by(acc[j][3], l1, r1)));
      }
    }
    __syncwarp();
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    bf16* out = o + ((size_t)b * T * S + s) * C + (size_t)h * D;
#pragma unroll 4
    for (int idx = lane; idx < ROWS * CHUNKS; idx += 32) {
      const int t = idx / CHUNKS, c = idx % CHUNKS;
      if (t < T)
        *reinterpret_cast<uint4*>(out + (size_t)t * S * C + 8 * c) =
            ld_shared_v4(chunk_at(qs, t, c));
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && u + WIDE_STAGES * step < units) load(u + WIDE_STAGES * step, st);
  }
}

// A 4D map over a (B*T, S, C) tensor seen as (C, S, T, B): boxes of 64
// channels x 1 position x 16 MT frames (frames past T read as zero).
bool frames_map(CUtensorMap* map, const void* p, int B, int T, int S, int C, int MT = 1) {
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)S, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)C * 2, (uint64_t)S * C * 2, (uint64_t)T * S * C * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)(MT * ROWS), 1};
  return cached_bf16_map(map, p, 4, dims, strides, box);
}

template <int KC, int MT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int H,
           float scale, cudaStream_t stream) {
  constexpr int DC = (16 * KC + 63) / 64;
  const int C = H * 16 * KC;
  CUtensorMap qm, km, vm;
  if (!frames_map(&qm, q, B, T, S, C, MT) || !frames_map(&km, k, B, T, S, C, MT) ||
      !frames_map(&vm, v, B, T, S, C, MT))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<DC, MT>();
  static std::atomic<uint64_t> smem_set{0};  // one per (KC, MT)
  cudaError_t err = smem_limit_once(temporal_attention_kernel<KC, MT>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long blocks = (units + WARPS - 1) / WARPS;
  const long long resident = (long long)sms * blocks_per_sm<DC, MT>();
  temporal_attention_kernel<KC, MT>
      <<<(unsigned)(blocks < resident ? blocks : resident), WARPS * 32, smem, stream>>>(
          qm, km, vm, (bf16*)o, T, S, H, units, scale);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_narrow(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                  int H, float scale, cudaStream_t stream) {
  return T <= ROWS ? launch<KC, 1>(q, k, v, o, B, T, S, H, scale, stream)
                   : launch<KC, 2>(q, k, v, o, B, T, S, H, scale, stream);
}

template <int DC>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                int H, float scale, cudaStream_t stream) {
  const int C = H * 64 * DC;
  CUtensorMap qm, km, vm;
  if (!frames_map(&qm, q, B, T, S, C) || !frames_map(&km, k, B, T, S, C) ||
      !frames_map(&vm, v, B, T, S, C))
    return (int)cudaErrorInvalidValue;
  const int smem = wide_smem_bytes<DC>();
  static std::atomic<uint64_t> smem_set{0};  // one per DC
  cudaError_t err = smem_limit_once(temporal_attention_wide_kernel<DC>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long blocks = (units + WIDE_WARPS - 1) / WIDE_WARPS;
  const long long resident = (long long)sms * wide_blocks_per_sm<DC>();
  temporal_attention_wide_kernel<DC>
      <<<(unsigned)(blocks < resident ? blocks : resident), WIDE_WARPS * 32, smem, stream>>>(
          qm, km, vm, (bf16*)o, T, S, H, units, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B*T, S, C) bf16, contiguous, 16-byte aligned; C = H D with D
// a multiple of 16 up to 128 and T <= 32 (the narrow family), or D a
// multiple of 64 from 192 up to 512 and T <= 16 (the wide family).
extern "C" int gcd_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                      int BT, int T, int S, int C, int H, float scale,
                                      void* stream) {
  if (T <= 0 || T > MAX_ROW_TILES * ROWS || H <= 0 || C % H || BT % T || BT <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int D = C / H, B = BT / T;
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 128) {
    if (T > ROWS) return (int)cudaErrorInvalidValue;
    switch (D % 64 ? 0 : D / 64) {
      case 3: return launch_wide<3>(q, k, v, o, B, T, S, H, scale, st);
      case 4: return launch_wide<4>(q, k, v, o, B, T, S, H, scale, st);
      case 5: return launch_wide<5>(q, k, v, o, B, T, S, H, scale, st);
      case 6: return launch_wide<6>(q, k, v, o, B, T, S, H, scale, st);
      case 7: return launch_wide<7>(q, k, v, o, B, T, S, H, scale, st);
      case 8: return launch_wide<8>(q, k, v, o, B, T, S, H, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D % 16 ? 0 : D / 16) {
    case 1: return launch_narrow<1>(q, k, v, o, B, T, S, H, scale, st);
    case 2: return launch_narrow<2>(q, k, v, o, B, T, S, H, scale, st);
    case 3: return launch_narrow<3>(q, k, v, o, B, T, S, H, scale, st);
    case 4: return launch_narrow<4>(q, k, v, o, B, T, S, H, scale, st);
    case 5: return launch_narrow<5>(q, k, v, o, B, T, S, H, scale, st);
    case 6: return launch_narrow<6>(q, k, v, o, B, T, S, H, scale, st);
    case 7: return launch_narrow<7>(q, k, v, o, B, T, S, H, scale, st);
    case 8: return launch_narrow<8>(q, k, v, o, B, T, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

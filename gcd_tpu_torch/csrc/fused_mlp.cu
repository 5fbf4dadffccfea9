// K3: GEGLU feed-forward for Hopper (sm_90a), on wgmma.
//
// Replaces gcd_tpu/ops/fused_mlp.py::_kernel (pallas_call in _fused_forward,
// entry geglu_mlp). Computes, for x (M, C), W1 (2I, C) = [value ; gate] rows,
// b1 (2I), W2 (Cout, I), b2 (Cout), all bf16, torch Linear layouts:
//     a = bf16(bf16(x @ Wv^T) + bv)          g = bf16(bf16(x @ Wg^T) + bg)
//     h = bf16(a * gelu_erf(g))              out = bf16(h @ W2^T + b2)
// with fp32 accumulation in every product and b2 added in fp32 before the one
// rounding -- the rounding points of the TPU kernel (fused_mlp.py:116-126),
// with exact erf GELU. erf is the Abramowitz & Stegun 7.1.26 form that the
// TPU kernel's exact path evaluates (fused_mlp.py:_erf_gelu_exact; |error|
// <= 1.5e-7, three orders below a bf16 ulp): branch-free, one reciprocal and
// one exponential.
//
// What bounds it: operations. Each UNet call is 6 M C I = 105.7 GFLOP (26.4
// at the middle block) of products against at most 0.2 GB of operands. The
// products run on wgmma (bf16, fp32 accumulators). The GEGLU is one erf per
// element of h (55 M at ds1) on the CUDA cores, where ds1's small C = 320
// gives each up tile only five stages of products to hide it under.
//
// Design: two persistent kernels (one block an SM, tiles dealt round-robin),
// one C call, no atomics; every sum has a fixed order, so two calls give
// bit-identical results.
//   - Up (geglu_up_kernel): tiles of 192 rows of x by 64 inner columns i. A
//     tile's B operand is the 64 value rows [i0, i0 + 64) of W1 followed by
//     the 64 gate rows [I + i0, I + i0 + 64): one wgmma m64n128k16 product
//     puts a(., i) and g(., i) in the same thread (fragment column blocks k
//     and k + 8). Three product warpgroups (64 rows each) round and add the
//     biases there, as bf16 pairs, and stage the tile's a and g (bf16) in
//     shared memory; one GEGLU warpgroup turns the staged tile into h =
//     bf16(a * gelu(g)) and writes it with 16-byte stores while the product
//     warpgroups run the next tile (a `staged` and a `drained` mbarrier
//     guard the one staging buffer). The (M, 2I) up-projection never leaves
//     the SM; h is written once, bf16, to an (M, I) buffer the wrapper keeps
//     per stream (220 MB at ds1 for a served batch). 384 + 128 + 32 threads
//     leave 96 registers each, enough for the 64 accumulators.
//   - Down (geglu_down_kernel<BN>): tiles of 128 rows of h by BN columns, the
//     whole inner dimension accumulated in registers (two warpgroups, 224
//     registers each), then + b2 and one rounding. BN is 256, 160 or 128,
//     picked by the wrapper from the shape (ops/fused_mlp.py::down_tile):
//     the width that leaves the busiest SM the fewest columns to compute,
//     so that Cout = 320 and 640 are not padded to a multiple of 256 and
//     the few row tiles at ds4 and the middle block still spread over the
//     SMs.
//   Why h goes through device memory: keeping it on chip and adding the down
//   product over I needs a 64-row accumulator of all Cout columns (160 fp32
//   registers a thread at Cout = 320, 640 at 1280), so every Cout tile past
//   the first would recompute the up product (1.67x the products at ds1, 8x
//   at ds4), where the h round trip costs 2 M I bytes (66 us at ds1 at
//   3.35 TB/s, L2-resident at ds4 and the middle block).
// Both kernels: TMA (2D tensor maps, 128-byte swizzle, rows past M and
// columns past C zero-filled) feeds a ring of (BM x 64) A and (BN x 64) B
// stages, each guarded by a full and an empty mbarrier. One producer warp
// issues the copies and runs on into the next tile while the consumers
// finish this one; the product warpgroups issue wgmma with both operands
// from shared memory (K-major descriptors, SBO 1024: W1 and W2 are K-major in
// torch's Linear layout, as are x and h) and release each stage as soon as
// its products complete. A one-warp producer leaves the consumers more
// registers than a producer warpgroup's setmaxnreg would, and ptxas compiles
// every warp to the launch bounds' count anyway, so there is no setmaxnreg
// here. Output stores are masked at M (the middle block's M = 672 is no
// multiple of 192 or 128) and at Cout.
//
// Requires C % 8 == 0, I % 64 == 0, Cout % 8 == 0, all pointers 16-byte
// aligned (the wrapper checks).

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// Tiling constants; ops/fused_mlp.py mirrors BN_UP (INNER_TILE), BM_DOWN
// (DOWN_ROWS) and DOWN_TILES, and a test pins the two to each other
// (tests/test_torch_fused_mlp.py).
constexpr int BK = 64;             // depth of one stage (128 bytes of bf16)
// Up kernel: tiles of 192 rows (three product warpgroups of 64) by 64 inner
// columns (x2: value and gate); one GEGLU warpgroup; a producer warp. The
// ring, then a and g of one tile staged as bf16, rows padded by 16 bytes
// (conflict-free fragment stores), then the staging's two barriers.
constexpr int UP_WG = 3;
constexpr int BM_UP = 64 * UP_WG;
constexpr int BN_UP = 64;
constexpr int GEGLU_WG = 1;
constexpr int UP_THREADS = 128 * (UP_WG + GEGLU_WG) + 32;
constexpr int UP_STAGES = 4;
constexpr int STAGE_ROW = 2 * BN_UP * 2 + 16;
constexpr int STAGING_BYTES = BM_UP * STAGE_ROW;
// Down kernel: tiles of 128 rows (two product warpgroups) by one of
// DOWN_TILES columns; a producer warp; 288 threads, 224 registers each.
constexpr int DOWN_WG = 2;
constexpr int BM_DOWN = 64 * DOWN_WG;
constexpr int DOWN_TILES[3] = {256, 160, 128};  // down tile widths, preferred first
constexpr int DOWN_RING_BYTES = 200 * 1024;
constexpr int DOWN_THREADS = 128 * DOWN_WG + 32;

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * BK * 2; }
// Shared memory of a ring of `stages` stages: alignment slack, the stages,
// their barriers.
__host__ __device__ constexpr int ring_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (stage_bytes(bm, bn) + 16);
}
constexpr int UP_SMEM = ring_bytes(BM_UP, 2 * BN_UP, UP_STAGES) + STAGING_BYTES + 16;
template <int BN>
__host__ __device__ constexpr int down_stages() {
  return DOWN_RING_BYTES / stage_bytes(BM_DOWN, BN);
}

// 0.5 g (1 + erf(g / sqrt 2)), erf by Abramowitz & Stegun 7.1.26.
__device__ __forceinline__ float gelu_erf(float g) {
  const float z = g * 0.70710678118654752f;
  const float az = fabsf(z);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, az, 1.0f));
  float poly = fmaf(t, 1.061405429f, -1.453152027f);
  poly = fmaf(t, poly, 1.421413741f);
  poly = fmaf(t, poly, -0.284496736f);
  poly = fmaf(t, poly, 0.254829592f);
  poly *= t;
  const float erf_abs = fmaf(-poly, __expf(-az * az), 1.0f);
  const float hg = 0.5f * g;
  return fmaf(hg, copysignf(erf_abs, z), hg);
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16_ss(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t da, uint64_t db) {
  wgmma_m64n160k16_ss(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16_ss(d, da, db);
}

// The ring of operand stages shared by both kernels: STAGES (128 x 64) A +
// (BN x 64) B stages at a 1024-byte boundary, then their full and empty
// mbarriers (a stage is empty again once each consumer warp has released
// it).
template <int CWG, int BN, int STAGES>
struct Ring {
  static constexpr int BM = 64 * CWG, A_BYTES = BM * BK * 2, STAGE = stage_bytes(BM, BN);
  unsigned char* base;
  uint64_t *full, *empty;

  __device__ __forceinline__ explicit Ring(unsigned char* smem) {
    base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
    empty = full + STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CWG * 4);
      }
      mbar_fence_init();
    }
  }
  __device__ __forceinline__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(empty + STAGES);
  }

  // The producer (one thread): for each of this block's tiles (t =
  // blockIdx.x, + gridDim.x, ...; row tile t / n_tiles, column tile t %
  // n_tiles), the A rows at (k, row) and B with load_b(dst, bar, k, column
  // tile), running on into the next tile while the consumers finish this one.
  template <typename LoadB>
  __device__ __forceinline__ void produce(const CUtensorMap* amap, int K, int n_tiles,
                                          int tiles, LoadB load_b) {
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * BM, nt = t % n_tiles;
      for (int kt = 0; kt < (K + BK - 1) / BK; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], STAGE);
        unsigned char* s = base + st * STAGE;
        tma_load_2d(s, amap, &full[st], kt * BK, m0);
        load_b(s + A_BYTES, &full[st], kt * BK, nt);
      }
    }
  }

  // The consumer warpgroups (warps 0 .. 4 CWG - 1): per tile, acc (64 x BN,
  // the warpgroup's rows) = A . B^T over the stages, each stage released as
  // soon as its products are done; then epilogue(acc, row, column tile, n)
  // in each thread, row its fragment's first row, n the tile's index in
  // this block's sequence.
  template <typename Epilogue>
  __device__ __forceinline__ void consume(int K, int n_tiles, int tiles, Epilogue epilogue) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = warp / 4;
    float acc[BN / 2];
    int it = 0, n = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < (K + BK - 1) / BK; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const uint32_t a = smem_u32(base + st * STAGE) + g * 64 * BK * 2;
        const uint32_t b = smem_u32(base + st * STAGE + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_ss<BN>(acc, desc_sw128(a + k * 32, 0, 1024), desc_sw128(b + k * 32, 0, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the products of the previous stage are done
        __syncwarp();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      epilogue(acc, (t / n_tiles) * BM + g * 64 + (warp % 4) * 16 + lane / 4, t % n_tiles, n);
    }
  }
};

// h = bf16(a * gelu(g)) for row tiles of 192 and inner column tiles of 64.
// Warpgroups 0-2 run the products and stage a tile's a and g as bf16 in
// shared memory (bias added); warpgroup 3 (the GEGLU warpgroup) turns the
// staged tile into h and writes it with 16-byte stores while 0-2 run the next
// tile's products; the last warp loads. One staging buffer, guarded by a
// `staged` and a `drained` mbarrier.
__global__ void __launch_bounds__(UP_THREADS, 1)
geglu_up_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap w1map, const bf16* __restrict__ b1,
                bf16* __restrict__ h, int M, int C, int I) {
  extern __shared__ unsigned char smem_raw[];
  Ring<UP_WG, 2 * BN_UP, UP_STAGES> ring(smem_raw);
  unsigned char* stage_ag = ring.end();  // 16-byte aligned
  uint64_t* staged = reinterpret_cast<uint64_t*>(stage_ag + STAGING_BYTES);
  uint64_t* drained = staged + 1;
  if (threadIdx.x == 0) {
    mbar_init(staged, UP_WG * 4);
    mbar_init(drained, GEGLU_WG * 4);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = I / BN_UP, tiles = ((M + BM_UP - 1) / BM_UP) * n_tiles;

  if (warp == (UP_WG + GEGLU_WG) * 4) {  // the producer
    if (lane == 0) {
      const CUtensorMap* wm = &w1map;
      ring.produce(&xmap, C, n_tiles, tiles, [=](unsigned char* dst, uint64_t* bar, int k, int nt) {
        tma_load_2d(dst, wm, bar, k, nt * BN_UP);                      // value rows
        tma_load_2d(dst + BN_UP * BK * 2, wm, bar, k, I + nt * BN_UP);  // gate rows
      });
    }
    return;
  }

  if (warp >= UP_WG * 4) {  // the GEGLU warpgroup
    const int tid = threadIdx.x - UP_WG * 128;
    int n = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
      const int m0 = (t / n_tiles) * BM_UP, i0 = (t % n_tiles) * BN_UP;
      mbar_wait(staged, n & 1);
      // Chunks of 8 columns, BN_UP / 8 a row; thread tid takes chunks tid,
      // tid + 256, ...
      for (int e = tid; e < BM_UP * BN_UP / 8; e += GEGLU_WG * 128) {
        const int r = e / (BN_UP / 8), c8 = (e % (BN_UP / 8)) * 8;
        const unsigned char* rowp = stage_ag + r * STAGE_ROW;
        const uint4 av = *reinterpret_cast<const uint4*>(rowp + c8 * 2);
        const uint4 gv = *reinterpret_cast<const uint4*>(rowp + (BN_UP + c8) * 2);
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(&av);
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
        uint4 out;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a2 = unpack_bf16(aw[q]), g2 = unpack_bf16(gw[q]);
          ow[q] = pack_bf16(a2.x * gelu_erf(g2.x), a2.y * gelu_erf(g2.y));
        }
        if (m0 + r < M) *reinterpret_cast<uint4*>(h + (size_t)(m0 + r) * I + i0 + c8) = out;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(drained);
    }
    return;
  }

  ring.consume(C, n_tiles, tiles, [=](float (&acc)[BN_UP], int row, int nt, int n) {
    // Fragment column block j < 8 holds a's columns 8 j + 2 (lane % 4) +
    // {0, 1} of the tile, for rows row and row + 8; block j + 8 holds g's.
    // Staged: bf16(bf16(acc) + bias), a pair at a time, a's columns then g's.
    if (n > 0) mbar_wait(drained, (n - 1) & 1);
    const int r0 = row % BM_UP;
#pragma unroll
    for (int j = 0; j < BN_UP / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(b1 + nt * BN_UP + c);
      const __nv_bfloat162 bg =
          *reinterpret_cast<const __nv_bfloat162*>(b1 + I + nt * BN_UP + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned char* rowp = stage_ag + (r0 + 8 * half) * STAGE_ROW;
        const float* va = acc + 4 * j + 2 * half;
        const float* vg = acc + 4 * (j + BN_UP / 8) + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(rowp + c * 2) =
            __hadd2(__floats2bfloat162_rn(va[0], va[1]), bv);
        *reinterpret_cast<__nv_bfloat162*>(rowp + (BN_UP + c) * 2) =
            __hadd2(__floats2bfloat162_rn(vg[0], vg[1]), bg);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(staged);
  });
}

// out = bf16(h . W2^T + b2) for row tiles of 128 and column tiles of BN.
template <int BN>
__global__ void __launch_bounds__(DOWN_THREADS, 1)
geglu_down_kernel(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ b2,
                  bf16* __restrict__ out, int M, int I, int Cout) {
  extern __shared__ unsigned char smem_raw[];
  Ring<DOWN_WG, BN, down_stages<BN>()> ring(smem_raw);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (Cout + BN - 1) / BN, tiles = ((M + BM_DOWN - 1) / BM_DOWN) * n_tiles;
  if (warp == DOWN_WG * 4) {
    if (lane == 0) {
      const CUtensorMap* wm = &w2map;
      ring.produce(&hmap, I, n_tiles, tiles, [=](unsigned char* dst, uint64_t* bar, int k,
                                                 int nt) { tma_load_2d(dst, wm, bar, k, nt * BN); });
    }
    return;
  }
  ring.consume(I, n_tiles, tiles, [=](float (&acc)[BN / 2], int row, int nt, int) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int f = nt * BN + 8 * j + 2 * (lane & 3);
      if (f >= Cout) continue;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + f));
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (row + 8 * half < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8 * half) * Cout + f) =
              pack_bf16(acc[4 * j + 2 * half] + bias.x, acc[4 * j + 2 * half + 1] + bias.y);
    }
  });
}

// A 2D map over a row-major (rows, cols) bf16 matrix, boxes of 64 columns x
// `box_rows` rows.
bool matrix_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)BK, (uint32_t)box_rows};
  return cached_bf16_map(map, p, 2, dims, strides, box);
}

// Launch `kernel` persistently: one block an SM, no more than the tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int threads, int smem, long long tiles, int sms,
                              std::atomic<uint64_t>& done, cudaStream_t st, Args... args) {
  cudaError_t err = smem_limit_once(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(tiles < sms ? tiles : sms), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_down(const CUtensorMap& hm, const void* w2, const void* b2, void* out,
                        int M, int I, int Cout, int sms, cudaStream_t st) {
  CUtensorMap w2m;
  if (!matrix_map(&w2m, w2, Cout, I, BN)) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  const long long tiles = (long long)((M + BM_DOWN - 1) / BM_DOWN) * ((Cout + BN - 1) / BN);
  return launch_persistent(geglu_down_kernel<BN>, DOWN_THREADS,
                           ring_bytes(BM_DOWN, BN, down_stages<BN>()), tiles, sms,
                           done, st, hm, w2m, (const bf16*)b2, (bf16*)out, M, I, Cout);
}

}  // namespace

// out (M, Cout) = GEGLU MLP of x (M, C); h is (at least) M x I bf16 scratch;
// BN, one of DOWN_TILES, the down kernel's column tile.
// The two launches are enqueued under one lock, so another host thread's K3
// on the same stream (and so the same h) cannot fall between them.
extern "C" int gcd_geglu_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* h, void* out, int M, int C, int I,
                             int Cout, int BN, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || I <= 0 || I % BN_UP || Cout <= 0 || Cout % 8 ||
      (BN != DOWN_TILES[0] && BN != DOWN_TILES[1] && BN != DOWN_TILES[2]))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, w1m, hm;
  if (!matrix_map(&xm, x, M, C, BM_UP) || !matrix_map(&w1m, w1, 2 * I, C, BN_UP) ||
      !matrix_map(&hm, h, M, I, BM_DOWN))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = (cudaStream_t)stream;
  static std::atomic<uint64_t> up_set{0};
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err = launch_persistent(geglu_up_kernel, UP_THREADS, UP_SMEM,
                                      (long long)((M + BM_UP - 1) / BM_UP) * (I / BN_UP), sms,
                                      up_set, st, xm, w1m, (const bf16*)b1, (bf16*)h, M, C, I);
  if (err != cudaSuccess) return (int)err;
  switch (BN) {
    case 256: return (int)launch_down<256>(hm, w2, b2, out, M, I, Cout, sms, st);
    case 160: return (int)launch_down<160>(hm, w2, b2, out, M, I, Cout, sms, st);
    default: return (int)launch_down<128>(hm, w2, b2, out, M, I, Cout, sms, st);
  }
}

extern "C" const char* gcd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

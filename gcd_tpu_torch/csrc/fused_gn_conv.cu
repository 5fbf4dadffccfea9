// K7: GroupNorm -> SiLU -> 3x3 same-pad convolution, for Hopper (sm_90a),
// on wgmma.
//
// Replaces gcd_tpu/ops/fused_gn_conv.py::_kernel (pallas_call in
// _fused_forward, entry gn_silu_conv3x3). For x (N, H, W, C) channels-last,
// the GroupNorm affine gamma / beta (C), the conv weight w (F, 3, 3, C)
// (torch's (F, C, 3, 3) in channels_last memory) and its bias (F), all bf16:
//     a   = bf16(silu((x - mean) * (inv * gamma) + beta))     fp32, then one rounding
//     a   = 0 where the tap falls outside the plane            (after the norm)
//     out = bf16(sum over taps and channels of a * w + bias)  fp32 accumulation
// with mean / inv from the per-(sample, group) sums s1, s2 that K5
// (fused_norm.cu, channels-last) computes first: mean = s1 / n,
// inv = rsqrt(max(s2 / n - mean^2, 0) + eps), the variance clamped as the TPU
// kernel (fused_gn_conv.py:66-67) and the reference do. The padding is a zero
// of the normalised activation, not of x: zero-padding x would give
// silu(beta - mean * inv * gamma) at the border (fused_gn_conv.py:77-86).
// The SiLU is t * sigmoid(t) with sigmoid(t) = (1 + tanh(t / 2)) / 2 on the
// hardware tanh (relative error below 2^-10.9; a bf16 ulp is 2^-7).
//
// What bounds it: operations. Per UNet evaluation the 44 sites do 3.4 TFLOP
// of products against well under 1 GB of traffic, far above the H100's
// ridge point, so the products run on wgmma (bf16, fp32 accumulators).
//
// Design. An implicit GEMM, M = output pixels, N = filters, K = 9 * C, with
// the normalisation done once per input value and block:
//   - A block owns a spatial output tile of 192 pixels -- TH x TW pixels of
//     one sample, or NS whole planes of TH x TW = H x W when a plane is
//     smaller (4 x 6: eight planes, 8 x 12: two) -- and BN = 160 filters (which divides
//     320, 640 and 1280). The wrapper picks the tile (ops/fused_gn_conv.py
//     tile_plan) and a split of the channel chunks over blocks when the
//     tiles alone would leave SMs idle.
//   - The producer warpgroup's first lane walks the block's channel chunks
//     of 64. Per chunk it
//     loads, with TMA, the (NS, TH + 2, TW + 2, 64) halo tile of x (a 4D
//     tensor map; positions off the plane read as zero) and, with bulk
//     copies, the chunk's per-(sample, channel) scale and shift, into a
//     2-stage halo ring, one chunk ahead; and the nine (160 filters x 64
//     channels) weight tiles of the chunk's taps, with TMA, into a 4-stage
//     weight ring. Every stage has a full and an empty mbarrier. Both rings
//     are 128-byte swizzled.
//   - Three consumer warpgroups (64 pixels each) normalise the halo tile in
//     place, once: t = x * scale + shift, the SiLU, one bf16 rounding, and a
//     zero written wherever the halo position lies off the plane or past the
//     last sample (a per-block table of each halo pixel's sample, or -1,
//     built once; TMA's zero fill pads x, not a). Chunk i + 1's halo is
//     normalised right after chunk i's products. Two ways of hiding it
//     under the products -- slices between the taps' wgmma issues, and the
//     producer warpgroup's three idle warps as normalisers -- ran slower in
//     design runs on the H100, so the normalisation still stands between
//     the chunks.
//   - For each tap, every lane gives ldmatrix the shared-memory address of
//     its pixel's shifted halo row (a shifted window is no canonical wgmma
//     layout), which returns the m16n8k16 A fragments; wgmma m64n160k16
//     multiplies them from registers with the tap's weight tile from
//     shared memory (K-major descriptor). The fragments of tap t + 1 load
//     while the products of tap t run; the weight stage of tap t is
//     released as soon as they complete.
//   - Scale and shift are computed once per call, per (sample, channel),
//     by K5 (fused_norm.cu, one launch) from its sums, gamma and beta;
//     the C entry point launches K5 itself, so a call is one ctypes call
//     and one scratch allocation on the host.
//   - Split-K (4 x 6 and 8 x 12 planes, when the tiles alone would leave
//     SMs idle or a wave ragged): each split writes fp32 partial sums and a
//     second kernel adds them in split order with the bias. There are no
//     atomics anywhere, so two calls give bit-identical results.
// A block is three consumer warpgroups and one producer warpgroup (512
// threads, one block per SM at 186 KB of shared memory). ptxas gives a
// wgmma kernel of 512 threads 128 registers a thread, too few for the 80
// accumulators and two sets of A fragments (it spilled); setmaxnreg moves
// the producer warpgroup down to 56 and the consumers up to 152 (the ptxas
// report is printed by chip_smoke.py).
//
// Requires C % 64 == 0, C % G == 0, F % 8 == 0, x, w, out 16-byte aligned
// (the wrapper checks, and asks F % 64 as the TPU rule does).

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// The tiling constants BM, BN, CK, HALO_MAX and NS_MAX have Python mirrors in
// ops/fused_gn_conv.py (BLOCK_PIXELS, BLOCK_FILTERS, CHUNK, HALO_MAX,
// SAMPLES_MAX), from which tile_plan picks the tile; a test pins the two to
// each other (tests/test_torch_fused_gn_conv.py).
constexpr int BN = 160;             // filters per block
constexpr int CK = 64;              // channels per chunk
constexpr int CWG = 3;              // consumer warpgroups, 64 pixels each
constexpr int BM = 64 * CWG;        // output pixels per block
constexpr int THREADS = 128 * (CWG + 1);  // the consumers, then the producer warpgroup
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 152;  // 3 x 128 x 152 + 128 x 56 = 64 K
constexpr int CONSUMERS = 128 * CWG;
constexpr int HALO_MAX = 384;       // halo pixels per block
constexpr int NS_MAX = 8;           // samples per block
constexpr int HALO_BYTES = HALO_MAX * CK * 2;
constexpr int TABLE_BYTES = NS_MAX * CK * 8;
constexpr int HSTAGE = HALO_BYTES + TABLE_BYTES;  // a multiple of 1024
constexpr int HSTAGES = 2;
constexpr int WTILE = BN * CK * 2;                // a multiple of 1024
constexpr int WSTAGES = 4;
constexpr int SMEM = 1024 + HSTAGES * HSTAGE + WSTAGES * WTILE + 256 + HALO_MAX * 2;

struct Plan {
  int N, H, W, C, F;
  int TH, TW, NS;         // output tile: NS samples x TH rows x TW columns
  int tiles_y, tiles_x;   // tiles per sample plane
  int splits;             // channel-chunk splits (blockIdx.z)
  int silu;
};

__device__ __forceinline__ float silu(float t) {
  const float h = 0.5f * t;
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

// Two channels of x (a bf16 pair) normalised with their (scale, shift)
// pairs ss, SiLU'd when `on`, rounded to a bf16 pair.
__device__ __forceinline__ uint32_t norm_pair(uint32_t x2, float4 ss, int on) {
  const float2 v = unpack_bf16(x2);
  float t0 = fmaf(v.x, ss.x, ss.y), t1 = fmaf(v.y, ss.z, ss.w);
  if (on) {
    t0 = silu(t0);
    t1 = silu(t1);
  }
  return pack_bf16(t0, t1);
}

// Normalise a halo tile in place: this consumer thread's steps, step k the
// 16 bytes (8 channels) e = tid + k * CONSUMERS < E, of halo pixel e / 8,
// logical channel group e % 8. `where[hp]` is the halo pixel's sample in
// the tile, or -1 off the plane or past the last sample.
__device__ __forceinline__ void normalise(unsigned char* hb, const int16_t* where, int E,
                                          int silu_on, int tid) {
  const float2* tbl = reinterpret_cast<const float2*>(hb + HALO_BYTES);
  for (int e = tid; e < E; e += CONSUMERS) {
    const int hp = e >> 3, j = e & 7;
    const int ns = where[hp];
    uint4* a = reinterpret_cast<uint4*>(hb + hp * 128 + ((j ^ (hp & 7)) << 4));
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ns >= 0) {
      const uint4 v = *a;
      const float4* t4 = reinterpret_cast<const float4*>(tbl + ns * CK + j * 8);
      u.x = norm_pair(v.x, t4[0], silu_on);
      u.y = norm_pair(v.y, t4[1], silu_on);
      u.z = norm_pair(v.z, t4[2], silu_on);
      u.w = norm_pair(v.w, t4[3], silu_on);
    }
    *a = u;
  }
}

// The A fragments of one tap: 16 pixels x 64 channels of the warp, from the
// normalised halo at `hsm`, halo pixel hp of this lane's row.
__device__ __forceinline__ void load_a(uint32_t (&fr)[4][4], uint32_t hsm, int hp, int khalf) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(fr[kk], hsm + hp * 128 + (((2 * kk + khalf) ^ (hp & 7)) << 4));
}

__global__ void __launch_bounds__(THREADS, 1)
gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float2* __restrict__ table, const bf16* __restrict__ bias,
                       bf16* __restrict__ out, float* __restrict__ partial, Plan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* halo = base;                          // [HSTAGES][halo | table]
  unsigned char* wts = base + HSTAGES * HSTAGE;        // [WSTAGES][BN rows of 128 bytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(wts + WSTAGES * WTILE);
  uint64_t* hfull = bars;
  uint64_t* hempty = bars + HSTAGES;
  uint64_t* wfull = bars + 2 * HSTAGES;
  uint64_t* wempty = bars + 2 * HSTAGES + WSTAGES;
  int16_t* where = reinterpret_cast<int16_t*>(bars + 32);  // [HALO_MAX]

  const int tiles = p.tiles_y * p.tiles_x;
  const int nb = blockIdx.x / tiles, rem = blockIdx.x % tiles;
  const int n0 = nb * p.NS, y0 = (rem / p.tiles_x) * p.TH, x0 = (rem % p.tiles_x) * p.TW;
  const int f0 = blockIdx.y * BN;
  const int chunks = p.C / CK;
  const int cb = blockIdx.z * chunks / p.splits, nch = (blockIdx.z + 1) * chunks / p.splits - cb;
  const int HWp = p.TW + 2, HP = (p.TH + 2) * HWp;  // halo row length, pixels per sample
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], CWG * 4);
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], CWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CWG * 4) {
    // The producer warpgroup hands its registers to the consumers; its first
    // lane issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // Producer: the halo of chunk 0, then per chunk i its nine weight tiles
    // and the halo of chunk i + 1.
    if (warp == CWG * 4 && lane == 0) {
      const int valid_ns = min(p.NS, p.N - n0);
      const uint32_t halo_tx = p.NS * HP * CK * 2 + valid_ns * CK * 8;
      // Step 0 loads halo 0; step i + 1 the weights of chunk i, then halo i + 1.
      for (int i = -1; i < nch; ++i) {
        for (int tap = 0; i >= 0 && tap < 9; ++tap) {
          const int wi = i * 9 + tap, ws = wi % WSTAGES;
          mbar_wait(&wempty[ws], ((wi / WSTAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&wfull[ws], WTILE);
          tma_load_2d(wts + ws * WTILE, &wmap, &wfull[ws], tap * p.C + (cb + i) * CK, f0);
        }
        const int h = i + 1, hs = h % HSTAGES, c0 = (cb + h) * CK;
        if (h >= nch) break;
        mbar_wait(&hempty[hs], ((h / HSTAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&hfull[hs], halo_tx);
        unsigned char* hb = halo + hs * HSTAGE;
        tma_load_4d(hb, &xmap, &hfull[hs], c0, x0 - 1, y0 - 1, n0);
        for (int s = 0; s < valid_ns; ++s)
          bulk_load(hb + HALO_BYTES + s * CK * 8, table + (size_t)(n0 + s) * p.C + c0, CK * 8,
                    &hfull[hs]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumers. Lane l of warp wi in warpgroup g reads, through ldmatrix, the
  // halo row of pixel g * 64 + wi * 16 + (l % 16), channels 8 (l / 16) + 16 kk.
  const int tid = threadIdx.x, g = warp / 4, wi = warp % 4;
  const int tile_px = p.NS * p.TH * p.TW;
  int hbase = 0;
  {
    const int px = g * 64 + wi * 16 + (lane & 15);
    if (px < tile_px) {
      const int ns = px / (p.TH * p.TW), r = px % (p.TH * p.TW);
      hbase = ns * HP + (r / p.TW) * HWp + r % p.TW;
    }
  }
  const int khalf = lane >> 4;
  // Each halo pixel's sample in the tile, or -1 where a is zero.
  for (int hp = tid; hp < p.NS * HP; hp += CONSUMERS) {
    const int ns = hp / HP, r = hp % HP;
    const int yy = y0 - 1 + r / HWp, xx = x0 - 1 + r % HWp;
    where[hp] = (n0 + ns < p.N && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) ? ns : -1;
  }
  named_barrier(1, CONSUMERS);
  const int E = p.NS * HP * 8;

  float acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0.0f;
  uint32_t afr[2][4][4];

  mbar_wait(&hfull[0], 0);
  normalise(halo, where, E, p.silu, tid);
  named_barrier(1, CONSUMERS);

  for (int i = 0; i < nch; ++i) {
    const int hs = i % HSTAGES;
    const uint32_t hsm = smem_u32(halo + hs * HSTAGE);
    const bool next = i + 1 < nch;
    unsigned char* hn = halo + ((i + 1) % HSTAGES) * HSTAGE;

    load_a(afr[0], hsm, hbase, khalf);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int wi9 = i * 9 + tap, ws = wi9 % WSTAGES;
      mbar_wait(&wfull[ws], (wi9 / WSTAGES) & 1);
      const uint32_t wb = smem_u32(wts + ws * WTILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n160k16_rs(acc, afr[tap & 1][kk], desc_sw128(wb + kk * 32, 0, 1024));
      wgmma_commit();
      if (tap > 0) {
        wgmma_wait<1>();  // the products of tap - 1 are done
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(afr[(tap - 1) & 1][kk]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&wempty[(wi9 - 1) % WSTAGES]);
      }
      if (tap < 8)
        load_a(afr[(tap + 1) & 1], hsm, hbase + ((tap + 1) / 3) * HWp + (tap + 1) % 3, khalf);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(afr[0][kk]);
    fence_proxy_async();  // this proxy wrote the halo stage the TMA refills
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&wempty[(i * 9 + 8) % WSTAGES]);
      mbar_arrive(&hempty[hs]);
    }
    if (next) {
      mbar_wait(&hfull[(i + 1) % HSTAGES], ((i + 1) / HSTAGES) & 1);
      normalise(hn, where, E, p.silu, tid);
    }
    named_barrier(1, CONSUMERS);  // the next chunk's halo is normalised
  }

  // Epilogue: accumulator rows lane / 4 and lane / 4 + 8 of the warp's 16
  // pixels, filters f0 + 8 c + 2 (lane % 4) and the next.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int px = g * 64 + wi * 16 + lane / 4 + 8 * half;
    if (px >= tile_px) continue;
    const int ns = px / (p.TH * p.TW), r = px % (p.TH * p.TW);
    const int n = n0 + ns, y = y0 + r / p.TW, x = x0 + r % p.TW;
    if (n >= p.N || y >= p.H || x >= p.W) continue;
    const size_t row = ((size_t)n * p.H + y) * p.W + x;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int f = f0 + 8 * c + 2 * (lane & 3);
      if (f >= p.F) continue;
      const float v0 = acc[4 * c + 2 * half], v1 = acc[4 * c + 2 * half + 1];
      if (p.splits == 1) {
        *reinterpret_cast<uint32_t*>(out + row * p.F + f) =
            pack_bf16(v0 + __bfloat162float(bias[f]), v1 + __bfloat162float(bias[f + 1]));
      } else {
        const size_t m = (size_t)p.N * p.H * p.W;
        *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * m + row) * p.F + f) =
            make_float2(v0, v1);
      }
    }
  }
}

// out = bf16(sum over splits, in split order, of the partial sums + bias).
__global__ void splitk_sum_kernel(const float2* __restrict__ partial,
                                  const bf16* __restrict__ bias, bf16* __restrict__ out,
                                  long long pairs, int F, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int f = (int)((2 * i) % F);
  float2 s = partial[i];
  for (int k = 1; k < splits; ++k) {
    const float2 t = partial[k * pairs + i];
    s.x += t.x;
    s.y += t.y;
  }
  *reinterpret_cast<uint32_t*>(out + 2 * i) =
      pack_bf16(s.x + __bfloat162float(bias[f]), s.y + __bfloat162float(bias[f + 1]));
}

}  // namespace

// K5, channels-last, with the scale / shift table (fused_norm.cu).
extern "C" int gcd_group_stats_cl(const void* x, void* work, void* s1, void* s2, int N, int C,
                                  int P, int G, const void* gamma, const void* beta,
                                  void* table, float eps, void* stream);

// K7: out (N, H, W, F) = conv3x3(silu(x * scale + shift), w) + bias,
// channels-last, with `table` (N, C) float2 the per-(sample, channel)
// (scale, shift). With `stats`, K5 writes the table first from x, gamma,
// beta and eps (its scratch `work`, as gcd_group_stats_cl takes it, and its
// sums s1, s2, (N, G) fp32 each); else the table is given. `partial`
// is (splits, N * H * W, F) fp32 scratch when splits > 1 (else unused). TH,
// TW, NS, splits: the tile plan. Tensor maps come from cached_bf16_map: the
// weights' stay put, and the UNet's activations come back to the same
// addresses evaluation after evaluation.
extern "C" int gcd_gn_silu_conv3x3(const void* x, const void* w, const void* gamma,
                                   const void* beta, const void* bias, void* work, void* s1,
                                   void* s2, void* table, void* partial, void* out, int N, int H,
                                   int W, int C, int F, int G, float eps, int stats,
                                   int silu_on, int TH, int TW, int NS, int splits,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % CK || F <= 0 || F % 8 ||
      TH <= 0 || TW <= 0 || NS <= 0 || NS > NS_MAX || TH * TW * NS > BM ||
      NS * (TH + 2) * (TW + 2) > HALO_MAX || TW + 2 > 256 || TH + 2 > 256 || splits <= 0 ||
      splits > C / CK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Plan p;
  p.N = N; p.H = H; p.W = W; p.C = C; p.F = F;
  p.TH = TH; p.TW = TW; p.NS = NS;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles_x = (W + TW - 1) / TW;
  p.splits = splits;
  p.silu = silu_on;
  const long long blocks = (long long)((N + NS - 1) / NS) * p.tiles_y * p.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  CUtensorMap xm, wm;
  const uint64_t xdims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t xstr[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2};
  const uint32_t xbox[4] = {(uint32_t)CK, (uint32_t)(TW + 2), (uint32_t)(TH + 2), (uint32_t)NS};
  const uint64_t wdims[2] = {(uint64_t)9 * C, (uint64_t)F};
  const uint64_t wstr[1] = {(uint64_t)9 * C * 2};
  const uint32_t wbox[2] = {(uint32_t)CK, (uint32_t)BN};
  if (!cached_bf16_map(&xm, x, 4, xdims, xstr, xbox) ||
      !cached_bf16_map(&wm, w, 2, wdims, wstr, wbox))
    return (int)cudaErrorInvalidValue;

  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = smem_limit_once(gn_silu_conv3x3_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  if (stats) {
    const int e = gcd_group_stats_cl(x, work, s1, s2, N, C, H * W, G, gamma, beta, table, eps,
                                     stream);
    if (e) return e;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((F + BN - 1) / BN), (unsigned)splits);
  gn_silu_conv3x3_kernel<<<grid, THREADS, SMEM, st>>>(xm, wm, (const float2*)table,
                                                      (const bf16*)bias, (bf16*)out,
                                                      (float*)partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)N * H * W * F / 2;
  splitk_sum_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
      (const float2*)partial, (const bf16*)bias, (bf16*)out, pairs, F, splits);
  return (int)cudaGetLastError();
}

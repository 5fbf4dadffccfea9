// K4 / K5: GroupNorm(32) with optional SiLU, and its per-group statistics,
// for Hopper (sm_90a).
//
// Replaces gcd_tpu/ops/fused_norm.py::_kernel (K4, pallas_call in
// _fused_forward, entry fused_group_norm) and ::_stats_kernel (K5, entry
// group_stats_pallas). Semantics are those of _reference_groupnorm:
//     mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0)    (fp32)
//     y    = (x - mean) * (rsqrt(var + eps) * gamma) + beta       (fp32)
//     y    = y * sigmoid(y)                                       (if silu)
// rounded once to bf16. The TPU kernel does not clamp the variance; this
// one does, as the reference does. y is written at x's own offsets, so it
// keeps x's memory layout.
//
// What bounds it: memory (about 10 fp32 operations per 4 bytes moved). The
// design goal is to move each value the fewest times. Two memory orders:
//
// Channels-first, x read as (N, C, F, L): a group (n, g) is F segments of
// S = (C/G) * L contiguous values, segment f at n*sN + f*sF + g*S. A
// contiguous (N, C, *spatial) tensor is F = 1; the (B, C, T, H, W) view of a
// contiguous (B, T, C, H, W) video (the time_stack GroupNorms) is F = T,
// L = H*W, so the view is normalised in place of a copy.
//   - one pass (K4 alone): a group of at most FUSED_MAX values (96 KB of
//     bf16) is loaded once into one block's shared memory, reduced there and
//     written once: 1 read + 1 write.
//   - split (K5, then K4's apply pass): larger groups (VAE planes at full
//     resolution, 5.5 M values per group in the decoder's time_stack) are cut
//     into fixed chunks; one block per chunk writes its fp32 (sum, sum of
//     squares), one block per group adds the partials in a fixed order, and
//     the apply pass reads x again: 2 reads + 1 write.
//
// Channels-last, x read as (N, P, C) with channels fastest: the layout the
// port's convolutions produce (its engine takes channels-last frames and
// latents, and cuDNN keeps that memory format), and the TPU kernel's own.
// A group's values are strided by C, so every group of a sample is reduced
// together. K4 takes one of two variants, by a rule on the shape alone
// (ops/fused_norm.py::uses_split_path; a test pins the constants):
//   (a) one pass, cluster-resident, where N >= OP_MIN_N and a sample cut in
//       OP_CLUSTER spans of ceil(P / OP_CLUSTER) pixels fits OP_BYTES of
//       shared memory a span: every per-frame site of the UNet (N = 28, or
//       56 when serving two clips). A sample is one thread-block cluster of
//       OP_CLUSTER blocks (cudaLaunchKernelEx). Each block loads its span
//       once with bulk copies, sums it per channel from shared memory, folds
//       the sums into the (at most two) groups each thread's 8 channels
//       touch and adds them per group as K5 does; every block then adds the
//       cluster's block sums through distributed shared memory in rank
//       order (so all hold the same sums), normalises its span from shared
//       memory and writes y with 16-byte stores: 1 read + 1 write, one
//       launch, no scratch. With fewer samples (the time_stack views,
//       N = 2) the grid would hold fewer than OP_MIN_N * OP_CLUSTER = 128
//       blocks for the card's 132 SMs, where (b) spreads the plane over all.
//   (b) otherwise K5 (one launch, below), whose last block of each sample
//       writes the (N, C) float2 (scale, shift) table (K7's), then K4's
//       apply pass over that table: 16-byte loads and stores of 8 channels,
//       K5's partition with 8 loads in flight a thread, and its blocks in
//       reverse order, so that the second read of x starts where K5's read
//       ended (the part most likely still in L2): 2 reads + 1 write, two
//       launches, K5's per-stream scratch.
// K5 on channels-last input is one launch (group_stats_cl_kernel): a
// sample's pixels are cut into blocks of `rows` pixels, each block reads its
// rows as one contiguous span with 16-byte loads (8 channels; every
// main-path C is a multiple of 8), each thread always the same 8 channels,
// all of a thread's loads issued before its sums. A thread folds its
// per-channel sums into the (at most two) groups its 8 channels touch, in
// registers; `sub` lanes per group add the block's thread sums through 8 KB
// of shared memory, in a fixed order. Small blocks (256 threads where
// C <= 2048, at most 64 registers) keep four blocks an SM, and a call aims at
// one wave of them; the partition is computed on the host and passed by
// value. A block writes its group partials; the last block of a sample to
// finish -- elected by an atomic ticket (atomicInc wrapping at the block
// count, so each call leaves the ticket zero), which orders nothing but the
// election -- adds the sample's partials in a fixed order and writes the
// sums and, for K7 and K4's apply pass, the (scale, shift) table from each
// group's mean and 1 / std. A sample of one block skips the partials and
// the ticket. Where a sample has many blocks (at least CL_CLUSTER_FROM: the
// time_stack views at N = 2, the decoder's planes at N = 1), its blocks form
// thread-block clusters of 8, whose first block adds the cluster's sums
// through distributed shared memory, so that the last block adds an eighth
// as many partials.
//
// No sum is taken in atomic order: the partition and the order of every sum
// depend only on the shape, so the statistics are bit-identical from run to
// run. Requires bf16 x / gamma / beta and C % G == 0; channels-first also
// L % 8 == 0 and a 16-byte-aligned x (16-byte accesses); channels-last
// C % 8 == 0, C <= 4096, an even C / G of at least 4 (8 aligned channels
// then touch at most two groups), G <= 256 and no more than the block's
// whole warps' threads, and a 16-byte-aligned x.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // bf16 values per 16-byte access
constexpr int FUSED_MAX = 49152;     // values of one group on the one-pass path
// Channels-last K5 partition; ops/fused_norm.py mirrors CL_THREADS,
// CL_MAX_THREADS, CL_UNROLL, CL_BLOCKS and TICKETS (cl_stats_plan,
// cl_stats_work), and a test pins them.
constexpr int CL_THREADS = 256;      // threads a block aims at
constexpr int CL_MAX_THREADS = 512;  // most threads of a block (C / 8 when larger)
constexpr int CL_UNROLL = 8;         // 16-byte loads in flight per thread
constexpr int CL_BLOCKS = 512;       // blocks a call aims at, at most (one wave)
constexpr int CL_CLUSTER = 8;        // blocks a cluster
constexpr int CL_CLUSTER_FROM = 64;  // blocks a sample from which they form clusters
constexpr int CL_SUB = 8;            // most lanes adding one group's sums
constexpr int TICKETS = 4096;        // most samples of a call (one ticket each)
// Channels-last K4 variant (a); ops/fused_norm.py mirrors them (a test pins
// them).
constexpr int OP_CLUSTER = 8;        // blocks a sample (one cluster)
constexpr int OP_MIN_N = 16;         // fewest samples
constexpr int OP_BYTES = 163840;     // most bytes of x a block holds
constexpr int OP_THREADS = 512;      // threads a block aims at
constexpr int OP_CHUNKS = 4;         // bulk copies (one mbarrier each) a block's span

struct Layout {                      // channels-first (N, C, F, L)
  int N, C, F, L, G;
  long long sN, sF;                  // sample and frame strides, in values
  __device__ int cpg() const { return C / G; }
  __device__ int seg() const { return (C / G) * L; }
};

__device__ __forceinline__ void unpack8(const uint4& u, float v[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// Sum (a, b) over a block of THREADS threads; fixed shuffle / tree order, so
// deterministic.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 red[THREADS / 32];
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 v = lane < THREADS / 32 ? red[lane] : make_float2(0.0f, 0.0f);
    a = v.x;
    b = v.y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) red[0] = make_float2(a, b);
  }
  __syncthreads();
  const float2 out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ void moments(float s1, float s2, float count, float eps,
                                        float* mean, float* inv) {
  const float m = s1 / count;
  *mean = m;
  *inv = rsqrtf(fmaxf(s2 / count - m * m, 0.0f) + eps);
}

__device__ __forceinline__ float norm1(float v, float mean, float scale, float shift,
                                       int silu) {
  const float t = (v - mean) * scale + shift;
  return silu ? t / (1.0f + expf(-t)) : t;
}

// Channels-first: normalise the 8 values of channel c at src, store at dst.
__device__ __forceinline__ void apply8(const uint4& src, bf16* dst, int c, float mean,
                                       float inv, const bf16* gamma, const bf16* beta,
                                       int silu) {
  const float scale = inv * __bfloat162float(gamma[c]);
  const float shift = __bfloat162float(beta[c]);
  float v[VEC];
  unpack8(src, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = norm1(v[i], mean, scale, shift, silu);
  *reinterpret_cast<uint4*>(dst) = pack8(v);
}

// One pass: block (n, g) keeps its group in shared memory.
__global__ void __launch_bounds__(THREADS)
group_norm_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta, bf16* __restrict__ y, Layout lo,
                        float eps, int silu) {
  extern __shared__ uint4 tile[];
  const int n = blockIdx.x / lo.G, g = blockIdx.x % lo.G;
  const int S = lo.seg();
  const int SV = S / VEC;
  const int EV = lo.F * SV;
  const long long base = n * lo.sN + (long long)g * S;
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < EV; i += THREADS) {
    const int f = i / SV;
    const uint4 u = *reinterpret_cast<const uint4*>(
        x + base + f * lo.sF + (long long)(i - f * SV) * VEC);
    tile[i] = u;
    float v[VEC];
    unpack8(u, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1 += v[k];
      s2 += v[k] * v[k];
    }
  }
  const float2 tot = block_sum2(s1, s2);  // its barriers also publish `tile`
  float mean, inv;
  moments(tot.x, tot.y, (float)lo.F * (float)S, eps, &mean, &inv);
  for (int i = threadIdx.x; i < EV; i += THREADS) {
    const int f = i / SV;
    const int r = (i - f * SV) * VEC;
    apply8(tile[i], y + base + f * lo.sF + r, g * lo.cpg() + r / lo.L, mean, inv, gamma,
           beta, silu);
  }
}

// Split path, K5 first half: block b = ((n*G + g)*F + f)*chunks + k sums
// values [k*chunk, min(S, (k+1)*chunk)) of segment f of group (n, g).
__global__ void __launch_bounds__(THREADS)
group_stats_partial_kernel(const bf16* __restrict__ x, float2* __restrict__ part, Layout lo,
                           int chunk, int chunks) {
  const long long b = blockIdx.x;
  const int k = (int)(b % chunks);
  const int f = (int)((b / chunks) % lo.F);
  const int ng = (int)(b / ((long long)chunks * lo.F));
  const int n = ng / lo.G, g = ng % lo.G;
  const int S = lo.seg();
  const int r1 = min(S, (k + 1) * chunk);
  const bf16* seg = x + n * lo.sN + f * lo.sF + (long long)g * S;
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = k * chunk + threadIdx.x * VEC; r < r1; r += THREADS * VEC) {
    float v[VEC];
    unpack8(*reinterpret_cast<const uint4*>(seg + r), v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
    }
  }
  const float2 tot = block_sum2(s1, s2);
  if (threadIdx.x == 0) part[b] = tot;
}

// K5 second half (channels-first): block ng = n*G + g adds its group's P
// partials part[ng*P + i] in order i.
__global__ void __launch_bounds__(THREADS)
group_stats_finalize_kernel(const float2* __restrict__ part, float* __restrict__ s1,
                            float* __restrict__ s2, int P) {
  const int ng = blockIdx.x;
  const float2* p = part + (long long)ng * P;
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < P; i += THREADS) {
    a += p[i].x;
    b += p[i].y;
  }
  const float2 tot = block_sum2(a, b);
  if (threadIdx.x == 0) {
    s1[ng] = tot.x;
    s2[ng] = tot.y;
  }
}

// Split path, K4's apply pass: same block decomposition as the partials.
__global__ void __launch_bounds__(THREADS)
group_norm_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta, const float* __restrict__ s1,
                        const float* __restrict__ s2, bf16* __restrict__ y, Layout lo,
                        int chunk, int chunks, float eps, int silu) {
  const long long b = blockIdx.x;
  const int k = (int)(b % chunks);
  const int f = (int)((b / chunks) % lo.F);
  const int ng = (int)(b / ((long long)chunks * lo.F));
  const int n = ng / lo.G, g = ng % lo.G;
  const int S = lo.seg();
  float mean, inv;
  moments(s1[ng], s2[ng], (float)lo.F * (float)S, eps, &mean, &inv);
  const int r1 = min(S, (k + 1) * chunk);
  const long long base = n * lo.sN + f * lo.sF + (long long)g * S;
  for (int r = k * chunk + threadIdx.x * VEC; r < r1; r += THREADS * VEC) {
    apply8(*reinterpret_cast<const uint4*>(x + base + r), y + base + r,
           g * lo.cpg() + r / lo.L, mean, inv, gamma, beta, silu);
  }
}

// The channels-last K5 partition of N (P, C) samples, computed on the host:
// `lanes` pixel lanes of C / 8 threads each; a chunk is `rows` = lanes *
// CL_UNROLL pixels (one load per thread in flight for each); a block takes
// `per` consecutive chunks, as few as keep the call at or under CL_BLOCKS
// blocks (before the padding below). A sample of at least CL_CLUSTER_FROM
// such blocks has them in `clusters` thread-block clusters of `cluster` =
// CL_CLUSTER blocks, its last blocks empty where its chunks do not fill
// them; otherwise cluster = 1. `used` blocks a sample hold pixels, `blocks`
// = clusters * cluster blocks per sample; `sub` lanes add one group's sums
// (the most, up to CL_SUB, that keep sub * G within the block's whole
// warps).
struct ClPlan {
  int vpr, lanes, threads, rows, per, used, cluster, clusters, blocks, sub;
};

ClPlan cl_plan(int N, int C, int P, int G) {
  ClPlan q;
  q.vpr = C / VEC;
  q.lanes = q.vpr < CL_THREADS ? CL_THREADS / q.vpr : 1;
  q.threads = q.vpr * q.lanes;
  q.rows = q.lanes * CL_UNROLL;
  const int chunks = (P + q.rows - 1) / q.rows;
  const int cap = CL_BLOCKS / N > 1 ? CL_BLOCKS / N : 1;
  q.per = (chunks + cap - 1) / cap;
  q.used = (chunks + q.per - 1) / q.per;
  q.cluster = q.used >= CL_CLUSTER_FROM ? CL_CLUSTER : 1;
  q.clusters = (q.used + q.cluster - 1) / q.cluster;
  q.blocks = q.clusters * q.cluster;
  q.sub = CL_SUB;
  while (q.sub > 1 && q.sub * G > (q.threads & ~31)) q.sub >>= 1;
  return q;
}

// Adds t over the `sub` consecutive lanes of a group (a butterfly: every
// lane forms the same sum).
__device__ __forceinline__ float2 lanes_sum(float2 t, int sub) {
  for (int o = 1; o < sub; o <<= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
  }
  return t;
}

// The (at most two) group sums of a thread's 8 channels starting at channel
// c0: channels in order, those before the next group boundary into `lo`.
__device__ __forceinline__ void fold2(const float a[VEC], const float a2[VEC], int c0, int cpg,
                                      float2* lo, float2* hi) {
  const int split = min(VEC, (c0 / cpg + 1) * cpg - c0);
  *lo = make_float2(0.0f, 0.0f);
  *hi = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < split) {
      lo->x += a[i];
      lo->y += a2[i];
    } else {
      hi->x += a[i];
      hi->y += a2[i];
    }
  }
}

// A block's sum of group g from its threads' two group sums in `red`
// (2 * tid: lo, 2 * tid + 1: hi): `sub` lanes, lane j adding, for pixel lanes
// l = j, j + sub, ... in order, the vectors that touch g in order (each
// vector's first sum where it starts in g, else its second); a butterfly
// adds the lanes, so every lane of the group returns the sum.
__device__ __forceinline__ float2 block_group_sum(const float2* red, int g, int j, int G,
                                                  int cpg, int lanes, int vpr, int sub) {
  float2 t = make_float2(0.0f, 0.0f);
  if (g < G) {
    const int c0 = g * cpg, v0 = c0 / VEC, v1 = (c0 + cpg - 1) / VEC;
    for (int l = j; l < lanes; l += sub)
      for (int v = v0; v <= v1; ++v) {
        const float2 r = red[2 * (l * vpr + v) + (v * VEC >= c0 ? 0 : 1)];
        t.x += r.x;
        t.y += r.y;
      }
  }
  return lanes_sum(t, sub);
}

// K5, channels-last, one launch. Block b of sample n (blockIdx.x = n*blocks
// + b) takes pixels [b*per*rows, (b+1)*per*rows); thread t owns channels
// 8 v .. 8 v + 7 (v = t % vpr) at pixel lane l = t / vpr, and sums its
// lane's pixels b*per*rows + l + i*lanes, i = 0, 1, ..., in order i. It
// adds its 8 channels in order into two sums: those of group g0 = 8 v / cpg
// and those of group g0 + 1 (channels past the group's end). Group g's
// block sum: `sub` lanes, lane j adding, for pixel lanes l = j, j + sub,
// ... in order, the vectors v = 8 g / cpg ... that touch g in order (each
// vector's first sum where it starts in g, else its second); a butterfly
// adds the sub lanes. In a cluster, its first block adds the blocks' sums
// in block order, reading them from their shared memory (distributed
// shared memory). With one cluster (or block) a sample, that is the
// sample's sum. Otherwise the cluster's first block writes
// part[(n*clusters + c)*G + g] for its cluster c, and the sample's last
// cluster (ticket) adds the sample's partials: lane j of a group takes
// clusters j, j + sub, ... in order, and a butterfly adds the lanes. It
// writes s1, s2 and, with `table`, the (scale, shift) of each channel for
// a = x * scale + shift (K7's).
// Launch bounds: 64 registers a thread, so four blocks of 256 threads fit an
// SM.
__global__ void __launch_bounds__(CL_MAX_THREADS, 2)
group_stats_cl_kernel(const bf16* __restrict__ x, unsigned int* __restrict__ tickets,
                      float2* __restrict__ part, float* __restrict__ s1,
                      float* __restrict__ s2, const ClPlan q, int C, int P, int G,
                      const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                      float2* __restrict__ table, float eps) {
  __shared__ float2 red[2 * CL_MAX_THREADS];  // each thread's two group sums, 8 KB
  __shared__ float2 grp[256];                 // the block's group sums
  __shared__ int last;
  const int n = blockIdx.x / q.blocks, b = blockIdx.x - n * q.blocks;
  const int tid = threadIdx.x, lane = tid / q.vpr, vec = tid - lane * q.vpr;
  const int cpg = C / G;
  const int g = tid / q.sub, j = tid % q.sub;  // a group's lane, for the sums
  const bool adds = tid < ((q.sub * G + 31) & ~31);  // whole warps, for the butterflies

  // Per-channel sums of this thread's pixels.
  float a[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = a2[i] = 0.0f;
  const bf16* xs = x + (size_t)n * P * C + vec * VEC;
  for (int r = 0; r < q.per; ++r) {
    const int p0 = (b * q.per + r) * q.rows + lane;
    if (p0 >= P) break;
    uint4 u[CL_UNROLL];
#pragma unroll
    for (int k = 0; k < CL_UNROLL; ++k) {
      const int p = p0 + k * q.lanes;
      u[k] = p < P ? __ldg(reinterpret_cast<const uint4*>(xs + (size_t)p * C))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < CL_UNROLL; ++k) {
      float v[VEC];
      unpack8(u[k], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] += v[i];
        a2[i] += v[i] * v[i];
      }
    }
  }
  // Into the thread's (at most two) groups, channels in order.
  float2 lo, hi;
  fold2(a, a2, vec * VEC, cpg, &lo, &hi);
  red[2 * tid] = lo;
  red[2 * tid + 1] = hi;
  __syncthreads();
  if (adds) {
    const float2 t = block_group_sum(red, g, j, G, cpg, q.lanes, q.vpr, q.sub);
    if (g < G && j == 0) grp[g] = t;
  }
  __syncthreads();

  // The cluster's sums, in its first block (in `red`, free again there);
  // the other blocks wait until it has read their `grp`, then leave.
  float2* sums = grp;
  if (q.cluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const bool first = cluster.block_rank() == 0;
    if (first && tid < G) {
      float2 t = make_float2(0.0f, 0.0f);
      for (int k = 0; k < q.cluster; ++k) {
        const float2 v = cluster.map_shared_rank(grp, k)[tid];
        t.x += v.x;
        t.y += v.y;
      }
      red[tid] = t;
    }
    cluster.sync();
    if (!first) return;
    sums = red;
  }

  // One cluster a sample: its sums are the sample's. Otherwise the last
  // cluster of sample n to get here adds the cluster partials.
  if (q.clusters > 1) {
    if (tid < G) {
      part[((size_t)n * q.clusters + b / q.cluster) * G + tid] = sums[tid];
      __threadfence();
    }
    __syncthreads();
    if (tid == 0)
      last = atomicInc(&tickets[n], (unsigned)(q.clusters - 1)) == (unsigned)(q.clusters - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  // The sample's last cluster (or only one). Thread t takes the table's
  // channels t, t + threads, ... (at most 8, as threads >= C / 8); their
  // gamma and beta are read before the partials are added.
  const bool tab = table != nullptr;
  float gam[VEC], bet[VEC];
  if (tab) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int ch = tid + i * q.threads;
      gam[i] = ch < C ? __bfloat162float(gamma[ch]) : 0.0f;
      bet[i] = ch < C ? __bfloat162float(beta[ch]) : 0.0f;
    }
  }
  if (q.clusters > 1) {
    if (adds) {
      const float2* mine = part + (size_t)n * q.clusters * G + g;
      float2 t = make_float2(0.0f, 0.0f);
      if (g < G) {
#pragma unroll 8
        for (int k = j; k < q.clusters; k += q.sub) {
          const float2 v = __ldcg(mine + (size_t)k * G);
          t.x += v.x;
          t.y += v.y;
        }
      }
      t = lanes_sum(t, q.sub);
      if (g < G && j == 0) grp[g] = t;
    }
    sums = grp;
  }
  __syncthreads();
  // Each group's sums, then its mean and 1 / std (in `red`: free again
  // here) for the table.
  const float count = (float)P * (float)cpg;
  if (tid < G) {
    const float2 t = sums[tid];
    s1[n * G + tid] = t.x;
    s2[n * G + tid] = t.y;
    const float mean = t.x / count;
    red[tid + 256] = make_float2(mean, rsqrtf(fmaxf(t.y / count - mean * mean, 0.0f) + eps));
  }
  if (!tab) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = tid + i * q.threads;
    if (ch < C) {
      const float2 m = red[ch / cpg + 256];
      const float scale = m.y * gam[i];
      table[(size_t)n * C + ch] = make_float2(scale, bet[i] - m.x * scale);
    }
  }
}

// x * scale + shift (+ SiLU) of 8 values, in fp32, rounded once. The SiLU
// takes the fast exponential and division (a few ulp of fp32, far below the
// bf16 rounding): at the one-pass sites the exact ones cost as much issue
// time as the memory traffic.
__device__ __forceinline__ uint4 norm8(const uint4& u, const float sc[VEC], const float sh[VEC],
                                       int silu) {
  float v[VEC];
  unpack8(u, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float t = fmaf(v[i], sc[i], sh[i]);
    v[i] = silu ? __fdividef(t, 1.0f + __expf(-t)) : t;
  }
  return pack8(v);
}

// Channels-last K4, variant (a)'s partition: `lanes` pixel lanes of C / 8
// threads each (as many as keep the block at OP_THREADS, at least one), a
// span of ceil(P / OP_CLUSTER) pixels a block, `sub` lanes adding one group's
// sums (as in cl_plan).
struct OpPlan {
  int vpr, lanes, threads, span, sub;
};

OpPlan op_plan(int C, int P, int G) {
  OpPlan q;
  q.vpr = C / VEC;
  q.lanes = q.vpr < OP_THREADS ? OP_THREADS / q.vpr : 1;
  q.threads = q.vpr * q.lanes;
  q.span = (P + OP_CLUSTER - 1) / OP_CLUSTER;
  q.sub = CL_SUB;
  while (q.sub > 1 && q.sub * G > (q.threads & ~31)) q.sub >>= 1;
  return q;
}

// Channels-last K4, variant (a): one cluster of OP_CLUSTER blocks a sample
// (blockIdx.x = n * OP_CLUSTER + rank). Block `rank` holds pixels
// [rank * span, min(P, (rank + 1) * span)) in shared memory, loaded in
// OP_CHUNKS bulk copies. Thread t owns channels 8 v .. 8 v + 7 (v = t % vpr)
// at pixel lane l = t / vpr and sums its lane's pixels l, l + lanes, ... of
// the span in order; the block's group sums as K5 forms them; then each
// block adds the cluster's block sums in rank order and normalises its
// span: y = x * scale + shift (+ SiLU), scale = rsqrt(var + eps) * gamma,
// shift = beta - mean * scale.
__global__ void __launch_bounds__(OP_THREADS, 1)
group_norm_cl_onepass_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                             const bf16* __restrict__ beta, bf16* __restrict__ y,
                             const OpPlan q, int C, int P, int G, float eps, int silu) {
  extern __shared__ uint4 span[];               // the block's pixels, (np, C) bf16
  __shared__ float2 red[2 * OP_THREADS];        // each thread's two group sums, 16 KB
  __shared__ float2 grp[256];                   // the block's group sums
  __shared__ float2 mom[256];                   // each group's mean and 1 / std
  __shared__ __align__(8) uint64_t bars[OP_CHUNKS];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / OP_CLUSTER, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid / q.vpr, vec = tid - lane * q.vpr;
  const int cpg = C / G;
  const int p0 = rank * q.span, np = max(0, min(P, p0 + q.span) - p0);
  const int cp = (np + OP_CHUNKS - 1) / OP_CHUNKS;  // pixels a bulk copy

  if (tid == 0) {
    for (int k = 0; k < OP_CHUNKS; ++k) mbar_init(&bars[k], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const bf16* src = x + ((size_t)n * P + p0) * C;
    for (int k = 0; k < OP_CHUNKS; ++k) {
      const int c0 = k * cp, c1 = min(np, c0 + cp);
      if (c0 >= c1) break;
      const uint32_t bytes = (uint32_t)(c1 - c0) * C * 2;
      mbar_arrive_expect_tx(&bars[k], bytes);
      bulk_load(span + (size_t)c0 * q.vpr, src + (size_t)c0 * C, bytes, &bars[k]);
    }
  }

  // Per-channel sums of this thread's pixels, chunk by chunk as they land.
  float a[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = a2[i] = 0.0f;
  int p = lane;
  for (int k = 0; k < OP_CHUNKS && k * cp < np; ++k) {
    const int c1 = min(np, (k + 1) * cp);
    if (p >= c1) continue;
    mbar_wait(&bars[k], 0);
    for (; p < c1; p += q.lanes) {
      float v[VEC];
      unpack8(span[(size_t)p * q.vpr + vec], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] += v[i];
        a2[i] += v[i] * v[i];
      }
    }
  }
  float2 lo, hi;
  fold2(a, a2, vec * VEC, cpg, &lo, &hi);
  red[2 * tid] = lo;
  red[2 * tid + 1] = hi;
  __syncthreads();
  const int g = tid / q.sub, j = tid % q.sub;
  if (tid < ((q.sub * G + 31) & ~31)) {
    const float2 t = block_group_sum(red, g, j, G, cpg, q.lanes, q.vpr, q.sub);
    if (g < G && j == 0) grp[g] = t;
  }
  cluster.sync();
  // The sample's sums: every block adds the cluster's in rank order.
  const float count = (float)P * (float)cpg;
  if (tid < G) {
    float2 t = make_float2(0.0f, 0.0f);
    for (int r = 0; r < OP_CLUSTER; ++r) {
      const float2 v = cluster.map_shared_rank(grp, r)[tid];
      t.x += v.x;
      t.y += v.y;
    }
    const float mean = t.x / count;
    mom[tid] = make_float2(mean, rsqrtf(fmaxf(t.y / count - mean * mean, 0.0f) + eps));
  }
  // Done reading the other blocks' shared memory: they may leave once every
  // block has arrived (the wait at the end).
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  float sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = vec * VEC + i;
    const float2 m = mom[ch / cpg];
    sc[i] = m.y * __bfloat162float(gamma[ch]);
    sh[i] = __bfloat162float(beta[ch]) - m.x * sc[i];
  }
  uint4* dst = reinterpret_cast<uint4*>(y + ((size_t)n * P + p0) * C) + vec;
  for (int r = lane; r < np; r += q.lanes)
    dst[(size_t)r * q.vpr] = norm8(span[(size_t)r * q.vpr + vec], sc, sh, silu);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Channels-last K4, variant (b): the apply pass over K5's (scale, shift)
// table, with K5's partition (cl_plan) and its blocks in reverse order:
// block index N * used - 1 - blockIdx.x is block b of sample n, and takes
// K5's block b's pixels. Thread t owns channels 8 v .. 8 v + 7 at pixel lane
// l, as in K5.
__global__ void __launch_bounds__(CL_MAX_THREADS)
group_norm_cl_table_kernel(const bf16* __restrict__ x, const float2* __restrict__ table,
                           bf16* __restrict__ y, const ClPlan q, int N, int C, int P,
                           int silu) {
  const int idx = N * q.used - 1 - (int)blockIdx.x;
  const int n = idx / q.used, b = idx - n * q.used;
  const int tid = threadIdx.x, lane = tid / q.vpr, vec = tid - lane * q.vpr;
  float sc[VEC], sh[VEC];
  const float4* tab = reinterpret_cast<const float4*>(table + (size_t)n * C + vec * VEC);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float4 t = __ldg(tab + i);
    sc[2 * i] = t.x;
    sh[2 * i] = t.y;
    sc[2 * i + 1] = t.z;
    sh[2 * i + 1] = t.w;
  }
  const size_t off = (size_t)n * P * C + vec * VEC;
  const uint4* xs = reinterpret_cast<const uint4*>(x + off);
  uint4* ys = reinterpret_cast<uint4*>(y + off);
  const int vpr = q.vpr;
  for (int r = 0; r < q.per; ++r) {
    const int p0 = (b * q.per + r) * q.rows + lane;
    if (p0 >= P) break;
    uint4 u[CL_UNROLL];
#pragma unroll
    for (int k = 0; k < CL_UNROLL; ++k) {
      const int p = p0 + k * q.lanes;
      u[k] = p < P ? __ldg(xs + (size_t)p * vpr) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < CL_UNROLL; ++k) {
      const int p = p0 + k * q.lanes;
      if (p < P) ys[(size_t)p * vpr] = norm8(u[k], sc, sh, silu);
    }
  }
}

bool valid(const Layout& lo) {
  return lo.N > 0 && lo.G > 0 && lo.C % lo.G == 0 && lo.F > 0 && lo.L > 0 && lo.L % VEC == 0 &&
         lo.sN % VEC == 0 && lo.sF % VEC == 0;
}

// Channels-last shapes the kernels take (K5's constraints).
bool valid_cl(int N, int C, int P, int G) {
  return N > 0 && P > 0 && C > 0 && C % VEC == 0 && C / VEC <= CL_MAX_THREADS && G > 0 &&
         G <= 256 && C % G == 0 && (C / G) % 2 == 0 && C / G >= 4;
}

Layout make_layout(int N, int C, int F, int L, long long sN, long long sF, int G) {
  Layout lo;
  lo.N = N; lo.C = C; lo.F = F; lo.L = L; lo.G = G; lo.sN = sN; lo.sF = sF;
  return lo;
}

}  // namespace

// K5, channels-first: s1[n, g] = sum x, s2[n, g] = sum x^2 over group (n, g),
// fp32. `part` is scratch of N*G*F*ceil(S/chunk) float2.
extern "C" int gcd_group_stats(const void* x, void* part, void* s1, void* s2, int N, int C,
                               int F, int L, long long sN, long long sF, int G, int chunk,
                               void* stream) {
  const Layout lo = make_layout(N, C, F, L, sN, sF, G);
  if (!valid(lo) || chunk <= 0 || chunk % VEC) return (int)cudaErrorInvalidValue;
  const int S = (C / G) * L;
  const int chunks = (S + chunk - 1) / chunk;
  const long long blocks = (long long)N * G * F * chunks;
  cudaStream_t st = (cudaStream_t)stream;
  group_stats_partial_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      (const bf16*)x, (float2*)part, lo, chunk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_stats_finalize_kernel<<<(unsigned)(N * G), THREADS, 0, st>>>(
      (const float2*)part, (float*)s1, (float*)s2, F * chunks);
  return (int)cudaGetLastError();
}

// K5, channels-last (N, P, C), one launch. `work` is scratch: TICKETS
// unsigned ints that are zero (each call leaves them zero), then
// N * cl_plan(N, C, P, G).clusters * G float2 of partials. With a non-null
// `table` ((N, C) float2), also the GroupNorm's per-(sample, channel) scale
// and shift for gamma, beta and eps (K7's).
extern "C" int gcd_group_stats_cl(const void* x, void* work, void* s1, void* s2, int N, int C,
                                  int P, int G, const void* gamma, const void* beta,
                                  void* table, float eps, void* stream) {
  if (!valid_cl(N, C, P, G) || N > TICKETS) return (int)cudaErrorInvalidValue;
  const ClPlan q = cl_plan(N, C, P, G);
  if ((long long)N * q.blocks > 0x7fffffffLL || G > (q.threads & ~31))
    return (int)cudaErrorInvalidValue;
  unsigned int* tickets = (unsigned int*)work;
  float2* part = (float2*)(tickets + TICKETS);
  cudaStream_t st = (cudaStream_t)stream;
  if (q.cluster == 1) {
    group_stats_cl_kernel<<<(unsigned)(N * q.blocks), q.threads, 0, st>>>(
        (const bf16*)x, tickets, part, (float*)s1, (float*)s2, q, C, P, G, (const bf16*)gamma,
        (const bf16*)beta, (float2*)table, eps);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * q.blocks));
  cfg.blockDim = dim3((unsigned)q.threads);
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)q.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, group_stats_cl_kernel, (const bf16*)x, tickets, part,
                                 (float*)s1, (float*)s2, q, C, P, G, (const bf16*)gamma,
                                 (const bf16*)beta, (float2*)table, eps);
}

// K4, channels-first. With s1 == s2 == NULL: one pass, the group (F*S
// values) must be at most FUSED_MAX. Otherwise the apply pass over
// statistics from K5.
extern "C" int gcd_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                              const void* s1, const void* s2, int N, int C, int F, int L,
                              long long sN, long long sF, int G, float eps, int silu,
                              int chunk, void* stream) {
  const Layout lo = make_layout(N, C, F, L, sN, sF, G);
  if (!valid(lo)) return (int)cudaErrorInvalidValue;
  const int S = (C / G) * L;
  cudaStream_t st = (cudaStream_t)stream;
  if (s1 == nullptr || s2 == nullptr) {
    const long long values = (long long)F * S;
    if (values > FUSED_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)values * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        group_norm_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    group_norm_fused_kernel<<<(unsigned)(N * G), THREADS, smem, st>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y, lo, eps, silu);
    return (int)cudaGetLastError();
  }
  if (chunk <= 0 || chunk % VEC) return (int)cudaErrorInvalidValue;
  const int chunks = (S + chunk - 1) / chunk;
  const long long blocks = (long long)N * G * F * chunks;
  group_norm_apply_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const float*)s1,
      (const float*)s2, (bf16*)y, lo, chunk, chunks, eps, silu);
  return (int)cudaGetLastError();
}

// K4, channels-last (N, P, C), variant (a): one launch, one cluster a
// sample. Refuses a shape outside variant (a)'s rule.
extern "C" int gcd_group_norm_cl_onepass(const void* x, const void* gamma, const void* beta,
                                         void* y, int N, int C, int P, int G, float eps, int silu,
                                         void* stream) {
  if (!valid_cl(N, C, P, G) || N < OP_MIN_N || N > 0x7fffffff / OP_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const OpPlan q = op_plan(C, P, G);
  const long long bytes = (long long)q.span * C * 2;
  if (bytes > OP_BYTES || G > (q.threads & ~31)) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = smem_limit_once(group_norm_cl_onepass_kernel, OP_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * OP_CLUSTER));
  cfg.blockDim = dim3((unsigned)q.threads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = OP_CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, group_norm_cl_onepass_kernel, (const bf16*)x,
                                 (const bf16*)gamma, (const bf16*)beta, (bf16*)y, q, C, P, G,
                                 eps, silu);
}

// K4, channels-last (N, P, C), variant (b). `table` is (N, C) float2, 16-byte
// aligned. With `stats`, K5 writes it first (its scratch `work` as
// gcd_group_stats_cl takes it, its sums into `sums`, 2 * N * G fp32); else
// the table is given. Then the apply pass over the table.
extern "C" int gcd_group_norm_cl(const void* x, const void* gamma, const void* beta, void* y,
                                 void* work, void* sums, void* table, int N, int C, int P, int G,
                                 float eps, int stats, int silu, void* stream) {
  if (!valid_cl(N, C, P, G)) return (int)cudaErrorInvalidValue;
  const ClPlan q = cl_plan(N, C, P, G);
  if ((long long)N * q.used > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (stats) {
    float* s1 = (float*)sums;
    const int e = gcd_group_stats_cl(x, work, s1, s1 + (size_t)N * G, N, C, P, G, gamma, beta,
                                     table, eps, stream);
    if (e) return e;
  }
  group_norm_cl_table_kernel<<<(unsigned)(N * q.used), q.threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float2*)table, (bf16*)y, q, N, C, P, silu);
  return (int)cudaGetLastError();
}

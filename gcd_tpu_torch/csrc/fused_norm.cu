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
// together. K5 here is one launch (group_stats_cl_kernel): a sample's pixels
// are cut into blocks of `rows` pixels, each block reads its rows as one
// contiguous span with 16-byte loads (8 channels; every main-path C is a
// multiple of 8), each thread always the same 8 channels, all of a thread's
// loads issued before its sums. A thread folds its per-channel sums into
// the (at most two) groups its 8 channels touch, in registers; `sub` lanes
// per group add the block's thread sums through 8 KB of shared memory, in
// a fixed order. Small blocks (256 threads where C <= 2048, at most 64
// registers) keep four blocks an SM, and a call aims at one wave of them;
// the partition is computed on the host and passed by value. A block writes
// its group partials; the last block of a sample to finish -- elected by an
// atomic ticket (atomicInc wrapping at the block count, so each call leaves
// the ticket zero), which orders nothing but the election -- adds the
// sample's partials in a fixed order and writes the sums and, for K7, the
// (scale, shift) table from each group's mean and 1 / std. A sample of one
// block skips the partials and the ticket. Where a sample has many blocks
// (at least CL_CLUSTER_FROM: the time_stack views at N = 2, the decoder's
// planes at N = 1), its blocks form thread-block clusters of 8, whose first
// block adds the cluster's sums through distributed shared memory, so that
// the last block adds an eighth as many partials. K4's apply pass reads x
// again: 2 reads + 1 write.
//
// No sum is taken in atomic order: the partition and the order of every sum
// depend only on the shape, so the statistics are bit-identical from run to
// run. Requires bf16 x / gamma / beta and C % G == 0; channels-first also
// L % 8 == 0 and a 16-byte-aligned x (16-byte accesses); K4's channels-last
// apply pass an even C / G and a 4-byte-aligned x (the wrapper checks);
// channels-last K5 C % 8 == 0, C <= 4096, an even C / G of at least 4 (8
// aligned channels then touch at most two groups), G <= 256 and no more than the
// block's whole warps' threads, and a 16-byte-aligned x.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // bf16 values per 16-byte access
constexpr int FUSED_MAX = 49152;     // values of one group on the one-pass path
constexpr int CL_PAIRS = 32;         // channels-last apply: channel pairs per block
constexpr int CL_LANES = THREADS / CL_PAIRS;  // channels-last apply: pixel lanes per block
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
// them; otherwise cluster = 1. `blocks` = clusters * cluster blocks per
// sample; `sub` lanes add one group's sums (the most, up to CL_SUB, that
// keep sub * G within the block's whole warps).
struct ClPlan {
  int vpr, lanes, threads, rows, per, cluster, clusters, blocks, sub;
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
  const int used = (chunks + q.per - 1) / q.per;
  q.cluster = used >= CL_CLUSTER_FROM ? CL_CLUSTER : 1;
  q.clusters = (used + q.cluster - 1) / q.cluster;
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
  // Into the thread's (at most) two groups, channels in order.
  const int split = min(VEC, (vec * VEC / cpg + 1) * cpg - vec * VEC);
  float2 lo = make_float2(0.0f, 0.0f), hi = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < split) {
      lo.x += a[i];
      lo.y += a2[i];
    } else {
      hi.x += a[i];
      hi.y += a2[i];
    }
  }
  red[2 * tid] = lo;
  red[2 * tid + 1] = hi;
  __syncthreads();
  if (adds) {
    float2 t = make_float2(0.0f, 0.0f);
    if (g < G) {
      const int c0 = g * cpg, v0 = c0 / VEC, v1 = (c0 + cpg - 1) / VEC;
      for (int l = j; l < q.lanes; l += q.sub) {
        for (int v = v0; v <= v1; ++v) {
          const float2 r = red[2 * (l * q.vpr + v) + (v * VEC >= c0 ? 0 : 1)];
          t.x += r.x;
          t.y += r.y;
        }
      }
    }
    t = lanes_sum(t, q.sub);
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

// Channels-last K4 apply pass, same block decomposition as its partials.
__global__ void __launch_bounds__(THREADS)
group_norm_cl_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                           const bf16* __restrict__ beta, const float* __restrict__ s1,
                           const float* __restrict__ s2, bf16* __restrict__ y, int C, int P,
                           int G, int ptile, float eps, int silu) {
  const int pair = blockIdx.y * CL_PAIRS + threadIdx.x;
  if (pair >= C / 2) return;  // no barriers below
  const int n = blockIdx.z;
  const int c = 2 * pair;
  const int ng = n * G + c / (C / G);
  float mean, inv;
  moments(s1[ng], s2[ng], (float)P * (float)(C / G), eps, &mean, &inv);
  const float sc0 = inv * __bfloat162float(gamma[c]), sc1 = inv * __bfloat162float(gamma[c + 1]);
  const float sh0 = __bfloat162float(beta[c]), sh1 = __bfloat162float(beta[c + 1]);
  const long long base = (long long)n * P * C + c;
  const int p1 = min(P, (blockIdx.x + 1) * ptile);
  for (int p = blockIdx.x * ptile + threadIdx.y; p < p1; p += CL_LANES) {
    const long long off = base + (long long)p * C;
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
    *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(
        norm1(v.x, mean, sc0, sh0, silu), norm1(v.y, mean, sc1, sh1, silu));
  }
}

bool valid(const Layout& lo) {
  return lo.N > 0 && lo.G > 0 && lo.C % lo.G == 0 && lo.F > 0 && lo.L > 0 && lo.L % VEC == 0 &&
         lo.sN % VEC == 0 && lo.sF % VEC == 0;
}

bool valid_cl(int N, int C, int P, int G, int ptile) {
  return N > 0 && N <= 65535 && P > 0 && G > 0 && C % G == 0 && (C / G) % 2 == 0 &&
         ptile > 0;
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
  if (N <= 0 || N > TICKETS || P <= 0 || C <= 0 || C % VEC || C / VEC > CL_MAX_THREADS ||
      G <= 0 || G > 256 || C % G || (C / G) % 2 || C / G < 4)
    return (int)cudaErrorInvalidValue;
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

// K4, channels-last (N, P, C): the apply pass over statistics from K5.
extern "C" int gcd_group_norm_cl(const void* x, const void* gamma, const void* beta, void* y,
                                 const void* s1, const void* s2, int N, int C, int P, int G,
                                 float eps, int silu, int ptile, void* stream) {
  if (!valid_cl(N, C, P, G, ptile)) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + ptile - 1) / ptile, (C / 2 + CL_PAIRS - 1) / CL_PAIRS, N);
  group_norm_cl_apply_kernel<<<grid, dim3(CL_PAIRS, CL_LANES), 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const float*)s1,
      (const float*)s2, (bf16*)y, C, P, G, ptile, eps, silu);
  return (int)cudaGetLastError();
}

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
// together: a block covers 64 channels (a 128-byte row of each pixel, as
// bf16 pairs; C/G is even, so a pair never straddles two groups) over a
// tile of pixels and writes per-pair partials; one block per group adds its
// pairs' partials over all tiles in a fixed order; the apply pass reads x
// again. 2 reads + 1 write.
//
// Neither path uses atomics: the partition and the order of every sum depend
// only on the shape, so the statistics are bit-identical from run to run.
// Requires bf16 x / gamma / beta and C % G == 0; channels-first also
// L % 8 == 0 and a 16-byte-aligned x (16-byte accesses), channels-last an
// even C / G and a 4-byte-aligned x (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // bf16 values per 16-byte access
constexpr int FUSED_MAX = 49152;     // values of one group on the one-pass path
constexpr int CL_PAIRS = 32;         // channels-last: channel pairs per block
constexpr int CL_LANES = THREADS / CL_PAIRS;  // channels-last: pixel lanes per block

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

// K5 second half: block ng = n*G + g adds its group's partials in order i.
//   channels-first: partial i < P is part[ng*P + i].
//   channels-last:  partial i = t*ppg + j (tile t, the group's pair j) is
//                   part[(n*tiles + t)*pairs + g*ppg + j].
__global__ void __launch_bounds__(THREADS)
group_stats_finalize_kernel(const float2* __restrict__ part, float* __restrict__ s1,
                            float* __restrict__ s2, int G, int P, int tiles, int pairs,
                            int channels_last) {
  const int ng = blockIdx.x;
  float a = 0.0f, b = 0.0f;
  if (!channels_last) {
    const float2* p = part + (long long)ng * P;
    for (int i = threadIdx.x; i < P; i += THREADS) {
      a += p[i].x;
      b += p[i].y;
    }
  } else {
    const int n = ng / G, g = ng % G;
    const int ppg = pairs / G;
    const float2* p = part + (long long)n * tiles * pairs + g * ppg;
    for (int i = threadIdx.x; i < tiles * ppg; i += THREADS) {
      const float2 v = p[(long long)(i / ppg) * pairs + i % ppg];
      a += v.x;
      b += v.y;
    }
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

// Channels-last K5 first half. Block (tile, channel block, n), threads
// (pair lane tx, pixel lane ty): thread sums channel pair cb*32 + tx over
// pixels tile*ptile + ty, + CL_LANES, ...; the CL_LANES lanes are added in
// order and each pair's partial is written to part[(n*tiles + tile)*pairs
// + pair].
__global__ void __launch_bounds__(THREADS)
group_stats_cl_partial_kernel(const bf16* __restrict__ x, float2* __restrict__ part, int C,
                              int P, int ptile) {
  __shared__ float2 red[CL_LANES][CL_PAIRS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int pairs = C / 2;
  const int pair = blockIdx.y * CL_PAIRS + tx;
  const int n = blockIdx.z;
  const int p1 = min(P, (blockIdx.x + 1) * ptile);
  float a = 0.0f, b = 0.0f;
  if (pair < pairs) {
    const bf16* xp = x + (long long)n * P * C + 2 * pair;
    for (int p = blockIdx.x * ptile + ty; p < p1; p += CL_LANES) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xp + (long long)p * C));
      a += v.x + v.y;
      b += v.x * v.x + v.y * v.y;
    }
  }
  red[ty][tx] = make_float2(a, b);
  __syncthreads();
  if (ty == 0 && pair < pairs) {
    float2 s = red[0][tx];
#pragma unroll
    for (int i = 1; i < CL_LANES; ++i) {
      s.x += red[i][tx].x;
      s.y += red[i][tx].y;
    }
    part[((long long)n * gridDim.x + blockIdx.x) * pairs + pair] = s;
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
      (const float2*)part, (float*)s1, (float*)s2, G, F * chunks, 0, 0, 0);
  return (int)cudaGetLastError();
}

// K5, channels-last (N, P, C). `part` is scratch of N*ceil(P/ptile)*(C/2)
// float2.
extern "C" int gcd_group_stats_cl(const void* x, void* part, void* s1, void* s2, int N, int C,
                                  int P, int G, int ptile, void* stream) {
  if (!valid_cl(N, C, P, G, ptile)) return (int)cudaErrorInvalidValue;
  const int tiles = (P + ptile - 1) / ptile;
  const dim3 grid(tiles, (C / 2 + CL_PAIRS - 1) / CL_PAIRS, N);
  cudaStream_t st = (cudaStream_t)stream;
  group_stats_cl_partial_kernel<<<grid, dim3(CL_PAIRS, CL_LANES), 0, st>>>(
      (const bf16*)x, (float2*)part, C, P, ptile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_stats_finalize_kernel<<<(unsigned)(N * G), THREADS, 0, st>>>(
      (const float2*)part, (float*)s1, (float*)s2, G, 0, tiles, C / 2, 1);
  return (int)cudaGetLastError();
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

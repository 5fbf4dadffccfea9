// K7: GroupNorm -> SiLU -> 3x3 same-pad convolution in one kernel, for
// Hopper (sm_90a).
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
// ridge point, so the products run on tensor cores (mma.sync m16n8k16 bf16,
// fp32 accumulators, operands from shared memory through ldmatrix).
//
// Design. The TPU kernel holds a whole sample plane in VMEM and computes the
// statistics in-kernel; a Hopper block cannot see a plane, so K5 runs first
// and this kernel is an implicit GEMM: M = N*H*W output pixels, N = F
// filters, K = 9*C (channel slices of BK outer, the 9 taps inner). Block
// (pixel tile, filter tile) owns a 64 x 160 output tile; 8 warps of 32 x 40.
// Both operands stream through a 4-stage cp.async ring: the A tile (pixels x
// channels of one tap) straight from x, zero-filled where the tap leaves the
// plane; the B tile (filters x channels of one tap), contiguous in the
// channels_last weight. After its products of one k-step, each thread
// normalises in place the A values it copied for the next (scale and shift
// per channel from the statistics, SiLU, one bf16 rounding, zero outside the
// plane), so the normalised activation never reaches device memory and one
// barrier per k-step publishes it. Each block runs its whole K loop, with no
// atomics, so two calls give bit-identical results. At under 128 registers a
// thread and 70 KB of shared memory a block, two blocks fit an SM; 128-pixel
// tiles needed 184 registers, one block an SM, and ran slower.
//
// Requires C % 32 == 0, C % G == 0, F % 8 == 0, 16-byte aligned x, w and
// out (the wrapper checks, and asks C % 64 and F % 64 as the TPU rule does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;              // output pixels per block
constexpr int BN = 160;             // filters per block (divides 320, 640, 1280)
constexpr int BK = 32;              // channels of one tap per k-step
constexpr int STAGES = 4;           // cp.async ring depth
constexpr int THREADS = 256;        // 8 warps: 2 along pixels x 4 along filters
constexpr int WARPS_N = 4;
constexpr int WN = BN / WARPS_N;    // 40 filters per warp
constexpr int NT = WN / 8;          // n8 tiles per warp
constexpr int LDK = BK + 8;         // staged row pitch (bf16): 80 bytes, ldmatrix conflict-free
constexpr int WM = BM / 2;          // pixels per warp
constexpr int MT = WM / 16;         // m16 tiles per warp
constexpr int A_STAGE = BM * LDK;   // bf16 values
constexpr int STAGE = (BM + BN) * LDK;
constexpr int SMEM = STAGES * STAGE * 2;      // bytes: 71,680
constexpr int CPT = BM * (BK / 8) / THREADS;  // 16-byte A chunks per thread
constexpr int TPR = (BK / 8) / CPT;           // threads per A row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float silu(float t) {
  const float h = 0.5f * t;
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

struct Shape {
  int N, H, W, C, F, G;
  float eps;
  int silu;
};

__global__ void __launch_bounds__(THREADS, 2)
gn_silu_conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                       const bf16* __restrict__ bias, const float* __restrict__ s1,
                       const float* __restrict__ s2, bf16* __restrict__ out, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int C = sh.C, HW = sh.H * sh.W;
  const long long M = (long long)sh.N * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int KS = 9 * (C / BK);

  // The A row this thread copies and normalises: pixel m0 + arow, channels
  // aq*8 .. (aq + CPT)*8 - 1 of each slice.
  const int arow = tid / TPR, aq = (tid % TPR) * CPT;
  const long long am = m0 + arow;
  const bool row_ok = am < M;
  const int an = row_ok ? (int)(am / HW) : 0;
  const int arem = row_ok ? (int)(am % HW) : 0;
  const int py = arem / sh.W, px = arem % sh.W;
  const bf16* xrow = x + (long long)an * HW * C + aq * 8;

  auto inside = [&](int tap, int& iy, int& ix) {
    iy = py + tap / 3 - 1;
    ix = px + tap % 3 - 1;
    return row_ok && iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
  };

  // Copy k-step ks into stage ks % STAGES; always commits a group, so the
  // group count stays one per k-step.
  auto issue = [&](int ks) {
    if (ks < KS) {
      const int tap = ks % 9, c0 = (ks / 9) * BK;
      bf16* as = smem + (ks % STAGES) * STAGE;
      bf16* bs = as + A_STAGE;
      int iy, ix;
      const bool ok = inside(tap, iy, ix);
      const bf16* src = xrow + ((long long)iy * sh.W + ix) * C + c0;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        cp_async16(as + arow * LDK + (aq + j) * 8, ok ? src + j * 8 : x, ok);
      for (int e = tid; e < BN * (BK / 8); e += THREADS) {
        const int row = e / (BK / 8), part = e % (BK / 8);
        const bool okb = f0 + row < sh.F;
        cp_async16(bs + row * LDK + part * 8,
                   okb ? w + (long long)(f0 + row) * 9 * C + tap * C + c0 + part * 8 : w, okb);
      }
    }
    cp_async_commit();
  };

  float scale[CPT * 8], shift[CPT * 8];
  const int cpg = C / sh.G;
  const float count = (float)HW * (float)cpg;

  // Normalise this thread's A chunks of k-step ks in place.
  auto transform = [&](int ks) {
    if (ks >= KS) return;
    const int tap = ks % 9;
    if (tap == 0) {  // a new channel slice: its per-channel scale and shift
      const int c0 = (ks / 9) * BK + aq * 8;
#pragma unroll
      for (int j = 0; j < CPT * 8; ++j) {
        const int c = c0 + j;
        const int ng = an * sh.G + c / cpg;
        const float mean = s1[ng] / count;
        const float inv = rsqrtf(fmaxf(s2[ng] / count - mean * mean, 0.0f) + sh.eps);
        scale[j] = inv * __bfloat162float(gamma[c]);
        shift[j] = __bfloat162float(beta[c]) - mean * scale[j];
      }
    }
    int iy, ix;
    const bool ok = inside(tap, iy, ix);
    bf16* a = smem + (ks % STAGES) * STAGE + arow * LDK + aq * 8;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        u = *reinterpret_cast<const uint4*>(a + j * 8);
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(h2[e]);
          float t0 = fmaf(v.x, scale[j * 8 + 2 * e], shift[j * 8 + 2 * e]);
          float t1 = fmaf(v.y, scale[j * 8 + 2 * e + 1], shift[j * 8 + 2 * e + 1]);
          if (sh.silu) {
            t0 = silu(t0);
            t1 = silu(t1);
          }
          h2[e] = __floats2bfloat162_rn(t0, t1);
        }
      }
      *reinterpret_cast<uint4*>(a + j * 8) = u;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  cp_async_wait<STAGES - 2>();
  transform(0);
  for (int ks = 0; ks < KS; ++ks) {
    __syncthreads();  // k-step ks normalised everywhere; every warp done with ks - 1
    issue(ks + STAGES - 1);  // into the stage of ks - 1
    const bf16* as = smem + (ks % STAGES) * STAGE + (warp_m * WM) * LDK;
    const bf16* bs = smem + (ks % STAGES) * STAGE + A_STAGE + (warp_n * WN) * LDK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], as + (i * 16 + (lane & 15)) * LDK + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ldsm_x2(bfr[j], bs + (j * 8 + (lane & 7)) * LDK + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    cp_async_wait<STAGES - 2>();  // this thread's copies of ks + 1 have landed
    transform(ks + 1);
  }
  cp_async_wait<0>();

  // Epilogue: accumulator rows lane / 4 and lane / 4 + 8, columns
  // 2 * (lane % 4) and the next, of each m16 x n8 tile.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = f0 + warp_n * WN + j * 8 + (lane & 3) * 2;
    if (col >= sh.F) continue;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const long long r0 = m0 + warp_m * WM + i * 16 + (lane >> 2);
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * sh.F + col) =
            __floats2bfloat162_rn(acc[i][j][0] + b0, acc[i][j][1] + b1);
      if (r0 + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * sh.F + col) =
            __floats2bfloat162_rn(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
}

}  // namespace

// K7: out (N, H, W, F) = conv3x3(silu(groupnorm(x)), w) + bias, channels-last,
// with the group sums s1, s2 (N, G) fp32 from gcd_group_stats_cl.
extern "C" int gcd_gn_silu_conv3x3(const void* x, const void* w, const void* gamma,
                                   const void* beta, const void* bias, const void* s1,
                                   const void* s2, void* out, int N, int H, int W, int C,
                                   int F, int G, float eps, int silu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || G <= 0 || C <= 0 || C % BK || C % G || F <= 0 || F % 8)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.N = N; sh.H = H; sh.W = W; sh.C = C; sh.F = F; sh.G = G; sh.eps = eps; sh.silu = silu;
  const long long mblocks = ((long long)N * H * W + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gn_silu_conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)mblocks, (unsigned)((F + BN - 1) / BN));
  gn_silu_conv3x3_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)gamma, (const bf16*)beta, (const bf16*)bias,
      (const float*)s1, (const float*)s2, (bf16*)out, sh);
  return (int)cudaGetLastError();
}

// Host point-splat renderer of the training-data pipeline (a copy of the JAX
// package's gcd_tpu/native/splat.cpp; the port keeps its own).
//
// Behavioral reference: gcd-model/sgm/data/geometry.py:242-444
// (project_points_to_pixels + spreaded_index_add + blur_into_black). The
// plain PyTorch versions in gcd_tpu_torch/data/geometry.py
// (splat_points_to_image / blur_into_black) compute the same function.
//
// A two-pass streaming scatter with thread-local accumulators, parallel over
// the host's cores with OpenMP. The reference renders on a dedicated GPU
// (kubric_arbit.py:426-428); here the host renders while the card trains.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 splat.cpp -o libgcdsplat.so
// (gcd_tpu_torch/native/__init__.py builds it at first use and raises if it
// cannot).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

struct Proj {
  int32_t u, v;
  float neg;   // shifted-exponent argument (larger = closer)
  bool ok;
};

// Gaussian blur (separable, reflect padding) matching
// torchvision.transforms.functional.gaussian_blur semantics.
void gaussian_blur(const float* src, float* dst, int h, int w, int c,
                   int ksize, float sigma, std::vector<float>& tmp) {
  std::vector<float> kern(ksize);
  float ksum = 0.f;
  for (int i = 0; i < ksize; ++i) {
    float x = i - (ksize - 1) * 0.5f;
    kern[i] = std::exp(-(x * x) / (2.f * sigma * sigma));
    ksum += kern[i];
  }
  for (int i = 0; i < ksize; ++i) kern[i] /= ksum;
  const int pad = ksize / 2;
  tmp.resize(static_cast<size_t>(h) * w * c);

  // Vertical pass (reflect index: mirror without edge repeat).
  #pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int i = 0; i < ksize; ++i) {
          int yy = y + i - pad;
          if (yy < 0) yy = -yy;
          if (yy >= h) yy = 2 * h - 2 - yy;
          acc += kern[i] * src[(static_cast<size_t>(yy) * w + x) * c + ch];
        }
        tmp[(static_cast<size_t>(y) * w + x) * c + ch] = acc;
      }
    }
  }
  // Horizontal pass.
  #pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int i = 0; i < ksize; ++i) {
          int xx = x + i - pad;
          if (xx < 0) xx = -xx;
          if (xx >= w) xx = 2 * w - 2 - xx;
          acc += kern[i] * tmp[(static_cast<size_t>(y) * w + xx) * c + ch];
        }
        dst[(static_cast<size_t>(y) * w + x) * c + ch] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// Renders points into out_img (H*W*3, f32 in [0,1]) and out_weight (H*W or
// nullptr). Returns 0 on success.
//  xyz: (n,3) world points f32; rgb: (n,3) in [0,1] f32.
//  intr: row-major 3x3; extr: row-major, extr_cols columns (>=4 rows x 4, only
//  the first 3 rows are used: rotation columns + translation).
//  mode_pardom: 0 = kubric (strength 512), 1 = pardom (sqrt depth clamp 32,
//  strength 256).  spread_radius: neighbor spreading as in spreaded_index_add.
int gcd_splat_points(const float* xyz, const float* rgb, int64_t n,
                     const float* intr, const float* extr, int extr_cols,
                     int height, int width, int spread_radius,
                     int mode_pardom, float* out_img, float* out_weight) {
  const int64_t hw = static_cast<int64_t>(height) * width;
  // Projection runs in double, matching the reference's float64 projection
  // (gcd-model/sgm/data/geometry.py:257): the depth-exponential z-buffer is
  // globally sensitive to dmax and to pixel-boundary rounding, so f32
  // projections produce visibly different (though equally valid) renders.
  const double r00 = extr[0 * extr_cols + 0], r01 = extr[0 * extr_cols + 1],
               r02 = extr[0 * extr_cols + 2];
  const double r10 = extr[1 * extr_cols + 0], r11 = extr[1 * extr_cols + 1],
               r12 = extr[1 * extr_cols + 2];
  const double r20 = extr[2 * extr_cols + 0], r21 = extr[2 * extr_cols + 1],
               r22 = extr[2 * extr_cols + 2];
  const double tx = extr[0 * extr_cols + 3], ty = extr[1 * extr_cols + 3],
               tz = extr[2 * extr_cols + 3];

  const float strength = mode_pardom ? 256.f : 512.f;

  // Pass 1: project every point; track the max effective depth (for the
  // normalization the reference applies before exponentiating).
  std::vector<Proj> proj(static_cast<size_t>(n));
  float dmax = kNegInf;
  #pragma omp parallel for schedule(static) reduction(max : dmax)
  for (int64_t i = 0; i < n; ++i) {
    const double px = xyz[i * 3 + 0] - tx;
    const double py = xyz[i * 3 + 1] - ty;
    const double pz = xyz[i * 3 + 2] - tz;
    // camera coords: p @ R  (columns of R are right/down/forward)
    const double cx = px * r00 + py * r10 + pz * r20;
    const double cy = px * r01 + py * r11 + pz * r21;
    const double cz = px * r02 + py * r12 + pz * r22;
    const double uw = cx * intr[0] + cy * intr[1] + cz * intr[2];
    const double vw = cx * intr[3] + cy * intr[4] + cz * intr[5];
    const double ww = cx * intr[6] + cy * intr[7] + cz * intr[8];
    const double denom = std::max(std::fabs(ww), 1e-12) * (ww < 0. ? -1. : 1.);
    const double uf = uw / denom;
    const double vf = vw / denom;
    // int cast with +0.5, truncation toward zero (reference semantics)
    const int32_t u = static_cast<int32_t>(uf + 0.5);
    const int32_t v = static_cast<int32_t>(vf + 0.5);
    Proj& p = proj[i];
    p.u = u;
    p.v = v;
    p.ok = (u >= 0 && u < width && v >= 0 && v < height && cz > 0.1);
    double deff = cz;
    if (mode_pardom) {
      deff = std::sqrt(std::max(cz, 0.));
      deff = std::min(std::max(deff, 0.), 32.);
    }
    p.neg = static_cast<float>(deff);  // finalized once dmax is known
    if (p.ok && p.neg > dmax) dmax = p.neg;
  }
  if (!(dmax > kNegInf)) {  // no valid points: zero image
    std::memset(out_img, 0, sizeof(float) * hw * 3);
    if (out_weight) std::memset(out_weight, 0, sizeof(float) * hw);
    return 0;
  }
  const float inv_dmax = 1.f / dmax;

  // Offsets of spreaded_index_add (geometry.py:370-380): center weight 1.0,
  // neighbors within the radius box weight 0.02.
  struct Off { int dx, dy; float factor; };
  std::vector<Off> offs;
  offs.push_back({0, 0, 1.0f});
  const int left = spread_radius / 2, right = (spread_radius + 1) / 2;
  for (int dx = -left; dx <= right; ++dx)
    for (int dy = -left; dy <= right; ++dy)
      if (dx != 0 || dy != 0) offs.push_back({dx, dy, 0.02f});

  const int nthreads = omp_get_max_threads();
  // Pass 2: per-pixel max exponent (log-sum-exp shift), thread-local + reduce.
  std::vector<std::vector<float>> local_max(
      nthreads, std::vector<float>(hw, kNegInf));
  #pragma omp parallel
  {
    float* lm = local_max[omp_get_thread_num()].data();
    #pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const Proj& p = proj[i];
      if (!p.ok) continue;
      const float neg = -(p.neg * inv_dmax * 2.f - 1.f) * strength;
      for (const Off& o : offs) {
        const int u = p.u + o.dx, v = p.v + o.dy;
        if (u < 0 || u >= width || v < 0 || v >= height) continue;
        const int64_t idx = static_cast<int64_t>(v) * width + u;
        if (neg > lm[idx]) lm[idx] = neg;
      }
    }
  }
  std::vector<float> pixmax(hw, kNegInf);
  for (int t = 0; t < nthreads; ++t) {
    const float* lm = local_max[t].data();
    for (int64_t j = 0; j < hw; ++j)
      if (lm[j] > pixmax[j]) pixmax[j] = lm[j];
  }
  for (int64_t j = 0; j < hw; ++j)
    if (!std::isfinite(pixmax[j])) pixmax[j] = 0.f;

  // Pass 3: weighted accumulation (w, w*rgb), thread-local + reduce.
  std::vector<std::vector<float>> local_acc(
      nthreads, std::vector<float>(hw * 4, 0.f));
  #pragma omp parallel
  {
    float* la = local_acc[omp_get_thread_num()].data();
    #pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const Proj& p = proj[i];
      if (!p.ok) continue;
      const float neg = -(p.neg * inv_dmax * 2.f - 1.f) * strength;
      const float r = rgb[i * 3 + 0], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
      for (const Off& o : offs) {
        const int u = p.u + o.dx, v = p.v + o.dy;
        if (u < 0 || u >= width || v < 0 || v >= height) continue;
        const int64_t idx = static_cast<int64_t>(v) * width + u;
        const float d = neg - pixmax[idx];
        // Occluded-point early-out: the pixel's max contributor has weight
        // >= 0.02 by construction, so one exp(-30) (~9e-14) term is below
        // f32 accumulation resolution. Not strictly bit-exact, though: the
        // per-thread partials start at 0, so many thousands of skipped
        // sub-threshold terms at one pixel can together exceed 0.5 ulp of a
        // small wsum — observed effect <~1e-8 relative on production-density
        // clouds. Avoids the expf for the (typically large) occluded
        // majority of a dense merged cloud.
        if (d < -30.f) continue;
        const float w = std::exp(d) * o.factor;
        la[idx * 4 + 0] += w;
        la[idx * 4 + 1] += w * r;
        la[idx * 4 + 2] += w * g;
        la[idx * 4 + 3] += w * b;
      }
    }
  }
  #pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < hw; ++j) {
    float wsum = 0.f, rs = 0.f, gs = 0.f, bs = 0.f;
    for (int t = 0; t < nthreads; ++t) {
      const float* la = local_acc[t].data();
      wsum += la[j * 4 + 0];
      rs += la[j * 4 + 1];
      gs += la[j * 4 + 2];
      bs += la[j * 4 + 3];
    }
    if (wsum > 0.f) {
      const float inv = 1.f / std::max(wsum, 1e-30f);
      out_img[j * 3 + 0] = std::min(std::max(rs * inv, 0.f), 1.f);
      out_img[j * 3 + 1] = std::min(std::max(gs * inv, 0.f), 1.f);
      out_img[j * 3 + 2] = std::min(std::max(bs * inv, 0.f), 1.f);
    } else {
      out_img[j * 3 + 0] = out_img[j * 3 + 1] = out_img[j * 3 + 2] = 0.f;
    }
    if (out_weight) out_weight[j] = wsum;
  }
  return 0;
}

// Hole filling (reference blur_into_black, geometry.py:404-444): leak valid
// content into zero pixels via mask-normalized gaussian blur, then a gentle
// 3x3 smoothing. In-place on img (H*W*3 f32).
int gcd_blur_into_black(float* img, int height, int width, int blur_kernel,
                        float sigma) {
  const int64_t hw = static_cast<int64_t>(height) * width;
  std::vector<float> borrow(hw), blur_img(hw * 3), blur_mask(hw), tmp;
  std::vector<uint8_t> black(hw);
  for (int64_t j = 0; j < hw; ++j) {
    const float s = img[j * 3] + img[j * 3 + 1] + img[j * 3 + 2];
    black[j] = (s == 0.f);
    borrow[j] = black[j] ? 0.f : 1.f;
  }
  gaussian_blur(img, blur_img.data(), height, width, 3, blur_kernel, sigma, tmp);
  gaussian_blur(borrow.data(), blur_mask.data(), height, width, 1, blur_kernel,
                sigma, tmp);
  for (int64_t j = 0; j < hw; ++j) {
    if (!black[j]) continue;
    const float m = std::max(blur_mask[j], 1e-7f);
    img[j * 3 + 0] = blur_img[j * 3 + 0] / m;
    img[j * 3 + 1] = blur_img[j * 3 + 1] / m;
    img[j * 3 + 2] = blur_img[j * 3 + 2] / m;
  }
  std::vector<float> out(hw * 3);
  gaussian_blur(img, out.data(), height, width, 3, 3, 0.6f, tmp);
  std::memcpy(img, out.data(), sizeof(float) * hw * 3);
  return 0;
}

}  // extern "C"

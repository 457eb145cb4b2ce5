// K4: per-image HSV jitter of the training augmentation, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolov10_3d_tpu/ops/pallas_preprocess.py hsv_jitter
// (body _hsv_kernel). Per pixel: RGB in [0, 1] -> HSV with the hue in
// [0, 6); h = (h * gh) mod 6 (floor mod, as jnp's %), s = clip(s * gs, 0, 1),
// v = clip(v * gv, 0, 1); then back to RGB by hue sector. The gains (gh, gs,
// gv) are per image.
//
// Layout: planar, img (B, 3, H, W) float32 contiguous, which is what the
// port's augmentation holds (the model takes NCHW), as the Pallas kernel's
// planar tiles did; out has the same layout. gains (B, 3) float32.
//
// Bound: memory. Each pixel reads 12 bytes and writes 12 and does ~40
// float operations (4 divisions), far below the card's rate. At B=16, 640^2
// the call moves 157 MB: 0.047 ms at 3.35 TB/s.
// Design: one thread per 4 neighbouring pixels of a row-major plane when
// H*W is a multiple of 4 and both buffers are 16-byte aligned (16-byte
// loads and stores from each of the three planes, coalesced across the
// warp), one pixel per thread otherwise; the block's image is blockIdx.y,
// so a thread reads its three gains once.
// Every rounding step is an explicit _rn intrinsic (no contraction into
// FMA, IEEE divisions), in the order of the plain twin
// (kernels/hsv.py hsv_jitter_torch), so the two agree to the bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// out = c[sector]; a sector that is none of 0..4 picks c5, as the chained
// selects of the TPU kernel do.
__device__ __forceinline__ float pick(float i, float c0, float c1, float c2, float c3, float c4,
                                      float c5) {
  float out = c5;
  out = i == 4.f ? c4 : out;
  out = i == 3.f ? c3 : out;
  out = i == 2.f ? c2 : out;
  out = i == 1.f ? c1 : out;
  out = i == 0.f ? c0 : out;
  return out;
}

__device__ __forceinline__ void hsv_pixel(float r, float g, float b, float gh, float gs, float gv,
                                          float& ro, float& go, float& bo) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = __fsub_rn(maxc, minc);
  const float safe = delta > 0.f ? delta : 1.f;
  float s = maxc > 0.f ? __fdiv_rn(delta, fmaxf(maxc, 1e-12f)) : 0.f;
  const float hr = __fdiv_rn(__fsub_rn(g, b), safe);
  const float hg = __fadd_rn(__fdiv_rn(__fsub_rn(b, r), safe), 2.f);
  const float hb = __fadd_rn(__fdiv_rn(__fsub_rn(r, g), safe), 4.f);
  float h = maxc == r ? hr : (maxc == g ? hg : hb);
  h = delta > 0.f ? h : 0.f;
  h = h < 0.f ? __fadd_rn(h, 6.f) : h;

  float m = fmodf(__fmul_rn(h, gh), 6.f);  // exact; floor mod for divisor 6
  h = (m != 0.f && m < 0.f) ? __fadd_rn(m, 6.f) : m;
  s = clip01(__fmul_rn(s, gs));
  const float v = clip01(__fmul_rn(maxc, gv));

  const float i = floorf(h);
  const float f = __fsub_rn(h, i);
  const float p = __fmul_rn(v, __fsub_rn(1.f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, f)));
  const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, __fsub_rn(1.f, f))));
  ro = pick(i, v, q, p, p, t, v);
  go = pick(i, t, v, v, q, p, p);
  bo = pick(i, p, p, t, v, v, q);
}

__global__ void __launch_bounds__(kThreads)
hsv_jitter_vec4(const float4* __restrict__ img, const float* __restrict__ gains,
                float4* __restrict__ out, int hw4) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= hw4) return;
  const int b = blockIdx.y;
  const float gh = gains[3 * b], gs = gains[3 * b + 1], gv = gains[3 * b + 2];
  const size_t base = (size_t)b * 3 * hw4 + k;
  const float4 r = img[base], g = img[base + hw4], bl = img[base + 2 * (size_t)hw4];
  float4 ro, go, bo;
  hsv_pixel(r.x, g.x, bl.x, gh, gs, gv, ro.x, go.x, bo.x);
  hsv_pixel(r.y, g.y, bl.y, gh, gs, gv, ro.y, go.y, bo.y);
  hsv_pixel(r.z, g.z, bl.z, gh, gs, gv, ro.z, go.z, bo.z);
  hsv_pixel(r.w, g.w, bl.w, gh, gs, gv, ro.w, go.w, bo.w);
  out[base] = ro;
  out[base + hw4] = go;
  out[base + 2 * (size_t)hw4] = bo;
}

__global__ void __launch_bounds__(kThreads)
hsv_jitter_scalar(const float* __restrict__ img, const float* __restrict__ gains,
                  float* __restrict__ out, int hw) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= hw) return;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * 3 * hw + k;
  hsv_pixel(img[base], img[base + hw], img[base + 2 * (size_t)hw], gains[3 * b],
            gains[3 * b + 1], gains[3 * b + 2], out[base], out[base + hw],
            out[base + 2 * (size_t)hw]);
}

}  // namespace

// C interface: img and out (B, 3, H, W) float32 contiguous with hw = H * W,
// gains (B, 3) float32. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int k4_hsv_jitter_f32(const float* img, const float* gains, float* out, int B, int hw,
                                 void* stream) {
  if (B < 1 || B > 65535 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hw % 4 == 0 && ((uintptr_t)img | (uintptr_t)out) % 16 == 0) {
    const int hw4 = hw / 4;
    const dim3 grid((hw4 + kThreads - 1) / kThreads, B);
    hsv_jitter_vec4<<<grid, kThreads, 0, st>>>(reinterpret_cast<const float4*>(img), gains,
                                               reinterpret_cast<float4*>(out), hw4);
  } else {
    const dim3 grid((hw + kThreads - 1) / kThreads, B);
    hsv_jitter_scalar<<<grid, kThreads, 0, st>>>(img, gains, out, hw);
  }
  return (int)cudaGetLastError();
}

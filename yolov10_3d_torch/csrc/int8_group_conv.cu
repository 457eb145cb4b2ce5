// Grouped int8 convolution with the float epilogue, for Hopper (sm_90a).
//
// The int8 conv of the JAX package's int8 mode at scope "all" for a Conv
// with groups g > 1 (yolov10_3d_tpu/nn/modules.py int8_conv with
// feature_group_count = g, then TorchBatchNorm and apply_act), which XLA
// compiles and no Pallas kernel replaces: the depthwise convs of YOLOv10
// (SCDown.cv2, CIB's and RepVGGDW's 3x3 and 7x7, Attention.pe, the class
// branches' first convs, the 3D head's dsconv pairs). PyTorch has no int8
// grouped convolution on CUDA.
//
// One C entry point, int8_group_conv_f32:
//   x (B, H, W, C) int8 NHWC, w (N, kh, kw, C / g) int8, ep (4, N) float32
//   rows (deq, mean, mul, beta) -> out (B, N, Ho, Wo) float32 NCHW, with
//   output channel n reading input channels [(n / (N / g)) * C / g, +C / g),
//   any kh x kw, stride, symmetric zero padding and dilation.
// The int32 sums over kh * kw * C / g taps are exact. The epilogue is
// int8_conv_f32's (csrc/int8_conv.cu), in its order and with its explicit
// roundings:
//   y = ((float(acc) * deq) - mean) * mul + beta;  y = y * (1 / (1 + exp(-y))) if act
// so that the plain PyTorch twin (kernels/int8.py int8_group_conv_f32_torch)
// gives the same bits.
//
// Two direct kernels, one thread per output pixel (consecutive threads take
// consecutive pixels, so each output channel's row is written coalesced):
//   dw_kernel     depthwise (C / g == 1, N == C, C % 4 == 0): a thread
//                 takes four neighbouring channels, one 32-bit load of their
//                 four codes per tap, the block's 4 x kh x kw weights staged
//                 in shared memory as one 32-bit word per tap.
//   group_kernel  any other g: a thread takes one output channel, the
//                 group's codes in 32-bit words with __dp4a when C / g and C
//                 are multiples of 4, one byte at a time otherwise.
// Bound: bytes at the main path's shapes (each input code read once, four
// bytes of float written per output value: 2 x 9 ops per output for a 3x3
// depthwise conv). This is the simple, right version; tiling the input in
// shared memory so that neighbouring pixels share their taps is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 64;  // kh * kw of the dw kernel's staged weights

struct Geom {
  int B, H, W, C, N, g, kh, kw, stride, pad, dil, Ho, Wo;
};

__device__ __forceinline__ float epilogue(int acc, const float* __restrict__ ep, int n, int N,
                                          int act) {
  float y = __fmul_rn((float)acc, ep[n]);
  y = __fadd_rn(__fmul_rn(__fsub_rn(y, ep[N + n]), ep[2 * N + n]), ep[3 * N + n]);
  if (act) y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
  return y;
}

__device__ __forceinline__ int sbyte(int word, int j) { return (int)(int8_t)(word >> (8 * j)); }

// grid (pixel blocks, C / 4): four channels [4q, 4q + 4) of one output pixel a thread.
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ ep, int act, float* __restrict__ out, Geom g) {
  __shared__ int wq[kMaxTaps];  // tap t: the four channels' weights, channel 4q + j in byte j
  const int q = blockIdx.y, taps = g.kh * g.kw;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    int word = 0;
    for (int j = 0; j < 4; ++j)
      word |= (int)(uint8_t)w[(4 * q + j) * taps + t] << (8 * j);
    wq[t] = word;
  }
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int M = g.B * g.Ho * g.Wo;
  if (m >= M) return;
  const int ox = m % g.Wo, oy = (m / g.Wo) % g.Ho, b = m / (g.Wo * g.Ho);
  int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int iy = oy * g.stride - g.pad + ky * g.dil;
    if (iy < 0 || iy >= g.H) continue;
    const int8_t* row = x + ((size_t)(b * g.H + iy) * g.W) * g.C + 4 * q;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ix = ox * g.stride - g.pad + kx * g.dil;
      if (ix < 0 || ix >= g.W) continue;
      const int xv = __ldg(reinterpret_cast<const int*>(row + (size_t)ix * g.C));
      const int wv = wq[ky * g.kw + kx];
      acc0 += sbyte(xv, 0) * sbyte(wv, 0);
      acc1 += sbyte(xv, 1) * sbyte(wv, 1);
      acc2 += sbyte(xv, 2) * sbyte(wv, 2);
      acc3 += sbyte(xv, 3) * sbyte(wv, 3);
    }
  }
  const int acc[4] = {acc0, acc1, acc2, acc3};
  const size_t plane = (size_t)g.Ho * g.Wo, pix = (size_t)oy * g.Wo + ox;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * q + j;
    out[((size_t)b * g.N + n) * plane + pix] = epilogue(acc[j], ep, n, g.N, act);
  }
}

// grid (pixel blocks, N): output channel blockIdx.y of one output pixel a thread.
__global__ void __launch_bounds__(kThreads)
    group_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ ep, int act, float* __restrict__ out, Geom g,
                 int words) {
  const int n = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int M = g.B * g.Ho * g.Wo;
  if (m >= M) return;
  const int cg = g.C / g.g, c0 = (n / (g.N / g.g)) * cg;
  const int ox = m % g.Wo, oy = (m / g.Wo) % g.Ho, b = m / (g.Wo * g.Ho);
  const int8_t* wn = w + (size_t)n * g.kh * g.kw * cg;
  int acc = 0;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int iy = oy * g.stride - g.pad + ky * g.dil;
    if (iy < 0 || iy >= g.H) continue;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ix = ox * g.stride - g.pad + kx * g.dil;
      if (ix < 0 || ix >= g.W) continue;
      const int8_t* xp = x + ((size_t)(b * g.H + iy) * g.W + ix) * g.C + c0;
      const int8_t* wp = wn + (ky * g.kw + kx) * cg;
      if (words) {
        const int* x4 = reinterpret_cast<const int*>(xp);
        const int* w4 = reinterpret_cast<const int*>(wp);
        for (int c = 0; c < cg / 4; ++c) acc = __dp4a(__ldg(x4 + c), __ldg(w4 + c), acc);
      } else {
        for (int c = 0; c < cg; ++c) acc += (int)xp[c] * (int)wp[c];
      }
    }
  }
  out[((size_t)b * g.N + n) * g.Ho * g.Wo + (size_t)oy * g.Wo + ox] =
      epilogue(acc, ep, n, g.N, act);
}

}  // namespace

// x (B, H, W, C) int8, w (N, kh, kw, C / groups) int8, ep (4, N) f32 ->
// out (B, N, Ho, Wo) f32, SiLU if act. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success); the Python wrapper
// (kernels/int8.py int8_group_conv_f32_cuda) checks shapes and types first.
extern "C" int int8_group_conv_f32(const int8_t* x, const int8_t* w, const float* ep, int act,
                                   float* out, int B, int H, int W, int C, int N, int groups,
                                   int kh, int kw, int stride, int pad, int dil, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || groups <= 0 || C % groups != 0 ||
      N % groups != 0 || kh <= 0 || kw <= 0 || stride < 1 || pad < 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - dil * (kh - 1) - 1) / stride + 1;
  const int Wo = (W + 2 * pad - dil * (kw - 1) - 1) / stride + 1;
  if (Ho <= 0 || Wo <= 0) return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, C, N, groups, kh, kw, stride, pad, dil, Ho, Wo};
  const int M = B * Ho * Wo;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x & 3) == 0 && ((uintptr_t)w & 3) == 0;
  if (C / groups == 1 && N == C && C % 4 == 0 && kh * kw <= kMaxTaps && aligned) {
    dw_kernel<<<dim3((M + kThreads - 1) / kThreads, C / 4), kThreads, 0, s>>>(x, w, ep, act,
                                                                                out, g);
  } else {
    const int words = aligned && (C / groups) % 4 == 0 && C % 4 == 0;
    group_kernel<<<dim3((M + kThreads - 1) / kThreads, N), kThreads, 0, s>>>(x, w, ep, act, out,
                                                                             g, words);
  }
  return (int)cudaGetLastError();
}

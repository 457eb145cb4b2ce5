// Grouped int8 convolution with the float epilogue, for Hopper (sm_90a).
//
// The int8 conv of the JAX package's int8 mode at scope "all" for a Conv
// with groups g > 1 (yolov10_3d_tpu/nn/modules.py int8_conv with
// feature_group_count = g, then TorchBatchNorm and apply_act), which XLA
// compiles into one fusion and no Pallas kernel replaces: the depthwise
// convs of YOLOv10 (SCDown.cv2, CIB's and RepVGGDW's 3x3 and 7x7,
// Attention.pe, the class branches' first convs, the 3D head's dsconv
// pairs). PyTorch has no int8 grouped convolution on CUDA.
//
// Three C entry points:
//
//   int8_dw_conv_f32   the main path. A depthwise conv (C = N = g) as the
//       whole of XLA's int8_conv + BatchNorm + act: x (B, C, H, W) float32
//       as the model hands it over (planes of H x W contiguous, any batch
//       stride), quantized on load, w (C, kh, kw, 1) int8, ep (4, C)
//       float32 rows (deq, mean, mul, beta) -> out (B, C, Ho, Wo) float32
//       NCHW. One launch under a static scale; under the dynamic scale
//       int8_act_absmax runs first and this kernel reads its max.
//   int8_act_absmax    max |x| over the tensor (the dynamic scale's
//       reduction), as the bits of a float in one unsigned word.
//   int8_group_conv_f32   codes in: x (B, H, W, C) int8 NHWC, w (N, kh, kw,
//       C / g) int8 -> out (B, N, Ho, Wo) float32 NCHW, any g. It serves a
//       grouped conv with C / g > 1 and a grouped conv fed int8 codes by a
//       fused producer (nn/quant.py). Neither occurs in a shipped model: the
//       YOLOv10 and YOLOv10-3D YAMLs (n to x, the 3D head's options
//       included) have depthwise grouped convs only, and no plan of theirs
//       has a fused producer whose consumer is grouped (_producer_pairs
//       pairs a grouped conv with no producer; the dsconv head's pairs are
//       Sequentials, which it skips). A direct kernel: one output pixel
//       and channel a thread.
//
// Every route computes what its plain PyTorch twin (kernels/int8.py) does,
// bit for bit. Quantization as quantize_act (nn/quant.py): a static scale
// multiplies by the host's float32 reciprocal (__fmul_rn), the dynamic one
// divides (__fdiv_rn) by sx = max|x| * fl(1/127) + 1e-12 formed in float32;
// then round half to even (rintf) and clamp to +-127. Under the dynamic
// scale deq = sw * sx (__fmul_rn), as the twin's torch.cat row. The int32
// sums are exact. The epilogue is int8_conv_f32's (csrc/int8_conv.cu), in
// its order and with its explicit roundings:
//   y = ((float(acc) * deq) - mean) * mul + beta;  y = y * (1 / (1 + exp(-y))) if act
//
// int8_dw_conv_f32's design. A block of 128 threads owns P (image, channel)
// planes and a band of TH output rows (P > 1 for whole planes only).
// kernels/int8.py dw_tiles picks P and TH: a batch-1 call still gives the
// 132 SMs two blocks each, and a larger batch gives a block more work while
// the grid keeps about one wave of resident blocks (measured fastest on the
// shipped shapes). It reads its input band
// once, the halo rows included, with 16-byte loads when W is a multiple of
// 4 (every shipped W is): consecutive threads on consecutive addresses, the
// band of a plane one contiguous run. It quantizes in registers and stages
// the codes in shared memory (a zeroed tile, so the padding reads zeros).
// Codes are quantized straight from registers rather than copied with
// cp.async into a float staging buffer: each float is used once, to make one
// code, so staging would add a shared-memory pass and four times the tile,
// and a block's tile is small (on the shipped shapes at most 4.5 KB at batch
// 1, 17 KB at batch 8, 39 KB at batch 32), so several blocks share an SM and
// their loads cover each other's latency.
// Each thread then computes R = 4 neighbouring outputs along x: per kernel
// row it reads the row's window of codes from shared memory once, as
// 32-bit words, into registers, and takes every tap from there (a 3x3 at
// stride 1 reads 6 codes for 12 products, a 7x7 10 for 28). The plane's
// kh x kw weights are staged once per block. The 3x3 and 7x7 at stride 1,
// the 3x3 at stride 2 (and 5x5, 7x7 at stride 2) are unrolled; any other
// filter, stride or dilation takes the same tile with runtime loops. Output
// rows are written with 16-byte stores when Wo is a multiple of 4.
//
// Bound: bytes. Input floats read once, output floats written once, the
// weights and ep, at 3.35 TB/s; under the dynamic scale one more read of
// the input (the reduction). At 80 x 80 x 128, B = 8, stride 1 that is
// 52 MB, 0.0157 ms. The integer work (2 x 9 operations an output for a 3x3,
// 2 x 49 for a 7x7) is far below the card's rate, but the quantization
// (4-6 instructions an input value), the window extraction and the
// epilogue (an exp and a correctly rounded division an output) are not
// free: the design spends them once per value and keeps every byte of
// device memory to one touch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;

struct Geom {
  int B, H, W, C, N, g, kh, kw, stride, pad, dil, Ho, Wo;
};

__device__ __forceinline__ float epilogue(int acc, float deq, float mean, float mul, float beta,
                                          int act) {
  float y = __fmul_rn((float)acc, deq);
  y = __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), beta);
  if (act) y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
  return y;
}

__device__ __forceinline__ float epilogue(int acc, const float* __restrict__ ep, int n, int N,
                                          int act) {
  return epilogue(acc, ep[n], ep[N + n], ep[2 * N + n], ep[3 * N + n], act);
}

__device__ __forceinline__ int sbyte(int word, int j) { return (int)(int8_t)(word >> (8 * j)); }

// ----------------------------------------------------------- codes in
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

// --------------------------------------------------- depthwise, float in
constexpr int kR = 4;        // outputs along x a thread
constexpr int kMaxPlanes = 32;
constexpr int kMaxIndex = 1 << 16;  // block-local indices and divisors stay below this

struct DwGeom {
  int B, C, H, W, Ho, Wo, kh, kw, stride, pad, dil;
  long long sB;  // batch stride of x in floats; the C planes of an image are H * W apart
  int P, TH;     // planes a block, output rows a block
  int nbands;    // ceil(Ho / TH)
  int G;         // groups of kR outputs a row, ceil(Wo / kR)
  int BH, SWP;   // staged rows a plane, bytes a staged row (a multiple of 16)
  int vec;       // floats a global load: 4, or 1 where W or the strides are not multiples of 4
};

// n / d for n, d < 2^16: floor(n * ceil(2^32 / d) / 2^32) is exact there.
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(unsigned d_) : d(d_), m(d_ == 1 ? 0u : 0xffffffffu / d_ + 1u) {}
  __device__ unsigned div(unsigned n) const { return d == 1 ? n : __umulhi(n, m); }
};

__device__ __forceinline__ unsigned char quant(float v, float inv, float sx, bool dynamic) {
  float q = dynamic ? __fdiv_rn(v, sx) : __fmul_rn(v, inv);
  q = fminf(fmaxf(rintf(q), -127.f), 127.f);
  return (unsigned char)(int8_t)(int)q;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory: P * kh * kw weights (int), P plane offsets (long long), P
// channels (int), then the P * BH * SWP code tile.
__host__ __device__ inline int dw_smem_parts(const DwGeom& g, int* w_off, int* base_off,
                                             int* ch_off, int* tile_off) {
  *w_off = 0;
  *base_off = round_up(g.P * g.kh * g.kw * 4, 16);
  *ch_off = *base_off + round_up(g.P * 8, 16);
  *tile_off = *ch_off + round_up(g.P * 4, 16);
  return *tile_off + g.P * g.BH * g.SWP;
}

// One block: planes [bc0, bc0 + P) of the B * C, output rows [oy0, oy0 + TH).
// K > 0: a K x K filter at stride S without dilation, each kernel row's
// window of codes held in registers; K == 0: any filter, runtime loops.
template <int K, int S>
__global__ void __launch_bounds__(kThreads)
    dw_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ ep, const float* __restrict__ sw,
                  const unsigned* __restrict__ amax_bits, float inv, float recip127, int act,
                  float* __restrict__ out, DwGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int w_off, base_off, ch_off, tile_off;
  dw_smem_parts(g, &w_off, &base_off, &ch_off, &tile_off);
  int* wsm = reinterpret_cast<int*>(smem + w_off);
  long long* pbase = reinterpret_cast<long long*>(smem + base_off);
  int* pch = reinterpret_cast<int*>(smem + ch_off);
  unsigned char* tile = smem + tile_off;

  const int tid = threadIdx.x;
  const int band = blockIdx.x % g.nbands;
  const int bc0 = (blockIdx.x / g.nbands) * g.P;
  const int np = min(g.P, g.B * g.C - bc0);
  const int oy0 = band * g.TH, rows_out = min(g.TH, g.Ho - oy0);
  const int iy_base = oy0 * g.stride - g.pad;
  const int lo = max(0, iy_base), hi = min(g.H, iy_base + g.BH);
  const int KK = g.kh * g.kw;
  const bool dynamic = amax_bits != nullptr;
  const float sx =
      dynamic ? __fadd_rn(__fmul_rn(__uint_as_float(__ldg(amax_bits)), recip127), 1e-12f) : 0.f;

  // zero the tile (the padding), stage the weights and the planes' offsets
  int4* t4 = reinterpret_cast<int4*>(tile);
  for (int i = tid; i < g.P * g.BH * g.SWP / 16; i += kThreads) t4[i] = make_int4(0, 0, 0, 0);
  for (int i = tid; i < np * KK; i += kThreads) {
    const int p = i / KK;
    wsm[i] = (int)w[(size_t)((bc0 + p) % g.C) * KK + (i - p * KK)];
  }
  for (int p = tid; p < np; p += kThreads) {
    const int bc = bc0 + p, c = bc % g.C;
    pch[p] = c;
    pbase[p] = (long long)(bc / g.C) * g.sB + (long long)c * g.H * g.W;
  }
  __syncthreads();

  // read the band once, quantize in registers, stage the codes
  const int nrows = hi - lo;
  if (nrows > 0) {
    const int Wv = g.W / g.vec;
    const FastDiv dWv(Wv), dRows(nrows);
    const int total = np * nrows * Wv;
    for (int e0 = tid; e0 < total; e0 += 4 * kThreads) {
      float4 v[4];  // four loads in flight before the first code is made
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          const unsigned rg = dWv.div(e), p = dRows.div(rg);
          const int r = rg - p * nrows, col = (e - rg * Wv) * g.vec;
          const float* src = x + pbase[p] + (long long)(lo + r) * g.W + col;
          if (g.vec == 4)
            v[u] = __ldg(reinterpret_cast<const float4*>(src));
          else
            v[u].x = __ldg(src);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= total) break;
        const unsigned rg = dWv.div(e), p = dRows.div(rg);
        const int r = rg - p * nrows, col = (e - rg * Wv) * g.vec;
        unsigned char* dst = tile + (p * g.BH + (lo + r - iy_base)) * g.SWP + g.pad + col;
        dst[0] = quant(v[u].x, inv, sx, dynamic);
        if (g.vec == 4) {
          dst[1] = quant(v[u].y, inv, sx, dynamic);
          dst[2] = quant(v[u].z, inv, sx, dynamic);
          dst[3] = quant(v[u].w, inv, sx, dynamic);
        }
      }
    }
  }
  __syncthreads();

  // R outputs along x a work item: (plane, output row, group of R)
  const FastDiv dG(g.G), dR(rows_out);
  const int items = np * rows_out * g.G;
  const bool vec_out = g.Wo % 4 == 0;
  for (int e = tid; e < items; e += kThreads) {
    const unsigned rg = dG.div(e), p = dR.div(rg);
    const int gx = e - rg * g.G, oyl = rg - p * rows_out;
    const unsigned char* trow =
        tile + (p * g.BH + oyl * g.stride) * g.SWP + gx * kR * g.stride;
    const int* wp = wsm + p * KK;
    int acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0;
    if constexpr (K > 0) {
      constexpr int WIN = (kR - 1) * S + K, NW = (WIN + 3) / 4;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const int* wr = reinterpret_cast<const int*>(trow + ky * g.SWP);
        int v[4 * NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int word = wr[j];
#pragma unroll
          for (int b = 0; b < 4; ++b) v[4 * j + b] = sbyte(word, b);
        }
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const int wv = wp[ky * K + kx];
#pragma unroll
          for (int i = 0; i < kR; ++i) acc[i] += v[i * S + kx] * wv;
        }
      }
    } else {
      for (int ky = 0; ky < g.kh; ++ky) {
        const unsigned char* r = trow + ky * g.dil * g.SWP;
        for (int kx = 0; kx < g.kw; ++kx) {
          const int wv = wp[ky * g.kw + kx];
#pragma unroll
          for (int i = 0; i < kR; ++i)
            acc[i] += (int)(int8_t)r[i * g.stride + kx * g.dil] * wv;
        }
      }
    }
    const int c = pch[p];
    const float deq = dynamic ? __fmul_rn(__ldg(sw + c), sx) : __ldg(ep + c);
    const float mean = __ldg(ep + g.C + c), mul = __ldg(ep + 2 * g.C + c),
                beta = __ldg(ep + 3 * g.C + c);
    const int ox0 = gx * kR;
    float* orow = out + ((long long)(bc0 + p) * g.Ho + oy0 + oyl) * g.Wo + ox0;
    float y[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) y[i] = epilogue(acc[i], deq, mean, mul, beta, act);
    if (vec_out) {
      *reinterpret_cast<float4*>(orow) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (ox0 + i < g.Wo) orow[i] = y[i];
    }
  }
}

// grid (blocks an image, B): max |x| as float bits (non-negative floats
// order as unsigned integers; a NaN's bits exceed every number's, so a NaN
// propagates as in torch's amax), one atomicMax a block.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    absmax_kernel(const float* __restrict__ x, long long sB, long long per_image, int vec,
                  unsigned* __restrict__ out) {
  const float* xb = x + (long long)blockIdx.y * sB;
  const long long n = per_image / vec;
  const long long step = (long long)gridDim.x * kReduceThreads;
  unsigned m = 0;
  for (long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x; i < n; i += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + u * step;
      if (j < n) {
        if (vec == 4)
          v[u] = __ldg(reinterpret_cast<const float4*>(xb) + j);
        else
          v[u] = make_float4(__ldg(xb + j), 0.f, 0.f, 0.f);
      } else {
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      m = max(m, __float_as_uint(v[u].x) & 0x7fffffffu);
      m = max(m, __float_as_uint(v[u].y) & 0x7fffffffu);
      m = max(m, __float_as_uint(v[u].z) & 0x7fffffffu);
      m = max(m, __float_as_uint(v[u].w) & 0x7fffffffu);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned warp_max[kReduceThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kReduceThreads / 32; ++i) m = max(m, warp_max[i]);
    atomicMax(out, m);
  }
}

template <int K, int S>
cudaError_t launch_dw(int blocks, int smem, cudaStream_t s, const float* x, const int8_t* w,
                      const float* ep, const float* sw, const unsigned* amax_bits, float inv,
                      float recip127, int act, float* out, const DwGeom& g) {
  dw_f32_kernel<K, S><<<blocks, kThreads, smem, s>>>(x, w, ep, sw, amax_bits, inv, recip127,
                                                     act, out, g);
  return cudaGetLastError();
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
  const int words = aligned && (C / groups) % 4 == 0 && C % 4 == 0;
  group_kernel<<<dim3((M + kThreads - 1) / kThreads, N), kThreads, 0, s>>>(x, w, ep, act, out, g,
                                                                           words);
  return (int)cudaGetLastError();
}

// max |x| of x (B, per_image floats an image, images sB floats apart) into
// *out_bits as float bits: zeroes *out_bits, then one launch. Returns
// cudaGetLastError() (0 = success).
extern "C" int int8_act_absmax(const float* x, int B, long long sB, long long per_image,
                               unsigned* out_bits, void* stream) {
  if (B <= 0 || B > 65535 || per_image <= 0 || sB < per_image) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = (per_image % 4 == 0 && sB % 4 == 0 && ((uintptr_t)x & 15) == 0) ? 4 : 1;
  const long long n = per_image / vec;
  const long long per_block = 4LL * kReduceThreads;
  const int cap = (4 * 132 + B - 1) / B;  // about four blocks an SM in all
  const int gx = (int)std::min<long long>((n + per_block - 1) / per_block, cap);
  cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<<<dim3(gx > 0 ? gx : 1, B), kReduceThreads, 0, s>>>(x, sB, per_image, vec,
                                                                    out_bits);
  return (int)cudaGetLastError();
}

// The depthwise conv from float input: x (B, C, H, W) float32, planes
// contiguous, images sB floats apart; w (C, kh, kw, 1) int8; ep (4, C); sw
// (C,) float32 (read under the dynamic scale only); amax_bits null for the
// static scale (codes = rint(x * inv)), else int8_act_absmax's output on
// this stream; out (B, C, Ho, Wo) float32. planes and rows are the block's
// tile (kernels/int8.py dw_tiles). Returns cudaGetLastError() after the
// launch (0 = success), cudaErrorInvalidValue for a tile it cannot take.
extern "C" int int8_dw_conv_f32(const float* x, const int8_t* w, const float* ep, const float* sw,
                                const unsigned* amax_bits, float inv, float recip127, int act,
                                float* out, int B, int C, int H, int W, long long sB, int kh,
                                int kw, int stride, int pad, int dil, int planes, int rows,
                                void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || kh <= 0 || kw <= 0 || stride < 1 || pad < 0 ||
      dil < 1 || planes < 1 || planes > kMaxPlanes || rows < 1 || sB < (long long)C * H * W)
    return (int)cudaErrorInvalidValue;
  DwGeom g{};
  g.B = B, g.C = C, g.H = H, g.W = W, g.kh = kh, g.kw = kw, g.stride = stride, g.pad = pad;
  g.dil = dil, g.sB = sB, g.P = planes;
  g.Ho = (H + 2 * pad - dil * (kh - 1) - 1) / stride + 1;
  g.Wo = (W + 2 * pad - dil * (kw - 1) - 1) / stride + 1;
  if (g.Ho <= 0 || g.Wo <= 0 || rows > g.Ho) return (int)cudaErrorInvalidValue;
  g.TH = rows;
  g.nbands = (g.Ho + rows - 1) / rows;
  g.G = (g.Wo + kR - 1) / kR;
  g.BH = (rows - 1) * stride + (kh - 1) * dil + 1;
  const int span = round_up((kR - 1) * stride + (kw - 1) * dil + 1, 4);
  g.SWP = round_up(std::max(pad + W, (g.G - 1) * kR * stride + span), 16);
  g.vec = (W % 4 == 0 && sB % 4 == 0 && ((uintptr_t)x & 15) == 0) ? 4 : 1;
  int w_off, base_off, ch_off, tile_off;
  const int smem = dw_smem_parts(g, &w_off, &base_off, &ch_off, &tile_off);
  const long long groups = ((long long)B * C + planes - 1) / planes;
  if (smem > 48 * 1024 || planes * g.BH * (W / g.vec) >= kMaxIndex || g.G >= kMaxIndex ||
      planes * rows * g.G >= kMaxIndex || groups * g.nbands > 0x7fffffffLL ||
      (long long)B * C * g.Ho * g.Wo >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(groups * g.nbands);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool square = kh == kw && dil == 1;
  cudaError_t err;
  if (square && kh == 3 && stride == 1)
    err = launch_dw<3, 1>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else if (square && kh == 3 && stride == 2)
    err = launch_dw<3, 2>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else if (square && kh == 5 && stride == 1)
    err = launch_dw<5, 1>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else if (square && kh == 5 && stride == 2)
    err = launch_dw<5, 2>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else if (square && kh == 7 && stride == 1)
    err = launch_dw<7, 1>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else if (square && kh == 7 && stride == 2)
    err = launch_dw<7, 2>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  else
    err = launch_dw<0, 0>(blocks, smem, s, x, w, ep, sw, amax_bits, inv, recip127, act, out, g);
  return (int)err;
}

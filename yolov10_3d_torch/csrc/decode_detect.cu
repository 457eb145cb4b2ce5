// K1: fused NMS-free decode epilogue of YOLOv10 for Hopper (sm_90a).
//
// Replaces the TPU kernel yolov10_3d_tpu/ops/pallas_kernels.py
// decode_detect_pallas (body _decode_kernel). Per anchor: four 16-bin DFL
// softmaxes projected on 0..15 give the ltrb distances; xyxy =
// (anchor -/+ ltrb) * stride; the class logits go through a sigmoid.
//
// Input: the per-scale head maps flattened and concatenated channel-major,
// x (B, 4*16 + nc, A) float32, which is torch.cat([f.flatten(2) ...], 2) of
// the NCHW maps. Anchors are H x W row-major per scale, as in the JAX
// package; the kernel computes each anchor's grid point and stride from the
// scale geometry instead of reading anchor tensors.
// Output: out (B, A, 4 + nc) float32, boxes then scores, the layout
// decode_detect returns, so no concatenation follows.
//
// Bound: memory. Each anchor reads (64 + nc) floats and writes (4 + nc); the
// arithmetic is ~64 exp + 80 sigmoid per anchor, far below the card's rate.
// At B=1, A=8400, nc=80 the call moves 7.7 MB (2.3 us at 3.35 TB/s), so
// launch overhead dominates there; at B=32 it moves 245 MB.
// Design: one thread per anchor, 128 anchors per block, so every load of
// one channel is a coalesced row segment across the warp. The block's
// output rows are contiguous in memory; they are staged in shared memory
// (odd row pitch, no bank conflicts) and written back as one linear,
// coalesced run instead of 84 strided stores per thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kMaxLevels = 4;
constexpr int kThreads = 128;

struct Levels {
  int n;
  int start[kMaxLevels + 1];  // first anchor of each scale, then A
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
decode_detect_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int C, int A, int nc, Levels lv) {
  extern __shared__ float tile[];
  const int no = 4 + nc;
  const int pitch = no | 1;
  const int t = threadIdx.x;
  const int a0 = blockIdx.x * kThreads;
  const int a = a0 + t;
  const float* xb = x + (size_t)blockIdx.y * C * A;

  if (a < A) {
    float d[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v[kRegMax];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRegMax; ++j) {
        v[j] = __ldg(xb + (size_t)(g * kRegMax + j) * A + a);
        m = fmaxf(m, v[j]);
      }
      // sequential sums, no FMA contraction: the same roundings, in the same
      // order, as the plain twin (kernels/decode.py), so near-zero box
      // coordinates, where (anchor - d) cancels, agree too
      float s = 0.f, p = 0.f;
#pragma unroll
      for (int j = 0; j < kRegMax; ++j) {
        const float e = expf(__fsub_rn(v[j], m));
        s = __fadd_rn(s, e);
        p = __fadd_rn(p, __fmul_rn(e, (float)j));
      }
      d[g] = __fdiv_rn(p, s);
    }
    int l = 0;
    while (l + 1 < lv.n && a >= lv.start[l + 1]) ++l;
    const int local = a - lv.start[l];
    const float ax = (float)(local % lv.w[l]) + 0.5f;
    const float ay = (float)(local / lv.w[l]) + 0.5f;
    const float st = lv.stride[l];
    float* row = tile + t * pitch;
    row[0] = __fmul_rn(__fsub_rn(ax, d[0]), st);
    row[1] = __fmul_rn(__fsub_rn(ay, d[1]), st);
    row[2] = __fmul_rn(__fadd_rn(ax, d[2]), st);
    row[3] = __fmul_rn(__fadd_rn(ay, d[3]), st);
    const float* xc = xb + (size_t)4 * kRegMax * A + a;
    for (int c = 0; c < nc; ++c) {
      const float z = __ldg(xc + (size_t)c * A);
      row[4 + c] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
    }
  }
  __syncthreads();

  const int rows = min(kThreads, A - a0);
  float* ob = out + ((size_t)blockIdx.y * A + a0) * no;
  for (int i = t; i < rows * no; i += kThreads) {
    const int r = i / no;
    ob[i] = tile[r * pitch + (i - r * no)];
  }
}

}  // namespace

// C interface. hws holds (h, w, stride) for each of the nl scales. Launches
// on `stream` and returns cudaGetLastError() after the launch (0 = success).
extern "C" int k1_decode_detect_f32(const float* x, float* out, int B, int C, int A,
                                    int nc, int nl, const int* hws, void* stream) {
  if (nl < 1 || nl > kMaxLevels || C != 4 * kRegMax + nc) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = nl;
  lv.start[0] = 0;
  for (int l = 0; l < nl; ++l) {
    lv.w[l] = hws[3 * l + 1];
    lv.stride[l] = (float)hws[3 * l + 2];
    lv.start[l + 1] = lv.start[l] + hws[3 * l] * hws[3 * l + 1];
  }
  for (int l = nl; l < kMaxLevels; ++l) {
    lv.w[l] = 1;
    lv.stride[l] = 0.f;
    lv.start[l + 1] = lv.start[l];
  }
  if (lv.start[nl] != A) return (int)cudaErrorInvalidValue;

  const size_t smem = (size_t)kThreads * ((4 + nc) | 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_detect_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  decode_detect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, out, C, A, nc, lv);
  return (int)cudaGetLastError();
}

// K1: fused NMS-free decode epilogue of YOLOv10 for Hopper (sm_90a).
//
// Replaces the TPU kernel yolov10_3d_tpu/ops/pallas_kernels.py
// decode_detect_pallas (body _decode_kernel). Per anchor: four 16-bin DFL
// softmaxes projected on 0..15 give the ltrb distances; xyxy =
// (anchor -/+ ltrb) * stride; the class logits go through a sigmoid.
//
// Input: the head's maps of up to kMaxLevels scales, each read in place
// through its own base pointer and strides (Levels): the NCHW maps (B, 4*16
// + nc, H, W) as the head returns them (image stride C*H*W, channel stride
// H*W), or scales of one channel-major concatenation x (B, C, A) (base x +
// first anchor, image stride C*A, channel stride A). Anchors are H x W
// row-major per scale, the scales in order, as in the JAX package; the
// kernel computes each anchor's grid point and stride from the scale
// geometry instead of reading anchor tensors.
// Output: out (B, A, 4 + nc) float32, boxes then scores, the layout
// decode_detect returns, so no concatenation follows.
//
// Contract: bit for bit the plain twin (kernels/decode.py
// decode_detect_torch): the DFL sums run bin by bin with __fadd_rn and
// __fmul_rn (no FMA), the projection is an IEEE division, the box is
// __fsub_rn/__fadd_rn then __fmul_rn by the stride, and the score is
// 1 / (1 + exp(-z)).
//
// Bound: memory. Each anchor reads (64 + nc) floats and writes (4 + nc); the
// arithmetic is ~64 exp + 80 sigmoid per anchor, far below the card's rate.
// At B=1, A=8400, nc=80 the call moves 7.7 MB (2.3 us at 3.35 TB/s), below
// a launch's own floor on this card; at B=32 it moves 245 MB (73 us).
// Design: a block takes kTile = 32 anchors of one image and all C channels.
// - Load: each lane resolves its anchor's scale and address once; warp w
//   then copies channels w, w + 4, ..., one coalesced 128-byte row each,
//   by cp.async straight into a channel-major tile (pitch 33: no bank
//   conflicts), all 36 copies of a thread in flight at once and none
//   through registers (plain loads held the kernel at 63% of its bound at
//   B=32: the compiler kept few of them in flight); anchors past A are
//   zero-filled.
// - DFL: thread (side, anchor), 4 x 32 = all 128 threads, one softmax
//   projection each, then its own box coordinate.
// - Sigmoids: the 32 x nc (anchor, class) pairs shared by all threads,
//   consecutive threads on consecutive classes.
// - Store: the tile's 32 output rows are one contiguous run of 32 (4 + nc)
//   floats, staged in shared memory in the output layout and written as
//   16-byte streaming stores when 4 + nc is a multiple of 4.
// - Grid: (A / 32, B): 263 blocks at B=1 (two per SM), ~30 KB of shared
//   memory a block (seven per SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kMaxLevels = 4;
constexpr int kTile = 32;          // anchors per block, one per lane
constexpr int kThreads = 4 * kTile;  // one warp per DFL side
constexpr int kPitch = kTile + 1;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

struct Levels {
  int n;
  int start[kMaxLevels + 1];  // first anchor of each scale, then A
  int w[kMaxLevels];
  float stride[kMaxLevels];
  const float* base[kMaxLevels];
  long long img[kMaxLevels];   // elements between images
  long long chan[kMaxLevels];  // elements between channels
};

__host__ __device__ constexpr size_t tile_floats(int C) {
  return ((size_t)C * kPitch + 3) & ~(size_t)3;
}

__global__ void __launch_bounds__(kThreads)
decode_detect_kernel(float* __restrict__ out, int C, int A, int nc, Levels lv) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [C][kPitch]: channel-major, anchors fastest
  float* ot = smem + tile_floats(C);  // [kTile][4 + nc]: the output rows
  const int no = 4 + nc;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  const int a = a0 + lane;
  const int rows = min(kTile, A - a0);

  int l = 0;
  const float* src = nullptr;
  long long cs = 0;
  if (lane < rows) {
    while (l + 1 < lv.n && a >= lv.start[l + 1]) ++l;
    src = lv.base[l] + b * lv.img[l] + (a - lv.start[l]);
    cs = lv.chan[l];
  }
  for (int c = warp; c < C; c += 4)  // every load in flight at once, none through registers
    cp_async4(xs + c * kPitch + lane, src != nullptr ? src + c * cs : lv.base[0],
              src != nullptr);
  cp_async_wait_all();
  __syncthreads();

  if (lane < rows) {  // DFL side `warp` of anchor `lane`
    const float* xv = xs + warp * kRegMax * kPitch + lane;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRegMax; ++j) m = fmaxf(m, xv[j * kPitch]);
    float s = 0.f, p = 0.f;
#pragma unroll
    for (int j = 0; j < kRegMax; ++j) {
      const float e = expf(__fsub_rn(xv[j * kPitch], m));
      s = __fadd_rn(s, e);
      p = __fadd_rn(p, __fmul_rn(e, (float)j));
    }
    const float d = __fdiv_rn(p, s);
    const int local = a - lv.start[l];
    const float grid = (warp & 1) ? (float)(local / lv.w[l]) + 0.5f   // y: sides 1, 3
                                  : (float)(local % lv.w[l]) + 0.5f;  // x: sides 0, 2
    ot[lane * no + warp] =
        __fmul_rn(warp < 2 ? __fsub_rn(grid, d) : __fadd_rn(grid, d), lv.stride[l]);
  }
  // sigmoids: pair e = t, t + kThreads, ... as (row r, class c), walked by increments
  const int dr = kThreads / nc, dc = kThreads - dr * nc;
  for (int r = t / nc, c = t - (t / nc) * nc; r < rows;) {
    const float z = xs[(4 * kRegMax + c) * kPitch + r];
    ot[r * no + 4 + c] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
  __syncthreads();

  float* ob = out + ((size_t)b * A + a0) * no;
  const int n = rows * no;
  if ((no & 3) == 0) {  // ob and ot are 16-byte aligned
    for (int i = t; i < n / 4; i += kThreads)
      __stcs(reinterpret_cast<float4*>(ob) + i, reinterpret_cast<const float4*>(ot)[i]);
  } else {
    for (int i = t; i < n; i += kThreads) __stcs(ob + i, ot[i]);
  }
}

}  // namespace

// C interface. desc holds 6 values for each of the nl scales: base pointer,
// image stride, channel stride (in floats), h, w, stride. out (B, A, 4 + nc)
// contiguous float32. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int k1_decode_detect_f32(float* out, int B, int C, int A, int nc, int nl,
                                    const long long* desc, void* stream) {
  if (nl < 1 || nl > kMaxLevels || C != 4 * kRegMax + nc || nc < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = nl;
  lv.start[0] = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < nl;
    const long long* d = desc + 6 * l;
    lv.base[l] = on ? reinterpret_cast<const float*>((uintptr_t)d[0]) : nullptr;
    lv.img[l] = on ? d[1] : 0;
    lv.chan[l] = on ? d[2] : 0;
    lv.w[l] = on ? (int)d[4] : 1;
    lv.stride[l] = on ? (float)d[5] : 0.f;
    lv.start[l + 1] = lv.start[l] + (on ? (int)(d[3] * d[4]) : 0);
  }
  if (lv.start[nl] != A || A < 1) return (int)cudaErrorInvalidValue;

  const size_t smem = (tile_floats(C) + (size_t)kTile * (4 + nc)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_detect_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((A + kTile - 1) / kTile, B);
  decode_detect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(out, C, A, nc, lv);
  return (int)cudaGetLastError();
}

// The NMS of the v8-family heads from the boxes, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the (K, K) IoU or probiou
// matrix in XLA and sweeps it with an XLA fori_loop
// (yolov10_3d_tpu/ops/nms.py:20 nms_fixed, and the rotated sweep of
// engine/validator_tasks.py:189-199). Here each pairwise term is computed
// in the kernel, so no (K, K) matrix reaches device memory.
//
// Function: keep (B, K) bool of JAX's loop over conf-sorted candidates:
//   keep = all true; for i in 0..K-1: keep[j] &= !(m[i, j] > thr && j > i
//   && keep[i]) for every j; then keep &= ok,
// with m[i, j] the pairwise term of candidates i and j:
// - axis-aligned (kind 0): box_iou_pairwise (ops/boxes.py) of the
//   class-offset xyxy boxes (B, K, 4);
// - rotated (kind 1): probiou (ops/boxes.py) of the xywhr boxes (B, K, 5),
//   0 where the labels differ or either row fails ok.
// Every rounding of the twin's separate elementwise launches is one
// __f*_rn here (nvcc would contract a * b + c into an FMA), min and max
// propagate NaN as torch.minimum, torch.maximum and clamp do, and cos, sin,
// log, exp and sqrt are the CUDA math library's, as torch's kernels call
// them. So the kernel equals the twin run on the card (kernels/nms.py) bit
// for bit.
//
// Bound. Bytes: the boxes and conf_ok in, keep out, B K (16 + 1 + 1) bytes
// axis-aligned; operations: about 15 float ops a pair i < j whose row i is
// kept for IoU, 43 for probiou. Both are about a microsecond or less: what
// holds the function is the greedy chain, which no byte or operation count
// bounds.
// Design, S[i] the suppression bitmask of row i, a bit a later column:
// - Build (nms_build_kernel): a tile is 32 rows (row block r) by 32
//   columns (word w >= r), four warps of 8 rows each: each lane holds its
//   column's terms, each row's terms are broadcast by shuffle, and each
//   row's 32 comparisons are one ballot; lane k ends holding
//   S[32 r + k][w]. 528 tiles at K 1024 on small CTAs, so one image spans
//   the SMs. S goes to a (B, W, W, 32) word scratch (W = K / 32: 128 KB an
//   image at K 1024, in L2).
// - Chain (nms_chain_kernel): a CTA an image copies S into shared memory,
//   then one warp, lane l owning word l of the removed mask, runs it. For
//   block r in order, lane r settles its 32 candidates in registers from the
//   diagonal words S[32 r + k][r] (every earlier kept row already ORed in),
//   broadcasts the kept bits, and every later lane ORs in the kept rows'
//   words of its own column, loaded two blocks ahead: K / 32 dependent
//   word-steps where a candidate-at-a-time loop takes K.
// A cluster of up to 16 CTAs an image, building S into distributed shared
// memory and running the chain from there in one launch, measured slower
// on an H100 at B=1 and B=8 (PERF.md §6): it builds on 16 SMs, not all.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxW = kMaxK / 32;
constexpr int kChainThreads = 256;
constexpr int kStride = 36;  // words between a lane's rows in the chain's shared copy
constexpr int kTileRows = 8;  // rows of a tile a build warp takes: 4 warps a tile
constexpr int kBuildWarps = 4;  // warps a build CTA
constexpr int kAhead = 2;  // row blocks the chain loads ahead
constexpr float kEps = 1e-7f;
constexpr float kInv12 = 1.0f / 12.0f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.minimum / torch.maximum / clamp_min: NaN if either input is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One image's inputs: the boxes (xyxy (K, 4), or xywhr (K, 5)), the labels
// (K) int64 and ok (K) bytes (rotated only).
struct Src {
  const float* boxes;
  const long long* labels;
  const uint8_t* ok;
};

// Axis-aligned: the box and its area, (x2 - x1) * (y2 - y1) as the twin.
struct IouBox {
  static constexpr int kWidth = 4;
  float x1, y1, x2, y2, area;

  __device__ static IouBox load(const Src& src, int j, int K) {
    IouBox t{0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < K) {
      const float4 v = reinterpret_cast<const float4*>(src.boxes)[j];
      t = {v.x, v.y, v.z, v.w, mul(sub(v.z, v.x), sub(v.w, v.y))};
    }
    return t;
  }
  __device__ IouBox from(int k) const {
    return {__shfl_sync(kAll, x1, k), __shfl_sync(kAll, y1, k), __shfl_sync(kAll, x2, k),
            __shfl_sync(kAll, y2, k), __shfl_sync(kAll, area, k)};
  }
  // box_iou_pairwise(p, q) > thr, p the row (earlier), q the column:
  // wh = (min(p2, q2) - max(p1, q1)).clamp_min(0), inter = wh.x * wh.y,
  // inter / (area_p + area_q - inter + eps). 0 / den needs no division.
  __device__ static bool over(const IouBox& p, const IouBox& q, float thr) {
    const float wx = max_nan(sub(min_nan(p.x2, q.x2), max_nan(p.x1, q.x1)), 0.f);
    const float wy = max_nan(sub(min_nan(p.y2, q.y2), max_nan(p.y1, q.y1)), 0.f);
    const float inter = mul(wx, wy);
    const float den = add(sub(add(p.area, q.area), inter), kEps);
    if (inter == 0.f) return den == den && den != 0.f && 0.f > thr;  // +-0, or NaN
    return div(inter, den) > thr;
  }
};

// Rotated: x, y, the covariance a, b, c of _obb_covariance (ops/boxes.py),
// q = (a b - c^2).clamp_min(0), the label and ok of one box. On the card
// torch divides by a Python scalar as a product with its float reciprocal:
// w**2 / 12 is (w w) * rn(1 / 12).
struct RotBox {
  static constexpr int kWidth = 5;
  float x, y, a, b, c, q;
  long long label;
  int ok;

  __device__ static RotBox load(const Src& src, int j, int K) {
    RotBox t{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0, 0};
    if (j < K) {
      const float* v = src.boxes + 5 * j;
      const float w2 = mul(mul(v[2], v[2]), kInv12), h2 = mul(mul(v[3], v[3]), kInv12);
      const float cs = cosf(v[4]), sn = sinf(v[4]);
      const float cc = mul(cs, cs), ss = mul(sn, sn);
      const float a = add(mul(w2, cc), mul(h2, ss)), b = add(mul(w2, ss), mul(h2, cc));
      const float c = mul(mul(sub(w2, h2), cs), sn);
      t = {v[0], v[1], a, b, c, max_nan(sub(mul(a, b), mul(c, c)), 0.f), src.labels[j],
           (int)src.ok[j]};
    }
    return t;
  }
  __device__ RotBox from(int k) const {
    return {__shfl_sync(kAll, x, k), __shfl_sync(kAll, y, k), __shfl_sync(kAll, a, k),
            __shfl_sync(kAll, b, k), __shfl_sync(kAll, c, k), __shfl_sync(kAll, q, k),
            __shfl_sync(kAll, label, k), __shfl_sync(kAll, ok, k)};
  }
  // probiou(p, o) (ops/boxes.py) in its operation order, 0 where the labels
  // differ or either row fails ok; > thr. Divisions by a tensor are true
  // divisions, products with a Python scalar plain products.
  __device__ static bool over(const RotBox& p, const RotBox& o, float thr) {
    if (!(p.label == o.label && p.ok && o.ok)) return 0.f > thr;
    const float sa = add(p.a, o.a), sb = add(p.b, o.b), sc = add(p.c, o.c);
    const float den = sub(mul(sa, sb), mul(sc, sc));
    const float dy = sub(p.y, o.y), dx = sub(p.x, o.x);
    const float de = add(den, kEps);
    const float t1 = mul(div(add(mul(sa, mul(dy, dy)), mul(sb, mul(dx, dx))), de), 0.25f);
    const float t2 = mul(div(mul(mul(sc, sub(o.x, p.x)), dy), de), 0.5f);
    const float root = add(mul(4.f, sqrtf(mul(p.q, o.q))), kEps);
    const float t3 = mul(logf(add(div(den, root), kEps)), 0.5f);
    float bd = add(add(t1, t2), t3);
    if (!isnan(bd)) bd = fminf(fmaxf(bd, kEps), 100.f);  // clamp(eps, 100)
    const float hd = sqrtf(add(sub(1.f, expf(-bd)), kEps));
    return sub(1.f, hd) > thr;
  }
};

// Lane k (k0 <= k < k0 + kTileRows) returns S[32 r + k][w]: bit l for
// column j = 32 w + l when j > i, j < K and the pair is over thr
// (i = 32 r + k; rows i >= K get 0).
template <class Box>
__device__ uint32_t tile_word(const Src& src, int K, int r, int w, int k0, float thr, int lane) {
  const Box col = Box::load(src, 32 * w + lane, K);
  const Box row = Box::load(src, 32 * r + lane, K);
  const int j = 32 * w + lane;
  uint32_t mine = 0;
#pragma unroll 4
  for (int k = k0; k < k0 + kTileRows; ++k) {
    const Box p = row.from(k);
    const int i = 32 * r + k;
    const bool bit = j > i && j < K && i < K && Box::over(p, col, thr);
    const uint32_t word = __ballot_sync(kAll, bit);
    if (lane == k) mine = word;
  }
  return mine;
}

// The chain's step for row block r: s[k] = S[32 r + k][lane] (lanes r..W-1).
// Lane r settles its word's candidates in order, skipping 8-row groups that
// remove nothing; then the later lanes OR in the kept rows.
__device__ __forceinline__ void chain_step(int r, int W, const uint32_t (&s)[32], uint32_t& rem,
                                           int lane) {
  uint32_t x = rem;
  if (lane == r) {
#pragma unroll
    for (int g = 0; g < 32; g += 8) {
      uint32_t any = 0;
#pragma unroll
      for (int k = g; k < g + 8; ++k) any |= s[k];
      if (any) {
#pragma unroll
        for (int k = g; k < g + 8; ++k)
          if (!((x >> k) & 1u)) x |= s[k];
      }
    }
  }
  const uint32_t kept = __shfl_sync(kAll, ~x, r);
  if (lane == r) {
    rem = x;
  } else if (lane > r && lane < W) {
    uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      a0 |= ((kept >> k) & 1u) ? s[k] : 0u;
      a1 |= ((kept >> (k + 1)) & 1u) ? s[k + 1] : 0u;
      a2 |= ((kept >> (k + 2)) & 1u) ? s[k + 2] : 0u;
      a3 |= ((kept >> (k + 3)) & 1u) ? s[k + 3] : 0u;
    }
    rem |= (a0 | a1) | (a2 | a3);
  }
}

// The greedy chain over W row blocks, one warp. block(r) is the address of
// S[32 r][lane]'s 32 words (row-major in k), valid for lanes r..W-1.
// Returns lane l's removed word.
template <class Block>
__device__ uint32_t chain(Block block, int W, int lane) {
  uint32_t buf[kAhead + 1][32];
  auto fetch = [&](int r, uint32_t(&s)[32]) {
    if (r < W && lane >= r && lane < W) {
      const uint4* p = reinterpret_cast<const uint4*>(block(r));
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const uint4 v = p[m];
        s[4 * m] = v.x;
        s[4 * m + 1] = v.y;
        s[4 * m + 2] = v.z;
        s[4 * m + 3] = v.w;
      }
    }
  };
#pragma unroll
  for (int q = 0; q <= kAhead; ++q) fetch(q, buf[q]);
  uint32_t rem = 0;
  for (int r0 = 0; r0 < W; r0 += kAhead + 1) {
#pragma unroll
    for (int q = 0; q <= kAhead; ++q) {
      const int r = r0 + q;
      if (r < W) {
        chain_step(r, W, buf[q], rem, lane);
        fetch(r + kAhead + 1, buf[q]);
      }
    }
  }
  return rem;
}

// Bit w of lane l's result: ok[32 w + l]. All loads in flight at once.
__device__ uint32_t ok_bits(const uint8_t* ok, int K, int lane) {
  uint8_t v[32];
#pragma unroll
  for (int w = 0; w < 32; ++w) v[w] = (32 * w + lane < K) ? ok[32 * w + lane] : 0;
  uint32_t bits = 0;
#pragma unroll
  for (int w = 0; w < 32; ++w) bits |= (v[w] ? 1u : 0u) << w;
  return bits;
}

__device__ void write_keep(uint32_t rem, uint32_t okb, int K, uint8_t* keep, int lane) {
#pragma unroll
  for (int w = 0; w < 32; ++w) {
    const uint32_t word = __shfl_sync(kAll, rem, w);
    const int j = 32 * w + lane;
    if (j < K) keep[j] = (!((word >> lane) & 1u) && ((okb >> w) & 1u)) ? 1 : 0;
  }
}

// Image b's inputs.
template <class Box>
__device__ Src image(const float* boxes, const long long* labels, const uint8_t* ok, int b, int K) {
  return {boxes + (size_t)b * K * Box::kWidth, labels ? labels + (size_t)b * K : nullptr,
          ok + (size_t)b * K};
}

// The build: tile t of an image in row-block-major order, 32 / kTileRows
// warps a tile.
template <class Box>
__global__ void __launch_bounds__(kBuildWarps * 32)
nms_build_kernel(const float* __restrict__ boxes, const long long* __restrict__ labels,
                 const uint8_t* __restrict__ ok, float thr, uint32_t* __restrict__ S, int K) {
  const int b = blockIdx.x;
  const int W = (K + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.y * kBuildWarps + (threadIdx.x >> 5);
  const int k0 = (v % (32 / kTileRows)) * kTileRows;
  int u = v / (32 / kTileRows);
  if (u >= W * (W + 1) / 2) return;  // warp-uniform
  int r = 0;
  while (u >= W - r) {
    u -= W - r;
    ++r;
  }
  const int w = r + u;
  const uint32_t word =
      tile_word<Box>(image<Box>(boxes, labels, ok, b, K), K, r, w, k0, thr, lane);
  if (lane >= k0 && lane < k0 + kTileRows) S[(((size_t)b * W + r) * W + w) * 32 + lane] = word;
}

// The chain: the CTA copies the image's S into shared memory, 16 bytes a
// thread and load, eight loads in flight a thread; then warp 0 runs the
// chain from there. A lane's 32 words sit kStride words apart, so the
// 16-byte reads of a warp hit every bank.
__global__ void __launch_bounds__(kChainThreads)
nms_chain_kernel(const uint32_t* __restrict__ S, const uint8_t* __restrict__ ok,
                 uint8_t* __restrict__ keep, int K) {
  extern __shared__ uint4 sm[];
  uint32_t* Ss = reinterpret_cast<uint32_t*>(sm);  // (W, W, kStride)
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int W = (K + 31) >> 5, n = W * W * 8;
  const uint4* Sb = reinterpret_cast<const uint4*>(S + (size_t)b * W * W * 32);
  for (int t0 = threadIdx.x; t0 < n; t0 += 8 * kChainThreads) {
    uint4 v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (t0 + m * kChainThreads < n) v[m] = Sb[t0 + m * kChainThreads];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int t = t0 + m * kChainThreads;
      if (t < n) reinterpret_cast<uint4*>(Ss + (t >> 3) * kStride)[t & 7] = v[m];
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const uint32_t okb = ok_bits(ok + (size_t)b * K, K, lane);
  auto block = [&](int r) { return Ss + (r * W + lane) * kStride; };
  const uint32_t rem = chain(block, W, lane);
  write_keep(rem, okb, K, keep + (size_t)b * K, lane);
}

// The chain's shared memory exceeds 48 KB above K 576: its attribute is set
// on a device's first call (before any graph capture: the serving path's
// eager first forward).
cudaError_t prepare() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(nms_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxW * kMaxW * kStride * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <class Box>
int launch(const float* boxes, const long long* labels, const uint8_t* ok, float thr,
           uint8_t* keep, uint32_t* S, int B, int K, cudaStream_t stream) {
  const int W = (K + 31) / 32, warps = W * (W + 1) / 2 * (32 / kTileRows);
  nms_build_kernel<Box><<<dim3(B, (warps + kBuildWarps - 1) / kBuildWarps), kBuildWarps * 32, 0,
                          stream>>>(boxes, labels, ok, thr, S, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_chain_kernel<<<B, kChainThreads, (size_t)W * W * kStride * sizeof(uint32_t), stream>>>(
      S, ok, keep, K);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface. kind 0: boxes (B, K, 4) class-offset xyxy, labels unused
// (null); kind 1: boxes (B, K, 5) xywhr, labels (B, K) int64. ok and keep
// (B, K) one byte each (torch.bool); S the bitmask scratch, B * W * W * 32
// words (W = ceil(K / 32)); all contiguous on the current device, the xyxy
// boxes 16-byte aligned, 1 <= K <= 1024, B >= 1. Launches the build and the chain on `stream` and
// returns cudaGetLastError() after each launch (0 = success).
extern "C" int nms_keep_f32(int kind, const float* boxes, const long long* labels,
                            const uint8_t* ok, float thr, uint8_t* keep, uint32_t* S, int B,
                            int K, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || (kind != 0 && kind != 1) || S == nullptr ||
      (kind == 1 && labels == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  return kind == 0 ? launch<IouBox>(boxes, nullptr, ok, thr, keep, S, B, K, s)
                   : launch<RotBox>(boxes, labels, ok, thr, keep, S, B, K, s);
}

// The greedy NMS sweep of the v8-family heads, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the sweep as an XLA
// fori_loop (yolov10_3d_tpu/ops/nms.py:20 nms_fixed, and the rotated sweep
// of engine/validator_tasks.py:189-199). In plain PyTorch that loop is
// about K dependent launches per call (K = 1024 candidates), so the sweep is
// one hand kernel here.
//
// Function: m (B, K, K) float32, thr, conf_ok (B, K) bool -> keep (B, K)
// bool, the mask of JAX's loop over conf-sorted candidates:
//   keep = all true; for i in 0..K-1: keep[j] &= !(m[i, j] > thr && j > i
//   && keep[i]) for every j; then keep &= conf_ok.
// m is the pairwise matrix built before the call (the IoU of class-offset
// boxes, or probiou masked by label and conf_ok). The only arithmetic is the
// strict comparison m > thr on the same floats, so the kernel equals the
// plain twin (kernels/nms.py nms_sweep_torch) bit for bit on any input,
// NaN included (a NaN suppresses nothing in either).
//
// Bound: memory. The function needs only the entries above the diagonal
// (j > i), read once: B * K (K - 1) / 2 * 4 bytes (2.1 MB at K = 1024, 0.63 us
// at 3.35 TB/s), and conf_ok and keep, a byte each a candidate; its work is
// K (K - 1) / 2 compares.
// Design: one block of 1024 threads per image.
// - Phase 1, all 32 warps: row i goes to warp i % 32, which reads the
//   row's words at and after i's own (only j > i can be suppressed by i),
//   32 columns a word, one coalesced 128-byte load per lane and word, all of
//   a row's loads in flight before the ballots; each ballot is one word of
//   the row's suppression bitmask S[i] in shared memory (K^2 / 8 bytes:
//   128 KB at K = 1024).
// - Phase 2, warp 0: lane w holds word w of the removed mask. For i in
//   order, the owner lane's bit i is broadcast; if i is not removed, every
//   lane ORs in S[i]'s word (S[i + 1]'s word is loaded ahead). This is the
//   greedy dependency chain, K steps from shared memory.
// - Then every thread writes keep[j] = !removed[j] && conf_ok[j].
// At B = 1 one SM reads the whole matrix: the kernel is held by one SM's
// load rate and by the K-step chain, not by the card's memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float* __restrict__ m, float thr, const uint8_t* __restrict__ conf_ok,
                 uint8_t* __restrict__ keep, int K) {
  extern __shared__ uint32_t smem[];
  uint32_t* S = smem;                  // (K, words) suppression bitmask
  __shared__ uint32_t removed[kMaxWords];
  const int b = blockIdx.x;
  const int words = (K + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mb = m + (size_t)b * K * K;

  for (int i = warp; i < K; i += kWarps) {
    const float* row = mb + (size_t)i * K;
    const int w0 = (i + 1) >> 5;  // first word holding a column j > i
    float v[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      const int j = (w << 5) + lane;
      v[w] = (w >= w0 && j < K) ? row[j] : 0.f;
    }
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w >= w0 && w < words) {  // warp-uniform
        const int j = (w << 5) + lane;
        const uint32_t bits = __ballot_sync(0xffffffffu, j > i && j < K && v[w] > thr);
        if (lane == 0) S[i * words + w] = bits;
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t rem = 0;
    uint32_t cur = (lane < words) ? S[lane] : 0u;
    for (int i = 0; i < K; ++i) {
      const uint32_t nxt = (i + 1 < K && lane < words) ? S[(i + 1) * words + lane] : 0u;
      const uint32_t owner = __shfl_sync(0xffffffffu, rem, i >> 5);
      if (!((owner >> (i & 31)) & 1u) && lane >= ((i + 1) >> 5) && lane < words) rem |= cur;
      cur = nxt;
    }
    removed[lane] = rem;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += kThreads) {
    const bool gone = (removed[j >> 5] >> (j & 31)) & 1u;
    keep[(size_t)b * K + j] = (!gone && conf_ok[(size_t)b * K + j]) ? 1 : 0;
  }
}

}  // namespace

// C interface: m (B, K, K) float32, conf_ok and keep (B, K) one byte each
// (torch.bool), all contiguous on the current device; 1 <= K <= 1024,
// 1 <= B <= 2^31 - 1. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success). The first call on a device raises the
// kernel's dynamic shared memory limit (a call made before any graph
// capture: the serving path's eager first forward).
extern "C" int nms_sweep_f32(const float* m, float thr, const uint8_t* conf_ok, uint8_t* keep,
                             int B, int K, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const int words = (K + 31) / 32;
  const size_t smem = (size_t)K * words * sizeof(uint32_t);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)((size_t)kMaxK * kMaxWords * sizeof(uint32_t)));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  nms_sweep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(m, thr, conf_ok, keep, K);
  return (int)cudaGetLastError();
}

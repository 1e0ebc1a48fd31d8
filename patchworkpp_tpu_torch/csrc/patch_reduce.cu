// Kernel KR of the PyTorch port: the unfused engine's per-patch sum
// (patchworkpp_tpu_torch/ops/onehot.py:patch_reduce), (P, C) per-row
// features of (patch, z)-sorted rows -> (S, C) per-patch sums.
//
// It replaces no TPU kernel: the JAX package's per-patch sum is XLA,
// patchworkpp_tpu/ops/onehot.py:patch_reduce (a one-hot f32_dot_c0 product,
// whose sum order is the CPU runtime's). The port keeps its own fixed order,
// the same on the CPU and on the card: each patch's rows are cut into
// 128-row chunks from the patch's first row, each chunk is summed in
// ops.tree_sum's order (zero-padded to 128, halved in place: v[i] + v[i+64],
// then v[i] + v[i+32], ... v[0] + v[1]), and the patch's chunk sums are
// added in order from +0.0. The plain PyTorch version,
// ops/onehot.py:patch_reduce_reference, adds +0.0 for every chunk past a
// patch's last up to the longest patch's count; a sum started from +0.0
// is never -0.0, and x + +0.0 == x for every other x, so stopping at the
// patch's own count gives the same bits. No multiply, so no contraction
// (the build keeps --fmad=false all the same).
//
// Design: one CTA of kWarps warps a patch. A warp sums one chunk at a time,
// each lane holding four rows (lane, lane+32, lane+64, lane+96): the two
// halving steps 128 -> 64 -> 32 are the lane's own adds, the five steps
// 32 -> 1 shuffles down. A round of kWarps chunks leaves each warp's chunk
// sums in shared memory; thread c then adds column c's in chunk order to
// its running sum, so the sum never depends on which warp took which chunk.
//
// What bounds it: bytes (each feature read once, P * C * 4; the sums are
// 1/128 of that). It reads a chunk column by column (stride C floats; the
// chunk's other columns come from L1), so it runs far from the bound: a
// simple kernel that is right, timed in chip_smoke.py.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
patch_reduce_kernel(const float* __restrict__ feats, const int* __restrict__ start, int cols,
                    float* __restrict__ out) {
  extern __shared__ float part[];  // [kWarps][cols]: one round's chunk sums
  const int s = blockIdx.x;
  const int lo = start[s];
  const int hi = start[s + 1];
  const int nch = (hi - lo + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;  // column threadIdx.x's running sum (threads < cols)
  for (int base = 0; base < nch; base += kWarps) {
    const int j = base + warp;
    if (j < nch) {
      const int r0 = lo + j * kChunk + lane;
      for (int c = 0; c < cols; ++c) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + 32 * q;
          v[q] = r < hi ? feats[static_cast<size_t>(r) * cols + c] : 0.0f;
        }
        // 128 -> 64: rows (lane, lane+64) and (lane+32, lane+96); 64 -> 32
        float t = (v[0] + v[2]) + (v[1] + v[3]);
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1) {
          t = t + __shfl_down_sync(kFull, t, h);
        }
        if (lane == 0) part[warp * cols + c] = t;
      }
    }
    __syncthreads();
    if (threadIdx.x < cols) {
      const int n = min(kWarps, nch - base);
      for (int w = 0; w < n; ++w) acc = acc + part[w * cols + threadIdx.x];
    }
    __syncthreads();
  }
  if (threadIdx.x < cols) out[static_cast<size_t>(s) * cols + threadIdx.x] = acc;
}

}  // namespace

// The most columns a call takes (one summing thread a column).
extern "C" int ppk_patch_reduce_max_cols() { return kThreads; }

// out (S, cols) = per-patch sums of feats (P, cols) over the row runs
// [start[s], start[s+1]) of start (S+1,), on `stream`. Returns the CUDA
// error code of the launch.
extern "C" int ppk_patch_reduce(const float* feats, const int* start, int num_patches, int cols,
                                float* out, void* stream) {
  if (cols < 1 || cols > kThreads || num_patches < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_patches == 0) return 0;
  const size_t smem = sizeof(float) * kWarps * cols;
  patch_reduce_kernel<<<num_patches, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      feats, start, cols, out);
  return static_cast<int>(cudaGetLastError());
}

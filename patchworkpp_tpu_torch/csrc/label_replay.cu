// Kernel KL of the PyTorch port: the frame tail's label replay
// (patchworkpp_tpu_torch/pipeline.py _finalize, wrapper
// ops/label_replay_kernel.py:label_replay). Every point, in its original
// order, is labelled from its patch's row of the label table: ground where
// the patch's code is above 2.5 (processed and a ground patch, or reverted
// by TGR), the point lies under th_dist from the patch's final plane, and
// no R-VPF snapshot plane lies within th_dist_v of it (a snapshot whose
// gate was shut holds the sentinel plane [0, 0, 0, 1e30], which never
// peels). It also counts the frame's ground points.
//
// It replaces no TPU kernel: the JAX package's replay is XLA,
// patchworkpp_tpu/pipeline.py _finalize's _replay (a one-hot lookup of the
// table and the same tests). Its plain version is
// ops/label_replay_kernel.py:label_replay_reference, which it equals bit for
// bit: each distance is ops.plane_dist, fma(z, nz, fma(x, nx, y * ny)) + d,
// whose fma is a once-rounded float32 fused multiply-add emulated in
// float64 tensor ops; __fmaf_rn is that operation, and the build keeps
// --fmad=false, so the multiply and the adds round as written. The label is
// a conjunction of comparisons, so the tests may stop at the first that
// fails: a point of a patch that is not ground reads one float of the table
// and not its coordinates. The count is an integer sum, exact in any order.
//
// What bounds it: bytes. A launch reads each point's x, y, z (one 16-byte
// load of the (P, 4) cloud) and patch id once, the (S, 5 + 4 R) table
// through the read-only cache, and writes one byte a point; a few dozen
// float operations a point are far below the card's ridge. One thread a
// point, 256 a CTA; a CTA's points lie in a few patches (patch ids are
// spatially coherent in scan order), so it reads a few table rows. Each
// warp counts its ground points by a ballot, the CTA adds its warps' counts
// and adds them to the frame's count with one integer atomicAdd; the
// wrapper zeroes the count (torch.zeros), so nothing is read back and a
// captured frame holds the launch as it is.
//
// On an H100 80GB HBM3 at 700 W, calls back to back on a 64-beam frame's
// inputs (131,072 rows, a (512, 17) table; chip_smoke.py phase 5): 0.0054
// ms a call with the count's zeroing, against 0.00083 ms for its 2.79 MB.
// A variant that staged the table in shared memory once a CTA and walked
// the points with a persistent grid (two CTAs an SM) took 0.0066 ms, its
// 35 KB of staging a CTA ahead of the first point.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCodeCol = 4;        // the label table: [nx, ny, nz, d, code, R x (nx, ny, nz, d)]
constexpr int kFirstSnapCol = 5;

// The kernel counts its own launches on the card (the grid's first thread
// adds one), so that a caller can hold the wrapper's count of calls to the
// launches that ran, also inside a replayed graph
// (ppk_label_replay_launches reads it).
__device__ unsigned long long kl_launch_count;

// ops.plane_dist: ((x*nx + y*ny) + z*nz) + d as XLA:CPU contracts it.
__device__ __forceinline__ float plane_dist(float x, float y, float z,
                                            const float* __restrict__ plane) {
  const float nx = __ldg(plane), ny = __ldg(plane + 1), nz = __ldg(plane + 2);
  const float d = __ldg(plane + 3);
  return __fadd_rn(__fmaf_rn(z, nz, __fmaf_rn(x, nx, __fmul_rn(y, ny))), d);
}

// One point's label: the plain version's
//   (code > 1.5) & ~peeled & (dist_o < th_dist) & (code > 2.5)
// evaluated up to the first test that fails.
template <bool kVec4>
__device__ __forceinline__ bool label_point(const float* __restrict__ points, int ld, int i,
                                            const float* __restrict__ row, int num_snaps,
                                            float th_dist, float th_dist_v) {
  const float code = __ldg(row + kCodeCol);
  if (!(code > 1.5f) || !(code > 2.5f)) return false;
  float x, y, z;
  if constexpr (kVec4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(points) + i);
    x = v.x;
    y = v.y;
    z = v.z;
  } else {
    const float* pt = points + static_cast<size_t>(i) * ld;
    x = __ldg(pt);
    y = __ldg(pt + 1);
    z = __ldg(pt + 2);
  }
  if (!(plane_dist(x, y, z, row) < th_dist)) return false;
  for (int it = 0; it < num_snaps; ++it) {
    if (fabsf(plane_dist(x, y, z, row + kFirstSnapCol + 4 * it)) < th_dist_v) return false;
  }
  return true;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    kl_label_replay(const float* __restrict__ points, int ld, const int* __restrict__ patch_id,
                    int num_rows, const float* __restrict__ table, int num_patches, int cols,
                    float th_dist, float th_dist_v, bool* __restrict__ ground,
                    int* __restrict__ num_ground) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&kl_launch_count, 1ull);
  __shared__ int warp_counts[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int num_snaps = (cols - kFirstSnapCol) / 4;
  bool g = false;
  if (i < num_rows) {
    const int pid = __ldg(patch_id + i);
    // an id outside the table (never made by the binning, which gives
    // noise and padding the overflow bucket's row) reads nothing
    if (pid >= 0 && pid < num_patches) {
      g = label_point<kVec4>(points, ld, i, table + static_cast<size_t>(pid) * cols, num_snaps,
                             th_dist, th_dist_v);
    }
    ground[i] = g;
  }
  const unsigned votes = __ballot_sync(0xffffffffu, g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(votes);
  __syncthreads();
  if (warp == 0) {
    int c = lane < kWarps ? warp_counts[lane] : 0;
    for (int off = kWarps / 2; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0 && c != 0) atomicAdd(num_ground, c);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The kernel's own launch count into host (1,), then zeroed if `reset`.
// Synchronous with the device.
extern "C" int ppk_label_replay_launches(unsigned long long* host, int reset) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) {
    rc = cudaMemcpyFromSymbol(host, kl_launch_count, sizeof(kl_launch_count));
  }
  if (rc == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    rc = cudaMemcpyToSymbol(kl_launch_count, &zero, sizeof(zero));
  }
  return static_cast<int>(rc);
}

// ground (num_rows,) bool = the label of each point of points (num_rows,
// ld) f32 (x, y, z in its first three columns) from row patch_id[i] of
// table (num_patches, cols) f32, cols = 5 + 4 R; num_ground (an int32 the
// caller zeroed) += the count of ground points. One launch on `stream`.
// Returns the CUDA error code of the launch.
extern "C" int ppk_label_replay(const float* points, int ld, const int* patch_id, int num_rows,
                                const float* table, int num_patches, int cols, float th_dist,
                                float th_dist_v, bool* ground, int* num_ground, void* stream) {
  if (num_rows < 0 || ld < 3 || num_patches < 1 || cols < kFirstSnapCol ||
      (cols - kFirstSnapCol) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one CTA at least, so that every call is one launch on the card too
  const int grid = num_rows > 0 ? (num_rows + kThreads - 1) / kThreads : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ld == 4 && aligned16(points)) {
    kl_label_replay<true><<<grid, kThreads, 0, st>>>(points, ld, patch_id, num_rows, table,
                                                     num_patches, cols, th_dist, th_dist_v,
                                                     ground, num_ground);
  } else {
    kl_label_replay<false><<<grid, kThreads, 0, st>>>(points, ld, patch_id, num_rows, table,
                                                      num_patches, cols, th_dist, th_dist_v,
                                                      ground, num_ground);
  }
  return static_cast<int>(cudaGetLastError());
}

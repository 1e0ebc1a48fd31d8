// Kernel KR of the PyTorch port: the unfused engine's per-patch sum
// (patchworkpp_tpu_torch/ops/onehot.py:patch_reduce), (P, C) per-row
// features of (patch, z)-sorted rows -> (S, C) per-patch sums, and its
// moment mode (ops/onehot.py:patch_moment_sums), which forms the plane
// fit's 10 masked monomials from the (P,) columns qx, qy, qz, mask itself.
//
// It replaces no TPU kernel: the JAX package's per-patch sum is XLA,
// patchworkpp_tpu/ops/onehot.py:281 patch_reduce (a one-hot f32_dot_c0
// product, whose sum order is the CPU runtime's). The port keeps its own
// fixed order, the same on the CPU and on the card: each patch's rows are
// cut into 128-row chunks from the patch's first row, each chunk is summed
// in ops.tree_sum's order (zero-padded to 128 with +0.0, halved in place:
// v[i] + v[i+64], then v[i] + v[i+32], ... v[0] + v[1]), and the patch's
// chunk sums are added in chunk order from +0.0. The plain PyTorch
// version, ops/onehot.py:patch_reduce_reference, adds +0.0 for every chunk
// past a patch's last up to the longest patch's count; a sum started from
// +0.0 is never -0.0, and x + +0.0 == x for every other x, so stopping at
// the patch's own count gives the same bits. The moment mode's monomials
// are plain float multiplies in ops/moments.py:masked_moment_features_cols'
// order; the build keeps --fmad=false, so no product is fused into the
// tree's adds.
//
// What bounds it: bytes. A call reads each feature once (P * C * 4 B; the
// moment mode P * 4 * 4 B) and writes 1/128 of that; its one add a
// feature is far below the card's ridge. Two launches a call:
//
// 1. kr_chunk_sums (or kr_moment_sums): the unit of work is the
//    chunk, not the patch, so a 313-chunk patch costs what 313 one-chunk
//    patches cost. The grid is fixed by the shapes alone (at most
//    max_chunks(P, S) chunks, one warp each, kWarps a CTA), so a captured
//    graph replays it as it is. Each CTA maps its warps' global chunk
//    indices to (patch, chunk of the patch) itself: it copies start into
//    shared memory, counts each patch's chunks and takes their prefix sum
//    (a block scan), then each warp finds its patch by binary search.
//    Nothing is read back to the host. A chunk of the generic mode is one
//    contiguous run of rows * C floats: the warp reads it with consecutive
//    lanes on consecutive 16-byte vectors of its aligned window and stages
//    it in shared memory, rows padded to an odd stride so that the tree's
//    reads (lane l: rows l, l+32, l+64, l+96 of a column) hit 32 banks.
//    The moment mode needs no staging: lane l reads its four rows of the
//    four columns (consecutive lanes, consecutive addresses) and forms the
//    10 monomials in registers, so the (P, 10) feature table is never
//    written (16 bytes a row read instead of 40 written and 40 read). Each
//    column's tree: the lane's own two halving steps, then five shuffles
//    down; lane 0 writes the chunk's sums to the scratch (chunks, C).
// 2. kr_fold: one warp a patch copies the patch's chunk sums (one
//    contiguous run) to shared memory, 2048 floats at a time, one
//    cp.async a 16-byte block with every copy in flight, then lane c adds
//    column c's in chunk order from +0.0. It is launched as a
//    programmatic dependent of launch 1 (Hopper's griddepcontrol): its CTAs
//    become resident while launch 1 runs, build the same chunk map from
//    start meanwhile, and wait on the card for launch 1's end.
//    A second launch rather than a per-patch ticket (the CTA that finishes
//    a patch's last chunk folds it): tickets kept between calls would be
//    shared by two calls on two streams (two facades' captured frames
//    replayed at once), and tickets made fresh a call need a memset node,
//    which costs a graph node as the launch does.
//
// Where a call's time goes on an H100 80GB HBM3 at 700 W (calls back to
// back; measured on builds that stopped after each step and on the fold's
// clock64() records, PERF.md): the two
// launches alone ~2.8 us (~3.8 us without the programmatic dependence),
// the chunk map ~1.7 us, the chunk sums 0.9-3.9 us by their bytes, the
// fold 1.1 us on the main scan's 10 columns (its map hidden behind launch
// 1; ~2 us where launch 1 is short) and 4.4 us on a 460-chunk patch. The
// fold stages by cp.async, one instruction a 16-byte block (~1,000 cycles
// a window): staged float by float, one warp's index arithmetic and
// predicated stores took ~3,300 cycles a window, however many loads were
// in flight.
//
// The wrapper allocates the chunk sums with torch.empty, so a captured
// frame keeps them in its graph's pool (16-byte aligned, as the fold's
// copies need).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 4;  // chunks a CTA of launch 1, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCols = 32;  // the widest generic-mode row (shared-memory stage)
constexpr int kMomentCols = 10;
constexpr int kFoldWindow = 2048;  // floats of chunk sums a warp of launch 2 stages at a time
constexpr int kFoldPad = 8;  // a window's room for its run's offset in its first 16-byte block
constexpr int kFoldBatch = 16;  // terms of the fold loaded ahead of their adds
constexpr int kMaxSmem = 232448;  // shared memory a block may have on sm_90 (227 KB)
constexpr size_t kStaticMapBytes = sizeof(int) * kWarps;  // chunk_map's warp totals
constexpr unsigned kFull = 0xffffffffu;

// Each kernel counts its own launches on the card (the grid's first
// thread adds one), so that a caller can hold the wrappers' count of calls
// to the launches that ran, also inside a replayed graph
// (ppk_patch_reduce_launches reads them).
enum LaunchCounter { kChunkSums, kMomentSums, kFoldGeneric, kFoldMoments, kCounters };
__device__ unsigned long long kr_launch_counts[kCounters];

__device__ __forceinline__ void count_launch(int counter) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&kr_launch_counts[counter], 1ull);
}

// The most chunks a call can have: each patch's rows in 128-row chunks,
// sum over s of ceil(n_s / 128) <= (P + 127 S) / 128.
long long max_chunks(int rows, int patches) {
  return (static_cast<long long>(rows) + static_cast<long long>(kChunk - 1) * patches) / kChunk;
}

__device__ __forceinline__ int chunks_of(int lo, int hi) {
  const int n = hi - lo;
  return n > 0 ? (n + kChunk - 1) / kChunk : 0;
}

// The chunk map in shared memory: sstart[s] = start[s] (s <= S) and
// sfirst[s] = the first global chunk of patch s, sfirst[S] the call's
// chunk count. Every thread of the CTA calls it.
__device__ void chunk_map(const int* __restrict__ start, int num_patches, int* sstart,
                          int* sfirst) {
  __shared__ int warp_total[kWarps];
  for (int i = threadIdx.x; i <= num_patches; i += kThreads) sstart[i] = start[i];
  __syncthreads();
  // thread t counts the chunks of its run of patches [a, b)
  const int per = (num_patches + kThreads - 1) / kThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, num_patches);
  const int b = min(a + per, num_patches);
  int own = 0;
  for (int s = a; s < b; ++s) own += chunks_of(sstart[s], sstart[s + 1]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = own;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int s = a; s < b; ++s) {
    sfirst[s] = run;
    run += chunks_of(sstart[s], sstart[s + 1]);
  }
  if (threadIdx.x == kThreads - 1) sfirst[num_patches] = run;  // the last run ends at the total
  __syncthreads();
}

// The patch s of global chunk g < sfirst[S]: sfirst[s] <= g < sfirst[s+1].
__device__ __forceinline__ int patch_of(const int* sfirst, int num_patches, int g) {
  int lo = 0, hi = num_patches;  // sfirst[lo] <= g < sfirst[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (sfirst[mid] <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The 16-byte block p[a, a+4) (a a multiple of 4 floats from an aligned
// address): one vector load, or element by element where the block reaches
// outside [0, end) (+0.0 there).
__device__ __forceinline__ float4 load_block(const float* __restrict__ p, long long a,
                                             long long end) {
  if (a >= 0 && a + 4 <= end) return *reinterpret_cast<const float4*>(p + a);
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = (a + k >= 0 && a + k < end) ? p[a + k] : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Launch 1's common head: the chunk map, CTA 0's copy of it for the fold,
// and this warp's chunk: its global index g (-1 past the call's chunks),
// first row r0 and row count n.
struct Chunk {
  int g, r0, n;
};

__device__ __forceinline__ Chunk my_chunk(const int* __restrict__ start, int num_patches,
                                          long long gmax, int* sstart, int* sfirst) {
  // let launch 2 become resident now; it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;");
  chunk_map(start, num_patches, sstart, sfirst);
  const long long total = min(static_cast<long long>(sfirst[num_patches]), gmax);
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= total) return Chunk{-1, 0, 0};
  const int s = patch_of(sfirst, num_patches, g);
  const int r0 = sstart[s] + (g - sfirst[s]) * kChunk;
  return Chunk{g, r0, min(kChunk, sstart[s + 1] - r0)};
}

__global__ void __launch_bounds__(kThreads)
kr_chunk_sums(const float* __restrict__ feats, const int* __restrict__ start, int num_rows,
              int num_patches, int cols, long long gmax, float* __restrict__ partial) {
  extern __shared__ int smem[];  // sstart, sfirst (S+1 each), then kWarps stages
  count_launch(kChunkSums);
  int* sstart = smem;
  int* sfirst = smem + num_patches + 1;
  const Chunk ch = my_chunk(start, num_patches, gmax, sstart, sfirst);
  if (ch.g < 0) return;  // warp-uniform; no barrier follows
  const int lane = threadIdx.x & 31;
  const int cstride = cols | 1;  // an odd row stride: the tree's reads hit 32 banks
  float* stage = reinterpret_cast<float*>(smem + 2 * (num_patches + 1)) +
                 (threadIdx.x >> 5) * kChunk * cstride;

  // Stage the run feats[f0, f1) through the 16-byte blocks that hold it
  // (aligned on the address, which a view may leave off 16); a block that
  // reaches outside feats is read element by element.
  const long long f0 = static_cast<long long>(ch.r0) * cols;
  const long long f1 = f0 + static_cast<long long>(ch.n) * cols;
  const long long fend = static_cast<long long>(num_rows) * cols;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(feats) >> 2) & 3);
  const long long a0 = ((f0 + mis) & ~3LL) - mis;
  const int blocks = static_cast<int>((f1 - a0 + 3) >> 2);
  // row = l / cols for l < 128 * kMaxCols: the high word of l * ceil(2^32 / cols)
  const unsigned magic = cols > 1 ? 0xffffffffu / cols + 1 : 0;
#pragma unroll 8
  for (int b = lane; b < blocks; b += 32) {
    const long long a = a0 + 4LL * b;
    const float4 v = load_block(feats, a, fend);
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = a + k;
      if (f >= f0 && f < f1) {
        const unsigned l = static_cast<unsigned>(f - f0);
        const unsigned row = cols > 1 ? __umulhi(l, magic) : l;
        stage[row * cstride + (l - row * cols)] = x[k];
      }
    }
  }
  __syncwarp();

  // Four columns' trees at a time (their shuffles interleave); rows past
  // the chunk's end enter as +0.0.
  float* out = partial + static_cast<size_t>(ch.g) * cols;
  for (int c0 = 0; c0 < cols; c0 += 4) {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = min(c0 + k, cols - 1);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lane + 32 * q;
        v[q] = r < ch.n ? stage[r * cstride + c] : 0.0f;
      }
      t[k] = (v[0] + v[2]) + (v[1] + v[3]);
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = t[k] + __shfl_down_sync(kFull, t[k], h);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c0 + k < cols) out[c0 + k] = t[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kr_moment_sums(const float* __restrict__ qx, const float* __restrict__ qy,
               const float* __restrict__ qz, const float* __restrict__ mask,
               const int* __restrict__ start, int num_patches, long long gmax,
               float* __restrict__ partial) {
  extern __shared__ int smem[];  // sstart, sfirst (S+1 each)
  count_launch(kMomentSums);
  const Chunk ch = my_chunk(start, num_patches, gmax, smem, smem + num_patches + 1);
  if (ch.g < 0) return;
  const int lane = threadIdx.x & 31;
  // [m, mx, my, mz, mx*mx, mx*my, mx*mz, my*my, my*mz, mz*mz], mx = qx * m,
  // for the lane's rows; +0.0 past the chunk's end
  float v[kMomentCols][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = lane + 32 * q;
    if (r < ch.n) {
      const int i = ch.r0 + r;
      const float m = mask[i];
      const float mx = qx[i] * m;
      const float my = qy[i] * m;
      const float mz = qz[i] * m;
      v[0][q] = m;
      v[1][q] = mx;
      v[2][q] = my;
      v[3][q] = mz;
      v[4][q] = mx * mx;
      v[5][q] = mx * my;
      v[6][q] = mx * mz;
      v[7][q] = my * my;
      v[8][q] = my * mz;
      v[9][q] = mz * mz;
    } else {
#pragma unroll
      for (int c = 0; c < kMomentCols; ++c) v[c][q] = 0.0f;
    }
  }
  float t[kMomentCols];
#pragma unroll
  for (int c = 0; c < kMomentCols; ++c) t[c] = (v[c][0] + v[c][2]) + (v[c][1] + v[c][3]);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
    for (int c = 0; c < kMomentCols; ++c) t[c] = t[c] + __shfl_down_sync(kFull, t[c], h);
  }
  if (lane == 0) {
    float* out = partial + static_cast<size_t>(ch.g) * kMomentCols;
#pragma unroll
    for (int c = 0; c < kMomentCols; ++c) out[c] = t[c];
  }
}

// Launch 2: out[s, c] = the chunk sums of patch s, column c, added in chunk
// order from +0.0 (an empty patch: +0.0). One warp a patch: the patch's
// chunk sums are one contiguous run of partial, which the warp copies to
// shared memory a window at a time (every 16-byte load in flight), then
// lane c adds column c's in order. Launched as a programmatic dependent of
// launch 1, so it is resident while launch 1 runs: it builds the chunk map
// from start (an input, not launch 1's output) before it waits for launch
// 1's end.
__global__ void __launch_bounds__(kThreads)
kr_fold(const float* __restrict__ partial, const int* __restrict__ start, int num_patches,
        int cols, long long gmax, float* __restrict__ out, int counter) {
  extern __shared__ int smem[];  // sstart, sfirst (S+1 each)
  count_launch(counter);
  __shared__ __align__(16) float window[kWarps][kFoldWindow + kFoldPad];
  chunk_map(start, num_patches, smem, smem + num_patches + 1);
  const int* sfirst = smem + num_patches + 1;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // launch 1's sums are visible
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= num_patches) return;
  const int lane = threadIdx.x & 31;
  float* win = window[threadIdx.x >> 5];
  const long long lo = sfirst[s];
  const long long hi = min(static_cast<long long>(sfirst[s + 1]), gmax);
  const int per = kFoldWindow / cols;  // chunks a window
  const long long fend = gmax * cols;
  float acc = 0.0f;
  for (long long g0 = lo; g0 < hi; g0 += per) {
    // the window's run partial[f0, f0 + n) as the 16-byte blocks that hold
    // it (partial is 16-byte aligned, which the entries check), copied as
    // they are by cp.async, one instruction a block, every copy in flight
    // at once; the run starts `off` floats into the window
    const int n = static_cast<int>(min(static_cast<long long>(per), hi - g0)) * cols;
    const long long f0 = g0 * cols;
    const long long a0 = f0 & ~3LL;
    const int off = static_cast<int>(f0 - a0);
    const int blocks = (off + n + 3) >> 2;
    for (int b = lane; b < blocks; b += 32) {
      const long long a = a0 + 4LL * b;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(win + 4 * b));
      const int bytes = static_cast<int>(min(4LL, fend - a)) * 4;  // zero-filled past fend
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(partial + a),
                   "r"(bytes)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    // the adds in chunk order, kFoldBatch terms' shared-memory loads ahead
    // of them: the chain waits one load a batch, not one a term
    if (lane < cols) {
      const float* run = win + off;
      int f = lane;
      for (; f + (kFoldBatch - 1) * cols < n; f += kFoldBatch * cols) {
        float x[kFoldBatch];
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) x[k] = run[f + k * cols];
#pragma unroll
        for (int k = 0; k < kFoldBatch; ++k) acc = acc + x[k];
      }
      for (; f < n; f += cols) acc = acc + run[f];
    }
    __syncwarp();
  }
  if (lane < cols) out[static_cast<size_t>(s) * cols + lane] = acc;
}

// The dynamic shared memory of a launch: the chunk map, and launch 1's
// stages in the generic mode.
size_t map_bytes(int num_patches) { return sizeof(int) * 2 * (num_patches + 1); }

// Let `kernel` take `dyn` bytes of dynamic shared memory beside its
// `fixed` static bytes (above the default 48 KB a block only on request);
// cudaErrorInvalidValue past the most a block may have.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t dyn, size_t fixed) {
  if (dyn + fixed > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (dyn + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dyn));
}

// Launch 2 on `st`, after checking launch 1's launch; it counts itself in
// `counter`, its mode's.
int launch_fold(const float* partial, const int* start, int num_patches, int cols,
                long long gmax, float* out, cudaStream_t st, int counter) {
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t dyn = map_bytes(num_patches);
  rc = allow_smem(kr_fold, dyn,
                  sizeof(float) * kWarps * (kFoldWindow + kFoldPad) + kStaticMapBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((num_patches + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kr_fold, partial, start, num_patches, cols, gmax, out, counter);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int chunk_grid(long long gmax) {
  return static_cast<int>(gmax > 0 ? (gmax + kWarps - 1) / kWarps : 1);
}

}  // namespace

// The kernels' own launch counts (kr_chunk_sums, kr_moment_sums, kr_fold in
// the generic mode, kr_fold in the moment mode) into host (4,), then zeroed
// if `reset`. Synchronous with the device.
extern "C" int ppk_patch_reduce_launches(unsigned long long* host, int reset) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) {
    rc = cudaMemcpyFromSymbol(host, kr_launch_counts, sizeof(kr_launch_counts));
  }
  if (rc == cudaSuccess && reset) {
    const unsigned long long zero[kCounters] = {};
    rc = cudaMemcpyToSymbol(kr_launch_counts, zero, sizeof(zero));
  }
  return static_cast<int>(rc);
}

// The widest row the generic mode takes (its shared-memory stage).
extern "C" int ppk_patch_reduce_max_cols() { return kMaxCols; }

// out (S, cols) = per-patch sums of feats (num_rows, cols) over the row
// runs [start[s], start[s+1]) of start (S+1,), on `stream`; partial
// (chunks, cols) f32, chunks >= (num_rows + 127 S) / 128, 16-byte aligned,
// is scratch. Two launches. Returns the CUDA error code of the launches.
extern "C" int ppk_patch_reduce(const float* feats, const int* start, int num_rows,
                                int num_patches, int cols, float* partial, int chunks,
                                float* out, void* stream) {
  if (cols < 1 || cols > kMaxCols || num_patches < 0 || num_rows < 0 ||
      chunks < max_chunks(num_rows, num_patches) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_patches == 0) return 0;
  const size_t dyn = map_bytes(num_patches) + sizeof(float) * kWarps * kChunk * (cols | 1);
  const cudaError_t attr = allow_smem(kr_chunk_sums, dyn, kStaticMapBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long gmax = max_chunks(num_rows, num_patches);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kr_chunk_sums<<<chunk_grid(gmax), kThreads, dyn, st>>>(feats, start, num_rows, num_patches, cols,
                                                         gmax, partial);
  return launch_fold(partial, start, num_patches, cols, gmax, out, st, kFoldGeneric);
}

// The moment mode: out (S, 10) = per-patch sums of the masked monomials
// [m, mx, my, mz, mx*mx, mx*my, mx*mz, my*my, my*mz, mz*mz] (mx = qx * m)
// of the (num_rows,) columns qx, qy, qz, mask over the runs of start;
// partial (chunks, 10) is scratch, as above. Two launches.
extern "C" int ppk_patch_moments(const float* qx, const float* qy, const float* qz,
                                 const float* mask, const int* start, int num_rows,
                                 int num_patches, float* partial, int chunks, float* out,
                                 void* stream) {
  if (num_patches < 0 || num_rows < 0 || chunks < max_chunks(num_rows, num_patches) ||
      !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_patches == 0) return 0;
  const size_t dyn = map_bytes(num_patches);
  const cudaError_t attr = allow_smem(kr_moment_sums, dyn, kStaticMapBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long gmax = max_chunks(num_rows, num_patches);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kr_moment_sums<<<chunk_grid(gmax), kThreads, dyn, st>>>(qx, qy, qz, mask, start, num_patches,
                                                          gmax, partial);
  return launch_fold(partial, start, num_patches, kMomentCols, gmax, out, st, kFoldMoments);
}

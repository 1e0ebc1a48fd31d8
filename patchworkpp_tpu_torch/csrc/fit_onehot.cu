// Unrolled fit kernel of the PyTorch port (K2, fused="onehot"): the per-patch
// R-VPF / R-GPF program of Patchwork++ ground segmentation as its 15 separate
// passes (at num_iter 3), one launch a frame.
//
// Replaces the TPU Pallas kernel
//   patchworkpp_tpu/ops/pallas/fit_kernel.py:fused_fit
// (body make_fit_kernel, pass program build_pass_program, tile scan
// _seg_scan_sum). The plain PyTorch version is
// patchworkpp_tpu_torch/ops/fit_kernel.py:fused_fit_reference; this kernel
// performs the same float operations in the same order, so the two agree
// bit for bit. Build flags (ops/nvcc.py): sm_90a, -O3, --fmad=false.
//
// What it computes differently from K1 (fit_grid.cu): the per-patch sums
// are plain f32 sums of per-tile partials, added in tile order (the TPU
// kernel's HIGHEST-precision one-hot dots), not K1's bf16x3 split sums. So
// its float columns differ from K1's by ulps; its integer columns (n,
// g_count, snapshot gates) and the frame's labels are the same.
//
// What bounds it: bytes, in principle. Each pass reads x, y, z and `active`
// (and `count` writes `active`) for every row of the patch's tiles, ~16 B a
// row a pass over 15 passes; the arithmetic is a few dozen flops a row. The
// working set (~4 MB a frame at capacity 131072) stays in the 50 MB L2. In
// this first version the bound is not reached: the passes of a patch are
// serial, separated by block barriers, and the frame waits on the patch with
// the most tiles.
//
// Design:
// - One CTA of kWarps warps per patch row of the (spad, 48) table. The warps
//   split the patch's tiles pad_start[p]/128 .. pad_start[p+1]/128 (warp w
//   takes tiles t0 + w, t0 + w + kWarps, ...), so the largest patch's tiles
//   are walked by 8 warps instead of K1's one; lane l holds rows l, l+32,
//   l+64, l+96 of a tile (coalesced loads).
// - Each warp writes its tiles' partials to a global (NT, 16) scratch, the
//   TPU kernel's per-tile VMEM columns: eligible counts (int32, `cnt`), LPR
//   sums, moment sums. After a block barrier, one thread scans the counts
//   into the exclusive same-patch prior (int32), or lanes of warp 0 add one
//   column each over the patch's tiles in tile order.
// - Tile sums run in ops.tree_sum's order (fit_math.cuh tile_sum). LPR
//   quota and lane ranks are int32 (warp ballots).
// - The plane carry, alive, lpr and the R-VPF snapshots live in shared
//   memory; thread 0 runs the plane fit (fit_math.cuh plane_row) per pass.
// - Unprocessed patches (gates col 0 == 0) have no active row, and every
//   column of their row stays zero; the CTA writes zeros and returns.
// - The pass program arrives as a (6, npasses) int32 array (kind, peel
//   slot, snapshot slot, gate_alive, final, threshold bits).

#include "fit_math.cuh"  // tile_sum, plane_row (shared with fit_grid.cu)

namespace {

using namespace ppk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPart = 16;  // columns of the per-tile partial scratch
constexpr int kCols = 48;  // result table columns (fit_kernel.py OUT_COLS)
constexpr int kSnap = 16;  // OUT_SNAP: 3 x [gate, nx, ny, nz, d]
constexpr int kCarry2 = 31;
constexpr int kNumSnap = 3;
// pass kinds (ops/fit_kernel.py _KINDS); 3 is fitdist
constexpr int kCount = 0, kLprsum = 1, kFitseed = 2;

__global__ void __launch_bounds__(kThreads)
fit_onehot_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ zs, const float* __restrict__ valid,
                  const int* __restrict__ pad_start, const float* __restrict__ gates,
                  const float* __restrict__ consts, const int* __restrict__ prog,
                  int npasses, float* __restrict__ active, float* __restrict__ part,
                  int* __restrict__ cnt, float* __restrict__ out, int nt, int num_lpr,
                  float th_dist_v, float upright_thr) {
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* orow = out + (size_t)p * kCols;
  for (int c = threadIdx.x; c < kCols; c += kThreads) orow[c] = 0.0f;

  const float* g = gates + (size_t)p * 8;
  const float proc = g[0];
  if (!(proc > 0.5f)) return;  // uniform over the block
  const float spx = g[1], spy = g[2], spz = g[3];
  const bool zone0 = g[4] > 0.5f;
  const float margin = consts[0];
  const int t0 = pad_start[p] / kLane;
  const int t1 = min(pad_start[p + 1] / kLane, nt);
  const unsigned lt_mask = (1u << lane) - 1u;

  __shared__ float plane[14];
  __shared__ float snap[kNumSnap][5];
  __shared__ float sums[10];
  __shared__ float s_alive, s_lpr;

  for (int t = t0 + warp; t < t1; t += kWarps) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = (size_t)t * kLane + lane + 32 * k;
      active[i] = valid[i] * proc;
    }
  }
  if (threadIdx.x < 14) plane[threadIdx.x] = 0.0f;
  if (threadIdx.x < kNumSnap * 5) snap[threadIdx.x / 5][threadIdx.x % 5] = 0.0f;
  if (threadIdx.x == 0) {
    s_alive = proc;
    s_lpr = 0.0f;
  }
  __syncthreads();

  for (int ps = 0; ps < npasses; ++ps) {
    const int kind = prog[ps];
    const int peel = prog[npasses + ps];
    const int slot = prog[2 * npasses + ps];
    const int gate_alive = prog[3 * npasses + ps];
    const int is_final = prog[4 * npasses + ps];
    const float th = __int_as_float(prog[5 * npasses + ps]);

    if (kind == kCount) {
      // peel by the previous snapshot, then eligible counts per tile
      const bool do_peel = peel >= 0;
      float sg = 0.f, snx = 0.f, sny = 0.f, snz = 0.f, sd = 0.f;
      if (do_peel) {
        sg = snap[peel][0];
        snx = snap[peel][1];
        sny = snap[peel][2];
        snz = snap[peel][3];
        sd = snap[peel][4];
      }
      for (int t = t0 + warp; t < t1; t += kWarps) {
        int n = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          const float z = zs[i];
          float a = active[i];
          if (do_peel) {
            const float dist = ((xs[i] * snx + ys[i] * sny) + z * snz) + sd;
            const float hit = (sg > 0.5f && fabsf(dist) < th_dist_v) ? 1.0f : 0.0f;
            a = a * (1.0f - hit);
            active[i] = a;
          }
          const float e = a * ((zone0 && z < margin) ? 0.0f : 1.0f);
          n += __popc(__ballot_sync(kFull, e > 0.5f));
        }
        if (lane == 0) cnt[t] = n;
      }
      __syncthreads();
      if (threadIdx.x == 0) {  // exclusive same-patch prefix, in tile order
        int run = 0;
        for (int t = t0; t < t1; ++t) {
          const int c = cnt[t];
          cnt[t] = run;
          run += c;
        }
      }
      __syncthreads();

    } else if (kind == kLprsum) {
      // the lowest num_lpr eligible z of the patch: tile quota + lane rank
      for (int t = t0 + warp; t < t1; t += kWarps) {
        const int quota = max(num_lpr - cnt[t], 0);
        int before = 0;
        float zt[4], tk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          const float z = zs[i];
          const float e = active[i] * ((zone0 && z < margin) ? 0.0f : 1.0f);
          const unsigned bal = __ballot_sync(kFull, e > 0.5f);
          const int rank = before + __popc(bal & lt_mask);
          before += __popc(bal);
          tk[k] = e * (rank < quota ? 1.0f : 0.0f);
          zt[k] = z * tk[k];
        }
        const float sz = tile_sum(zt[0], zt[1], zt[2], zt[3]);
        const float st = tile_sum(tk[0], tk[1], tk[2], tk[3]);
        if (lane == 0) {
          part[(size_t)t * kPart] = sz;
          part[(size_t)t * kPart + 1] = st;
        }
      }
      __syncthreads();
      if (threadIdx.x < 2) {
        float acc = 0.0f;
        for (int t = t0; t < t1; ++t) acc = acc + part[(size_t)t * kPart + threadIdx.x];
        sums[threadIdx.x] = acc;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const float c = sums[1];
        s_lpr = c > 0.0f ? sums[0] / max_nan(c, 1.0f) : 0.0f;
      }
      __syncthreads();

    } else {  // kFitseed or fitdist
      // fitseed: seed mask; fitdist: signed-distance mask; then moments
      const bool seed = kind == kFitseed;
      const float gate = gate_alive ? s_alive : proc;
      const float lim = s_lpr + th;
      const float gsel = gate > 0.5f ? 1.0f : 0.0f;
      const float nx = plane[0], ny = plane[1], nz = plane[2], d = plane[3];
      if (!seed && is_final && threadIdx.x < 4) orow[kCarry2 + threadIdx.x] = plane[threadIdx.x];
      for (int t = t0 + warp; t < t1; t += kWarps) {
        float v[10][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          const float x = xs[i], y = ys[i], z = zs[i];
          float m;
          if (seed) {
            m = active[i] * (z < lim ? 1.0f : 0.0f) * gsel;
          } else {
            const float dist = ((x * nx + y * ny) + z * nz) + d;
            m = active[i] * (dist < th ? 1.0f : 0.0f);
          }
          const float qx = x - spx, qy = y - spy, qz = z - spz;
          v[0][k] = m;
          v[1][k] = qx * m;
          v[2][k] = qy * m;
          v[3][k] = qz * m;
          v[4][k] = qx * qx * m;
          v[5][k] = qx * qy * m;
          v[6][k] = qx * qz * m;
          v[7][k] = qy * qy * m;
          v[8][k] = qy * qz * m;
          v[9][k] = qz * qz * m;
        }
#pragma unroll
        for (int c = 0; c < 10; ++c) {
          const float s = tile_sum(v[c][0], v[c][1], v[c][2], v[c][3]);
          if (lane == 0) part[(size_t)t * kPart + c] = s;
        }
      }
      __syncthreads();
      if (threadIdx.x < 10) {
        float acc = 0.0f;
        for (int t = t0; t < t1; ++t) acc = acc + part[(size_t)t * kPart + threadIdx.x];
        sums[threadIdx.x] = acc;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        if (!seed && is_final) orow[kOutGcount] = sums[0];
        float row[14];
        plane_row(sums, spx, spy, spz, row);
        if (gate > 0.5f && sums[0] > 0.0f) {
          for (int c = 0; c < 14; ++c) plane[c] = row[c];
        }
        if (seed && slot >= 0) {
          const float vert =
              (s_alive > 0.5f && zone0 && plane[2] < upright_thr) ? 1.0f : 0.0f;
          snap[slot][0] = vert;
          for (int c = 0; c < 4; ++c) snap[slot][1 + c] = plane[c];
          s_alive = vert;
        }
      }
      __syncthreads();
    }
  }

  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c) orow[kOutNormal + c] = plane[c];
    orow[kOutD] = plane[3];
    for (int c = 0; c < 3; ++c) orow[kOutMean + c] = plane[11 + c];
    orow[kOutN] = plane[4];
    for (int c = 0; c < 6; ++c) orow[kOutCov + c] = plane[5 + c];
    for (int s = 0; s < kNumSnap; ++s)
      for (int c = 0; c < 5; ++c) orow[kSnap + 5 * s + c] = snap[s][c];
  }
}

}  // namespace

extern "C" int ppk_fit_onehot(const float* xs, const float* ys, const float* zs,
                              const float* valid, const int* pad_start,
                              const float* gates, const float* consts,
                              const int* prog, int npasses, float* active,
                              float* part, int* cnt, float* out, int nt, int spad,
                              int num_lpr, float th_dist_v, float upright_thr,
                              void* stream) {
  fit_onehot_kernel<<<spad, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, zs, valid, pad_start, gates, consts, prog, npasses, active, part,
      cnt, out, nt, num_lpr, th_dist_v, upright_thr);
  return static_cast<int>(cudaGetLastError());
}

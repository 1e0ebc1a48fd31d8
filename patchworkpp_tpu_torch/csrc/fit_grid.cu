// Fit kernel of the PyTorch port: the per-patch R-VPF / R-GPF pass program
// of Patchwork++ ground segmentation on the tiled layout, one launch a frame.
//
// Replaces the TPU Pallas kernel
//   patchworkpp_tpu/ops/pallas/fit_kernel_grid.py:fused_fit_grid
// (pass program _pass_config, body make_fit_kernel_grid), whose program the
// JAX engine runs as XLA ops in patchworkpp_tpu/ops/tiled_fit.py. The plain
// PyTorch version is patchworkpp_tpu_torch/ops/tiled_fit.py:tiled_fit; this
// kernel performs the same float operations in the same order, so the two
// agree bit for bit. Build flags (ops/nvcc.py): sm_90a, -O3,
// --fmad=false. Contraction must stay off: plane distances and the
// eigensolver's results are compared against thresholds, and an FMA rounds
// differently than the separate multiply and add of the plain version.
//
// What bounds it: bytes, in principle. Each pass reads x, y, z and
// reads/writes `active` for every row of the tiled cloud (196,096 rows at
// capacity 131,072), about 20 B/row a pass; the arithmetic is a few dozen
// flops a row. In this first version the bound is not reached: a patch's
// tiles are walked in order by one warp, with fixed-order warp reductions
// per tile, so the frame waits on the patch with the most tiles (latency,
// load imbalance). The working set (~4 MB a frame) stays in the 50 MB L2.
//
// Design:
// - One CTA of one warp per patch row of the (spad, out_cols) table. The
//   warp walks the patch's tiles pad_start[p]/128 .. pad_start[p+1]/128;
//   lane l holds rows l, l+32, l+64, l+96 of a tile (coalesced loads).
//   Nothing crosses CTAs, so no grid-wide synchronisation is needed, and
//   the passes of a patch follow each other inside its warp.
// - Per-patch state (plane carry, alive, LPR sums) lives in registers,
//   identical in every lane; R-VPF snapshots are written into the patch's
//   own output row and read back by the later peel pass. `active` per row
//   lives in a global scratch buffer that only this warp touches.
// - A tile's 128-lane sum runs in the fixed pairwise order of
//   ops.tree_sum (halving: +64, +32, then shuffles 16..1). Each tile sum is
//   split into three round-to-nearest bf16 parts, accumulated per part in
//   f32 over the tiles in order, and re-added as (hi + mid) + lo: the JAX
//   grid kernel's reduction profile.
// - The LPR quota clip(num_lpr - prior, 0) and the lane ranks are int32;
//   ranks come from warp ballots.
// - Unprocessed patches (gates col 0 == 0) hold no active row; their row
//   of the plain version's table is all zero, and the CTA writes zeros and
//   returns.
// - The pass program arrives as a (6, npasses) int32 array, so any
//   num_iter and any spad work.

#include "fit_math.cuh"  // tile_sum, plane_row (shared with fit_onehot.cu)

namespace {

using namespace ppk;

constexpr int kSeedfit = 0;

// Round-to-nearest-even bf16 part of v, as f32, and the remainder.
__device__ __forceinline__ float rne_part(float v, float* rest) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t lsb = (bits >> 16) & 1u;
  const float kept = __uint_as_float((bits + 0x7FFFu + lsb) & 0xFFFF0000u);
  *rest = v - kept;
  return kept;
}

// Per-part f32 accumulator of the rne bf16x3 split (tiled_fit._reduce_tiles_split3).
struct Split3 {
  float hi = 0.f, mid = 0.f, lo = 0.f;
  __device__ __forceinline__ void add(float v) {
    float r1, r2, r3;
    hi = hi + rne_part(v, &r1);
    mid = mid + rne_part(r1, &r2);
    lo = lo + rne_part(r2, &r3);
  }
  __device__ __forceinline__ float total() const { return (hi + mid) + lo; }
};

// Moments of one tile (tiled_fit._tile_moments), added to the accumulators.
__device__ __forceinline__ void add_tile_moments(const float x[4], const float y[4],
                                                 const float z[4], const float m[4],
                                                 float spx, float spy, float spz,
                                                 Split3 mom[10]) {
  float v[10][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float qx = x[k] - spx, qy = y[k] - spy, qz = z[k] - spz;
    v[0][k] = m[k];
    v[1][k] = qx * m[k];
    v[2][k] = qy * m[k];
    v[3][k] = qz * m[k];
    v[4][k] = qx * qx * m[k];
    v[5][k] = qx * qy * m[k];
    v[6][k] = qx * qz * m[k];
    v[7][k] = qy * qy * m[k];
    v[8][k] = qy * qz * m[k];
    v[9][k] = qz * qz * m[k];
  }
#pragma unroll
  for (int c = 0; c < 10; ++c) mom[c].add(tile_sum(v[c][0], v[c][1], v[c][2], v[c][3]));
}

__global__ void __launch_bounds__(32)
fit_grid_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                const float* __restrict__ zs, const float* __restrict__ valid,
                const int* __restrict__ pad_start, const float* __restrict__ gates,
                const float* __restrict__ consts, const int* __restrict__ prog,
                int npasses, float* __restrict__ active, float* __restrict__ out,
                int nt, int out_cols, int snap_off, int carry2_off, int num_lpr,
                float th_dist_v, float upright_thr) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  float* orow = out + (size_t)p * out_cols;
  for (int c = lane; c < out_cols; c += 32) orow[c] = 0.0f;

  const float* g = gates + (size_t)p * 8;
  const float proc = g[0];
  if (!(proc > 0.5f)) return;
  const float spx = g[1], spy = g[2], spz = g[3];
  const bool zone0 = g[4] > 0.5f;
  const float margin = consts[0];
  const int t0 = pad_start[p] / kLane;
  const int t1 = min(pad_start[p + 1] / kLane, nt);
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = (size_t)t * kLane + lane + 32 * k;
      active[i] = valid[i] * proc;
    }
  }

  float plane[14];
#pragma unroll
  for (int c = 0; c < 14; ++c) plane[c] = 0.0f;
  float alive = proc;
  __syncwarp();

  for (int ps = 0; ps < npasses; ++ps) {
    const int kind = prog[ps];
    const int peel = prog[npasses + ps];
    const int snap = prog[2 * npasses + ps];
    const int gate_alive = prog[3 * npasses + ps];
    const int is_final = prog[4 * npasses + ps];
    const float th = __int_as_float(prog[5 * npasses + ps]);
    const float gate = gate_alive ? alive : proc;
    Split3 mom[10];
    float x[4], y[4], z[4], a[4], msk[4];

    if (kind == kSeedfit) {
      const bool do_peel = peel >= 0;
      float sg = 0.f, snx = 0.f, sny = 0.f, snz = 0.f, sd = 0.f;
      if (do_peel) {
        const float* s = orow + snap_off + 5 * peel;
        sg = s[0];
        snx = s[1];
        sny = s[2];
        snz = s[3];
        sd = s[4];
      }
      // walk 1: peel, eligibility, LPR over the lowest num_lpr eligible z
      Split3 lsum, lcnt;
      int prior = 0;
      for (int t = t0; t < t1; ++t) {
        float e[4];
        unsigned bal[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          x[k] = xs[i];
          y[k] = ys[i];
          z[k] = zs[i];
          a[k] = active[i];
          if (do_peel) {
            const float dist = ((x[k] * snx + y[k] * sny) + z[k] * snz) + sd;
            const float hit = (sg > 0.5f && fabsf(dist) < th_dist_v) ? 1.0f : 0.0f;
            a[k] = a[k] * (1.0f - hit);
            active[i] = a[k];
          }
          e[k] = a[k] * ((zone0 && z[k] < margin) ? 0.0f : 1.0f);
          bal[k] = __ballot_sync(kFull, e[k] > 0.5f);
        }
        const int quota = max(num_lpr - prior, 0);
        int before = 0;
        float zt[4], tk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rank = before + __popc(bal[k] & lt_mask);
          before += __popc(bal[k]);
          tk[k] = e[k] * (rank < quota ? 1.0f : 0.0f);
          zt[k] = z[k] * tk[k];
        }
        lsum.add(tile_sum(zt[0], zt[1], zt[2], zt[3]));
        lcnt.add(tile_sum(tk[0], tk[1], tk[2], tk[3]));
        prior += before;
      }
      const float ssum = lsum.total(), cnt = lcnt.total();
      const float lpr = cnt > 0.0f ? ssum / max_nan(cnt, 1.0f) : 0.0f;
      const float lim = lpr + th;
      const float gsel = gate > 0.5f ? 1.0f : 0.0f;
      // walk 2: seed mask and its moments
      for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          x[k] = xs[i];
          y[k] = ys[i];
          z[k] = zs[i];
          msk[k] = active[i] * (z[k] < lim ? 1.0f : 0.0f) * gsel;
        }
        add_tile_moments(x, y, z, msk, spx, spy, spz, mom);
      }
    } else {
      if (is_final && lane == 0) {
        for (int c = 0; c < 4; ++c) orow[carry2_off + c] = plane[c];
      }
      const float nx = plane[0], ny = plane[1], nz = plane[2], d = plane[3];
      for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t i = (size_t)t * kLane + lane + 32 * k;
          x[k] = xs[i];
          y[k] = ys[i];
          z[k] = zs[i];
          const float dist = ((x[k] * nx + y[k] * ny) + z[k] * nz) + d;
          msk[k] = active[i] * (dist < th ? 1.0f : 0.0f);
        }
        add_tile_moments(x, y, z, msk, spx, spy, spz, mom);
      }
    }

    float m[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) m[c] = mom[c].total();
    if (kind != kSeedfit && is_final && lane == 0) orow[kOutGcount] = m[0];
    float row[14];
    plane_row(m, spx, spy, spz, row);
    if (gate > 0.5f && m[0] > 0.0f) {
#pragma unroll
      for (int c = 0; c < 14; ++c) plane[c] = row[c];
    }
    if (kind == kSeedfit && snap >= 0) {
      const float vert =
          (alive > 0.5f && zone0 && plane[2] < upright_thr) ? 1.0f : 0.0f;
      if (lane == 0) {
        float* s = orow + snap_off + 5 * snap;
        s[0] = vert;
        for (int c = 0; c < 4; ++c) s[1 + c] = plane[c];
      }
      alive = vert;
    }
    __syncwarp();
  }

  if (lane == 0) {
    for (int c = 0; c < 3; ++c) orow[kOutNormal + c] = plane[c];
    orow[kOutD] = plane[3];
    for (int c = 0; c < 3; ++c) orow[kOutMean + c] = plane[11 + c];
    orow[kOutN] = plane[4];
    for (int c = 0; c < 6; ++c) orow[kOutCov + c] = plane[5 + c];
  }
}

}  // namespace

extern "C" int ppk_fit_grid(const float* xs, const float* ys, const float* zs,
                            const float* valid, const int* pad_start,
                            const float* gates, const float* consts,
                            const int* prog, int npasses, float* active,
                            float* out, int nt, int spad, int out_cols,
                            int snap_off, int carry2_off, int num_lpr,
                            float th_dist_v, float upright_thr, void* stream) {
  fit_grid_kernel<<<spad, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, zs, valid, pad_start, gates, consts, prog, npasses, active, out,
      nt, out_cols, snap_off, carry2_off, num_lpr, th_dist_v, upright_thr);
  return static_cast<int>(cudaGetLastError());
}

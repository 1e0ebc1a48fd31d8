// Fit kernel of the PyTorch port: the per-patch R-VPF / R-GPF pass program
// of Patchwork++ ground segmentation on the tiled layout, one launch a frame.
//
// Replaces the TPU Pallas kernel
//   patchworkpp_tpu/ops/pallas/fit_kernel_grid.py:fused_fit_grid
// (pass program _pass_config, body make_fit_kernel_grid), whose program the
// JAX engine runs as XLA ops in patchworkpp_tpu/ops/tiled_fit.py. The plain
// PyTorch version is patchworkpp_tpu_torch/ops/tiled_fit.py:tiled_fit; this
// kernel performs the same float operations in the same order, so the two
// agree bit for bit. Build flags (ops/fit_kernel_grid.py): sm_90a, -O3,
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeedfit = 0;

// Result table columns (ops/fit_kernel.py OUT_*).
constexpr int kOutNormal = 0;
constexpr int kOutD = 3;
constexpr int kOutMean = 4;
constexpr int kOutN = 7;
constexpr int kOutGcount = 8;
constexpr int kOutCov = 9;

// torch.maximum / torch.clamp semantics: a NaN operand wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}

// Sum of a 128-row tile held as rows (l, l+32, l+64, l+96) by lane l, in
// the order of ops.tree_sum; every lane gets the total.
__device__ __forceinline__ float tile_sum(float v0, float v1, float v2, float v3) {
  float s = (v0 + v2) + (v1 + v3);
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(kFull, s, off);
  return __shfl_sync(kFull, s, 0);
}

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

__device__ __forceinline__ void cross3(float px, float py, float pz, float qx,
                                       float qy, float qz, float& x, float& y,
                                       float& z) {
  x = py * qz - pz * qy;
  y = pz * qx - px * qz;
  z = px * qy - py * qx;
}

// ops/eigen3.py:_best_row_cross
__device__ void best_row_cross(float d00, float a01, float a02, float d11,
                               float a12, float d22, float& vx, float& vy,
                               float& vz, float& nbest) {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  cross3(d00, a01, a02, a01, d11, a12, ax, ay, az);
  cross3(d00, a01, a02, a02, a12, d22, bx, by, bz);
  cross3(a01, d11, a12, a02, a12, d22, cx, cy, cz);
  const float na = ax * ax + ay * ay + az * az;
  const float nb = bx * bx + by * by + bz * bz;
  const float nc = cx * cx + cy * cy + cz * cz;
  const bool use_a = na >= nb;
  vx = use_a ? ax : bx;
  vy = use_a ? ay : by;
  vz = use_a ? az : bz;
  const float nab = max_nan(na, nb);
  const bool use_ab = nab >= nc;
  vx = use_ab ? vx : cx;
  vy = use_ab ? vy : cy;
  vz = use_ab ? vz : cz;
  nbest = max_nan(nab, nc);
}

// ops/trig.py:cardano_cos_pair
__device__ void cardano_cos_pair(float r, float& c, float& c_hi) {
  const float ax = fabsf(r);
  float poly = -0.0012624911f;
  poly = poly * ax + 0.0066700901f;
  poly = poly * ax + -0.0170881256f;
  poly = poly * ax + 0.0308918810f;
  poly = poly * ax + -0.0501743046f;
  poly = poly * ax + 0.0889789874f;
  poly = poly * ax + -0.2145988016f;
  poly = poly * ax + 1.5707963050f;
  const float pos = sqrtf(max_nan(1.0f - ax, 0.0f)) * poly;
  const float acos_r = r >= 0.f ? pos : 3.14159265358979323846f - pos;
  const float phi = acos_r * (float)(1.0 / 3.0);
  const float p2 = phi * phi;
  float s = (float)(-1.0 / 39916800.0);
  s = s * p2 + (float)(1.0 / 362880.0);
  s = s * p2 + (float)(-1.0 / 5040.0);
  s = s * p2 + (float)(1.0 / 120.0);
  s = s * p2 + (float)(-1.0 / 6.0);
  s = s * p2 + 1.0f;
  const float sn = s * phi;
  float cs = (float)(1.0 / 479001600.0);
  cs = cs * p2 + (float)(-1.0 / 3628800.0);
  cs = cs * p2 + (float)(1.0 / 40320.0);
  cs = cs * p2 + (float)(-1.0 / 720.0);
  cs = cs * p2 + (float)(1.0 / 24.0);
  cs = cs * p2 + (float)(-1.0 / 2.0);
  cs = cs * p2 + 1.0f;
  c = cs;
  c_hi = -0.5f * cs - 0.8660254037844386f * sn;
}

// ops/eigen3.py:eig3_plane_columns, vector part only (the unflipped unit
// eigenvector of the smallest eigenvalue).
__device__ void eig3_plane(float a00, float a01, float a02, float a11,
                           float a12, float a22, float& vx, float& vy,
                           float& vz) {
  const float off_sq = a01 * a01 + a02 * a02 + a12 * a12;
  const float fro2 = a00 * a00 + a11 * a11 + a22 * a22 + 2.0f * off_sq;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * off_sq;
  const float p = sqrtf(p2 / 6.0f);

  const float safe_p = p > 1e-12f ? p : 1.0f;
  const float c00 = b00 / safe_p, c11 = b11 / safe_p, c22 = b22 / safe_p;
  const float c01 = a01 / safe_p, c02 = a02 / safe_p, c12 = a12 / safe_p;
  const float detb = c00 * (c11 * c22 - c12 * c12) -
                     c01 * (c01 * c22 - c12 * c02) +
                     c02 * (c01 * c12 - c11 * c02);
  const float r = clip_nan(detb / 2.0f, -1.0f, 1.0f);
  float cos_lo, cos_hi;
  cardano_cos_pair(r, cos_lo, cos_hi);

  const float two_p = 2.0f * p;
  const float e0 = q + two_p * cos_lo;
  const float e2 = q + two_p * cos_hi;
  const float e1 = 3.0f * q - e0 - e2;

  // separated pair: eigenvector of e2 from the largest row cross product
  float sx, sy, sz, nbest_s;
  best_row_cross(a00 - e2, a01, a02, a11 - e2, a12, a22 - e2, sx, sy, sz,
                 nbest_s);
  const bool degen_s = nbest_s <= 1e-12f * fro2 * fro2;
  sx = degen_s ? 0.0f : sx;
  sy = degen_s ? 0.0f : sy;
  sz = degen_s ? 1.0f : sz;
  const float norm_s = sqrtf(sx * sx + sy * sy + sz * sz);
  sx = sx / norm_s;
  sy = sy / norm_s;
  sz = sz / norm_s;

  // clustered pair: deflation from the isolated largest root
  float vx0, vy0, vz0, nbest0;
  best_row_cross(a00 - e0, a01, a02, a11 - e0, a12, a22 - e0, vx0, vy0, vz0,
                 nbest0);
  const bool degen0 = nbest0 <= 1e-12f * fro2 * fro2;
  const float inv0 = 1.0f / sqrtf(max_nan(nbest0, 1e-30f));
  vx0 = vx0 * inv0;
  vy0 = vy0 * inv0;
  vz0 = vz0 * inv0;

  const float nux = vy0 * vy0 + vz0 * vz0;
  const float nuy = vx0 * vx0 + vz0 * vz0;
  const bool use_x = nux >= nuy;
  float u1x = use_x ? 0.0f : -vz0;
  float u1y = use_x ? vz0 : 0.0f;
  float u1z = use_x ? -vy0 : vx0;
  const float inv1 = 1.0f / sqrtf(max_nan(max_nan(nux, nuy), 1e-30f));
  u1x = u1x * inv1;
  u1y = u1y * inv1;
  u1z = u1z * inv1;
  float u2x, u2y, u2z;
  cross3(vx0, vy0, vz0, u1x, u1y, u1z, u2x, u2y, u2z);

  const float w1x = a00 * u1x + a01 * u1y + a02 * u1z;
  const float w1y = a01 * u1x + a11 * u1y + a12 * u1z;
  const float w1z = a02 * u1x + a12 * u1y + a22 * u1z;
  const float w2x = a00 * u2x + a01 * u2y + a02 * u2z;
  const float w2y = a01 * u2x + a11 * u2y + a12 * u2z;
  const float w2z = a02 * u2x + a12 * u2y + a22 * u2z;
  const float t11 = u1x * w1x + u1y * w1y + u1z * w1z;
  const float t12 = u1x * w2x + u1y * w2y + u1z * w2z;
  const float t22 = u2x * w2x + u2y * w2y + u2z * w2z;

  const float mean2 = 0.5f * (t11 + t22);
  const float dd = 0.5f * (t11 - t22);
  const float s2x2 = sqrtf(dd * dd + t12 * t12);
  const float lam = mean2 - s2x2;
  const float ca1 = t12, ca2 = lam - t11;
  const float cb1 = lam - t22, cb2 = t12;
  const float na2 = ca1 * ca1 + ca2 * ca2;
  const float nb2 = cb1 * cb1 + cb2 * cb2;
  const bool use_ca = na2 >= nb2;
  float g1 = use_ca ? ca1 : cb1;
  float g2 = use_ca ? ca2 : cb2;
  const float wn2 = max_nan(na2, nb2);
  const bool degen2 = wn2 <= 1e-12f * fro2;
  const float invw = 1.0f / sqrtf(max_nan(wn2, 1e-30f));
  g1 = g1 * invw;
  g2 = g2 * invw;

  float dx = g1 * u1x + g2 * u2x;
  float dy = g1 * u1y + g2 * u2y;
  float dz = g1 * u1z + g2 * u2z;
  const float invn = 1.0f / sqrtf(max_nan(dx * dx + dy * dy + dz * dz, 1e-30f));
  dx = dx * invn;
  dy = dy * invn;
  dz = dz * invn;

  const bool degen_d = degen0 || degen2;
  dx = degen_d ? 0.0f : dx;
  dy = degen_d ? 0.0f : dy;
  dz = degen_d ? 1.0f : dz;

  const float fro = sqrtf(fro2);
  const bool clustered = (e1 - e2) <= 1e-2f * fro;
  vx = clustered ? dx : sx;
  vy = clustered ? dy : sy;
  vz = clustered ? dz : sz;

  if (!isfinite(a00 + a11 + a22 + off_sq)) {
    vx = vy = vz = __int_as_float(0x7fffffff);
  }
}

// ops/fit_kernel.py:plane_row_from_moments
__device__ void plane_row(const float m[10], float spx, float spy, float spz,
                          float row[14]) {
  const float n = m[0];
  const float safe_n = max_nan(n, 1.0f);
  const float mqx = m[1] / safe_n;
  const float mqy = m[2] / safe_n;
  const float mqz = m[3] / safe_n;
  const float denom = n - 1.0f;
  const float cxx = (m[4] - n * mqx * mqx) / denom;
  const float cxy = (m[5] - n * mqx * mqy) / denom;
  const float cxz = (m[6] - n * mqx * mqz) / denom;
  const float cyy = (m[7] - n * mqy * mqy) / denom;
  const float cyz = (m[8] - n * mqy * mqz) / denom;
  const float czz = (m[9] - n * mqz * mqz) / denom;
  float vx, vy, vz;
  eig3_plane(cxx, cxy, cxz, cyy, cyz, czz, vx, vy, vz);
  const bool flip = vz < 0.0f;
  float nx = flip ? -vx : vx;
  float ny = flip ? -vy : vy;
  float nz = flip ? -vz : vz;
  const float mx = mqx + spx;
  const float my = mqy + spy;
  const float mz = mqz + spz;
  float d = -(nx * mx + ny * my + nz * mz);
  // non-finite plane (a 1-point fit) -> sentinel [0, 0, 0, 1e30]
  const bool fin = isfinite(nx) && isfinite(ny) && isfinite(nz) && isfinite(d);
  if (!fin) {
    nx = 0.0f;
    ny = 0.0f;
    nz = 0.0f;
    d = 1e30f;
  }
  const float vals[14] = {nx, ny, nz, d, n, cxx, cxy, cxz,
                          cyy, cyz, czz, mx, my, mz};
  for (int c = 0; c < 14; ++c) row[c] = vals[c];
}

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

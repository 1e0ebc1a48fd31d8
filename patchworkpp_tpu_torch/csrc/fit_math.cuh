// Device functions shared by the port's two fit kernels (fit_grid.cu, K1,
// and fit_onehot.cu, K2): the fixed-order tile sum (K2's; K1 sums several
// columns at once along the same tree) and the plane fit from moment sums.
// Each repeats the plain PyTorch version operation for operation
// (ops.tree_sum, ops/eigen3.py, ops/trig.py,
// ops/fit_kernel.py:plane_row_from_moments), so the kernels and their plain
// versions agree bit for bit when built with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppk {

constexpr int kLane = 128;
constexpr unsigned kFull = 0xffffffffu;

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
// eigenvector of the smallest eigenvalue). The plain version computes the
// separated-pair and the clustered-pair vector and selects one; here only
// the selected one is computed, which gives the same bits (the other's
// values reach no output) in fewer dependent steps.
__device__ void eig3_plane(float a00, float a01, float a02, float a11,
                           float a12, float a22, float& vx, float& vy,
                           float& vz) {
  const float off_sq = a01 * a01 + a02 * a02 + a12 * a12;
  const float fro2 = a00 * a00 + a11 * a11 + a22 * a22 + 2.0f * off_sq;
  // ops.div: a division by a constant is a multiply by its f32 reciprocal
  const float q = (a00 + a11 + a22) * (1.0f / 3.0f);
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * off_sq;
  const float p = sqrtf(p2 * (1.0f / 6.0f));

  const float safe_p = p > 1e-12f ? p : 1.0f;
  const float c00 = b00 / safe_p, c11 = b11 / safe_p, c22 = b22 / safe_p;
  const float c01 = a01 / safe_p, c02 = a02 / safe_p, c12 = a12 / safe_p;
  const float detb = c00 * (c11 * c22 - c12 * c12) -
                     c01 * (c01 * c22 - c12 * c02) +
                     c02 * (c01 * c12 - c11 * c02);
  const float r = clip_nan(detb * 0.5f, -1.0f, 1.0f);
  float cos_lo, cos_hi;
  cardano_cos_pair(r, cos_lo, cos_hi);

  const float two_p = 2.0f * p;
  const float e0 = q + two_p * cos_lo;
  const float e2 = q + two_p * cos_hi;
  const float e1 = 3.0f * q - e0 - e2;
  const float fro = sqrtf(fro2);
  const bool clustered = (e1 - e2) <= 1e-2f * fro;

  // separated pair: eigenvector of e2 from the largest row cross product
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (!clustered) {
    float nbest_s;
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
  }

  // clustered pair: deflation from the isolated largest root
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (clustered) {
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

    dx = g1 * u1x + g2 * u2x;
    dy = g1 * u1y + g2 * u2y;
    dz = g1 * u1z + g2 * u2z;
    const float invn = 1.0f / sqrtf(max_nan(dx * dx + dy * dy + dz * dz, 1e-30f));
    dx = dx * invn;
    dy = dy * invn;
    dz = dz * invn;

    const bool degen_d = degen0 || degen2;
    dx = degen_d ? 0.0f : dx;
    dy = degen_d ? 0.0f : dy;
    dz = degen_d ? 1.0f : dz;
  }

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

}  // namespace ppk

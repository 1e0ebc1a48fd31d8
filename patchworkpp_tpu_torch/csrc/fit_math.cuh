// Device functions shared by the port's two fit kernels (fit_program.cuh,
// built as K1 in fit_grid.cu and K2 in fit_onehot.cu): the plane fit from
// moment sums. It repeats the plain PyTorch version operation for operation
// (ops/eigen3.py, ops/trig.py, ops/fit_kernel.py:plane_row_from_moments),
// so the kernels and their plain versions agree bit for bit. The build has
// --fmad=false, so nvcc contracts nothing on its own; every fused
// multiply-add here is an explicit __fmaf_rn, where the plain version has
// ops.fma, because XLA:CPU fuses the same multiply into its add or
// subtract when it compiles the JAX package (see ops/eigen3.py).

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

__device__ __forceinline__ void cross3(float px, float py, float pz, float qx,
                                       float qy, float qz, float& x, float& y,
                                       float& z) {
  x = py * qz - pz * qy;
  y = pz * qx - px * qz;
  z = px * qy - py * qx;
}

// ops/eigen3.py:_best_row_cross. kContracted: the rounding of the
// separated pair's fusion (products shared by two components or by off_sq
// are rounded on their own, the others fused into their subtraction).
template <bool kContracted>
__device__ void best_row_cross(float d00, float a01, float a02, float d11,
                               float a12, float d22, float& vx, float& vy,
                               float& vz, float& nbest) {
  float ax, ay, az, bx, by, bz, cx, cy, cz, na, nb, nc;
  if (kContracted) {
    ax = __fmaf_rn(a01, a12, -(a02 * d11));
    ay = a02 * a01 - d00 * a12;
    az = __fmaf_rn(d00, d11, -(a01 * a01));
    bx = a01 * d22 - a02 * a12;
    by = __fmaf_rn(-d00, d22, a02 * a02);
    bz = d00 * a12 - a01 * a02;
    cx = __fmaf_rn(d11, d22, -(a12 * a12));
    cy = a12 * a02 - a01 * d22;
    cz = ax;
    na = __fmaf_rn(az, az, __fmaf_rn(ay, ay, ax * ax));
    nb = __fmaf_rn(bz, bz, __fmaf_rn(bx, bx, by * by));
    nc = __fmaf_rn(cx, cx, cy * cy) + cz * cz;
  } else {
    cross3(d00, a01, a02, a01, d11, a12, ax, ay, az);
    cross3(d00, a01, a02, a02, a12, d22, bx, by, bz);
    cross3(a01, d11, a12, a02, a12, d22, cx, cy, cz);
    na = ax * ax + ay * ay + az * az;
    nb = bx * bx + by * by + bz * bz;
    nc = cx * cx + cy * cy + cz * cz;
  }
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
  poly = __fmaf_rn(poly, ax, 0.0066700901f);
  poly = __fmaf_rn(poly, ax, -0.0170881256f);
  poly = __fmaf_rn(poly, ax, 0.0308918810f);
  poly = __fmaf_rn(poly, ax, -0.0501743046f);
  poly = __fmaf_rn(poly, ax, 0.0889789874f);
  poly = __fmaf_rn(poly, ax, -0.2145988016f);
  poly = __fmaf_rn(poly, ax, 1.5707963050f);
  const float pos = sqrtf(max_nan(1.0f - ax, 0.0f)) * poly;
  const float acos_r = r >= 0.f ? pos : 3.14159265358979323846f - pos;
  const float phi = acos_r * (float)(1.0 / 3.0);
  const float p2 = phi * phi;
  float s = (float)(-1.0 / 39916800.0);
  s = __fmaf_rn(s, p2, (float)(1.0 / 362880.0));
  s = __fmaf_rn(s, p2, (float)(-1.0 / 5040.0));
  s = __fmaf_rn(s, p2, (float)(1.0 / 120.0));
  s = __fmaf_rn(s, p2, (float)(-1.0 / 6.0));
  s = __fmaf_rn(s, p2, 1.0f);
  const float sn = s * phi;
  float cs = (float)(1.0 / 479001600.0);
  cs = __fmaf_rn(cs, p2, (float)(-1.0 / 3628800.0));
  cs = __fmaf_rn(cs, p2, (float)(1.0 / 40320.0));
  cs = __fmaf_rn(cs, p2, (float)(-1.0 / 720.0));
  cs = __fmaf_rn(cs, p2, (float)(1.0 / 24.0));
  cs = __fmaf_rn(cs, p2, (float)(-1.0 / 2.0));
  cs = __fmaf_rn(cs, p2, 1.0f);
  c = cs;
  c_hi = __fmaf_rn(-0.5f, cs, -(0.8660254037844386f * sn));
}

// The Cardano roots of a symmetric 3x3 matrix and the terms the vector
// construction reuses (ops/eigen3.py:eig3_plane_columns, up to e0, e1, e2).
struct Roots {
  float off_sq, diag_sq, tr, q, p2, two_p, cos_hi, e0, e1, e2;
};

__device__ Roots cardano_roots(float a00, float a01, float a02, float a11, float a12,
                               float a22) {
  Roots o;
  o.off_sq = __fmaf_rn(a12, a12, __fmaf_rn(a01, a01, a02 * a02));
  o.diag_sq = __fmaf_rn(a22, a22, __fmaf_rn(a00, a00, a11 * a11));
  // ops.div: a division by a constant is a multiply by its f32 reciprocal
  o.tr = a00 + a11 + a22;
  const float third = 1.0f / 3.0f;
  o.q = o.tr * third;
  const float b00 = __fmaf_rn(-o.tr, third, a00);
  const float b11 = __fmaf_rn(-o.tr, third, a11);
  const float b22 = __fmaf_rn(-o.tr, third, a22);
  o.p2 = __fmaf_rn(b22, b22, __fmaf_rn(b00, b00, b11 * b11)) + 2.0f * o.off_sq;
  const float p = sqrtf(o.p2 * (1.0f / 6.0f));

  const float safe_p = p > 1e-12f ? p : 1.0f;
  const float c00 = b00 / safe_p, c11 = b11 / safe_p, c22 = b22 / safe_p;
  const float c01 = a01 / safe_p, c02 = a02 / safe_p, c12 = a12 / safe_p;
  const float detb = __fmaf_rn(
      c02, __fmaf_rn(c01, c12, -(c11 * c02)),
      __fmaf_rn(c00, __fmaf_rn(c11, c22, -(c12 * c12)),
                -(c01 * __fmaf_rn(c01, c22, -(c12 * c02)))));
  const float r = clip_nan(detb * 0.5f, -1.0f, 1.0f);
  float cos_lo;
  cardano_cos_pair(r, cos_lo, o.cos_hi);

  o.two_p = 2.0f * p;
  o.e0 = __fmaf_rn(o.two_p, cos_lo, o.q);
  o.e2 = __fmaf_rn(o.two_p, o.cos_hi, o.q);
  o.e1 = (o.tr - o.e0) - o.e2;  // 3 * q, folded to the trace
  return o;
}

// ops/eigen3.py:eig3_plane_columns(vector=False): the eigenvalues,
// descending (q where the matrix is isotropic, NaN where it is not finite).
__device__ void eig3_values(float a00, float a01, float a02, float a11, float a12, float a22,
                            float e[3]) {
  const Roots o = cardano_roots(a00, a01, a02, a11, a12, a22);
  const bool isotropic = o.p2 <= 1e-12f;
  const bool bad = !isfinite(a00 + a11 + a22 + o.off_sq);
  const float v[3] = {o.e0, o.e1, o.e2};
  for (int c = 0; c < 3; ++c) e[c] = bad ? __int_as_float(0x7fffffff) : isotropic ? o.q : v[c];
}

// ops/eigen3.py:eig3_plane_columns, vector part only (the unflipped unit
// eigenvector of the smallest eigenvalue). The plain version computes the
// separated-pair and the clustered-pair vector and selects one; here only
// the selected one is computed, which gives the same bits (the other's
// values reach no output) in fewer dependent steps.
__device__ void eig3_plane(float a00, float a01, float a02, float a11,
                           float a12, float a22, float& vx, float& vy,
                           float& vz) {
  const Roots o = cardano_roots(a00, a01, a02, a11, a12, a22);
  const float off_sq = o.off_sq, diag_sq = o.diag_sq, tr = o.tr;
  const float two_p = o.two_p, cos_hi = o.cos_hi, e0 = o.e0, e1 = o.e1, e2 = o.e2;
  const float third = 1.0f / 3.0f;
  const float fro2 = diag_sq + 2.0f * off_sq;
  const float fro = sqrtf(fro2);
  const bool clustered = (e1 - e2) <= 1e-2f * fro;

  // separated pair: eigenvector of e2 from the largest row cross product,
  // with that fusion's e2 and fro2 (ops/eigen3.py)
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (!clustered) {
    const float e2s = __fmaf_rn(tr, third, two_p * cos_hi);
    float nbest_s;
    best_row_cross<true>(a00 - e2s, a01, a02, a11 - e2s, a12, a22 - e2s, sx, sy, sz,
                         nbest_s);
    const float fro2_s = diag_sq + 2.0f * ((a01 * a01 + a02 * a02) + a12 * a12);
    const bool degen_s = nbest_s <= 1e-12f * fro2_s * fro2_s;
    sx = degen_s ? 0.0f : sx;
    sy = degen_s ? 0.0f : sy;
    sz = degen_s ? 1.0f : sz;
    const float norm_s = sqrtf(__fmaf_rn(sz, sz, __fmaf_rn(sx, sx, sy * sy)));
    sx = sx / norm_s;
    sy = sy / norm_s;
    sz = sz / norm_s;
  }

  // clustered pair: deflation from the isolated largest root
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (clustered) {
    float vx0, vy0, vz0, nbest0;
    best_row_cross<false>(a00 - e0, a01, a02, a11 - e0, a12, a22 - e0, vx0, vy0, vz0,
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
  const float cxx = __fmaf_rn(-(n * mqx), mqx, m[4]) / denom;
  const float cxy = __fmaf_rn(-(n * mqx), mqy, m[5]) / denom;
  const float cxz = __fmaf_rn(-(n * mqx), mqz, m[6]) / denom;
  const float cyy = __fmaf_rn(-(n * mqy), mqy, m[7]) / denom;
  const float cyz = __fmaf_rn(-(n * mqy), mqz, m[8]) / denom;
  const float czz = __fmaf_rn(-(n * mqz), mqz, m[9]) / denom;
  float vx, vy, vz;
  eig3_plane(cxx, cxy, cxz, cyy, cyz, czz, vx, vy, vz);
  const bool flip = vz < 0.0f;
  float nx = flip ? -vx : vx;
  float ny = flip ? -vy : vy;
  float nz = flip ? -vz : vz;
  const float mx = mqx + spx;
  const float my = mqy + spy;
  const float mz = mqz + spz;
  float d = -__fmaf_rn(nz, mz, __fmaf_rn(nx, mx, ny * my));
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

// The per-patch R-VPF / R-GPF fit program of Patchwork++ ground segmentation
// on the tiled layout, one launch a frame: the kernel body of both fit
// kernels of the PyTorch port, as a template on the per-patch reduction.
//
//   K1 (fit_grid.cu, Split3)   replaces patchworkpp_tpu/ops/pallas/
//       fit_kernel_grid.py:fused_fit_grid; plain version
//       ops/tiled_fit.py:tiled_fit (reduce=_reduce_tiles_split3).
//   K2 (fit_onehot.cu, F32Chain) replaces patchworkpp_tpu/ops/pallas/
//       fit_kernel.py:fused_fit; plain version
//       ops/fit_kernel.py:fused_fit_reference (tiled_fit with
//       reduce=_reduce_tiles_f32).
//
// The two TPU kernels compute one program (K2 as 15 unrolled passes, K1 as
// 7 fused ones); they differ only in how a patch's tile sums are added, so
// one body serves both. Each kernel performs its plain version's float
// operations in the same order, so the two agree bit for bit. Build flags
// (ops/nvcc.py): sm_90a, -O3, --fmad=false; the fused multiply-adds of the
// plain version (ops.fma: the contractions XLA:CPU makes when it compiles
// the JAX package) are explicit __fmaf_rn here and in fit_math.cuh.
//
// What bounds it: latency, not bytes. Its bytes (x, y, z and valid of the
// processed patches' tiles in, the table out, ~2.3 MB at capacity 131072)
// take under a microsecond at the HBM rate. A patch's 7 passes are a chain
// of dependent steps: walks over its tiles, each ended by a block barrier
// and a serial per-part sum over tiles, and after each pass one plane fit
// (a 3x3 eigensolver) on one thread. So every processed patch costs tens of
// microseconds whatever its size.
//
// Design:
// - One CTA of kWarps warps per patch row of the (spad, out_cols) table,
//   kBlocksPerSm CTAs resident on an SM so that the latency of one patch's
//   plane fits and barriers hides behind another's work.
// - The patch's x, y, z are copied once into shared memory (a patch of at
//   most kCapTiles tiles) with float4 loads, each 32-row window of a tile
//   padded to kWinStride floats (so not with the 1-D bulk copy, whose
//   destination must be 16-byte aligned). A longer patch is staged chunk by
//   chunk, kCapTiles tiles at a time, at every walk (its rows then come
//   through L2).
// - Tile sums follow ops.row_sum, XLA:CPU's order for a 128-lane sum: each
//   32-row window summed row after row from 0, then the 4 window sums in
//   order. One lane sums one window of one tile (a warp takes 8 tiles at
//   once), reading that window's rows from shared memory one after another;
//   the padding puts the 32 lanes' rows in 32 different banks. A row the
//   mask leaves out adds (q * 0), a zero that changes no sum, as in the
//   plain version: the loop has no branch per row.
// - `active` is one bit a row (16 B a tile): in shared memory for a
//   resident patch, in a global (nt, 4) word scratch for a longer one. The
//   plain version's `active` is a float that only ever holds 0 or 1, so the
//   bit gives it back exactly.
// - Each tile's sums are stored in shared memory by the reducer: Split3
//   stores the three round-to-nearest bf16 parts of each (tiled_fit.
//   _reduce_tiles_split3, re-added as (hi + mid) + lo), F32Chain the sum
//   itself (tiled_fit._reduce_tiles_f32). Only the per-part f32 chain
//   acc = acc + part[t], in tile order, is serial: one lane of warp 0 per
//   part (10 or 30 moment parts, 2 or 6 LPR parts).
// - LPR (the lowest num_lpr eligible z of the patch): each warp counts its
//   tiles' eligible rows (ballots), warp 0 scans the int32 counts into each
//   tile's exclusive prior (exact in any order), then each window's lane
//   takes its eligible rows while their rank is under num_lpr.
// - Plane carry, alive and LPR live in shared memory; lane 0 of warp 0 runs
//   the plane fit (fit_math.cuh plane_row) after each pass. R-VPF snapshots
//   are written into the patch's own output row and read back by the later
//   peel pass; a plane updates only where gate & n > 0.
// - Work whose result reaches no output is skipped, per patch: a pass whose
//   gate is shut (an R-VPF round after the patch stopped being vertical)
//   computes no LPR, moments or plane fit, and walks its tiles only if its
//   snapshot's gate asks for a peel. The plain version computes and
//   discards them; the bits are the same.
// - At the end thread 0 writes the eigenvalues of the final covariance
//   after carry2 (tiled_fit.out_layout), which the frame's tail reads, so
//   the frame runs no eigensolver of its own (one fma emulation a step in
//   PyTorch ops would cost the frame ~700 launches).
// - Unprocessed patches (gates col 0 == 0) hold no active row; their row of
//   the plain version's table is all zero, and the CTA writes zeros.
// - The pass program arrives as a (6, npasses) int32 array (tiled_fit's
//   _pass_config), so any num_iter and any spad work.

#pragma once

#include "fit_math.cuh"

namespace ppk {
// Internal linkage: each kernel library keeps its own instantiations and
// its own first-call attribute flag.
namespace {

constexpr int kSeedfit = 0;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;   // 2 x 512 threads: at most 64 registers
constexpr int kWin = 32;          // ops.ROW_WINDOW: rows of a tile-sum window
constexpr int kWinStride = 33;    // a window's floats in shared memory
constexpr int kTileFloats = 4 * kWinStride;
constexpr int kTilesPerWarp = 8;  // tiles one warp sums at once (lane = tile, window)
// Tiles of one patch kept in shared memory: 64 tiles of padded x, y and z
// are 101,376 B; with the active and eligible bits (1,024 B each), the
// tile counts (256 B) and the tile parts (7,680 B) a CTA takes 111,360 B of
// dynamic shared memory, so two CTAs share an SM's 228 KB.
constexpr int kCapTiles = 64;
constexpr int kPartSlots = 30;  // a tile's part slots: 10 columns x up to 3 parts
constexpr int kRowFloats = kCapTiles * kTileFloats;
constexpr size_t kSmemBytes =
    3 * kRowFloats * sizeof(float)          // x, y, z
    + 2 * kCapTiles * 4 * sizeof(uint32_t)  // active bits, eligible bits
    + kCapTiles * sizeof(int)               // eligible counts, then priors
    + kCapTiles * kPartSlots * sizeof(float);
static_assert(kCapTiles % 32 == 0, "warp 0 scans kCapTiles / 32 counts a lane");
static_assert(kCapTiles % kTilesPerWarp == 0, "chunks hold whole tile groups");
static_assert(kBlocksPerSm * (kSmemBytes + 1024) <= 233472, "over an SM's shared memory");

// K1's per-patch sum: three rne-bf16 parts per tile sum, each part summed
// over tiles in f32, re-added as (hi + mid) + lo.
struct Split3 {
  static constexpr int kParts = 3;
  static __device__ __forceinline__ float rne_part(float v, float* rest) {
    const uint32_t bits = __float_as_uint(v);
    const uint32_t lsb = (bits >> 16) & 1u;
    const float kept = __uint_as_float((bits + 0x7FFFu + lsb) & 0xFFFF0000u);
    *rest = v - kept;
    return kept;
  }
  // parts of v at dst[0], dst[stride], dst[2 * stride]
  static __device__ __forceinline__ void store(float v, float* dst, int stride) {
    float r1, r2, r3;
    dst[0] = rne_part(v, &r1);
    dst[stride] = rne_part(r1, &r2);
    dst[2 * stride] = rne_part(r2, &r3);
  }
  static __device__ __forceinline__ float combine(const float* acc, int c, int ncols) {
    return (acc[c] + acc[ncols + c]) + acc[2 * ncols + c];
  }
};

// K2's per-patch sum: the tile sums themselves, added in f32 in tile order.
struct F32Chain {
  static constexpr int kParts = 1;
  static __device__ __forceinline__ void store(float v, float* dst, int) { dst[0] = v; }
  static __device__ __forceinline__ float combine(const float* acc, int c, int) {
    return acc[c];
  }
};

struct PatchState {
  float plane[14];  // plane_row layout: n(3), d, count, cov(6), mean(3)
  float alive;
  float lpr;
  float acc[kPartSlots];  // the per-part chains, gathered for lane 0
};

struct Args {
  const float* xs;
  const float* ys;
  const float* zs;
  const float* valid;
  const int* prog;
  int npasses;
  uint32_t* gmask;
  int num_lpr;
  float th_dist_v;
  float upright_thr;
  int snap_off;
  int carry2_off;
};

// acc + col[0] + col[kPartSlots] + ... over n tiles, added in tile order;
// the loads run ahead of the dependent adds.
__device__ __forceinline__ float chain(float acc, const float* col, int n) {
#pragma unroll 8
  for (int j = 0; j < n; ++j) acc = acc + col[j * kPartSlots];
  return acc;
}

// v[i] without dynamic register indexing.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T r = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) r = (i == c) ? v[c] : r;
  return r;
}

__device__ __forceinline__ float bit_f(uint32_t word, int lane) {
  return ((word >> lane) & 1u) ? 1.0f : 0.0f;
}

// ops.plane_dist: ((x*nx + y*ny) + z*nz) + d as XLA:CPU contracts it.
__device__ __forceinline__ float plane_dist(float x, float y, float z, float nx, float ny,
                                            float nz, float d) {
  return __fmaf_rn(z, nz, __fmaf_rn(x, nx, y * ny)) + d;
}

// Shared-memory index of row r (0..127) of chunk tile jj.
__device__ __forceinline__ int srow(int jj, int r) {
  return jj * kTileFloats + (r >> 5) * kWinStride + (r & 31);
}

// Copies x, y, z of n tiles from tile t into the padded shared layout. The
// base pointers are 16-byte aligned (the wrapper checks) and a tile is 512
// B, so each thread moves float4s; 4 floats never straddle a window.
__device__ __forceinline__ void stage_rows(const Args& a, int t, int n, float* s_rows) {
  const size_t g0 = static_cast<size_t>(t) * kLane / 4;
  const float4* src[3] = {reinterpret_cast<const float4*>(a.xs) + g0,
                          reinterpret_cast<const float4*>(a.ys) + g0,
                          reinterpret_cast<const float4*>(a.zs) + g0};
  const int n4 = n * kLane / 4;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* dst = s_rows + c * kRowFloats;
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      const float4 v = src[c][e];
      const int r = (e * 4) & (kLane - 1);
      float* o = dst + srow(e * 4 / kLane, r);
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  }
}

// (((0 + w0) + w1) + w2) + w3 over the 4 window lanes of this lane's tile
// group (lanes 4t .. 4t + 3); valid in lane 4t.
__device__ __forceinline__ float tile_total(float w) {
  const float w1 = __shfl_down_sync(kFull, w, 1);
  const float w2 = __shfl_down_sync(kFull, w, 2);
  const float w3 = __shfl_down_sync(kFull, w, 3);
  return ((w + w1) + w2) + w3;
}

// The 10 moment sums of one 32-row window (tiled_fit._tile_moments's
// columns, ops.row_sum's order) over the rows whose active bit is set and
// that pass the walk's test: kSeed, z < lim (the seed walk runs only where
// the pass's gate is open); else a plane distance under th. A row that
// fails adds (q * 0), a zero, which changes no sum: no branch per row.
template <bool kSeed>
__device__ __forceinline__ void window_moments(const float* px, const float* py, const float* pz,
                                               uint32_t word, float lim, float th, float nx,
                                               float ny, float nz, float d, float spx, float spy,
                                               float spz, float (&s)[10]) {
#pragma unroll 4
  for (int i = 0; i < kWin; ++i) {
    const float x = px[i], y = py[i], z = pz[i];
    const bool in = kSeed ? z < lim : plane_dist(x, y, z, nx, ny, nz, d) < th;
    const float m = (((word >> i) & 1u) && in) ? 1.0f : 0.0f;
    const float qx = x - spx, qy = y - spy, qz = z - spz;
    s[0] = s[0] + m;
    s[1] = s[1] + qx * m;
    s[2] = s[2] + qy * m;
    s[3] = s[3] + qz * m;
    s[4] = s[4] + qx * qx * m;
    s[5] = s[5] + qx * qy * m;
    s[6] = s[6] + qx * qz * m;
    s[7] = s[7] + qy * qy * m;
    s[8] = s[8] + qy * qz * m;
    s[9] = s[9] + qz * qz * m;
  }
}

// The dynamic shared memory of one CTA: x, y, z rows of up to kCapTiles
// tiles, the active and eligible bits, the eligible counts (then priors),
// the tile sums' parts.
struct Smem {
  float* rows;
  uint32_t* mask;
  uint32_t* elig;
  int* cnt;
  float* part;
};

__device__ __forceinline__ Smem smem_layout(unsigned char* smem) {
  Smem s;
  s.rows = reinterpret_cast<float*>(smem);
  s.mask = reinterpret_cast<uint32_t*>(s.rows + 3 * kRowFloats);
  s.elig = s.mask + 4 * kCapTiles;
  s.cnt = reinterpret_cast<int*>(s.elig + 4 * kCapTiles);
  s.part = reinterpret_cast<float*>(s.cnt + kCapTiles);
  return s;
}

// A SEEDFIT pass's first walk over n staged tiles (tile j0 + jj of the
// patch at chunk row jj), lane = row: the peel by snapshot (gate sg,
// plane snx, sny, snz, sd) where do_peel, then each tile's eligible bits
// (s.elig) and count (s.cnt). The caller ends it with a block barrier.
__device__ __forceinline__ void seed_count_walk(const Args& a, const Smem& s, uint32_t* mk,
                                                int j0, int n, bool do_peel, float sg,
                                                float snx, float sny, float snz, float sd,
                                                bool zone0, float margin) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* sx_ = s.rows;
  const float* sy_ = s.rows + kRowFloats;
  const float* sz_ = s.rows + 2 * kRowFloats;
  for (int jj = warp; jj < n; jj += kWarps) {
    const int j = j0 + jj;
    const uint4 w = *reinterpret_cast<const uint4*>(mk + j * 4);
    const uint32_t wk[4] = {w.x, w.y, w.z, w.w};
    uint32_t nb[4] = {0u, 0u, 0u, 0u}, eb[4];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = srow(jj, lane + 32 * k);
      float act = bit_f(wk[k], lane);
      const float z = sz_[i];
      if (do_peel) {
        const float dist = plane_dist(sx_[i], sy_[i], z, snx, sny, snz, sd);
        const float hit = (sg > 0.5f && fabsf(dist) < a.th_dist_v) ? 1.0f : 0.0f;
        act = act * (1.0f - hit);
        nb[k] = __ballot_sync(kFull, act > 0.5f);
      }
      const float e = act * ((zone0 && z < margin) ? 0.0f : 1.0f);
      eb[k] = __ballot_sync(kFull, e > 0.5f);
      cnt += __popc(eb[k]);
    }
    if (do_peel && lane < 4) mk[j * 4 + lane] = pick(nb, lane);
    if (lane < 4) s.elig[jj * 4 + lane] = pick(eb, lane);
    if (lane == 0) s.cnt[jj] = cnt;
  }
}

// Warp 0: prior[jj] = carry + the exclusive int32 prefix of cnt[0..n) (exact
// in any order; prior may be cnt itself); carry grows by their total.
__device__ __forceinline__ void prefix_counts(const int* cnt, int* prior, int n, int& carry) {
  const int lane = threadIdx.x & 31;
  constexpr int kPer = kCapTiles / 32;
  int v[kPer];
  int own = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int jj = lane * kPer + i;
    v[i] = jj < n ? cnt[jj] : 0;
    own += v[i];
  }
  int inc = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  int run = carry + inc - own;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int jj = lane * kPer + i;
    if (jj < n) prior[jj] = run;
    run += v[i];
  }
  carry += __shfl_sync(kFull, inc, 31);
}

// One thread: the end of a pass that took moment sums m: a final
// FITDIST's g_count, the plane fit where the gate is open (fit) and the
// sums hold a point. (m by reference: a pointer to it would put the array
// in local memory.)
__device__ __forceinline__ void end_moments(const float (&m)[10], bool gcount, bool fit,
                                            float spx, float spy, float spz, float* orow,
                                            PatchState* st) {
  if (gcount) orow[kOutGcount] = m[0];
  if (fit && m[0] > 0.0f) {  // else the plane keeps its carry
    float row[14];
    plane_row(m, spx, spy, spz, row);
    for (int c = 0; c < 14; ++c) st->plane[c] = row[c];
  }
}

// One thread: a SEEDFIT pass's vertical snapshot into slot snap.
__device__ __forceinline__ void take_snapshot(const Args& a, int snap, bool zone0, float* orow,
                                              PatchState* st) {
  const float vert = (st->alive > 0.5f && zone0 && st->plane[2] < a.upright_thr) ? 1.0f : 0.0f;
  float* s = orow + a.snap_off + 5 * snap;
  s[0] = vert;
  for (int c = 0; c < 4; ++c) s[1 + c] = st->plane[c];
  st->alive = vert;
}

// One thread: the final plane's columns and its covariance's eigenvalues,
// which the frame's tail reads.
__device__ __forceinline__ void write_final(const Args& a, const PatchState* st, float* orow) {
  for (int c = 0; c < 3; ++c) orow[kOutNormal + c] = st->plane[c];
  orow[kOutD] = st->plane[3];
  for (int c = 0; c < 3; ++c) orow[kOutMean + c] = st->plane[11 + c];
  orow[kOutN] = st->plane[4];
  for (int c = 0; c < 6; ++c) orow[kOutCov + c] = st->plane[5 + c];
  float e[3];
  eig3_values(st->plane[5], st->plane[6], st->plane[7], st->plane[8], st->plane[9],
              st->plane[10], e);
  for (int c = 0; c < 3; ++c) orow[a.carry2_off + 4 + c] = e[c];
}

// The pass program of one processed patch of T tiles starting at tile t0.
template <class R>
__device__ __forceinline__ void fit_patch(const Args& a, int t0, int T, const float* g,
                                          float margin, float* orow, unsigned char* smem,
                                          PatchState* st) {
  constexpr int kMomParts = 10 * R::kParts;
  constexpr int kLprParts = 2 * R::kParts;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gt = lane >> 2;  // tile of this lane in its warp's group of 8
  const int gw = lane & 3;   // window of this lane
  const float proc = g[0];
  const float spx = g[1], spy = g[2], spz = g[3];
  const bool zone0 = g[4] > 0.5f;

  const Smem s = smem_layout(smem);
  const float* sx_ = s.rows;
  const float* sy_ = s.rows + kRowFloats;
  const float* sz_ = s.rows + 2 * kRowFloats;

  const bool resident = T <= kCapTiles;  // uniform over the block
  const size_t g0 = static_cast<size_t>(t0) * kLane;
  uint32_t* mk = resident ? s.mask : a.gmask + static_cast<size_t>(t0) * 4;

  if (tid == 0) {
    for (int c = 0; c < 14; ++c) st->plane[c] = 0.0f;
    st->alive = proc;
    st->lpr = 0.0f;
  }
  if (resident) stage_rows(a, t0, T, s.rows);
  // active = valid * proc, as bits
  for (int j = warp; j < T; j += kWarps) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __ballot_sync(kFull, a.valid[g0 + j * kLane + lane + 32 * k] * proc > 0.5f);
    if (lane < 4) mk[j * 4 + lane] = pick(w, lane);
  }
  __syncthreads();

  const int np = a.npasses;
  for (int ps = 0; ps < np; ++ps) {
    const int kind = a.prog[ps];
    const int peel = a.prog[np + ps];
    const int snap = a.prog[2 * np + ps];
    const int gate_alive = a.prog[3 * np + ps];
    const int is_final = a.prog[4 * np + ps];
    const float th = __int_as_float(a.prog[5 * np + ps]);
    const float gate = gate_alive ? st->alive : proc;
    const bool seed = kind == kSeedfit;
    // With the gate shut the pass's LPR, moments and plane reach no output
    // (the plane keeps its carry), except a final FITDIST's g_count: skip
    // them, and the peel too where its snapshot gate is shut (it removes
    // nothing then). Uniform over the block.
    const bool fit = gate > 0.5f;
    const bool moments = fit || (!seed && is_final);
    float lim = 0.0f;

    if (seed) {
      const bool do_peel = peel >= 0;
      float sg = 0.f, snx = 0.f, sny = 0.f, snz = 0.f, sd = 0.f;
      if (do_peel) {
        const float* sp = orow + a.snap_off + 5 * peel;
        sg = sp[0];
        snx = sp[1];
        sny = sp[2];
        snz = sp[3];
        sd = sp[4];
      }
      float acc = 0.0f;  // warp 0, lane < kLprParts: one part's chain
      int carry = 0;     // warp 0: eligible rows of the chunks before
      const int walk_to = fit || (do_peel && sg > 0.5f) ? T : 0;
      for (int j0 = 0; j0 < walk_to; j0 += kCapTiles) {
        const int n = min(kCapTiles, T - j0);
        if (!resident) {
          stage_rows(a, t0 + j0, n, s.rows);
          __syncthreads();
        }
        // walk 1: peel, eligibility bits and counts per tile (lane = row)
        seed_count_walk(a, s, mk, j0, n, do_peel, sg, snx, sny, snz, sd, zone0, margin);
        __syncthreads();
        if (!fit) continue;  // the peel alone
        // exclusive int32 prefix of the counts over the patch's tiles
        if (warp == 0) prefix_counts(s.cnt, s.cnt, n, carry);
        __syncthreads();
        // walk 2: the LPR rows (rank < num_lpr) and their z, one lane per
        // window; each tile's two sums as parts
        for (int grp = warp * kTilesPerWarp; grp < n; grp += kWarps * kTilesPerWarp) {
          const int jj = grp + gt;
          float zw = 0.0f;
          int taken = 0;
          if (jj < n) {
            const uint4 w = *reinterpret_cast<const uint4*>(s.elig + jj * 4);
            const uint32_t eb[4] = {w.x, w.y, w.z, w.w};
            int rank = s.cnt[jj];
#pragma unroll
            for (int k = 0; k < 3; ++k) rank += k < gw ? __popc(eb[k]) : 0;
            const float* zr = sz_ + jj * kTileFloats + gw * kWinStride;
            for (uint32_t word = pick(eb, gw); word && rank < a.num_lpr; word &= word - 1) {
              zw = zw + zr[__ffs(word) - 1];
              ++taken;
              ++rank;
            }
          }
          const float zt = tile_total(zw);
          const float ct = tile_total(static_cast<float>(taken));
          if (gw == 0 && jj < n) {
            R::store(zt, s.part + jj * kPartSlots, 2);
            R::store(ct, s.part + jj * kPartSlots + 1, 2);
          }
        }
        __syncthreads();
        if (warp == 0 && lane < kLprParts) acc = chain(acc, s.part + lane, n);
        // the next chunk writes parts (and rows) only after its first
        // barrier, which warp 0 reaches after this chain
      }
      if (fit) {
        if (warp == 0) {
          if (lane < kLprParts) st->acc[lane] = acc;
          __syncwarp();
          if (lane == 0) {
            const float ssum = R::combine(st->acc, 0, 2);
            const float cnt = R::combine(st->acc, 1, 2);
            st->lpr = cnt > 0.0f ? ssum / max_nan(cnt, 1.0f) : 0.0f;
          }
        }
        __syncthreads();
        lim = st->lpr + th;
      }
    } else if (is_final && tid == 0) {
      for (int c = 0; c < 4; ++c) orow[a.carry2_off + c] = st->plane[c];
    }

    // walk 3 (SEEDFIT: seed mask) or the only walk (FITDIST: distance
    // mask): the 10 moment sums of each tile, one lane per window
    const float nx = st->plane[0], ny = st->plane[1], nz = st->plane[2], d = st->plane[3];
    float acc = 0.0f;  // warp 0, lane < kMomParts: one part's chain
    for (int j0 = 0; j0 < (moments ? T : 0); j0 += kCapTiles) {
      const int n = min(kCapTiles, T - j0);
      if (!resident) {
        __syncthreads();  // the last walk has read the staged rows
        stage_rows(a, t0 + j0, n, s.rows);
        __syncthreads();
      }
      for (int grp = warp * kTilesPerWarp; grp < n; grp += kWarps * kTilesPerWarp) {
        const int jj = grp + gt;
        float m[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) m[c] = 0.0f;
        if (jj < n) {
          const uint32_t word = mk[(j0 + jj) * 4 + gw];
          const int base = jj * kTileFloats + gw * kWinStride;
          if (seed) {
            window_moments<true>(sx_ + base, sy_ + base, sz_ + base, word, lim, th, nx, ny, nz,
                                 d, spx, spy, spz, m);
          } else {
            window_moments<false>(sx_ + base, sy_ + base, sz_ + base, word, lim, th, nx, ny, nz,
                                  d, spx, spy, spz, m);
          }
        }
        float t[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) t[c] = tile_total(m[c]);
        if (gw == 0 && jj < n) {
#pragma unroll
          for (int c = 0; c < 10; ++c) R::store(t[c], s.part + jj * kPartSlots + c, 10);
        }
      }
      __syncthreads();
      if (warp == 0 && lane < kMomParts) acc = chain(acc, s.part + lane, n);
      if (j0 + n < T) __syncthreads();  // the chain has read the parts
    }

    if (warp == 0) {
      if (moments) {
        if (lane < kMomParts) st->acc[lane] = acc;
        __syncwarp();
      }
      if (lane == 0) {
        if (moments) {
          float m[10];
#pragma unroll
          for (int c = 0; c < 10; ++c) m[c] = R::combine(st->acc, c, 10);
          end_moments(m, !seed && is_final, fit, spx, spy, spz, orow, st);
        }
        if (seed && snap >= 0) take_snapshot(a, snap, zone0, orow, st);
      }
    }
    __syncthreads();
  }

  if (tid == 0) write_final(a, st, orow);
}

template <class R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fit_program_kernel(Args a, const int* __restrict__ pad_start, const float* __restrict__ gates,
                   const float* __restrict__ consts, float* __restrict__ out, int nt,
                   int out_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ PatchState st;

  const int p = blockIdx.x;
  float* orow = out + static_cast<size_t>(p) * out_cols;
  for (int c = threadIdx.x; c < out_cols; c += kThreads) orow[c] = 0.0f;

  const float* g = gates + static_cast<size_t>(p) * 8;
  if (!(g[0] > 0.5f)) return;  // uniform over the block
  const int t0 = pad_start[p] / kLane;
  const int t1 = min(pad_start[p + 1] / kLane, nt);
  __syncthreads();  // the zeroed row before fit_patch writes into it
  fit_patch<R>(a, t0, max(t1 - t0, 0), g, consts[0], orow, smem, &st);
}

// Launches the fit program with reducer R over spad patches. kBlocksPerSm
// CTAs of kSmemBytes each: the most shared memory an SM can give, its L1
// the least. Set at the first call (the attributes never change).
template <class R>
int launch_fit_program(const float* xs, const float* ys, const float* zs, const float* valid,
                       const int* pad_start, const float* gates, const float* consts,
                       const int* prog, int npasses, uint32_t* mask, float* out, int nt,
                       int spad, int out_cols, int snap_off, int carry2_off, int num_lpr,
                       float th_dist_v, float upright_thr, void* stream) {
  static const cudaError_t attr_rc = [] {
    cudaError_t rc = cudaFuncSetAttribute(fit_program_kernel<R>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(kSmemBytes));
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(fit_program_kernel<R>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    }
    return rc;
  }();
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  const Args a{xs, ys, zs, valid, prog, npasses, mask, num_lpr,
               th_dist_v, upright_thr, snap_off, carry2_off};
  fit_program_kernel<R><<<spad, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, pad_start, gates, consts, out, nt, out_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ppk

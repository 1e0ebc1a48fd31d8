// Fit kernel K1 of the PyTorch port: the per-patch R-VPF / R-GPF pass program
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
// What bounds it: latency, not bytes. Its bytes (x, y, z and valid of the
// processed patches' tiles in, the table out, ~2.3 MB at capacity 131072)
// take under a microsecond at the HBM rate. A patch's 7 passes are a chain
// of dependent steps: 11 walks over its tiles (SEEDFIT passes walk twice),
// each ended by a block barrier and a serial per-part sum, and after each
// pass one plane fit (a 3x3 eigensolver) on one thread. So every processed
// patch costs tens of microseconds whatever its size, and the largest one
// (62 of chip_smoke.py's 1,044 processed tiles) adds its tile work, which
// one SM's issue rate bounds.
//
// Design:
// - One CTA of kWarps warps per patch row of the (spad, out_cols) table,
//   kBlocksPerSm CTAs resident on an SM so that the latency of one patch's
//   plane fits and barriers hides behind another's work. The warps split
//   the patch's tiles pad_start[p]/128 .. pad_start[p+1]/128 (warp w takes
//   tiles w, w + kWarps, ... of the patch).
// - A tile is summed by one warp, lane l holding rows l, l+32, l+64, l+96,
//   in the fixed order of ops.tree_sum (fit_math.cuh tile_sum's tree), so
//   every tile sum keeps its bits. The 10 moment columns of a tile are
//   summed together by a butterfly that halves the columns a lane holds at
//   each step (Fold): 12 shuffles a tile instead of 60.
// - A patch of at most kCapTiles tiles is copied once into shared memory
//   (x, y, z: three 1-D bulk copies, cp.async.bulk with an mbarrier) and
//   every walk reads it there. A longer patch runs the same per-tile code
//   with its rows read from global memory (through L2), in chunks of
//   kCapTiles tiles. The choice is made per CTA on the card, so the wrapper
//   reads nothing back.
// - `active` is one bit a row (16 B a tile): in shared memory for a patch
//   that fits, in a global (nt, 4) word scratch for a longer one. The plain
//   version's `active` is a float that only ever holds 0 or 1 (valid_f and
//   gates column 0 are 0/1, a peel multiplies by 1 - hit), so the bit
//   `active > 0.5` gives it back exactly as 1.0f or 0.0f.
// - Each tile sum is split into its three round-to-nearest bf16 parts by
//   the lane that holds it and stored in shared memory. Only the per-part
//   f32 chain acc = acc + part[t], in tile order
//   (tiled_fit._reduce_tiles_split3), is serial: one lane of warp 0 per
//   part (30 moment parts, 6 LPR parts), its loads run ahead; no tree over
//   tiles, which would change the bits. The parts are re-added as
//   (hi + mid) + lo.
// - LPR (tiled_fit.py: the lowest num_lpr eligible z of the patch) takes
//   two phases: each warp counts its tiles' eligible rows (ballots); warp 0
//   scans the int32 counts into each tile's exclusive prior (exact in any
//   order); then quota max(num_lpr - prior, 0) and the in-tile lane ranks
//   pick the rows. A SEEDFIT pass is thus three walks over shared memory:
//   peel and count, LPR sums, seed moments.
// - Plane carry, alive and LPR live in shared memory; lane 0 of warp 0
//   runs the plane fit (fit_math.cuh plane_row: only the eigenvector branch
//   the solver keeps) after each pass. R-VPF snapshots are written
//   into the patch's own output row and read back by the later peel pass;
//   a plane updates only where gate & n > 0.
// - Work whose result reaches no output is skipped, per patch: a pass
//   whose gate is shut (an R-VPF round after the patch stopped being
//   vertical, the usual case) computes no LPR, moments or plane fit, and
//   walks its tiles only if its snapshot's gate asks for a peel. The plain
//   version computes and discards them; the bits are the same.
// - Unprocessed patches (gates col 0 == 0) hold no active row; their row
//   of the plain version's table is all zero, and the CTA writes zeros and
//   returns.
// - The pass program arrives as a (6, npasses) int32 array, so any
//   num_iter and any spad work.

#include "fit_math.cuh"  // plane_row, shared with fit_onehot.cu

namespace {

using namespace ppk;

constexpr int kSeedfit = 0;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// Tiles of one patch kept in shared memory: 64 tiles (8,192 rows) of x, y
// and z are 98,304 B; with the active and eligible bits (1,024 B each),
// the tile counts (256 B) and the tile parts (7,680 B) a CTA takes
// 108,288 B of dynamic shared memory, so two CTAs share an SM's 228 KB.
constexpr int kCapTiles = 64;
constexpr int kBlocksPerSm = 2;  // 2 x 512 threads: at most 64 registers
constexpr int kMomParts = 30;  // 10 moment columns x 3 bf16 parts
constexpr int kLprParts = 6;   // (z sum, count) x 3 bf16 parts
constexpr int kRowFloats = kCapTiles * kLane;
constexpr size_t kSmemBytes =
    3 * kRowFloats * sizeof(float)        // x, y, z
    + 2 * kCapTiles * 4 * sizeof(uint32_t)  // active bits, eligible bits
    + kCapTiles * sizeof(int)               // eligible counts, then priors
    + kCapTiles * kMomParts * sizeof(float);  // tile parts
static_assert(kCapTiles % 32 == 0, "warp 0 scans kCapTiles / 32 counts a lane");
static_assert(kBlocksPerSm * (kSmemBytes + 1024) <= 233472, "over an SM's shared memory");

struct PatchState {
  float plane[14];  // plane_row layout: n(3), d, count, cov(6), mean(3)
  float alive;
  float lpr;
  float acc[kMomParts];  // the per-part chains, gathered for lane 0
};

// Round-to-nearest-even bf16 part of v, as f32, and the remainder.
__device__ __forceinline__ float rne_part(float v, float* rest) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t lsb = (bits >> 16) & 1u;
  const float kept = __uint_as_float((bits + 0x7FFFu + lsb) & 0xFFFF0000u);
  *rest = v - kept;
  return kept;
}

// tiled_fit._rne_bf16_split3: hi, mid, lo parts of v at dst[0], dst[stride],
// dst[2 * stride].
__device__ __forceinline__ void store_split3(float v, float* dst, int stride) {
  float r1, r2, r3;
  dst[0] = rne_part(v, &r1);
  dst[stride] = rne_part(r1, &r2);
  dst[2 * stride] = rne_part(r2, &r3);
}

// acc + col[0] + col[kMomParts] + ... over n tiles, added in tile order;
// the loads run ahead of the dependent adds.
__device__ __forceinline__ float chain(float acc, const float* col, int n) {
#pragma unroll 8
  for (int j = 0; j < n; ++j) acc = acc + col[j * kMomParts];
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

// Sums of N columns of a 128-row tile at once, each in the order of
// fit_math.cuh tile_sum (ops.tree_sum). On entry s[c] is the lane's
// (v0 + v2) + (v1 + v3) of column c. Each butterfly step halves the columns
// a lane holds: at offset `off` the lanes with that bit clear keep the
// first half and receive their partner's values of it, the others the
// second half. Each add joins the same two partial sums as tile_sum's
// shfl_down step (in the other order on one side: the same bits), so the
// lane fold_col(N, lane) names ends with that column's tile sum in s[0]:
// 12 shuffles for 10 columns, where 10 tile_sums take 60.
template <int N, int Off>
struct Fold {
  static __device__ __forceinline__ void run(float* s, int lane) {
    constexpr int kHalf = (N + 1) / 2;
    const bool up = lane & Off;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float lo = s[i];
      const float hi = i + kHalf < N ? s[i + kHalf] : 0.0f;
      s[i] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, Off);
    }
    Fold<kHalf, Off / 2>::run(s, lane);
  }
};
template <int N>
struct Fold<N, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// The column whose tile sum Fold<n, 16> leaves in this lane, or -1.
__device__ __forceinline__ int fold_col(int n, int lane) {
  int base = 0, real = n;
  for (int off = 16; off > 0; off >>= 1) {
    const int half = (n + 1) / 2;
    if (lane & off) {
      base += half;
      real -= half;
    } else {
      real = min(real, half);
    }
    n = half;
  }
  return real >= 1 ? base : -1;
}

// The 10 moment sums of one tile (tiled_fit._tile_moments); the lane
// fold_col(10, lane) names gets its column's sum.
__device__ __forceinline__ float tile_moments(const float x[4], const float y[4],
                                              const float z[4], const float m[4],
                                              float spx, float spy, float spz,
                                              int lane) {
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
  float s[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) s[c] = (v[c][0] + v[c][2]) + (v[c][1] + v[c][3]);
  Fold<10, 16>::run(s, lane);
  return s[0];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase; a copy that never lands traps (a launch error the
// wrapper raises) after ~2^31 clock cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 31)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// 1-D bulk copy global -> shared (16 B aligned, a multiple of 16 B), counted
// on the mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

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

// The pass program of one processed patch of T tiles starting at tile t0.
// kSmem: its rows are in shared memory (T <= kCapTiles); else in global.
template <bool kSmem>
__device__ __forceinline__ void fit_patch(const Args& a, int t0, int T, const float* g,
                                          float margin, float* orow, unsigned char* smem,
                                          PatchState* st, uint64_t* bar) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int col10 = fold_col(10, lane);  // moment column this lane stores
  const int col2 = fold_col(2, lane);    // LPR column this lane stores
  const float proc = g[0];
  const float spx = g[1], spy = g[2], spz = g[3];
  const bool zone0 = g[4] > 0.5f;

  float* s_rows = reinterpret_cast<float*>(smem);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_rows + 3 * kRowFloats);
  uint32_t* s_elig = s_mask + 4 * kCapTiles;
  int* s_cnt = reinterpret_cast<int*>(s_elig + 4 * kCapTiles);
  float* s_part = reinterpret_cast<float*>(s_cnt + kCapTiles);

  const size_t g0 = static_cast<size_t>(t0) * kLane;
  const float* px = kSmem ? s_rows : a.xs + g0;
  const float* py = kSmem ? s_rows + kRowFloats : a.ys + g0;
  const float* pz = kSmem ? s_rows + 2 * kRowFloats : a.zs + g0;
  uint32_t* mk = kSmem ? s_mask : a.gmask + static_cast<size_t>(t0) * 4;

  if (tid == 0) {
    for (int c = 0; c < 14; ++c) st->plane[c] = 0.0f;
    st->alive = proc;
    st->lpr = 0.0f;
    if (kSmem && T > 0) mbar_init(bar);
  }
  __syncthreads();
  if (kSmem && T > 0 && tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(T) * kLane * sizeof(float);
    mbar_expect(bar, 3 * bytes);
    bulk_load(s_rows, a.xs + g0, bytes, bar);
    bulk_load(s_rows + kRowFloats, a.ys + g0, bytes, bar);
    bulk_load(s_rows + 2 * kRowFloats, a.zs + g0, bytes, bar);
  }
  // active = valid * proc, as bits (while the copy is in flight)
  for (int j = warp; j < T; j += kWarps) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __ballot_sync(kFull, a.valid[g0 + j * kLane + lane + 32 * k] * proc > 0.5f);
    if (lane < 4) mk[j * 4 + lane] = pick(w, lane);
  }
  if (kSmem && T > 0) mbar_wait(bar, 0);
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
        const float* s = orow + a.snap_off + 5 * peel;
        sg = s[0];
        snx = s[1];
        sny = s[2];
        snz = s[3];
        sd = s[4];
      }
      float acc = 0.0f;  // warp 0, lane < kLprParts: one part's chain
      int carry = 0;     // warp 0: eligible rows of the chunks before
      const int walk_to = fit || (do_peel && sg > 0.5f) ? T : 0;
      for (int j0 = 0; j0 < walk_to; j0 += kCapTiles) {
        const int j1 = min(j0 + kCapTiles, T);
        // walk 1: peel, eligibility bits and counts per tile
        for (int j = j0 + warp; j < j1; j += kWarps) {
          const float* tx = px + j * kLane;
          const float* ty = py + j * kLane;
          const float* tz = pz + j * kLane;
          const uint4 w = *reinterpret_cast<const uint4*>(mk + j * 4);
          const uint32_t wk[4] = {w.x, w.y, w.z, w.w};
          uint32_t nb[4] = {0u, 0u, 0u, 0u}, eb[4];
          int n = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = lane + 32 * k;
            float act = bit_f(wk[k], lane);
            const float z = tz[r];
            if (do_peel) {
              const float dist = ((tx[r] * snx + ty[r] * sny) + z * snz) + sd;
              const float hit = (sg > 0.5f && fabsf(dist) < a.th_dist_v) ? 1.0f : 0.0f;
              act = act * (1.0f - hit);
              nb[k] = __ballot_sync(kFull, act > 0.5f);
            }
            const float e = act * ((zone0 && z < margin) ? 0.0f : 1.0f);
            eb[k] = __ballot_sync(kFull, e > 0.5f);
            n += __popc(eb[k]);
          }
          if (do_peel && lane < 4) mk[j * 4 + lane] = pick(nb, lane);
          if (lane < 4) s_elig[(j - j0) * 4 + lane] = pick(eb, lane);
          if (lane == 0) s_cnt[j - j0] = n;
        }
        __syncthreads();
        if (!fit) continue;  // the peel alone
        // exclusive int32 prefix of the counts over the patch's tiles
        if (warp == 0) {
          constexpr int kPer = kCapTiles / 32;
          int v[kPer];
          int own = 0;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int jj = lane * kPer + i;
            v[i] = j0 + jj < j1 ? s_cnt[jj] : 0;
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
            if (j0 + jj < j1) s_cnt[jj] = run;
            run += v[i];
          }
          carry += __shfl_sync(kFull, inc, 31);
        }
        __syncthreads();
        // walk 2: tile quota and lane ranks -> LPR tile sums and their parts
        for (int j = j0 + warp; j < j1; j += kWarps) {
          const float* tz = pz + j * kLane;
          const int quota = max(a.num_lpr - s_cnt[j - j0], 0);
          const uint4 w = *reinterpret_cast<const uint4*>(s_elig + (j - j0) * 4);
          const uint32_t eb[4] = {w.x, w.y, w.z, w.w};
          int before = 0;
          float zt[4], tk[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int rank = before + __popc(eb[k] & lt_mask);
            before += __popc(eb[k]);
            tk[k] = bit_f(eb[k], lane) * (rank < quota ? 1.0f : 0.0f);
            zt[k] = tz[lane + 32 * k] * tk[k];
          }
          float sums[2] = {(zt[0] + zt[2]) + (zt[1] + zt[3]),
                           (tk[0] + tk[2]) + (tk[1] + tk[3])};
          Fold<2, 16>::run(sums, lane);
          if (col2 >= 0) store_split3(sums[0], s_part + (j - j0) * kMomParts + col2, 2);
        }
        __syncthreads();
        if (warp == 0 && lane < kLprParts) acc = chain(acc, s_part + lane, j1 - j0);
        // the next chunk writes parts only after its first barrier, which
        // warp 0 reaches after this chain
      }
      if (fit) {
        if (warp == 0) {
          if (lane < kLprParts) st->acc[lane] = acc;
          __syncwarp();
          if (lane == 0) {
            const float ssum = (st->acc[0] + st->acc[2]) + st->acc[4];
            const float cnt = (st->acc[1] + st->acc[3]) + st->acc[5];
            st->lpr = cnt > 0.0f ? ssum / max_nan(cnt, 1.0f) : 0.0f;
          }
        }
        __syncthreads();
        lim = st->lpr + th;
      }
    } else if (is_final && tid == 0) {
      for (int c = 0; c < 4; ++c) orow[a.carry2_off + c] = st->plane[c];
    }

    // walk 3 (SEEDFIT: seed mask) or the only walk (FITDIST: distance mask):
    // moment tile sums and their parts
    const float gsel = gate > 0.5f ? 1.0f : 0.0f;
    const float nx = st->plane[0], ny = st->plane[1], nz = st->plane[2], d = st->plane[3];
    float acc = 0.0f;  // warp 0, lane < kMomParts: one part's chain
    for (int j0 = 0; j0 < (moments ? T : 0); j0 += kCapTiles) {
      const int j1 = min(j0 + kCapTiles, T);
      for (int j = j0 + warp; j < j1; j += kWarps) {
        const float* tx = px + j * kLane;
        const float* ty = py + j * kLane;
        const float* tz = pz + j * kLane;
        const uint4 w = *reinterpret_cast<const uint4*>(mk + j * 4);
        const uint32_t wk[4] = {w.x, w.y, w.z, w.w};
        float x[4], y[4], z[4], msk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = lane + 32 * k;
          x[k] = tx[r];
          y[k] = ty[r];
          z[k] = tz[r];
          const float act = bit_f(wk[k], lane);
          if (seed) {
            msk[k] = act * (z[k] < lim ? 1.0f : 0.0f) * gsel;
          } else {
            const float dist = ((x[k] * nx + y[k] * ny) + z[k] * nz) + d;
            msk[k] = act * (dist < th ? 1.0f : 0.0f);
          }
        }
        const float s = tile_moments(x, y, z, msk, spx, spy, spz, lane);
        if (col10 >= 0) store_split3(s, s_part + (j - j0) * kMomParts + col10, 10);
      }
      __syncthreads();
      if (warp == 0 && lane < kMomParts) acc = chain(acc, s_part + lane, j1 - j0);
      if (j1 < T) __syncthreads();  // the chain has read the parts
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
          for (int c = 0; c < 10; ++c) m[c] = (st->acc[c] + st->acc[10 + c]) + st->acc[20 + c];
          if (!seed && is_final) orow[kOutGcount] = m[0];
          if (fit && m[0] > 0.0f) {  // else the plane keeps its carry
            float row[14];
            plane_row(m, spx, spy, spz, row);
            for (int c = 0; c < 14; ++c) st->plane[c] = row[c];
          }
        }
        if (seed && snap >= 0) {
          const float vert =
              (st->alive > 0.5f && zone0 && st->plane[2] < a.upright_thr) ? 1.0f : 0.0f;
          float* s = orow + a.snap_off + 5 * snap;
          s[0] = vert;
          for (int c = 0; c < 4; ++c) s[1 + c] = st->plane[c];
          st->alive = vert;
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int c = 0; c < 3; ++c) orow[kOutNormal + c] = st->plane[c];
    orow[kOutD] = st->plane[3];
    for (int c = 0; c < 3; ++c) orow[kOutMean + c] = st->plane[11 + c];
    orow[kOutN] = st->plane[4];
    for (int c = 0; c < 6; ++c) orow[kOutCov + c] = st->plane[5 + c];
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fit_grid_kernel(Args a, const int* __restrict__ pad_start, const float* __restrict__ gates,
                const float* __restrict__ consts, float* __restrict__ out, int nt,
                int out_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ PatchState st;
  __shared__ uint64_t bar;

  const int p = blockIdx.x;
  float* orow = out + static_cast<size_t>(p) * out_cols;
  for (int c = threadIdx.x; c < out_cols; c += kThreads) orow[c] = 0.0f;

  const float* g = gates + static_cast<size_t>(p) * 8;
  if (!(g[0] > 0.5f)) return;  // uniform over the block
  const int t0 = pad_start[p] / kLane;
  const int t1 = min(pad_start[p + 1] / kLane, nt);
  const int T = max(t1 - t0, 0);
  if (T <= kCapTiles) {
    fit_patch<true>(a, t0, T, g, consts[0], orow, smem, &st, &bar);
  } else {
    fit_patch<false>(a, t0, T, g, consts[0], orow, smem, &st, &bar);
  }
}

}  // namespace

extern "C" int ppk_fit_grid(const float* xs, const float* ys, const float* zs,
                            const float* valid, const int* pad_start,
                            const float* gates, const float* consts,
                            const int* prog, int npasses, uint32_t* mask,
                            float* out, int nt, int spad, int out_cols,
                            int snap_off, int carry2_off, int num_lpr,
                            float th_dist_v, float upright_thr, void* stream) {
  // kBlocksPerSm CTAs of kSmemBytes each: the most shared memory an SM can
  // give, its L1 the least. Set at the first call (the attributes never
  // change).
  static const cudaError_t attr_rc = [] {
    cudaError_t rc = cudaFuncSetAttribute(
        fit_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(fit_grid_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    }
    return rc;
  }();
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  const Args a{xs, ys, zs, valid, prog, npasses, mask, num_lpr,
               th_dist_v, upright_thr, snap_off, carry2_off};
  fit_grid_kernel<<<spad, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, pad_start, gates, consts, out, nt, out_cols);
  return static_cast<int>(cudaGetLastError());
}

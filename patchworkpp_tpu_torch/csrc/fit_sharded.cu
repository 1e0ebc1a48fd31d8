// Fit kernel KS of the PyTorch port: the fit program of fit_program.cuh
// (K1's per-patch sum, Split3) for a frame whose points are sharded (the
// chunked, point-sharded and shard x chunk paths,
// patchworkpp_tpu_torch/parallel/), meeting the other shards at its
// cross-shard points.
//
// It replaces no TPU kernel: the JAX package's sharded fit is
// patchworkpp_tpu/ops/tiled_fit.py:tiled_fit with a comm, composed by XLA
// (its Pallas modes refuse a sharded comm). The plain PyTorch version is
// patchworkpp_tpu_torch/ops/tiled_fit.py:tiled_fit(comm=...); each route
// also has its own in ops/sharded_fit.py; all agree bit for bit.
//
// It has two routes, chosen by ops/sharded_fit.py:cluster_route.
//
// The cluster route (fit_cluster_kernel; the chunks of one process, at most
// kMaxChunks: PatchworkPP(chunks=K), make_chunked_frame_fn and its
// sequence): one launch a frame for all K chunks. A thread-block cluster of
// K CTAs per patch, CTA rank r on chunk r's tiles of the patch, runs the
// whole pass program; the CTAs meet in distributed shared memory where the
// comm would meet them, after each SEEDFIT pass's seed walk (each CTA's
// dense LPR table row, merged by every CTA as MeshComm.merge_lpr_table does:
// one sort of the K rows' occupied slots, the counts and the first k values
// summed left to right) and after every pass's moment walk (the K rows of
// moment sums added left to right, MeshComm.reduce_patches). Each CTA then
// ends the pass itself from the same reduced values, so all hold the same
// plane, alive and snapshots: every decision, and every cluster barrier
// reached, is the same in each CTA of a cluster (unprocessed patches leave
// before the first barrier, as a whole cluster). At default Params that is
// 4 + 7 exchanges and one barrier before exit: 12 cluster barriers. Each CTA
// writes its chunk's table, the one tiled_fit(comm=...) gives that chunk.
//
// The phase route (fit_sharded_kernel; the shards of a process group, and
// shard x chunk): the program cut into launches between which the comm
// merges the LPR tables and reduces the moment sums in PyTorch over its
// transport, across processes. A pass is one launch (FITDIST) or two
// (SEEDFIT), and the frame ends with one more:
//
//   seed     (SEEDFIT) end the previous pass from its reduced moments (plane
//            fit, snapshot, alive), peel by the last snapshot, then the
//            eligible rows, their priors and lane ranks, and the shard's
//            dense LPR table row: z at each shard rank slot, the slots'
//            occupancy and the eligible count, (2 num_lpr + 1) columns,
//            each summed over the patch's tiles in Split3 parts
//            (tiled_fit._lpr_table and _reduce_tiles_split3);
//   moments  (every pass) FITDIST: end the previous pass, keep the final
//            pass's plane; SEEDFIT: the LPR mean from the merged table; then
//            the pass mask and the shard's 10 moment sums of the patch;
//   finish   end the last pass, write the final plane, the covariance and
//            its eigenvalues.
//
// At default Params (4 SEEDFIT and 3 FITDIST passes) that is 4 x 2 + 3 + 1
// = 12 launches a shard a frame. What persists across them lives in device
// buffers that the wrapper allocates per frame: the plane state (plane row
// and alive) per patch, the active bits per row (nt, 4 words) and the table
// itself (snapshots, g_count and the final pass's plane are written where
// they are made).
//
// What bounds it: latency, as K1 (one CTA per patch and chunk, the same
// walks over the same shared-memory rows). The cluster route stages a
// patch's rows once and pays twelve cluster barriers; its time grows with K
// (chip_smoke.py phase 5) for a cause not yet traced. The candidates: K CTAs
// for each processed patch, each running the pass program's per-patch steps
// in full, and how many clusters the card holds at once
// (ppk_fit_sharded_cluster_occupancy). The phase route stages the rows
// again at each launch (from L2, which holds the frame's 2 MB of tiles) and
// pays twelve launch latencies and the comm's steps between them, at the
// host's pace.
//
// The LPR table's sums have one contributing point per slot; they are still
// taken as the plain version takes them, every tile's Split3 parts chained in
// tile order, so the same bits come out (a slot written directly would give
// -0.0 where the plain version gives 0 + -0.0 = +0.0).

#include <cooperative_groups.h>

#include "fit_program.cuh"

namespace cg = cooperative_groups;

namespace ppk {
namespace {

constexpr int kPhaseSeed = 0;
constexpr int kPhaseMoments = 1;
constexpr int kPhaseFinish = 2;
constexpr int kMaxLpr = 64;     // the LPR slots a seed phase can hold
constexpr int kStateCols = 16;  // per patch: plane row (14), alive, pad
constexpr int kMomCols = 10;
static_assert(3 * (2 * kMaxLpr + 1) <= kThreads, "one thread per LPR part chain");
// the phase's static shared memory beside K1's dynamic layout
constexpr size_t kStaticBytes = sizeof(PatchState) + kCapTiles * sizeof(int) +
                                kMaxLpr * (sizeof(int) + sizeof(float)) +
                                3 * (2 * kMaxLpr + 1) * sizeof(float);
static_assert(kBlocksPerSm * (kSmemBytes + kStaticBytes + 1024) <= 233472,
              "over an SM's shared memory");

struct ShardArgs {
  Args a;
  const int* pad_start;
  const float* gates;
  const float* consts;
  float* state;          // (spad, kStateCols), across the frame's launches
  float* out;            // (spad, out_cols) the fit table
  const float* mom_in;   // (spad, 10) the previous pass's reduced moment sums
  const float* lpr_sum;  // (spad,) this SEEDFIT pass's merged LPR sum
  const float* lpr_cnt;  // (spad,) and count
  float* tab;            // this launch's table: (spad, 2 num_lpr + 1) or (spad, 10)
  int nt;
  int out_cols;
  int phase;
  int pass;  // the pass this launch works on (npasses: the finish)
};

// Part k (0: hi, 1: mid, 2: lo) of Split3::store's split of v.
__device__ __forceinline__ float split3_part(float v, int k) {
  float r1, r2, r3;
  const float hi = Split3::rne_part(v, &r1);
  const float mid = Split3::rne_part(r1, &r2);
  const float lo = Split3::rne_part(r2, &r3);
  return k == 0 ? hi : (k == 1 ? mid : lo);
}

// One thread: the end of pass ps, from its moment sums reduced over the
// shards, mrow (zeros where the pass took none).
__device__ __forceinline__ void end_shard_pass(const Args& a, int ps, const float* g,
                                               const float* mrow, float* orow,
                                               PatchState* st) {
  const int np = a.npasses;
  const bool seed = a.prog[ps] == kSeedfit;
  const bool is_final = a.prog[4 * np + ps] != 0;
  const float gate = a.prog[3 * np + ps] ? st->alive : g[0];
  const bool fit = gate > 0.5f;
  if (fit || (!seed && is_final)) {
    float m[kMomCols];
    for (int c = 0; c < kMomCols; ++c) m[c] = mrow[c];
    end_moments(m, !seed && is_final, fit, g[1], g[2], g[3], orow, st);
  }
  const int snap = a.prog[2 * np + ps];
  if (seed && snap >= 0) take_snapshot(a, snap, g[4] > 0.5f, orow, st);
}

// fit_patch's walk 3 as a function (fit_patch keeps it inline: called
// there, it made K1 and K2 slower on a staged patch): a pass's moment
// walk over the patch's T tiles (0: none), SEEDFIT's seed mask (z < lim)
// or FITDIST's distance mask (plane nx, ny, nz, d, under th), the 10
// moment sums of each tile, one lane per window, their Split3 parts
// chained over the tiles. Rows of a resident patch are already staged; a
// longer one is staged chunk by chunk. Returns the chain of part `lane` in
// the lanes of warp 0 below 30.
__device__ __forceinline__ float moment_walk(const Args& a, const Smem& s, const uint32_t* mk,
                                             int t0, int T, bool resident, bool seed, float lim,
                                             float th, float nx, float ny, float nz, float d,
                                             float spx, float spy, float spz) {
  constexpr int kMomParts = 10 * Split3::kParts;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gt = lane >> 2;
  const int gw = lane & 3;
  const float* sx_ = s.rows;
  const float* sy_ = s.rows + kRowFloats;
  const float* sz_ = s.rows + 2 * kRowFloats;
  float acc = 0.0f;  // warp 0, lane < kMomParts: one part's chain
  for (int j0 = 0; j0 < T; j0 += kCapTiles) {
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
          window_moments<true>(sx_ + base, sy_ + base, sz_ + base, word, lim, th, nx, ny, nz, d,
                               spx, spy, spz, m);
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
        for (int c = 0; c < 10; ++c) Split3::store(t[c], s.part + jj * kPartSlots + c, 10);
      }
    }
    __syncthreads();
    if (warp == 0 && lane < kMomParts) acc = chain(acc, s.part + lane, n);
    if (j0 + n < T) __syncthreads();  // the chain has read the parts
  }
  return acc;
}

// The seed phase's LPR table row of a processed patch: walks 1 and 2 of
// fit_patch, with each taken row's z kept at its slot (the shard rank of
// the patch's eligible row) instead of summed per window, then the 2 L + 1
// columns' part chains over the tiles. A resident patch's rows are staged
// here unless `staged` says they already are.
__device__ __forceinline__ void seed_table(const Args& a, const Smem& s, uint32_t* mk, int t0,
                                           int T, bool resident, bool staged, bool fit,
                                           bool do_peel,
                                           float sg, float snx, float sny, float snz, float sd,
                                           bool zone0,
                                           float margin, int* s_prior, int* s_slot_tile,
                                           float* s_slot_z, float* s_lacc, float* trow) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gt = lane >> 2;
  const int gw = lane & 3;
  const int L = a.num_lpr;
  const int ncol = 2 * L + 1;
  const float* sz_ = s.rows + 2 * kRowFloats;
  if (tid < L) s_slot_tile[tid] = -1;
  const int walk_to = fit || (do_peel && sg > 0.5f) ? T : 0;
  if (resident && walk_to && !staged) stage_rows(a, t0, T, s.rows);
  __syncthreads();

  float acc = 0.0f;  // thread tid < 3 ncol: part tid / ncol of column tid % ncol
  int carry = 0;     // warp 0: eligible rows of the chunks before
  for (int j0 = 0; j0 < walk_to; j0 += kCapTiles) {
    const int n = min(kCapTiles, T - j0);
    if (!resident) {
      stage_rows(a, t0 + j0, n, s.rows);
      __syncthreads();
    }
    seed_count_walk(a, s, mk, j0, n, do_peel, sg, snx, sny, snz, sd, zone0, margin);
    __syncthreads();
    if (!fit) continue;  // the peel alone
    if (warp == 0) prefix_counts(s.cnt, s_prior, n, carry);
    __syncthreads();
    // the taken rows (shard rank < num_lpr), one lane per window
    for (int grp = warp * kTilesPerWarp; grp < n; grp += kWarps * kTilesPerWarp) {
      const int jj = grp + gt;
      if (jj < n) {
        const uint4 w = *reinterpret_cast<const uint4*>(s.elig + jj * 4);
        const uint32_t eb[4] = {w.x, w.y, w.z, w.w};
        int rank = s_prior[jj];
#pragma unroll
        for (int k = 0; k < 3; ++k) rank += k < gw ? __popc(eb[k]) : 0;
        const float* zr = sz_ + jj * kTileFloats + gw * kWinStride;
        for (uint32_t word = pick(eb, gw); word && rank < L; word &= word - 1) {
          s_slot_tile[rank] = j0 + jj;
          s_slot_z[rank] = zr[__ffs(word) - 1];
          ++rank;
        }
      }
    }
    __syncthreads();
    // each tile's value of each column, as its parts, chained in tile order
    // (a slot taken in a later chunk holds no tile of this one)
    if (tid < 3 * ncol) {
      const int k = tid / ncol;
      const int c = tid - k * ncol;
      for (int jj = 0; jj < n; ++jj) {
        const int j = j0 + jj;
        float v;
        if (c < L) {
          v = s_slot_tile[c] == j ? s_slot_z[c] : 0.0f;
        } else if (c < 2 * L) {
          v = s_slot_tile[c - L] == j ? 1.0f : 0.0f;
        } else {
          v = static_cast<float>(s.cnt[jj]);
        }
        acc = acc + split3_part(v, k);
      }
    }
    // the next chunk writes counts and slots only after its first barrier,
    // which the chains reach after this chunk
  }
  if (fit) {  // uniform
    if (tid < 3 * ncol) s_lacc[tid] = acc;
    __syncthreads();
    if (tid < ncol) trow[tid] = Split3::combine(s_lacc, tid, ncol);
  } else {
    for (int c = tid; c < ncol; c += kThreads) trow[c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fit_sharded_kernel(ShardArgs s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ PatchState st;
  __shared__ int s_prior[kCapTiles];
  __shared__ int s_slot_tile[kMaxLpr];
  __shared__ float s_slot_z[kMaxLpr];
  __shared__ float s_lacc[3 * (2 * kMaxLpr + 1)];

  const Args& a = s.a;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int np = a.npasses;
  const int ps = s.pass;
  const int phase = s.phase;
  const float* g = s.gates + static_cast<size_t>(p) * 8;
  float* orow = s.out + static_cast<size_t>(p) * s.out_cols;
  float* srow_ = s.state + static_cast<size_t>(p) * kStateCols;
  const int ncol = phase == kPhaseSeed ? 2 * a.num_lpr + 1 : kMomCols;
  float* trow = phase == kPhaseFinish ? nullptr : s.tab + static_cast<size_t>(p) * ncol;
  const bool first = phase == kPhaseSeed && ps == 0;

  if (first) {
    for (int c = tid; c < s.out_cols; c += kThreads) orow[c] = 0.0f;
  }
  const float proc = g[0];
  if (!(proc > 0.5f)) {  // uniform: no active row, an all-zero table row
    if (trow) {
      for (int c = tid; c < ncol; c += kThreads) trow[c] = 0.0f;
    }
    return;
  }
  const int t0 = s.pad_start[p] / kLane;
  const int T = max(min(s.pad_start[p + 1] / kLane, s.nt) - t0, 0);
  uint32_t* mk = a.gmask + static_cast<size_t>(t0) * 4;
  const bool zone0 = g[4] > 0.5f;
  const bool seed = phase != kPhaseFinish && a.prog[ps] == kSeedfit;
  const bool is_final = phase != kPhaseFinish && a.prog[4 * np + ps] != 0;
  __syncthreads();  // the zeroed row before thread 0 writes into it

  if (tid == 0) {
    if (first) {
      for (int c = 0; c < 14; ++c) st.plane[c] = 0.0f;
      st.alive = proc;
    } else {
      for (int c = 0; c < 14; ++c) st.plane[c] = srow_[c];
      st.alive = srow_[14];
    }
    // the pending end of the previous pass, now that its sums are reduced
    const bool ends = phase == kPhaseFinish || (ps > 0 && (phase == kPhaseSeed || !seed));
    if (ends) {
      end_shard_pass(a, ps - 1, g, s.mom_in + static_cast<size_t>(p) * kMomCols, orow,
                     &st);
    }
    if (first || ends) {
      for (int c = 0; c < 14; ++c) srow_[c] = st.plane[c];
      srow_[14] = st.alive;
    }
    if (phase == kPhaseFinish) {
      write_final(a, &st, orow);
    } else if (phase == kPhaseMoments && seed) {
      const float ssum = s.lpr_sum[p];
      const float cnt = s.lpr_cnt[p];
      st.lpr = cnt > 0.0f ? ssum / max_nan(cnt, 1.0f) : 0.0f;
    } else if (phase == kPhaseMoments && is_final) {
      for (int c = 0; c < 4; ++c) orow[a.carry2_off + c] = st.plane[c];
    }
  }
  if (phase == kPhaseFinish) return;  // uniform
  if (first) {  // active = valid * proc, as bits
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const size_t g0 = static_cast<size_t>(t0) * kLane;
    for (int j = warp; j < T; j += kWarps) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = __ballot_sync(kFull, a.valid[g0 + j * kLane + lane + 32 * k] * proc > 0.5f);
      if (lane < 4) mk[j * 4 + lane] = pick(w, lane);
    }
  }
  __syncthreads();

  const Smem sm = smem_layout(smem);
  const bool resident = T <= kCapTiles;
  const float gate = a.prog[3 * np + ps] ? st.alive : proc;
  const bool fit = gate > 0.5f;
  if (phase == kPhaseSeed) {
    const int peel = a.prog[np + ps];
    float sg = 0.f, snx = 0.f, sny = 0.f, snz = 0.f, sd = 0.f;
    if (peel >= 0) {
      const float* sp = orow + a.snap_off + 5 * peel;
      sg = sp[0];
      snx = sp[1];
      sny = sp[2];
      snz = sp[3];
      sd = sp[4];
    }
    seed_table(a, sm, mk, t0, T, resident, false, fit, peel >= 0, sg, snx, sny, snz, sd, zone0,
               s.consts[0], s_prior, s_slot_tile, s_slot_z, s_lacc, trow);
    return;
  }

  // the moment phase
  const bool moments = fit || (!seed && is_final);
  const float th = __int_as_float(a.prog[5 * np + ps]);
  if (resident && moments) stage_rows(a, t0, T, sm.rows);
  __syncthreads();
  const float acc = moment_walk(a, sm, mk, t0, moments ? T : 0, resident, seed, st.lpr + th, th,
                                st.plane[0], st.plane[1], st.plane[2], st.plane[3], g[1], g[2],
                                g[3]);
  if (moments) {  // uniform
    if (tid < 10 * Split3::kParts) st.acc[tid] = acc;
    __syncthreads();
    if (tid < kMomCols) trow[tid] = Split3::combine(st.acc, tid, kMomCols);
  } else {
    if (tid < kMomCols) trow[tid] = 0.0f;
  }
}

// ---- the cluster route: the chunks of one process in one launch --------

constexpr int kMaxChunks = 8;  // the portable cluster size
static_assert(kMaxChunks * kMaxLpr + kMaxLpr <= kCapTiles * kPartSlots,
              "the LPR merge's scratch fits in the tile parts");
// the cluster kernel's static shared memory beside K1's dynamic layout
constexpr size_t kClusterStaticBytes =
    kStaticBytes + (2 * kMaxLpr + 1) * sizeof(float) + 2 * kMomCols * sizeof(float);
static_assert(kBlocksPerSm * (kSmemBytes + kClusterStaticBytes + 1024) <= 233472,
              "over an SM's shared memory");

// One chunk's tiles and outputs.
struct ChunkArgs {
  const float* xs;
  const float* ys;
  const float* zs;
  const float* valid;
  const int* pad_start;
  uint32_t* mask;  // (nt, 4) active bits of a patch longer than kCapTiles
  float* out;      // (spad, out_cols) the chunk's fit table
  int nt;
};

struct ClusterArgs {
  ChunkArgs c[kMaxChunks];
  const float* gates;   // chunk 0's (spad, 8): every chunk's holds the same values
  const float* consts;  // chunk 0's (8,)
  const int* prog;
  int npasses;
  int out_cols;
  int snap_off;
  int carry2_off;
  int num_lpr;
  float th_dist_v;
  float upright_thr;
};

// MeshComm.merge_lpr_table over the cluster's LPR table rows (s_xlpr in
// each CTA: z at each slot, the slots' occupancy, the eligible count):
// unoccupied slots as +inf, the nk * L values in chunk order sorted
// ascending (a value's rank counts the smaller ones and the equal ones
// before it), the counts summed left to right and clamped to L, then the
// first k sorted values summed from +0.0 over all L columns (the rest as
// +0.0, which turns a -0.0 sum into +0.0 as the plain version's does).
// All threads; thread 0 leaves the LPR mean in st->lpr. scratch: the tile
// parts, free between the walks.
__device__ __forceinline__ void merge_lpr(cg::cluster_group cluster, float* s_xlpr,
                                          int L, int nk, float* scratch, PatchState* st) {
  const int tid = threadIdx.x;
  const int n = nk * L;
  float* vals = scratch;
  float* merged = scratch + kMaxChunks * kMaxLpr;
  for (int i = tid; i < n; i += kThreads) {
    const int q = i / L;
    const int j = i - q * L;
    const float* row = cluster.map_shared_rank(s_xlpr, q);
    vals[i] = row[L + j] > 0.5f ? row[j] : __int_as_float(0x7f800000);
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const float v = vals[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float w = vals[j];
      rank += (w < v || (w == v && j < i)) ? 1 : 0;
    }
    if (rank < L) merged[rank] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float k = cluster.map_shared_rank(s_xlpr, 0)[2 * L];
    for (int q = 1; q < nk; ++q) k = k + cluster.map_shared_rank(s_xlpr, q)[2 * L];
    const float lim = static_cast<float>(L);
    k = k > lim ? lim : k;
    float ssum = 0.0f;
    for (int j = 0; j < L; ++j) ssum = ssum + (static_cast<float>(j) < k ? merged[j] : 0.0f);
    st->lpr = k > 0.0f ? ssum / max_nan(k, 1.0f) : 0.0f;
  }
}

// The whole fit program of one patch for nk chunks of one process: a
// cluster of nk CTAs per patch, CTA rank r on chunk r's tiles of the patch.
// The CTAs meet where the phase launches meet through the comm: after each
// SEEDFIT pass's seed walk (the LPR merge) and after every pass's moment
// walk (the left-to-right sum of the chunks' sums, MeshComm.reduce_patches),
// each time through distributed shared memory. Every CTA then ends the pass
// itself from the same reduced values, so the cluster's CTAs hold the same
// plane, alive and snapshots, and so make the same decisions. Each writes
// its chunk's table row.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fit_cluster_kernel(const __grid_constant__ ClusterArgs ca) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ PatchState st;
  __shared__ int s_prior[kCapTiles];
  __shared__ int s_slot_tile[kMaxLpr];
  __shared__ float s_slot_z[kMaxLpr];
  __shared__ float s_lacc[3 * (2 * kMaxLpr + 1)];
  __shared__ float s_xlpr[2 * kMaxLpr + 1];  // this chunk's LPR table row
  __shared__ float s_xmom[2][kMomCols];       // its moment sums, by pass parity

  cg::cluster_group cluster = cg::this_cluster();
  const int nk = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.x / nk;
  const int tid = threadIdx.x;
  const ChunkArgs& ch = ca.c[r];
  const Args a{ch.xs, ch.ys, ch.zs, ch.valid, ca.prog, ca.npasses, ch.mask, ca.num_lpr,
               ca.th_dist_v, ca.upright_thr, ca.snap_off, ca.carry2_off};
  const int np = ca.npasses;
  float* orow = ch.out + static_cast<size_t>(p) * ca.out_cols;
  for (int c = tid; c < ca.out_cols; c += kThreads) orow[c] = 0.0f;
  // Every CTA reads chunk 0's gates, so every decision below is the same
  // in all CTAs of the cluster: each one reaches every cluster barrier.
  const float* g = ca.gates + static_cast<size_t>(p) * 8;
  const float proc = g[0];
  if (!(proc > 0.5f)) return;  // the whole cluster, before its first barrier
  const int t0 = ch.pad_start[p] / kLane;
  const int T = max(min(ch.pad_start[p + 1] / kLane, ch.nt) - t0, 0);
  const bool resident = T <= kCapTiles;
  const bool zone0 = g[4] > 0.5f;
  const Smem sm = smem_layout(smem);
  uint32_t* mk = resident ? sm.mask : ch.mask + static_cast<size_t>(t0) * 4;

  if (tid == 0) {
    for (int c = 0; c < 14; ++c) st.plane[c] = 0.0f;
    st.alive = proc;
    st.lpr = 0.0f;
  }
  if (resident) stage_rows(a, t0, T, sm.rows);  // once: no later walk restages it
  {  // active = valid * proc, as bits
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const size_t g0 = static_cast<size_t>(t0) * kLane;
    for (int j = warp; j < T; j += kWarps) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = __ballot_sync(kFull, a.valid[g0 + j * kLane + lane + 32 * k] * proc > 0.5f);
      if (lane < 4) mk[j * 4 + lane] = pick(w, lane);
    }
  }
  __syncthreads();

  for (int ps = 0; ps < np; ++ps) {
    const bool seed = ca.prog[ps] == kSeedfit;
    const bool is_final = ca.prog[4 * np + ps] != 0;
    const float th = __int_as_float(ca.prog[5 * np + ps]);
    const float gate = ca.prog[3 * np + ps] ? st.alive : proc;
    const bool fit = gate > 0.5f;
    const bool moments = fit || (!seed && is_final);
    if (seed) {
      const int peel = ca.prog[np + ps];
      float sg = 0.f, snx = 0.f, sny = 0.f, snz = 0.f, sd = 0.f;
      if (peel >= 0) {
        const float* sp = orow + ca.snap_off + 5 * peel;
        sg = sp[0];
        snx = sp[1];
        sny = sp[2];
        snz = sp[3];
        sd = sp[4];
      }
      seed_table(a, sm, mk, t0, T, resident, true, fit, peel >= 0, sg, snx, sny, snz, sd,
                 zone0, ca.consts[0], s_prior, s_slot_tile, s_slot_z, s_lacc, s_xlpr);
      cluster.sync();  // every chunk's LPR table row is written
      merge_lpr(cluster, s_xlpr, ca.num_lpr, nk, sm.part, &st);
    } else if (is_final && tid == 0) {
      for (int c = 0; c < 4; ++c) orow[ca.carry2_off + c] = st.plane[c];
    }
    __syncthreads();  // st.lpr; the merge's scratch read before the walk's parts

    // the pass's moment sums of this chunk's rows (zeros where it takes
    // none), into the slot of this pass's parity: a peer may still be
    // reading the other slot, the last pass's
    float* xm = s_xmom[ps & 1];
    const float acc = moment_walk(a, sm, mk, t0, moments ? T : 0, resident, seed,
                                  st.lpr + th, th, st.plane[0], st.plane[1], st.plane[2],
                                  st.plane[3], g[1], g[2], g[3]);
    if (moments) {
      if (tid < 10 * Split3::kParts) st.acc[tid] = acc;
      __syncthreads();
      if (tid < kMomCols) xm[tid] = Split3::combine(st.acc, tid, kMomCols);
    } else if (tid < kMomCols) {
      xm[tid] = 0.0f;
    }
    cluster.sync();  // every chunk's moment sums are written
    if (tid == 0) {  // MeshComm.reduce_patches: g[0] + g[1] + ..., then the pass's end
      float m[kMomCols];
      const float* row0 = cluster.map_shared_rank(xm, 0);
      for (int c = 0; c < kMomCols; ++c) m[c] = row0[c];
      for (int q = 1; q < nk; ++q) {
        const float* row = cluster.map_shared_rank(xm, q);
        for (int c = 0; c < kMomCols; ++c) m[c] = m[c] + row[c];
      }
      end_shard_pass(a, ps, g, m, orow, &st);
    }
    __syncthreads();  // the ended pass's plane, alive and snapshot
#ifdef PPK_CLUSTER_CHECKS
    // debug builds: the decisions are uniform over the cluster by
    // construction; check that every CTA holds rank 0's plane and alive
    cluster.sync();
    if (tid == 0) {
      const PatchState* s0 = cluster.map_shared_rank(&st, 0);
      for (int c = 0; c < 14; ++c)
        if (__float_as_uint(s0->plane[c]) != __float_as_uint(st.plane[c])) __trap();
      if (__float_as_uint(s0->alive) != __float_as_uint(st.alive)) __trap();
    }
    cluster.sync();
#endif
  }
  if (tid == 0) write_final(a, &st, orow);
  cluster.sync();  // no CTA leaves while a peer may still read its moment row
}

}  // namespace
}  // namespace ppk

// One launch of KS's phase `phase` (0 seed, 1 moments, 2 finish) on pass
// `pass` over spad patches, on `stream`; returns the CUDA error code.
extern "C" int ppk_fit_sharded(int phase, int pass, const float* xs, const float* ys,
                               const float* zs, const float* valid, const int* pad_start,
                               const float* gates, const float* consts, const int* prog,
                               int npasses, uint32_t* mask, float* state, float* out,
                               const float* mom_in, const float* lpr_sum, const float* lpr_cnt,
                               float* tab, int nt, int spad, int out_cols, int snap_off,
                               int carry2_off, int num_lpr, float th_dist_v, float upright_thr,
                               void* stream) {
  using namespace ppk;
  static const cudaError_t attr_rc = [] {
    cudaError_t rc = cudaFuncSetAttribute(fit_sharded_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(kSmemBytes));
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(fit_sharded_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    }
    return rc;
  }();
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  if (num_lpr < 0 || num_lpr > kMaxLpr || phase < kPhaseSeed || phase > kPhaseFinish)
    return static_cast<int>(cudaErrorInvalidValue);
  const ShardArgs s{Args{xs, ys, zs, valid, prog, npasses, mask, num_lpr, th_dist_v, upright_thr,
                         snap_off, carry2_off},
                    pad_start, gates, consts, state, out, mom_in, lpr_sum, lpr_cnt, tab, nt,
                    out_cols, phase, pass};
  fit_sharded_kernel<<<spad, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// The cluster launch of nk CTAs a cluster over spad patches (attr: its one
// attribute, the cluster shape).
static cudaLaunchConfig_t cluster_config(int nk, int spad, void* stream,
                                         cudaLaunchAttribute* attr) {
  using namespace ppk;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nk;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spad * nk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The most clusters of nk (1..8) CTAs at the cluster kernel's shared memory
// that the card holds at once (cudaOccupancyMaxActiveClusters, asked once a
// size, the kernel's attributes set first), in *clusters; returns the CUDA
// error code.
static int max_clusters(int nk, int* clusters) {
  using namespace ppk;
  static const cudaError_t attr_rc = [] {
    cudaError_t rc = cudaFuncSetAttribute(fit_cluster_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(kSmemBytes));
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(fit_cluster_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    }
    return rc;
  }();
  if (attr_rc != cudaSuccess) return static_cast<int>(attr_rc);
  if (nk < 1 || nk > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  static int fits[kMaxChunks + 1] = {};
  if (!fits[nk]) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(nk, 1, nullptr, &attr);
    const cudaError_t rc = cudaOccupancyMaxActiveClusters(&fits[nk], fit_cluster_kernel, &cfg);
    if (rc != cudaSuccess) {
      fits[nk] = 0;
      return static_cast<int>(rc);
    }
  }
  *clusters = fits[nk];
  return 0;
}

// The most clusters of nk CTAs of KS's cluster route resident on the card
// at once (0: none fits), or minus the CUDA error code.
extern "C" int ppk_fit_sharded_cluster_occupancy(int nk) {
  int clusters = 0;
  const int rc = max_clusters(nk, &clusters);
  return rc != 0 ? -rc : clusters;
}

// KS's cluster route: the whole fit program of nk (1..8) chunks of one
// process in one launch, spad clusters of nk CTAs, on `stream`.
// chunk_ptrs holds each chunk's xs, ys, zs, valid, pad_start, mask and out
// (7 pointers a chunk, chunk-major), chunk_nt its tile counts; gates and
// consts are chunk 0's. Returns the CUDA error code, or -1 where no cluster
// of nk CTAs with this shared memory fits on the card (never degraded to
// fewer).
extern "C" int ppk_fit_sharded_cluster(int nk, const void* const* chunk_ptrs,
                                       const int* chunk_nt, const float* gates,
                                       const float* consts, const int* prog, int npasses,
                                       int spad, int out_cols, int snap_off, int carry2_off,
                                       int num_lpr, float th_dist_v, float upright_thr,
                                       void* stream) {
  using namespace ppk;
  if (num_lpr < 0 || num_lpr > kMaxLpr) return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  const int occ_rc = max_clusters(nk, &clusters);
  if (occ_rc != 0) return occ_rc;
  if (clusters < 1) return -1;
  ClusterArgs ca{};
  for (int r = 0; r < nk; ++r) {
    const void* const* c = chunk_ptrs + 7 * r;
    ca.c[r] = ChunkArgs{static_cast<const float*>(c[0]), static_cast<const float*>(c[1]),
                        static_cast<const float*>(c[2]), static_cast<const float*>(c[3]),
                        static_cast<const int*>(c[4]),
                        static_cast<uint32_t*>(const_cast<void*>(c[5])),
                        static_cast<float*>(const_cast<void*>(c[6])), chunk_nt[r]};
  }
  ca.gates = gates;
  ca.consts = consts;
  ca.prog = prog;
  ca.npasses = npasses;
  ca.out_cols = out_cols;
  ca.snap_off = snap_off;
  ca.carry2_off = carry2_off;
  ca.num_lpr = num_lpr;
  ca.th_dist_v = th_dist_v;
  ca.upright_thr = upright_thr;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(nk, spad, stream, &attr);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, fit_cluster_kernel, ca);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

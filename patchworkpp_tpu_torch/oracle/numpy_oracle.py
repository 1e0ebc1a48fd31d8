"""NumPy oracle: a semantically exact re-implementation of Patchwork++
(port of ``patchworkpp_tpu/oracle/numpy_oracle.py``).

This module is a *test reference*, not an engine and not a fallback: it runs
on the CPU, on every machine, one patch at a time, and the port's engines
(:mod:`patchworkpp_tpu_torch.pipeline`, on the card or the CPU) are held
against it. It mirrors the reference algorithm's observable behavior
(reference: cpp/patchworkpp/src/patchworkpp.cpp) including its
numeric-precision mix (float32 point storage, float64 scalar statistics)
and its behavioral quirks:

- RNR sentinel exclusion (patchworkpp.cpp:377-400, skip check :591);
- zone-0 adaptive seed margin applied to the LPR mean only (:88-96);
- signed (not absolute) distance test in R-GPF (:525);
- per-patch plane state carried across empty-fit early returns (:49);
- TGR ``ringwise_flatness`` only being flushed on rings that actually have
  revert candidates (:292-304) — so accepted-patch flatness can leak into a
  later ring's TGR statistics;
- ``update_flatness_thr`` using ``break`` on a starved ring, freezing all
  later rings (:363-364);
- FIFO trimming of the adaptive buffers to ``max_*_storage`` *after* the
  thresholds are computed (:354-355, :372-373).

It is deliberately written loop-over-patches style for auditability, not
speed. The one difference from the JAX package's oracle is the 3x3
eigensolver (:func:`_shared_eig3`): here the port's own
``ops/eigen3.py:eig3_plane_columns`` on 0-d CPU float32 tensors. For a
separated eigenvalue pair it gives the JAX solver's bits; for a clustered
pair its normal may differ in the last bits (the JAX solver's ``1/sqrt`` is
XLA:CPU's host-dependent ``rsqrt`` estimate), so the two oracles are held
to equal labels, not equal floats.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns
from patchworkpp_tpu_torch.params import Params

_FLT_MIN = np.float32(np.finfo(np.float32).tiny)  # std::numeric_limits<float>::min()
_DBL_MAX = np.finfo(np.float64).max


@torch.inference_mode()
def _eig3_cpu(*entries):
    """eig3_plane_columns on six float32 scalars, as 0-d CPU tensors; returns
    (e0, e1, e2, vx, vy, vz) as numpy float32."""
    out = eig3_plane_columns(*(torch.tensor(float(v), dtype=torch.float32)
                               for v in entries))
    return tuple(np.float32(t.item()) for t in out)


def _shared_eig3():
    """The solver every plane fit calls: the engines' own (ops/eigen3.py),
    always on the CPU whatever device the engines run on. A test may swap
    this function for an independent solver (as the JAX package's golden
    test swaps in ``np.linalg.eigh``)."""
    return _eig3_cpu


class _PlaneState:
    """Mutable plane-fit scratch mirroring the reference's member variables
    (normal_/pc_mean_/singular_values_/d_), including staleness on empty fits."""

    def __init__(self) -> None:
        self.normal = np.zeros(3, np.float32)
        self.mean = np.zeros(3, np.float32)
        self.svals = np.zeros(3, np.float32)
        self.d = np.float64(0.0)
        # Determinacy diagnostics. A fit of EXACTLY 2 points has a rank-1
        # covariance whose null-space eigenvector is solver-arbitrary, so
        # oracle-vs-engine label parity is undefined for runs where one
        # occurs (the documented subsampled-cloud caveat,
        # tests/test_fused_kernel.py). 1-point fits are NOT indeterminate:
        # their NaN covariance propagates to decision-identical NaN/sentinel
        # planes on both sides (test-enforced containment). Runs with
        # two_point_fits == 0 are determinate and must match exactly.
        self.min_fit_pts: float = np.inf
        self.two_point_fits: int = 0

    def estimate_plane(self, pts: np.ndarray) -> None:
        """PCA plane fit (reference patchworkpp.cpp:47-75). ``pts`` is (n,3) f32.

        Early-returns on empty input, leaving previous state in place. n==1
        produces a NaN covariance (0/0) whose NaN normal/d propagate exactly
        like the C++ float arithmetic does.
        """
        n = pts.shape[0]
        if n == 0:
            return
        self.min_fit_pts = min(self.min_fit_pts, n)
        self.two_point_fits += n == 2
        mean = pts.mean(axis=0, dtype=np.float32)
        centered = pts - mean
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = (centered.T @ centered) / np.float32(n - 1)
        self.mean = mean
        if not np.all(np.isfinite(cov)):
            self.svals = np.full(3, np.nan, np.float32)
            self.normal = np.full(3, np.nan, np.float32)
            self.d = np.float64(np.nan)
            return
        # Symmetric PSD: singular values == eigenvalues, descending. THE
        # SAME solver as every engine path (ops/eigen3.py — Cardano roots,
        # hybrid cross-product/deflated eigenvector): the reference's
        # JacobiSVD and this construction are both accurate to the
        # conditioning bound, but on clustered small eigenvalues ANY two
        # accurate solvers can disagree by more than a razor-thin decision
        # margin — sharing the engines' solver makes oracle == engine label
        # parity structural instead of reduction-order luck.
        cov32 = cov.astype(np.float32)
        e0, e1, e2, vx, vy, vz = _shared_eig3()(
            cov32[0, 0], cov32[0, 1], cov32[0, 2],
            cov32[1, 1], cov32[1, 2], cov32[2, 2],
        )
        self.svals = np.array([e0, e1, e2], np.float32)
        normal = np.array([vx, vy, vz], np.float32)
        if normal[2] < 0:
            normal = -normal
        self.normal = normal
        self.d = np.float64(-np.float32(normal @ mean))

    def dist(self, pts: np.ndarray) -> np.ndarray:
        """Signed point-to-plane distance (reference :551-554): f32 dot + f64 d."""
        dots = (pts * self.normal[None, :]).sum(axis=1, dtype=np.float32)
        return dots.astype(np.float64) + self.d


class NumpyPatchworkpp:
    """Stateful oracle with the same cross-frame adaptation as the reference."""

    @property
    def min_fit_pts(self) -> float:
        """Smallest nonzero plane-fit population seen so far."""
        return self._plane.min_fit_pts

    @property
    def two_point_fits(self) -> int:
        """Number of plane fits that saw EXACTLY 2 points (rank-1
        covariance, solver-arbitrary null vector). 0 means engine == oracle
        label parity is well-defined and must be exact; > 0 flags the
        documented indeterminate case (tests/test_fused_kernel.py).
        1-point fits do NOT count: their NaN planes are decision-identical
        on both sides (containment test-enforced)."""
        return self._plane.two_point_fits

    def __init__(self, params: Optional[Params] = None) -> None:
        self.params = params or Params()
        p = self.params
        mn, mx = p.min_range, p.max_range
        self.min_ranges = [mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0]
        bounds = self.min_ranges + [mx]
        self.ring_sizes = [
            (bounds[k + 1] - bounds[k]) / p.num_rings_each_zone[k] for k in range(p.num_zones)
        ]
        self.sector_sizes = [2 * math.pi / p.num_sectors_each_zone[k] for k in range(p.num_zones)]

        # Adaptive state (reference mutates Params + update_* buffers in place).
        self.sensor_height = float(p.sensor_height)
        self.elevation_thr: List[float] = list(p.elevation_thr)
        self.flatness_thr: List[float] = list(p.flatness_thr)
        self.update_elevation: List[List[float]] = [[] for _ in range(4)]
        self.update_flatness: List[List[float]] = [[] for _ in range(4)]

        self._plane = _PlaneState()
        # Per-frame debug/parity artifacts.
        # (self.min_fit_pts property below reports _plane.min_fit_pts.)
        self.centers: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []

    # ------------------------------------------------------------------ RNR

    def _rnr_mask(self, cloud: np.ndarray) -> np.ndarray:
        """Reflected-noise mask (reference :377-400). Requires >=4 cols."""
        p = self.params
        if cloud.shape[1] < 4:
            return np.zeros(cloud.shape[0], bool)
        x = cloud[:, 0].astype(np.float32)
        y = cloud[:, 1].astype(np.float32)
        z = cloud[:, 2].astype(np.float32)
        inten = cloud[:, 3].astype(np.float32)
        # C++ computes the radicand in float, then sqrts in double.
        rad_f32 = x * x + y * y
        r = np.sqrt(rad_f32.astype(np.float64))
        ver_deg = np.degrees(np.arctan2(z.astype(np.float64), r))
        return (
            (ver_deg < p.RNR_ver_angle_thr)
            & (z.astype(np.float64) < -self.sensor_height - 0.8)
            & (inten.astype(np.float64) < p.RNR_intensity_thr)
        )

    # ------------------------------------------------------------------ CZM

    def _czm_assign(self, cloud: np.ndarray, excluded: np.ndarray):
        """Assign every point a flat patch id (zone-major, ring, sector order).

        Returns (patch_id int32, in_range bool). Out-of-range/excluded points
        get patch_id == -1. Mirrors reference pc2czm (:578-622): r/theta in
        float64 from float32 coords, truncating casts, clamped to last bin.
        """
        p = self.params
        x = cloud[:, 0].astype(np.float64)
        y = cloud[:, 1].astype(np.float64)
        r = np.sqrt(x * x + y * y)
        in_range = (r <= p.max_range) & (r > p.min_range) & ~excluded
        theta = np.arctan2(y, x)
        theta = np.where(theta > 0, theta, 2 * math.pi + theta)

        patch_id = np.full(cloud.shape[0], -1, np.int64)
        offset = 0
        zone_lo = list(self.min_ranges)
        zone_hi = self.min_ranges[1:] + [p.max_range]
        for k in range(p.num_zones):
            nring, nsec = p.num_rings_each_zone[k], p.num_sectors_each_zone[k]
            if k == 0:
                zsel = in_range & (r < zone_hi[0])
            elif k < p.num_zones - 1:
                zsel = in_range & (r >= zone_hi[k - 1]) & (r < zone_hi[k])
            else:
                zsel = in_range & (r >= zone_hi[k - 1])
            ring = np.minimum(((r - zone_lo[k]) / self.ring_sizes[k]).astype(np.int64), nring - 1)
            sec = np.minimum((theta / self.sector_sizes[k]).astype(np.int64), nsec - 1)
            patch_id = np.where(zsel, offset + ring * nsec + sec, patch_id)
            offset += nring * nsec
        return patch_id.astype(np.int32), in_range

    # ---------------------------------------------------------------- seeds

    def _seed_mask(self, zone_idx: int, zs: np.ndarray, th_seed: float) -> np.ndarray:
        """Initial-seed mask over z-sorted patch points (reference :77-149).

        The zone-0 margin skips leading low outliers from the LPR *mean* only;
        the seed threshold itself is applied to every point.
        """
        p = self.params
        init_idx = 0
        if zone_idx == 0:
            thr = p.adaptive_seed_selection_margin * self.sensor_height
            init_idx = int(np.searchsorted(zs, thr, side="left"))
        sel = zs[init_idx : init_idx + p.num_lpr]
        lpr = float(sel.astype(np.float64).sum() / sel.size) if sel.size else 0.0
        return zs.astype(np.float64) < (lpr + th_seed)

    # ------------------------------------------------------- per-patch fits

    def _extract_piecewiseground(self, zone_idx: int, pts: np.ndarray):
        """R-VPF + R-GPF on one z-sorted patch (reference :467-549).

        Returns (ground_mask, nonground_mask) over the sorted patch rows.
        """
        p = self.params
        n = pts.shape[0]
        active = np.ones(n, bool)
        nonground = np.zeros(n, bool)

        # R-VPF: peel vertical structures (zone 0 only), <=num_iter rounds.
        if p.enable_RVPF:
            for _ in range(p.num_iter):
                act = np.flatnonzero(active)
                zs = pts[act, 2]
                smask = self._seed_mask(zone_idx, zs, p.th_seeds_v)
                self._plane.estimate_plane(pts[act][smask])
                nz = self._plane.normal[2]
                if zone_idx == 0 and bool(nz < p.uprightness_thr):
                    d = self._plane.dist(pts[act])
                    peel = np.abs(d) < p.th_dist_v
                    nonground[act[peel]] = True
                    active[act[peel]] = False
                else:
                    break

        # R-GPF: iterative ground plane refinement, signed distance test.
        act = np.flatnonzero(active)
        zs = pts[act, 2]
        smask = self._seed_mask(zone_idx, zs, p.th_seeds)
        self._plane.estimate_plane(pts[act][smask])

        g = np.zeros(act.size, bool)
        for i in range(p.num_iter):
            with np.errstate(invalid="ignore"):
                d = self._plane.dist(pts[act])
                g = d < p.th_dist  # signed: far-below-plane points stay in
            self._plane.estimate_plane(pts[act][g])

        ground = np.zeros(n, bool)
        ground[act[g]] = True
        nonground[act[~g]] = True
        return ground, nonground

    # ------------------------------------------------------------ the frame

    def estimate_ground(self, cloud: np.ndarray) -> np.ndarray:
        """Label one scan. Returns a (N,) bool ground mask (by original row).

        Mirrors the reference frame driver (:151-336) including the A-GLE
        cascade, per-ring TGR, and end-of-frame threshold adaptation.
        """
        p = self.params
        cloud = np.asarray(cloud, np.float32)
        n_pts = cloud.shape[0]
        ground = np.zeros(n_pts, bool)

        noise = self._rnr_mask(cloud) if p.enable_RNR else np.zeros(n_pts, bool)
        patch_id, _ = self._czm_assign(cloud, excluded=noise)
        # Exposed for tests: the f64 binning decision per point. The engine
        # bins in f32 (documented boundary-ulp deviation, ops/binning.py);
        # tests scope oracle-parity assertions to runs where the two agree.
        self.last_patch_id = patch_id.copy()

        # Pre-split point rows per patch (scan order within patch, as emplaced).
        num_patches = sum(
            p.num_rings_each_zone[k] * p.num_sectors_each_zone[k] for k in range(p.num_zones)
        )
        patch_rows: List[np.ndarray] = [np.empty(0, np.int64)] * num_patches
        order = np.argsort(patch_id, kind="stable")
        sorted_ids = patch_id[order]
        starts = np.searchsorted(sorted_ids, np.arange(num_patches))
        ends = np.searchsorted(sorted_ids, np.arange(num_patches), side="right")
        for pid in range(num_patches):
            patch_rows[pid] = order[starts[pid] : ends[pid]]

        self.centers = []
        self.normals = []

        candidates: List[dict] = []
        ringwise_flatness: List[float] = []
        concentric_idx = 0
        pid = 0
        for zone_idx in range(p.num_zones):
            for _ring in range(p.num_rings_each_zone[zone_idx]):
                for _sec in range(p.num_sectors_each_zone[zone_idx]):
                    rows = patch_rows[pid]
                    pid += 1
                    if rows.size < p.num_min_pts:
                        continue  # all stay nonground

                    zsort = np.argsort(cloud[rows, 2], kind="stable")
                    rows_s = rows[zsort]
                    pts = cloud[rows_s, :3].astype(np.float32)

                    g_mask, _ng_mask = self._extract_piecewiseground(zone_idx, pts)
                    self.centers.append(self._plane.mean.copy())
                    self.normals.append(self._plane.normal.copy())

                    normal, mean, svals = self._plane.normal, self._plane.mean, self._plane.svals
                    with np.errstate(invalid="ignore"):
                        uprightness = np.float64(normal[2])
                        elevation = np.float64(mean[2])
                        flatness = np.float64(np.min(svals))
                        line_variable = (
                            np.float64(svals[0]) / np.float64(svals[1])
                            if svals[1] != 0
                            else _DBL_MAX
                        )
                        heading = np.float64((mean * normal).astype(np.float32).sum(dtype=np.float64))

                        is_upright = bool(uprightness > p.uprightness_thr)
                        is_near = concentric_idx < p.num_rings_of_interest
                        is_heading_outside = bool(heading < 0.0)
                        is_not_elevated = False
                        is_flat = False
                        if is_near:
                            is_not_elevated = bool(elevation < self.elevation_thr[concentric_idx])
                            is_flat = bool(flatness < self.flatness_thr[concentric_idx])

                    if is_upright and is_not_elevated and is_near:
                        self.update_elevation[concentric_idx].append(float(elevation))
                        self.update_flatness[concentric_idx].append(float(flatness))
                        ringwise_flatness.append(float(flatness))

                    if not is_upright:
                        pass  # regionwise ground -> nonground
                    elif not is_near:
                        ground[rows_s[g_mask]] = True
                    elif not is_heading_outside:
                        pass  # -> nonground
                    elif is_not_elevated or is_flat:
                        ground[rows_s[g_mask]] = True
                    else:
                        candidates.append(
                            dict(
                                concentric_idx=concentric_idx,
                                flatness=float(flatness),
                                line_variable=float(line_variable),
                                rows=rows_s[g_mask],
                            )
                        )

                # ---- end of ring: TGR (reference :291-304) ----
                if candidates:
                    if p.enable_TGR:
                        self._temporal_ground_revert(
                            ground, ringwise_flatness, candidates, concentric_idx
                        )
                    candidates.clear()
                    ringwise_flatness.clear()
                concentric_idx += 1

        self._update_elevation_thr()
        self._update_flatness_thr()
        return ground

    # ---------------------------------------------------------------- TGR

    @staticmethod
    def _mean_stdev(vec: List[float]):
        """reference calc_mean_stdev (:557-566): no-op (zeros) for n<=1."""
        if len(vec) <= 1:
            return 0.0, 0.0
        mean = float(np.float64(sum(np.float64(v) for v in vec)) / len(vec))
        var = sum((np.float64(v) - mean) ** 2 for v in vec) / (len(vec) - 1)
        return mean, float(np.sqrt(var))

    def _temporal_ground_revert(self, ground, ring_flatness, candidates, concentric_idx):
        p = self.params
        mean_f, stdev_f = self._mean_stdev(ring_flatness)
        for cand in candidates:
            mu = mean_f + 1.5 * stdev_f
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                prob_flatness = np.float64(1.0) / (
                    np.float64(1.0)
                    + np.exp((np.float64(cand["flatness"]) - mu) / (np.float64(mu) / 10.0))
                )
            if cand["rows"].size > 1500 and cand["flatness"] < p.th_dist * p.th_dist:
                prob_flatness = np.float64(1.0)
            prob_line = 0.0 if cand["line_variable"] > 8.0 else 1.0
            revert = bool(prob_line * prob_flatness > 0.5)
            if concentric_idx < p.num_rings_of_interest:
                if revert:
                    ground[cand["rows"]] = True
                # else: stays nonground

    # ------------------------------------------------------ threshold update

    def _update_elevation_thr(self) -> None:
        p = self.params
        for i in range(p.num_rings_of_interest):
            buf = self.update_elevation[i]
            if not buf:
                continue
            mean, stdev = self._mean_stdev(buf)
            if i == 0:
                self.elevation_thr[i] = mean + 3 * stdev
                self.sensor_height = -mean
            else:
                self.elevation_thr[i] = mean + 2 * stdev
            exceed = len(buf) - p.max_elevation_storage
            if exceed > 0:
                del buf[:exceed]

    def _update_flatness_thr(self) -> None:
        p = self.params
        for i in range(p.num_rings_of_interest):
            buf = self.update_flatness[i]
            if len(buf) <= 1:
                break  # quirk: freezes all later rings too
            mean, stdev = self._mean_stdev(buf)
            self.flatness_thr[i] = mean + stdev
            exceed = len(buf) - p.max_flatness_storage
            if exceed > 0:
                del buf[:exceed]

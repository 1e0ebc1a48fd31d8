"""The plain reference: Patchwork++ in NumPy, one patch at a time.

A frozen copy of the port's NumPy oracle (itself a copy of the JAX
package's), which follows the C++ reference (cpp/patchworkpp/src/
patchworkpp.cpp) with its precision mix (float32 points, float64 scalar
statistics) and its quirks: RNR exclusion (:377-400), the zone-0 seed
margin on the LPR mean only (:88-96), the signed distance test of R-GPF
(:525), the plane state carried across empty fits (:49), TGR's ring-wise
flatness flushed only on rings with candidates (:292-304), the ``break`` of
``update_flatness_thr`` on a starved ring (:363-364) and the FIFO trim after
the thresholds (:354-355, :372-373).

Departures from the copy: the 3x3 eigenproblem is LAPACK's symmetric
solver in float64 on the float32 covariance (``np.linalg.eigh``), where
the oracle called the port's own float32 Cardano solver (the C++ reference
calls Eigen's JacobiSVD); the state can be exported and imported as the
program's checkpoint arrays; and ``lowp`` computes the frame in bfloat16
(the control that a correct run has to be told apart from).

Imports only NumPy: nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from benchmark.reference.params import Params

_DBL_MAX = np.finfo(np.float64).max


def bf16(a) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32. NaN and infinities pass."""
    a = np.asarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isfinite(a), r.view(np.float32), a)


def _same(a):
    return a


class _PlaneState:
    """The reference's plane members (normal_, pc_mean_, singular_values_,
    d_), which an empty fit leaves as they were."""

    def __init__(self, q) -> None:
        self.q = q
        self.normal = np.zeros(3, np.float32)
        self.mean = np.zeros(3, np.float32)
        self.svals = np.zeros(3, np.float32)
        self.d = np.float64(0.0)

    def estimate_plane(self, pts: np.ndarray) -> None:
        """PCA plane fit (patchworkpp.cpp:47-75) of (n, 3) float32 points."""
        n = pts.shape[0]
        if n == 0:
            return
        q = self.q
        mean = q(pts.mean(axis=0, dtype=np.float32))
        centered = q(pts - mean)
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = q((centered.T @ centered) / np.float32(n - 1))
        self.mean = mean
        if not np.all(np.isfinite(cov)):
            self.svals = np.full(3, np.nan, np.float32)
            self.normal = np.full(3, np.nan, np.float32)
            self.d = np.float64(np.nan)
            return
        w, v = np.linalg.eigh(cov.astype(np.float64))  # ascending
        self.svals = q(w[::-1].astype(np.float32))
        normal = q(v[:, 0].astype(np.float32))
        if normal[2] < 0:
            normal = -normal
        self.normal = normal
        self.d = np.float64(-np.float32(normal @ mean))

    def dist(self, pts: np.ndarray) -> np.ndarray:
        """Signed point-to-plane distance (:551-554): f32 dot + f64 d."""
        dots = self.q((pts * self.normal[None, :]).sum(axis=1, dtype=np.float32))
        return dots.astype(np.float64) + self.d


class Reference:
    """Stateful Patchwork++ with the reference's cross-frame adaptation."""

    def __init__(self, params: Optional[Params] = None, lowp: bool = False) -> None:
        self.params = params or Params()
        self.lowp = lowp
        self._q = bf16 if lowp else _same
        p = self.params
        mn, mx = p.min_range, p.max_range
        self.min_ranges = [mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0]
        bounds = self.min_ranges + [mx]
        self.ring_sizes = [
            (bounds[k + 1] - bounds[k]) / p.num_rings_each_zone[k] for k in range(p.num_zones)
        ]
        self.sector_sizes = [2 * math.pi / p.num_sectors_each_zone[k] for k in range(p.num_zones)]

        self.sensor_height = float(p.sensor_height)
        self.elevation_thr: List[float] = list(p.elevation_thr)
        self.flatness_thr: List[float] = list(p.flatness_thr)
        self.update_elevation: List[List[float]] = [[] for _ in range(4)]
        self.update_flatness: List[List[float]] = [[] for _ in range(4)]

        self._plane = _PlaneState(self._q)
        self.centers: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []

    # ------------------------------------------------------------- state

    def export_state(self) -> Dict[str, np.ndarray]:
        """The adapted quantities the chain carries, as float64 arrays, and
        the rings' sample buffers in the program's checkpoint layout."""
        out = {
            "sensor_height": np.float64(self.sensor_height),
            "elevation_thr": np.asarray(self.elevation_thr, np.float64),
            "flatness_thr": np.asarray(self.flatness_thr, np.float64),
        }
        for name, bufs in (("elev", self.update_elevation), ("flat", self.update_flatness)):
            buf = np.zeros((len(bufs), max(map(len, bufs), default=0)), np.float64)
            for i, b in enumerate(bufs):
                buf[i, : len(b)] = b
            out[f"{name}_buf"] = buf
            out[f"{name}_cnt"] = np.asarray([len(b) for b in bufs], np.int64)
        return out

    def import_state(self, d) -> None:
        """Take a checkpoint in the program's npz layout (sensor_height,
        elevation_thr, flatness_thr, and the four rings' sample buffers
        elev_buf / flat_buf with their counts elev_cnt / flat_cnt)."""
        self.sensor_height = float(np.asarray(d["sensor_height"]))
        self.elevation_thr = [float(v) for v in np.asarray(d["elevation_thr"])]
        self.flatness_thr = [float(v) for v in np.asarray(d["flatness_thr"])]
        for name, bufs in (("elev", self.update_elevation), ("flat", self.update_flatness)):
            buf, cnt = np.asarray(d[f"{name}_buf"]), np.asarray(d[f"{name}_cnt"])
            for i in range(len(bufs)):
                bufs[i] = [float(v) for v in buf[i, : int(cnt[i])]]

    # --------------------------------------------------------------- RNR

    def _rnr_mask(self, cloud: np.ndarray) -> np.ndarray:
        """Reflected-noise mask (:377-400). Requires >= 4 columns."""
        p = self.params
        if cloud.shape[1] < 4:
            return np.zeros(cloud.shape[0], bool)
        x, y, z, inten = (cloud[:, i].astype(np.float32) for i in range(4))
        rad_f32 = x * x + y * y  # float radicand, double sqrt
        r = np.sqrt(rad_f32.astype(np.float64))
        ver_deg = np.degrees(np.arctan2(z.astype(np.float64), r))
        return (
            (ver_deg < p.RNR_ver_angle_thr)
            & (z.astype(np.float64) < -self.sensor_height - 0.8)
            & (inten.astype(np.float64) < p.RNR_intensity_thr)
        )

    # --------------------------------------------------------------- CZM

    def czm_assign(self, cloud: np.ndarray, excluded: np.ndarray) -> np.ndarray:
        """Flat patch id of every point (zone-major, ring, sector), -1 out of
        range or excluded (pc2czm, :578-622)."""
        p = self.params
        x = cloud[:, 0].astype(np.float64)
        y = cloud[:, 1].astype(np.float64)
        r = np.sqrt(x * x + y * y)
        in_range = (r <= p.max_range) & (r > p.min_range) & ~excluded
        theta = np.arctan2(y, x)
        theta = np.where(theta > 0, theta, 2 * math.pi + theta)

        patch_id = np.full(cloud.shape[0], -1, np.int64)
        offset = 0
        zone_hi = self.min_ranges[1:] + [p.max_range]
        for k in range(p.num_zones):
            nring, nsec = p.num_rings_each_zone[k], p.num_sectors_each_zone[k]
            if k == 0:
                zsel = in_range & (r < zone_hi[0])
            elif k < p.num_zones - 1:
                zsel = in_range & (r >= zone_hi[k - 1]) & (r < zone_hi[k])
            else:
                zsel = in_range & (r >= zone_hi[k - 1])
            ring = np.minimum(((r - self.min_ranges[k]) / self.ring_sizes[k]).astype(np.int64),
                              nring - 1)
            sec = np.minimum((theta / self.sector_sizes[k]).astype(np.int64), nsec - 1)
            patch_id = np.where(zsel, offset + ring * nsec + sec, patch_id)
            offset += nring * nsec
        return patch_id.astype(np.int32)

    def patch_ids(self, cloud: np.ndarray) -> np.ndarray:
        """Each point's patch (-1: none) under the current sensor height."""
        cloud = np.asarray(cloud, np.float32)
        p = self.params
        noise = self._rnr_mask(cloud) if p.enable_RNR else np.zeros(len(cloud), bool)
        return self.czm_assign(cloud, noise)

    # ------------------------------------------------------------- seeds

    def _seed_mask(self, zone_idx: int, zs: np.ndarray, th_seed: float) -> np.ndarray:
        """Initial seeds over z-sorted patch points (:77-149)."""
        p = self.params
        init_idx = 0
        if zone_idx == 0:
            thr = p.adaptive_seed_selection_margin * self.sensor_height
            init_idx = int(np.searchsorted(zs, thr, side="left"))
        sel = zs[init_idx: init_idx + p.num_lpr]
        lpr = float(sel.astype(np.float64).sum() / sel.size) if sel.size else 0.0
        return zs.astype(np.float64) < (lpr + th_seed)

    # ---------------------------------------------------- per-patch fits

    def _extract_piecewiseground(self, zone_idx: int, pts: np.ndarray):
        """R-VPF + R-GPF on one z-sorted patch (:467-549): (ground, nonground)
        masks over its rows."""
        p = self.params
        n = pts.shape[0]
        active = np.ones(n, bool)
        nonground = np.zeros(n, bool)

        if p.enable_RVPF:
            for _ in range(p.num_iter):
                act = np.flatnonzero(active)
                smask = self._seed_mask(zone_idx, pts[act, 2], p.th_seeds_v)
                self._plane.estimate_plane(pts[act][smask])
                if zone_idx == 0 and bool(self._plane.normal[2] < p.uprightness_thr):
                    peel = np.abs(self._plane.dist(pts[act])) < p.th_dist_v
                    nonground[act[peel]] = True
                    active[act[peel]] = False
                else:
                    break

        act = np.flatnonzero(active)
        smask = self._seed_mask(zone_idx, pts[act, 2], p.th_seeds)
        self._plane.estimate_plane(pts[act][smask])
        g = np.zeros(act.size, bool)
        for _ in range(p.num_iter):
            with np.errstate(invalid="ignore"):
                g = self._plane.dist(pts[act]) < p.th_dist  # signed
            self._plane.estimate_plane(pts[act][g])

        ground = np.zeros(n, bool)
        ground[act[g]] = True
        nonground[act[~g]] = True
        return ground, nonground

    # --------------------------------------------------------- the frame

    def estimate_ground(self, cloud: np.ndarray) -> np.ndarray:
        """Label one scan: a (N,) bool ground mask by original row. The
        processed patches' plane centers and normals are left in
        ``centers`` and ``normals``."""
        p = self.params
        cloud = np.asarray(cloud, np.float32)
        if self.lowp:
            cloud = bf16(cloud)
        n_pts = cloud.shape[0]
        ground = np.zeros(n_pts, bool)

        patch_id = self.patch_ids(cloud)
        num_patches = p.num_patches
        order = np.argsort(patch_id, kind="stable")
        sorted_ids = patch_id[order]
        starts = np.searchsorted(sorted_ids, np.arange(num_patches))
        ends = np.searchsorted(sorted_ids, np.arange(num_patches), side="right")

        self.centers = []
        self.normals = []
        candidates: List[dict] = []
        ringwise_flatness: List[float] = []
        concentric_idx = 0
        pid = 0
        for zone_idx in range(p.num_zones):
            for _ring in range(p.num_rings_each_zone[zone_idx]):
                for _sec in range(p.num_sectors_each_zone[zone_idx]):
                    rows = order[starts[pid]: ends[pid]]
                    pid += 1
                    if rows.size < p.num_min_pts:
                        continue

                    rows_s = rows[np.argsort(cloud[rows, 2], kind="stable")]
                    pts = cloud[rows_s, :3]
                    g_mask, _ = self._extract_piecewiseground(zone_idx, pts)
                    self.centers.append(self._plane.mean.copy())
                    self.normals.append(self._plane.normal.copy())

                    normal, mean, svals = self._plane.normal, self._plane.mean, self._plane.svals
                    with np.errstate(invalid="ignore"):
                        uprightness = np.float64(normal[2])
                        elevation = np.float64(mean[2])
                        flatness = np.float64(np.min(svals))
                        line_variable = (
                            np.float64(svals[0]) / np.float64(svals[1])
                            if svals[1] != 0 else _DBL_MAX
                        )
                        heading = np.float64(
                            (mean * normal).astype(np.float32).sum(dtype=np.float64))
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
                        pass
                    elif not is_near:
                        ground[rows_s[g_mask]] = True
                    elif not is_heading_outside:
                        pass
                    elif is_not_elevated or is_flat:
                        ground[rows_s[g_mask]] = True
                    else:
                        candidates.append(dict(
                            flatness=float(flatness), line_variable=float(line_variable),
                            rows=rows_s[g_mask]))

                # end of ring: TGR (:291-304)
                if candidates:
                    if p.enable_TGR:
                        self._temporal_ground_revert(
                            ground, ringwise_flatness, candidates, concentric_idx)
                    candidates.clear()
                    ringwise_flatness.clear()
                concentric_idx += 1

        self._update_elevation_thr()
        self._update_flatness_thr()
        return ground

    # --------------------------------------------------------------- TGR

    @staticmethod
    def _mean_stdev(vec: List[float]):
        """calc_mean_stdev (:557-566): zeros for n <= 1."""
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
            if concentric_idx < p.num_rings_of_interest and prob_line * prob_flatness > 0.5:
                ground[cand["rows"]] = True

    # -------------------------------------------------- threshold update

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
                break  # the reference's quirk: later rings freeze too
            mean, stdev = self._mean_stdev(buf)
            self.flatness_thr[i] = mean + stdev
            exceed = len(buf) - p.max_flatness_storage
            if exceed > 0:
                del buf[:exceed]

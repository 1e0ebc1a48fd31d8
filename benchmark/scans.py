"""Synthetic LiDAR drives made from a seed, for any spinning sensor.

A copy of the port's 64-beam generator (``io/synthetic.py:make_scan``)
with the sensor as a parameter: beam elevations, columns per turn, mount
height and the number of points every scan has. The scene (ground tilt, six
walls, twelve boxes) is fixed by the seed; each frame moves the sensor 5 cm
and turns it 1 mrad and draws new noise, so a drive's scans are distinct.
With the KITTI HDL-64E sensor at ``points`` 130048 (the port's cap) its
rows begin with the port's ``make_scan`` bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

# the port's generator mounts its sensor here; the scene's low noise disc
# sits a fixed distance under the ground whatever the mount
_BASE_HEIGHT = 1.73


def make_scan(seed: int, frame: int, sensor: dict) -> np.ndarray:
    """One scan, float32 (N, 4): x, y, z, intensity.

    ``sensor``: ``beams``, ``elev_min_deg``, ``elev_max_deg`` (evenly spaced
    beams), ``columns`` (azimuth steps a turn), ``height`` (metres above
    the ground) and ``points``: every scan has exactly that many rows,
    sub-sampled in order, or topped up with returns beyond the maximum
    range, so that every seed gives the same work (None keeps the scene's
    own count)."""
    scene = np.random.default_rng(seed)
    rng = np.random.default_rng([seed, frame])
    h = sensor["height"]
    tx, ty = scene.uniform(-0.015, 0.015, 2)
    walls = [
        (scene.uniform(8, 40), scene.uniform(0, 2 * np.pi),
         scene.uniform(0, np.pi), scene.uniform(5, 15), scene.uniform(2, 6))
        for _ in range(6)
    ]
    boxes = []
    for _ in range(12):
        r, th = scene.uniform(5, 30), scene.uniform(0, 2 * np.pi)
        boxes.append((r * np.cos(th), r * np.sin(th), scene.uniform(1.5, 2.5),
                      scene.uniform(0.8, 1.2), scene.uniform(-0.3, 0.2)))

    ox, oy = 0.05 * frame, 0.0
    n_az = sensor["columns"]
    elev = np.deg2rad(np.linspace(sensor["elev_min_deg"], sensor["elev_max_deg"],
                                  sensor["beams"]))
    az = (np.arange(n_az) + rng.uniform()) * (2 * np.pi / n_az) + 1e-3 * frame
    e, a = np.meshgrid(elev, az, indexing="ij")
    dx = (np.cos(e) * np.cos(a)).ravel()
    dy = (np.cos(e) * np.sin(a)).ravel()
    dz = np.sin(e).ravel()
    t = np.full(dx.shape, np.inf)
    inten = rng.uniform(0.2, 0.6, dx.shape)

    # ground z = -h + tx x + ty y
    den = dz - tx * dx - ty * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (-h + tx * ox + ty * oy) / den
    t = np.where((tg > 0) & np.isfinite(tg), tg, t)

    for d, th, head, half, top in walls:
        cx, cy = d * np.cos(th), d * np.sin(th)
        nx, ny = np.cos(head), np.sin(head)
        den = nx * dx + ny * dy
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = (nx * (cx - ox) + ny * (cy - oy)) / den
        px, py, pz = ox + tw * dx, oy + tw * dy, tw * dz
        along = (px - cx) * -ny + (py - cy) * nx
        ok = (tw > 0) & (np.abs(along) < half) & (pz > -h) & (pz < top - h)
        closer = ok & (tw < t)
        t = np.where(closer, tw, t)
        inten = np.where(closer, rng.uniform(0.3, 0.9, dx.shape), inten)

    for cx, cy, hx, hy, top in boxes:
        with np.errstate(divide="ignore", invalid="ignore"):
            t1x, t2x = (cx - hx - ox) / dx, (cx + hx - ox) / dx
            t1y, t2y = (cy - hy - oy) / dy, (cy + hy - oy) / dy
            t1z, t2z = (-h - 0.0) / dz, (top - 0.0) / dz
        tin = np.maximum.reduce([np.minimum(t1x, t2x), np.minimum(t1y, t2y),
                                 np.minimum(t1z, t2z)])
        tout = np.minimum.reduce([np.maximum(t1x, t2x), np.maximum(t1y, t2y),
                                  np.maximum(t1z, t2z)])
        ok = (tin > 0) & (tin < tout) & (tin < t)
        t = np.where(ok, tin, t)
        inten = np.where(ok, rng.uniform(0.1, 0.9, dx.shape), inten)

    hit = t < 120.0
    pts = np.stack([ox + t * dx, oy + t * dy, t * dz], 1)[hit]
    pts += rng.normal(0.0, 0.02, pts.shape)
    rows = [np.concatenate([pts, inten[hit, None]], 1)]

    def disc(n, r_lo, r_hi, z_lo, z_hi, i_lo, i_hi):
        r = rng.uniform(r_lo, r_hi, n)
        th = rng.uniform(0, 2 * np.pi, n)
        return np.stack([ox + r * np.cos(th), oy + r * np.sin(th),
                         rng.uniform(z_lo, z_hi, n), rng.uniform(i_lo, i_hi, n)], 1)

    drop = _BASE_HEIGHT - h  # 0.0 at the port's own mount
    rows.append(disc(300, 3.0, 9.0, -3.8 + drop, -2.8 + drop, 0.0, 0.15))  # reflected noise
    rows.append(disc(300, 0.3, 2.6, -1.5, 0.5, 0.0, 1.0))     # inside min_range
    rows.append(disc(300, 81.0, 110.0, -1.0, 6.0, 0.0, 1.0))  # beyond max_range
    cloud = np.concatenate(rows, 0).astype(np.float32)
    n = sensor["points"] or len(cloud)
    if len(cloud) > n:
        cloud = cloud[np.sort(rng.permutation(len(cloud))[:n])]
    elif len(cloud) < n:  # topped up with far returns, out of range
        short = n - len(cloud)
        cloud = np.concatenate([cloud, disc(short, 81.0, 110.0, -1.0, 6.0, 0.0, 1.0)])
        cloud = cloud.astype(np.float32)
    return cloud


def make_drive(seed: int, frames: int, sensor: dict, sub: int = 1) -> List[np.ndarray]:
    """``frames`` consecutive scans of one drive (every ``sub``-th row),
    made on a few threads (NumPy's array work runs outside the lock)."""
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        scans = list(ex.map(lambda f: make_scan(seed, f, sensor), range(frames)))
    return [np.ascontiguousarray(s[::sub]) for s in scans]

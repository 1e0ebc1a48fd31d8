"""Synthetic scans made from a seed with numpy: the port's workload where no
KITTI scan is at hand (``chip_smoke.py``, the CLIs when ``PPK_DATA_DIR`` is
not set, and the tests).

- :func:`make_scan`: a 64-beam scan over 360 degrees (~120k points), a
  tilted noisy ground plane, walls, boxes, reflected noise below the ground
  and points out of range; ``frame`` moves the sensor.
- :func:`make_one_tile_scan`: every patch of the default CZM holds fewer
  than 128 points, so every processed patch owns one tile.
- :func:`make_crowded_scan`: the one-tile scan plus one patch longer than
  the fit kernels keep in shared memory.
"""

from __future__ import annotations

import numpy as np

CAPACITY = 131072


def make_scan(seed: int, frame: int = 0) -> np.ndarray:
    """Synthetic 64-beam scan, float32 (N, 4) x, y, z, intensity.

    The scene (ground tilt, walls, boxes) is fixed by ``seed``; ``frame``
    moves the sensor 5 cm and turns it 1 mrad per frame and draws new noise.
    """
    scene = np.random.default_rng(seed)
    rng = np.random.default_rng([seed, frame])
    h = 1.73
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
    n_az = 1960
    elev = np.deg2rad(np.linspace(-24.8, 2.0, 64))
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

    rows.append(disc(300, 3.0, 9.0, -3.8, -2.8, 0.0, 0.15))   # reflected noise
    rows.append(disc(300, 0.3, 2.6, -1.5, 0.5, 0.0, 1.0))     # inside min_range
    rows.append(disc(300, 81.0, 110.0, -1.0, 6.0, 0.0, 1.0))  # beyond max_range
    cloud = np.concatenate(rows, 0).astype(np.float32)
    if len(cloud) > CAPACITY - 1024:
        cloud = cloud[np.sort(rng.permutation(len(cloud))[: CAPACITY - 1024])]
    return cloud


def make_one_tile_scan(seed: int, per_patch: int = 64) -> np.ndarray:
    """``per_patch`` (< 128) points in every patch of the default CZM, away
    from the patch edges: a noisy ground plane, with a fifth of the points
    raised up to 2 m. Every processed patch then owns exactly one tile."""
    from patchworkpp_tpu_torch.params import CZMGeometry, Params

    p = Params()
    geom = CZMGeometry.create(p)
    rng = np.random.default_rng([seed, 202])
    rows = []
    for k in range(p.num_zones):
        nr, ns = p.num_rings_each_zone[k], p.num_sectors_each_zone[k]
        ring = np.repeat(np.arange(nr), ns * per_patch)
        sec = np.tile(np.repeat(np.arange(ns), per_patch), nr)
        n = ring.size
        r = geom.min_ranges[k] + geom.ring_sizes[k] * (ring + rng.uniform(0.15, 0.85, n))
        th = geom.sector_sizes[k] * (sec + rng.uniform(0.15, 0.85, n))
        z = -1.73 + 0.005 * r + rng.normal(0.0, 0.03, n)
        z = np.where(rng.uniform(size=n) < 0.2, z + rng.uniform(0.2, 2.0, n), z)
        rows.append(np.stack([r * np.cos(th), r * np.sin(th), z,
                              rng.uniform(0.3, 0.9, n)], 1))
    return np.concatenate(rows).astype(np.float32)


def make_crowded_scan(seed: int, crowd: int = 40000) -> np.ndarray:
    """make_one_tile_scan(seed) plus ``crowd`` points in one zone-0 patch
    (ring 0, sector 1: r in [3.2, 7.0] m, theta in [0.45, 0.75] rad), three
    quarters on a noisy ground plane, a quarter above it. That patch then
    holds ~314 tiles, more than the fit kernel K1 keeps in shared memory
    (ops/fit_kernel_grid.py CAP_TILES), so its rows are read from global
    memory; every other processed patch holds one tile."""
    rng = np.random.default_rng([seed, 101])
    r = rng.uniform(3.2, 7.0, crowd)
    th = rng.uniform(0.45, 0.75, crowd)
    z = np.where(rng.uniform(size=crowd) < 0.75,
                 -1.73 + rng.normal(0.0, 0.03, crowd), rng.uniform(-1.6, 0.5, crowd))
    pts = np.stack([r * np.cos(th), r * np.sin(th), z, rng.uniform(0.3, 0.9, crowd)], 1)
    return np.concatenate([make_one_tile_scan(seed), pts]).astype(np.float32)

"""Parameters and Concentric-Zone-Model geometry (PyTorch port).

Field-for-field copy of ``patchworkpp_tpu/params.py`` (the reference's
``patchwork::Params``, cpp/patchworkpp/include/patchwork/patchworkpp.h:42-147),
kept separate so that this package imports nothing of the JAX package. The
geometry is host-side Python; only the numeric tables derived from it reach
the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

# Dense per-patch capacity per zone. Read by no code of either package;
# carried so that the two Params dataclasses stay field-for-field equal.
DEFAULT_ZONE_CAPACITY: Tuple[int, int, int, int] = (8192, 2048, 1024, 1024)


@dataclasses.dataclass(frozen=True)
class Params:
    """All tunables of the ground-segmentation engine (reference defaults).

    Adaptive quantities (elevation_thr / flatness_thr / sensor_height) are
    initial values; the adapted ones live in :class:`state.AdaptiveState`.
    """

    verbose: bool = False
    enable_RNR: bool = True
    enable_RVPF: bool = True
    enable_TGR: bool = True

    num_iter: int = 3
    num_lpr: int = 20
    num_min_pts: int = 10
    num_zones: int = 4
    num_rings_of_interest: int = 4

    RNR_ver_angle_thr: float = -15.0
    RNR_intensity_thr: float = 0.2

    sensor_height: float = 1.723
    th_seeds: float = 0.125
    th_dist: float = 0.125
    th_seeds_v: float = 0.25
    th_dist_v: float = 0.1
    max_range: float = 80.0
    min_range: float = 2.7
    uprightness_thr: float = 0.707
    adaptive_seed_selection_margin: float = -1.2
    intensity_thr: float = 0.2  # bound but unused, as in the reference

    num_sectors_each_zone: Tuple[int, ...] = (16, 32, 54, 32)
    num_rings_each_zone: Tuple[int, ...] = (2, 4, 4, 4)

    max_flatness_storage: int = 1000
    max_elevation_storage: int = 1000

    elevation_thr: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    flatness_thr: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)

    zone_capacity: Tuple[int, ...] = DEFAULT_ZONE_CAPACITY

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)


def spad(num_patches: int) -> int:
    """Padded patch-space width: num_patches + 1 overflow bucket, rounded up
    to a multiple of 128 and floored at 512 (the default 504-patch CZM)."""
    need = num_patches + 1
    return max(512, -(-need // 128) * 128)


@dataclasses.dataclass(frozen=True)
class CZMGeometry:
    """Static CZM geometry derived from :class:`Params` (reference
    constructor, patchworkpp.h:122-134) plus the flat patch-id space."""

    params: Params
    min_ranges: Tuple[float, ...]
    ring_sizes: Tuple[float, ...]
    sector_sizes: Tuple[float, ...]
    zone_patch_offset: Tuple[int, ...]
    num_patches: int
    num_concentric_rings: int

    @property
    def spad(self) -> int:
        return spad(self.num_patches)

    @staticmethod
    def create(params: Params) -> "CZMGeometry":
        p = params
        mn, mx = p.min_range, p.max_range
        min_ranges = (mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0)
        bounds = min_ranges + (mx,)
        ring_sizes = tuple(
            (bounds[k + 1] - bounds[k]) / p.num_rings_each_zone[k]
            for k in range(p.num_zones)
        )
        sector_sizes = tuple(
            2 * math.pi / p.num_sectors_each_zone[k] for k in range(p.num_zones)
        )
        offsets = []
        off = 0
        for k in range(p.num_zones):
            offsets.append(off)
            off += p.num_rings_each_zone[k] * p.num_sectors_each_zone[k]
        return CZMGeometry(
            params=p,
            min_ranges=min_ranges,
            ring_sizes=ring_sizes,
            sector_sizes=sector_sizes,
            zone_patch_offset=tuple(offsets),
            num_patches=off,
            num_concentric_rings=sum(p.num_rings_each_zone),
        )

    def patch_zone(self) -> np.ndarray:
        """(num_patches,) zone index of each flat patch id."""
        out = np.empty(self.num_patches, np.int32)
        for k in range(self.params.num_zones):
            out[self.zone_patch_slice(k)] = k
        return out

    def patch_concentric_ring(self) -> np.ndarray:
        """(num_patches,) global concentric ring index of each patch
        (the reference's ``concentric_idx``, patchworkpp.cpp:309)."""
        out = np.empty(self.num_patches, np.int32)
        cr = 0
        for k in range(self.params.num_zones):
            s = self.params.num_sectors_each_zone[k]
            for ring in range(self.params.num_rings_each_zone[k]):
                a = self.zone_patch_offset[k] + ring * s
                out[a:a + s] = cr
                cr += 1
        return out

    def patch_sector(self) -> np.ndarray:
        """(num_patches,) sector index of each flat patch id within its ring."""
        out = np.empty(self.num_patches, np.int32)
        for k in range(self.params.num_zones):
            s = self.params.num_sectors_each_zone[k]
            for ring in range(self.params.num_rings_each_zone[k]):
                a = self.zone_patch_offset[k] + ring * s
                out[a:a + s] = np.arange(s)
        return out

    def zone_patch_slice(self, k: int) -> slice:
        a = self.zone_patch_offset[k]
        return slice(
            a, a + self.params.num_rings_each_zone[k] * self.params.num_sectors_each_zone[k]
        )

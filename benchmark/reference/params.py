"""The reference's parameters: a frozen copy of Patchwork++'s ``Params``
(cpp/patchworkpp/include/patchwork/patchworkpp.h:42-147, the compiled-in
defaults at :79-111), independent of the program under test.

A configuration file's ``params`` overrides these defaults by name; the
benchmark builds the program's own ``Params`` from the same overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Params:
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

    @staticmethod
    def from_overrides(overrides: dict) -> "Params":
        """Defaults with ``overrides`` (a configuration's ``params``); lists
        become tuples. An unknown key raises."""
        return Params(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in overrides.items()})

    @property
    def num_patches(self) -> int:
        return sum(r * s for r, s in zip(self.num_rings_each_zone,
                                         self.num_sectors_each_zone))

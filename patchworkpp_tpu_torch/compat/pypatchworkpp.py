"""Drop-in replacement for the reference ``pypatchworkpp`` extension module
(port of ``patchworkpp_tpu/compat/pypatchworkpp.py``).

Mirrors the pybind11 surface (reference: python/patchworkpp/pybinding.cpp:9-56):
a mutable ``Parameters`` object with all 25 tunables and a ``patchworkpp``
class with the same constructor and 9 methods, NumPy in / NumPy out. Existing
scripts can switch with::

    # import pypatchworkpp
    from patchworkpp_tpu_torch.compat import pypatchworkpp

    params = pypatchworkpp.Parameters()
    params.verbose = True
    PatchworkPLUSPLUS = pypatchworkpp.patchworkpp(params)   # on "cuda"
    PatchworkPLUSPLUS.estimateGround(cloud)
    ground = PatchworkPLUSPLUS.getGround()

The engine runs on CUDA unless the constructor is given ``device="cpu"``
(keyword only; the reference's constructor takes just the parameters).

Known deliberate differences from the C++ module:
- returned point/index arrays are ordered by original row index, not by the
  reference's internal accumulation order (the label *sets* are identical);
- ``getCenters``/``getNormals`` report each processed patch's own final plane
  (the reference can leak a stale previous-patch plane into these outputs
  when every fit of a patch early-returns; labels are unaffected either way);
- ``getTimeTaken`` returns host wall microseconds of the frame step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from patchworkpp_tpu_torch.params import Params as _FrozenParams

__version__ = "0.1.0"


class Parameters:
    """Mutable parameter bag, field-for-field the reference ``Parameters``."""

    def __init__(self) -> None:
        d = _FrozenParams()
        self.verbose = d.verbose
        self.enable_RNR = d.enable_RNR
        self.enable_RVPF = d.enable_RVPF
        self.enable_TGR = d.enable_TGR
        self.num_iter = d.num_iter
        self.num_lpr = d.num_lpr
        self.num_min_pts = d.num_min_pts
        self.num_zones = d.num_zones
        self.num_rings_of_interest = d.num_rings_of_interest
        self.RNR_ver_angle_thr = d.RNR_ver_angle_thr
        self.RNR_intensity_thr = d.RNR_intensity_thr
        self.sensor_height = d.sensor_height
        self.th_seeds = d.th_seeds
        self.th_dist = d.th_dist
        self.th_seeds_v = d.th_seeds_v
        self.th_dist_v = d.th_dist_v
        self.max_range = d.max_range
        self.min_range = d.min_range
        self.uprightness_thr = d.uprightness_thr
        self.adaptive_seed_selection_margin = d.adaptive_seed_selection_margin
        self.intensity_thr = d.intensity_thr  # bound but unused, as in reference
        self.num_sectors_each_zone = list(d.num_sectors_each_zone)
        self.num_rings_each_zone = list(d.num_rings_each_zone)
        self.max_flatness_storage = d.max_flatness_storage
        self.max_elevation_storage = d.max_elevation_storage
        self.elevation_thr = list(d.elevation_thr)
        self.flatness_thr = list(d.flatness_thr)

    def _freeze(self) -> _FrozenParams:
        return _FrozenParams(
            verbose=bool(self.verbose),
            enable_RNR=bool(self.enable_RNR),
            enable_RVPF=bool(self.enable_RVPF),
            enable_TGR=bool(self.enable_TGR),
            num_iter=int(self.num_iter),
            num_lpr=int(self.num_lpr),
            num_min_pts=int(self.num_min_pts),
            num_zones=int(self.num_zones),
            num_rings_of_interest=int(self.num_rings_of_interest),
            RNR_ver_angle_thr=float(self.RNR_ver_angle_thr),
            RNR_intensity_thr=float(self.RNR_intensity_thr),
            sensor_height=float(self.sensor_height),
            th_seeds=float(self.th_seeds),
            th_dist=float(self.th_dist),
            th_seeds_v=float(self.th_seeds_v),
            th_dist_v=float(self.th_dist_v),
            max_range=float(self.max_range),
            min_range=float(self.min_range),
            uprightness_thr=float(self.uprightness_thr),
            adaptive_seed_selection_margin=float(self.adaptive_seed_selection_margin),
            intensity_thr=float(self.intensity_thr),
            num_sectors_each_zone=tuple(self.num_sectors_each_zone),
            num_rings_each_zone=tuple(self.num_rings_each_zone),
            max_flatness_storage=int(self.max_flatness_storage),
            max_elevation_storage=int(self.max_elevation_storage),
            elevation_thr=tuple(float(v) for v in self.elevation_thr),
            flatness_thr=tuple(float(v) for v in self.flatness_thr),
        )


class patchworkpp:
    """Reference-compatible engine class (pybinding.cpp:45-55)."""

    def __init__(self, params: Optional[Parameters] = None, *,
                 device: Optional[str] = None) -> None:
        from patchworkpp_tpu_torch.models import PatchworkPP

        frozen = (params or Parameters())._freeze()
        self._model = PatchworkPP(frozen, device=device)
        self._cloud: Optional[np.ndarray] = None
        self._result = None

    def estimateGround(self, cloud: np.ndarray) -> None:
        cloud = np.asarray(cloud, np.float32)
        self._cloud = cloud
        self._result = self._model.estimate_ground(cloud)

    def _require(self):
        if self._result is None:
            raise RuntimeError("call estimateGround() first")
        return self._result

    def getGround(self) -> np.ndarray:
        r = self._require()
        return self._cloud[r.ground_indices, :3]

    def getNonground(self) -> np.ndarray:
        r = self._require()
        return self._cloud[r.nonground_indices, :3]

    def getGroundIndices(self) -> np.ndarray:
        return self._require().ground_indices

    def getNongroundIndices(self) -> np.ndarray:
        return self._require().nonground_indices

    def getCenters(self) -> np.ndarray:
        return self._require().centers

    def getNormals(self) -> np.ndarray:
        return self._require().normals

    def getHeight(self) -> float:
        return self._model.sensor_height

    def getTimeTaken(self) -> float:
        """Microseconds, like the reference's CPU-clock getTimeTaken()."""
        return self._require().time_taken_s * 1e6

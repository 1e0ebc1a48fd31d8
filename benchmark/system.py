"""The system under test: the PyTorch and CUDA port, reached through its
public entry points only (``PatchworkPP``, ``GroundSegmentationServer``,
``ServerConfig``, ``CloudMsg``, ``Params``), built from a configuration's
file. Nothing else of the port is read by the benchmark.
"""

from __future__ import annotations


def _params_kw(overrides: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()}


class Port:
    """Builds the port's objects for one configuration on ``device``."""

    def __init__(self, config: dict, device: str) -> None:
        from patchworkpp_tpu_torch import Params

        self.params = Params(**_params_kw(config["params"]))
        self.capacity = config["capacity"]
        self.device = device

    def facade(self):
        from patchworkpp_tpu_torch import PatchworkPP

        return PatchworkPP(self.params, capacity=self.capacity, device=self.device)

    def server(self, batch_max: int, queue_depth: int):
        from patchworkpp_tpu_torch.serve import GroundSegmentationServer, ServerConfig

        cfg = ServerConfig(capacity=self.capacity, batch_max=batch_max,
                           queue_depth=queue_depth)
        return GroundSegmentationServer(self.params, cfg, device=self.device)

    @staticmethod
    def message(points, stamp: float):
        from patchworkpp_tpu_torch.serve import CloudMsg

        return CloudMsg(points=points, stamp=stamp)

"""patchworkpp_tpu_torch — the PyTorch / CUDA port of patchworkpp_tpu.

Patchwork++ LiDAR ground segmentation (RNR, CZM binning, R-VPF / R-GPF plane
fits, A-GLE, TGR and the cross-frame adaptive state) on an NVIDIA GPU, with
the fit pass program as a hand-written CUDA kernel (csrc/fit_grid.cu). The
JAX package ``patchworkpp_tpu`` is the reference it is tested against; this
package imports none of it.

Public API: :class:`Params`, :class:`PatchworkPP` (runs on "cuda" unless
given ``device="cpu"``), :func:`init_state`, :class:`AdaptiveState`; the
presets in ``models``, the streaming server and multi-stream segmenter in
``serve``, the ``pypatchworkpp`` surface in ``compat``, and the bench and
the other command-line tools in ``cli``.
"""

from patchworkpp_tpu_torch.models import PatchworkPP
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.state import AdaptiveState, init_state

__all__ = ["Params", "CZMGeometry", "PatchworkPP", "AdaptiveState", "init_state"]

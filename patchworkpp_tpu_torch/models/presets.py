"""Parameter presets (port of ``patchworkpp_tpu/models/presets.py``).

- Default :class:`Params` == the reference's compiled-in defaults
  (reference: cpp/patchworkpp/include/patchwork/patchworkpp.h:79-111).
- ``patchwork_params`` == the predecessor Patchwork (RA-L 2021) behavior:
  Patchwork++ minus its three additions (RNR, R-VPF, TGR), which the
  reference exposes as enable_* flags.
- ``ros_launch_params`` == the deployment defaults the reference ROS 2 launch
  file overrides (ros/launch/patchworkpp.launch.py:53-66), with RNR forced
  off exactly as the ROS server does (GroundSegmentationServer.cpp:47).
"""

from patchworkpp_tpu_torch.params import Params


def patchwork_params(**overrides) -> Params:
    """Plain Patchwork (RA-L 2021): no RNR, no R-VPF, no TGR."""
    return Params(enable_RNR=False, enable_RVPF=False, enable_TGR=False).replace(
        **overrides
    )


def ros_launch_params(**overrides) -> Params:
    """The reference ROS 2 launch-file deployment profile."""
    return Params(
        enable_RNR=False,  # PointCloud2 intensity not wired through in reference
        sensor_height=1.88,
        num_iter=3,
        num_lpr=20,
        num_min_pts=0,
        th_seeds=0.3,
        th_dist=0.125,
        th_seeds_v=0.25,
        th_dist_v=0.9,
        max_range=80.0,
        min_range=1.0,
        uprightness_thr=0.101,
    ).replace(**overrides)

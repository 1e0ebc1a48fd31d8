"""Optional ROS 2 adapter for :class:`GroundSegmentationServer` (port of
``patchworkpp_tpu/serve/ros2_bridge.py``).

Capability parity with the reference node (reference:
ros/src/GroundSegmentationServer.cpp): subscribes ``pointcloud_topic``,
republishes ``/patchworkpp/cloud``, ``/patchworkpp/ground`` and
``/patchworkpp/nonground``. Only importable when rclpy + sensor_msgs are
installed; the transport-agnostic server in serve/server.py is the surface
everywhere else.

Deliberate capability EXCESS over the reference: the reference node forces
``enable_RNR = false`` because it never wires PointCloud2 intensity through
(GroundSegmentationServer.cpp:47, Utils.hpp:158-172 reads x/y/z only). Here
the subscription inspects ``msg.fields`` per message — when an ``intensity``
field is present the cloud is read as (N, 4) and RNR runs (gated by the
``enable_RNR`` node parameter, default true); without one the 3-column
fallback disables RNR silently, exactly like the reference's behavior.

The node's engine runs on CUDA unless it is constructed with
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from patchworkpp_tpu_torch.params import Params
from patchworkpp_tpu_torch.serve.server import CloudMsg, GroundSegmentationServer

try:  # pragma: no cover - exercised only with a ROS 2 install
    import rclpy
    from rclpy.node import Node
    from rclpy.qos import (
        DurabilityPolicy,
        QoSProfile,
        ReliabilityPolicy,
        qos_profile_sensor_data,
    )
    from sensor_msgs.msg import PointCloud2
    from sensor_msgs_py import point_cloud2

    HAVE_ROS2 = True
except Exception:  # pragma: no cover
    HAVE_ROS2 = False


if HAVE_ROS2:  # pragma: no cover

    def _publisher_qos() -> "QoSProfile":
        """Reliable + transient-local publisher QoS, mirroring the reference
        ("we use the following QoS setting for reliable ground
        segmentation", ros/src/GroundSegmentationServer.cpp:58-65): late
        subscribers still receive the last published clouds."""
        return QoSProfile(
            depth=10,  # rmw_qos_profile_default's keep-last depth
            reliability=ReliabilityPolicy.RELIABLE,
            durability=DurabilityPolicy.TRANSIENT_LOCAL,
        )

    class PatchworkppNode(Node):
        """rclpy node mirroring the reference server's topics, QoS and params
        (reference: ros/src/GroundSegmentationServer.cpp:26-71). ``device``
        and ``config`` go to the :class:`GroundSegmentationServer`."""

        def __init__(self, device=None, config=None) -> None:
            super().__init__("patchworkpp_node")
            params = Params(
                # Unlike the reference (which forces RNR off — cpp:47), the
                # intensity field IS wired through when the message has one;
                # 3-column messages still gate RNR off per message.
                enable_RNR=self.declare_parameter("enable_RNR", True).value,
                verbose=self.declare_parameter("verbose", False).value,
                sensor_height=self.declare_parameter("sensor_height", 1.723).value,
                num_iter=self.declare_parameter("num_iter", 3).value,
                num_lpr=self.declare_parameter("num_lpr", 20).value,
                num_min_pts=self.declare_parameter("num_min_pts", 10).value,
                th_seeds=self.declare_parameter("th_seeds", 0.125).value,
                th_dist=self.declare_parameter("th_dist", 0.125).value,
                th_seeds_v=self.declare_parameter("th_seeds_v", 0.25).value,
                th_dist_v=self.declare_parameter("th_dist_v", 0.1).value,
                max_range=self.declare_parameter("max_range", 80.0).value,
                min_range=self.declare_parameter("min_range", 2.7).value,
                uprightness_thr=self.declare_parameter("uprightness_thr", 0.707).value,
            )
            self.base_frame = self.declare_parameter("base_frame", "base_link").value
            self.server = GroundSegmentationServer(params, config=config, device=device)
            self.server.on_result(self._publish)
            self.server.start()

            # Best-effort sensor-data QoS on the subscription (the
            # reference's rclcpp::SensorDataQoS(), cpp:53-55); reliable +
            # transient-local on the three publishers (cpp:58-69).
            self.sub = self.create_subscription(
                PointCloud2, "pointcloud_topic", self._on_cloud,
                qos_profile_sensor_data,
            )
            qos = _publisher_qos()
            self.pub_cloud = self.create_publisher(
                PointCloud2, "/patchworkpp/cloud", qos
            )
            self.pub_ground = self.create_publisher(
                PointCloud2, "/patchworkpp/ground", qos
            )
            self.pub_nonground = self.create_publisher(
                PointCloud2, "/patchworkpp/nonground", qos
            )

        def _on_cloud(self, msg: PointCloud2) -> None:
            # NOT read_points_numpy: its same-dtype assert inspects EVERY
            # field of the message (not just the selected ones), so any
            # real driver cloud — float32 x/y/z plus uint16 intensity,
            # uint8 ring, uint32 t, ... — raises on even an xyz-only read.
            # The structured read_points has no such restriction; assemble
            # the columns ourselves and cast (uint8/uint16 reflectivity
            # intensities become float32, so RNR runs on the cast values).
            names = ["x", "y", "z"]
            if any(f.name == "intensity" for f in msg.fields):
                names.append("intensity")
            arr = point_cloud2.read_points(
                msg, field_names=names, skip_nans=False
            )
            pts = np.stack(
                [np.asarray(arr[n], np.float32) for n in names], axis=1
            )
            pts = pts[np.isfinite(pts).all(axis=1)]
            stamp = msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9
            self.server.publish(CloudMsg(points=pts, stamp=stamp, frame_id=self.base_frame))
            self.pub_cloud.publish(msg)

        def _publish(self, out) -> None:
            if out.error is not None:  # the scan raised: nothing to publish
                return
            pts = out.msg.points[:, :3]
            header_frame = self.base_frame
            g = point_cloud2.create_cloud_xyz32(
                self._mk_header(out.msg.stamp, header_frame),
                pts[out.result.ground_indices],
            )
            ng = point_cloud2.create_cloud_xyz32(
                self._mk_header(out.msg.stamp, header_frame),
                pts[out.result.nonground_indices],
            )
            self.pub_ground.publish(g)
            self.pub_nonground.publish(ng)

        def _mk_header(self, stamp: float, frame: str):
            from builtin_interfaces.msg import Time
            from std_msgs.msg import Header

            h = Header()
            h.frame_id = frame
            h.stamp = Time(sec=int(stamp), nanosec=int((stamp % 1) * 1e9))
            return h

    def main() -> None:
        rclpy.init()
        node = PatchworkppNode()
        try:
            rclpy.spin(node)
        finally:
            node.server.stop()
            rclpy.shutdown()

"""ROS 2 launch description for the ground-segmentation node (port of
``patchworkpp_tpu/serve/launch.py``).

Analog of the reference launch file (reference:
ros/launch/patchworkpp.launch.py:20-66): declares ``topic`` /
``visualize`` / ``base_frame`` arguments, starts the bridge node with the
deployment parameter profile (``presets.ros_launch_params``), and optionally
an RViz window loading ``patchworkpp_tpu_torch/serve/rviz/patchworkpp.rviz``.

Only importable where the ``launch`` / ``launch_ros`` packages exist (a ROS 2
install); elsewhere the module import-gates itself off the same way
``serve/ros2_bridge.py`` does. The pure helper ``launch_node_parameters()``
is importable everywhere and unit-tested.
"""

from __future__ import annotations

import os

from patchworkpp_tpu_torch.models import presets


def launch_node_parameters(base_frame: str = "base_link",
                           use_sim_time: bool = True) -> dict:
    """The ROS parameter dict the launch description passes to the node.

    Field-for-field the reference deployment profile
    (reference: ros/launch/patchworkpp.launch.py:53-66), derived from
    ``presets.ros_launch_params`` so the two surfaces cannot drift apart.
    """
    p = presets.ros_launch_params()
    fields = (
        "sensor_height", "num_iter", "num_lpr", "num_min_pts", "th_seeds",
        "th_dist", "th_seeds_v", "th_dist_v", "max_range", "min_range",
        "uprightness_thr",
    )
    out = {f: getattr(p, f) for f in fields}
    out.update({
        "base_frame": base_frame,
        "use_sim_time": use_sim_time,
        "verbose": True,
    })
    return out


try:  # pragma: no cover - exercised only with a ROS 2 install
    from launch import LaunchDescription
    from launch.actions import DeclareLaunchArgument
    from launch.conditions import IfCondition
    from launch.substitutions import LaunchConfiguration
    from launch_ros.actions import Node

    HAVE_LAUNCH = True
except Exception:  # pragma: no cover
    HAVE_LAUNCH = False


if HAVE_LAUNCH:  # pragma: no cover

    def generate_launch_description() -> "LaunchDescription":
        pointcloud_topic = LaunchConfiguration("topic")
        visualize = LaunchConfiguration("visualize", default="true")

        node = Node(
            package="patchworkpp_tpu_torch",
            executable="patchworkpp-ros2",
            name="patchworkpp_node",
            output="screen",
            remappings=[("pointcloud_topic", pointcloud_topic)],
            parameters=[launch_node_parameters()],
        )
        rviz_config = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "rviz", "patchworkpp.rviz"
        )
        rviz = Node(
            package="rviz2",
            executable="rviz2",
            output="screen",
            arguments=["-d", rviz_config],
            condition=IfCondition(visualize),
        )
        return LaunchDescription([
            DeclareLaunchArgument("topic", description="input PointCloud2 topic"),
            DeclareLaunchArgument("visualize", default_value="true"),
            DeclareLaunchArgument("base_frame", default_value="base_link"),
            node,
            rviz,
        ])

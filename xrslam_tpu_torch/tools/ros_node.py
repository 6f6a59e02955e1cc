"""ROS1 node: live VIO from `/cam0/image_raw` + `/imu0`.

Behavioral port of the reference's ROS adapter (reference:
xrslam-ros/src/xrslam-ros/src/xrslam_node.cpp:1-162): subscribes to the
camera and IMU topics, time-orders IMU against images (the node buffers
images until the IMU stream passes them, :95-130), feeds the public
API, and publishes the trajectory as `nav_msgs/Path` plus
`geometry_msgs/PoseStamped`. Undistortion at ingest uses the device
config's distortion model (the reference hardcodes EuRoC's radtan
coefficients, :82-89; here they come from the YAML pair).

Port of `xrslam_tpu/tools/ros_node.py`: the engine is
`xrslam_tpu_torch.api.XRSLAM` on `device` (the card unless "cpu" is
asked for), and the undistortion remap runs in the native host runtime
(`io.dataset.UndistortMap`).

Requires rospy (a ROS1 environment); everything ROS-specific is
import-gated so the rest of the package never depends on it.

Usage:
  rosrun <pkg> ros_node.py _slam_config:=euroc_slam.yaml \
                           _device_config:=euroc_sensor.yaml
  # or directly:
  python -m xrslam_tpu_torch.tools.ros_node --slam-config ... --device-config ... \
      [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .. import api
from ..config import Config, load_config
from ..io.dataset import UndistortMap


class RosVioNode:
    """Wraps api.XRSLAM with the reference node's ordering/publishing
    behavior. Constructed lazily so the class can be unit-tested
    without a ROS master by injecting fake messages via the handlers."""

    def __init__(self, config: Config,
                 image_topic: str = "/cam0/image_raw",
                 imu_topic: str = "/imu0", device="cuda"):
        self.config = config
        self.image_topic = image_topic
        self.imu_topic = imu_topic
        self.slam = api.XRSLAM(config=config, device=device)
        self._undistort: Optional[UndistortMap] = None
        if config.camera_distortion_flag:
            w, h = config.camera_resolution
            self._undistort = UndistortMap(
                np.asarray(config.camera_intrinsic),
                np.asarray(config.camera_distortion), int(w), int(h))
        # image buffer: frames wait until IMU catches up
        # (xrslam_node.cpp:95-130)
        self._pending_images: list = []
        self._last_imu_t = -np.inf
        self._path: list = []  # (t, q_xyzw, p)

    # ---- message handlers (rospy callbacks) ----
    def handle_imu(self, t: float, w: np.ndarray, a: np.ndarray) -> None:
        self.slam.push_sensor_data(api.SensorType.GYROSCOPE, t, w)
        self.slam.push_sensor_data(api.SensorType.ACCELERATION, t, a)
        self._last_imu_t = t
        self._drain()

    def handle_image(self, t: float, gray01: np.ndarray) -> None:
        if self._undistort is not None:
            gray01 = self._undistort(gray01)
        self._pending_images.append((t, gray01))
        self._drain()

    def _drain(self) -> None:
        while self._pending_images and self._pending_images[0][0] <= self._last_imu_t:
            t, img = self._pending_images.pop(0)
            self.slam.push_sensor_data(api.SensorType.CAMERA, t, img)
            self.slam.run_one_frame()
            if self.slam.get_result(api.ResultType.STATE) == \
                    api.State.TRACKING_SUCCESS:
                pose = self.slam.get_result(api.ResultType.BODY_POSE)
                self._path.append((pose.timestamp, pose.quaternion.copy(),
                                   pose.translation.copy()))
                self._publish(pose)

    def _publish(self, pose) -> None:  # overridden by the rospy runner
        pass


def run_rospy(config: Config, image_topic: str, imu_topic: str,
              frame_id: str = "world", device="cuda") -> None:
    import rospy
    from geometry_msgs.msg import PoseStamped
    from nav_msgs.msg import Path
    from sensor_msgs.msg import Image, Imu

    node = RosVioNode(config, image_topic, imu_topic, device=device)
    rospy.init_node("xrslam_tpu_torch")
    path_pub = rospy.Publisher("~path", Path, queue_size=2)
    pose_pub = rospy.Publisher("~pose", PoseStamped, queue_size=10)
    path_msg = Path()
    path_msg.header.frame_id = frame_id

    def publish(pose):
        ps = PoseStamped()
        ps.header.frame_id = frame_id
        ps.header.stamp = rospy.Time.from_sec(pose.timestamp)
        x, y, z, w = pose.quaternion
        ps.pose.orientation.x, ps.pose.orientation.y = x, y
        ps.pose.orientation.z, ps.pose.orientation.w = z, w
        (ps.pose.position.x, ps.pose.position.y,
         ps.pose.position.z) = pose.translation
        pose_pub.publish(ps)
        path_msg.header.stamp = ps.header.stamp
        path_msg.poses.append(ps)
        path_pub.publish(path_msg)

    node._publish = publish

    def on_imu(msg: Imu):
        t = msg.header.stamp.to_sec()
        w = np.array([msg.angular_velocity.x, msg.angular_velocity.y,
                      msg.angular_velocity.z])
        a = np.array([msg.linear_acceleration.x, msg.linear_acceleration.y,
                      msg.linear_acceleration.z])
        node.handle_imu(t, w, a)

    def on_image(msg: Image):
        arr = np.frombuffer(msg.data, dtype=np.uint8).reshape(
            msg.height, msg.step)[:, :msg.width]
        node.handle_image(msg.header.stamp.to_sec(),
                          arr.astype(np.float32) / 255.0)

    rospy.Subscriber(imu_topic, Imu, on_imu, queue_size=1000)
    rospy.Subscriber(image_topic, Image, on_image, queue_size=10)
    rospy.spin()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slam-config", required=True)
    ap.add_argument("--device-config", required=True)
    ap.add_argument("--image-topic", default="/cam0/image_raw")
    ap.add_argument("--imu-topic", default="/imu0")
    ap.add_argument("--device", default="cuda",
                    help='torch device (default "cuda"; "cpu" to run on the CPU)')
    args = ap.parse_args(argv)
    config = load_config(args.slam_config, args.device_config)
    run_rospy(config, args.image_topic, args.imu_topic, device=args.device)


if __name__ == "__main__":
    main()

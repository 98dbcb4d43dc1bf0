"""Optional thin ROS 1 adapter around the streaming pipeline.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/ros_adapter.py
(cloud_to_pointcloud2_msg :23, RosPseudoLidarNode :53). The reference
serves through a ROS graph (camera/kitti -> depth/output -> PL/output,
PointCloud2 fields x/y/z/i); the port's core is ROS-free
(pseudolidar/pipeline.py), and this module only translates messages at
its edges. Every ROS import is deferred to the call that needs it, so the
package imports and runs without a ROS installation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
    DepthToPointCloudPipeline,
    PipelineResult,
)


def cloud_to_pointcloud2_msg(points: np.ndarray, frame_id: str = "velodyne",
                             stamp=None):
    """[N, 4] cloud -> sensor_msgs/PointCloud2 with float32 fields x, y, z,
    i (16 bytes a point, little-endian), stamped now unless `stamp` is
    given."""
    import rospy
    from sensor_msgs.msg import PointCloud2, PointField
    from std_msgs.msg import Header

    header = Header(frame_id=frame_id)
    header.stamp = stamp if stamp is not None else rospy.Time.now()
    fields = [
        PointField(name=name, offset=4 * i, datatype=PointField.FLOAT32, count=1)
        for i, name in enumerate("xyzi")
    ]
    data = np.ascontiguousarray(points, dtype=np.float32)
    return PointCloud2(
        header=header,
        height=1,
        width=data.shape[0],
        is_dense=False,
        is_bigendian=False,
        fields=fields,
        point_step=16,
        row_step=16 * data.shape[0],
        data=data.tobytes(),
    )


class RosPseudoLidarNode:
    """Subscribes to a camera Image topic and publishes a PointCloud2 (and
    the depth Image) for each frame: one node for the reference's
    DepthPipeline + PseudoLidarPipeline pair, the depth -> cloud hop kept
    on the device. Each frame is one pipeline.process: on the card one
    replay of the pipeline's CUDA graph, captured and replayed on the
    subscriber's callback thread."""

    def __init__(
        self,
        pipeline: DepthToPointCloudPipeline,
        in_topic: str = "camera/kitti",
        out_topic: str = "PL/output",
        depth_topic: Optional[str] = "depth/output",
        size_hw=(192, 640),
    ):
        self.pipeline = pipeline
        self.in_topic = in_topic
        self.out_topic = out_topic
        self.depth_topic = depth_topic
        self.size_hw = size_hw
        self._frame = 0

    def start(self):
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image, PointCloud2

        from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import normalize_image

        rospy.init_node("pseudo_lidar", anonymous=True)
        bridge = CvBridge()
        cloud_pub = rospy.Publisher(self.out_topic, PointCloud2, queue_size=1)
        depth_pub = (rospy.Publisher(self.depth_topic, Image, queue_size=1)
                     if self.depth_topic else None)

        def callback(msg):
            img = bridge.imgmsg_to_cv2(msg, desired_encoding="rgb8")
            img = np.asarray(img, dtype=np.float32) / 255.0
            if img.shape[:2] != tuple(self.size_hw):
                from PIL import Image as PILImage

                img = np.asarray(
                    PILImage.fromarray((img * 255).astype(np.uint8)).resize(
                        (self.size_hw[1], self.size_hw[0])
                    ),
                    dtype=np.float32,
                ) / 255.0
            result: PipelineResult = self.pipeline.process(normalize_image(img), self._frame)
            self._frame += 1
            cloud_pub.publish(cloud_to_pointcloud2_msg(result.points, stamp=msg.header.stamp))
            if depth_pub is not None:
                depth_pub.publish(bridge.cv2_to_imgmsg(result.depth.astype(np.float32)))

        rospy.Subscriber(self.in_topic, Image, callback, queue_size=1)
        rospy.spin()

"""The online viewer (port of ``pi3_slam_tpu/viz``)."""

from .visualizer import OnlineVisualizer, SceneState, follow_camera_pose, render_keypoints_on_image

__all__ = ["OnlineVisualizer", "SceneState", "follow_camera_pose", "render_keypoints_on_image"]

"""Helpers for robotics scenes: articulated joints and RGB-D point clouds
(port of ``gstk_tpu/extra_toolkit``)."""

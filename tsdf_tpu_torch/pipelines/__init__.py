"""End-to-end fusion pipelines: rigid KinectFusion with ground-truth
poses or with ICP tracking against the raycast model (``kinfu``)."""

from .kinfu import FusionConfig, fuse_frames, track_and_fuse_frames

__all__ = ["FusionConfig", "fuse_frames", "track_and_fuse_frames"]

from .pipeline import (
    GroupStats,
    dominant_hand_mirror,
    frame_mask,
    mirror_lr,
    preprocess,
    resample_or_pad,
    thin_frames,
)

__all__ = [
    "GroupStats",
    "dominant_hand_mirror",
    "frame_mask",
    "mirror_lr",
    "preprocess",
    "resample_or_pad",
    "thin_frames",
]

"""
The port's media layer: streaming video read/write, still images and audio
muxing (the counterpart of gance_tpu/media/). The native AVI muxer is bound
in `media/native`. cv2 and PIL are imported only where they are used.
"""

from gance_tpu_torch.media.images import horizontal_concat_images, read_image, write_image
from gance_tpu_torch.media.video import (
    VideoFrames,
    add_wavs_to_video,
    create_video_writer,
    frames_in_video,
    reduce_fps_take_every,
    resize_source,
    scale_square_source_duplicate,
    write_source_to_disk_consume,
    write_source_to_disk_forward,
)

__all__ = [
    "VideoFrames",
    "frames_in_video",
    "reduce_fps_take_every",
    "create_video_writer",
    "write_source_to_disk_forward",
    "write_source_to_disk_consume",
    "add_wavs_to_video",
    "resize_source",
    "scale_square_source_duplicate",
    "read_image",
    "write_image",
    "horizontal_concat_images",
]

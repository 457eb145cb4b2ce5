"""Multi-object trackers over the detections of each frame (port of
``yolov10_3d_tpu/trackers``): ``BYTETracker`` and ``BOTSORT`` (with
``gmc.GMC``, the camera-motion estimate), numpy on the host."""

from .bot_sort import BOTSORT  # noqa: F401
from .byte_tracker import BYTETracker  # noqa: F401

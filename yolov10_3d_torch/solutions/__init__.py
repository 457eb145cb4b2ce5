"""Solution apps over tracked detections (port of
``yolov10_3d_tpu/solutions``): object counting, heatmaps, speed and
distance estimation and workout counting, numpy on the host, drawn by
``utils/plotting.py``'s Annotator (PIL's pixels)."""

from .ai_gym import AIGym  # noqa: F401
from .distance_calculation import DistanceCalculator  # noqa: F401
from .geometry import (  # noqa: F401
    point_in_polygon, point_segment_distance, polygon_centroid,
    polyline_distance, segments_intersect,
)
from .heatmap import Heatmap  # noqa: F401
from .object_counter import ObjectCounter  # noqa: F401
from .speed_estimation import SpeedEstimator  # noqa: F401

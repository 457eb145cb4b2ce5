"""PyTorch/CUDA port of yolov10_3d_tpu for NVIDIA Hopper.

Slice 1 serves YOLOv10 (n-x) NMS-free 2D detection: the YAML-built model,
the eval forward and the decode epilogue, whose DFL decode runs in a
hand-written CUDA kernel (``kernels/decode.py``) on the card. Module names
follow the JAX package so each counterpart is easy to find.

Everything here imports torch and numpy only; nothing imports jax, flax or
the JAX package.
"""

from .engine.model import YOLO, Model, YOLOv10
from .nn.build import build_model

__all__ = ["YOLO", "Model", "YOLOv10", "build_model"]

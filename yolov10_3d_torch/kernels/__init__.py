"""Hand-written Hopper kernels and their plain PyTorch twins.

Each kernel's wrapper counts its launches in ``launch_counts`` (one per
launch, nowhere else), so a run can show that its main path went through
the kernel. The twin runs only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

launch_counts: Dict[str, int] = {
    "decode_detect": 0,  # K1, kernels/decode.py
    "int8_mm_fused": 0,  # K2, kernels/int8.py
    "int8_conv3x3_fused": 0,  # K3, kernels/int8.py
    "int8_conv_f32": 0,  # kernels/int8.py
    "hsv_jitter": 0,  # K4, kernels/hsv.py
    "stem_conv": 0,  # the fused serving stem, kernels/stem.py
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0

"""Hand-written Hopper kernels and their plain PyTorch twins.

Each kernel's wrapper counts its launches in ``launch_counts`` (one per
launch, nowhere else), so a run can show that its main path went through
the kernel. The twin runs only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.

Inside a CUDA graph capture a wrapper still counts once, though the capture
only records the launch, and a replay runs no Python. So the code that
captures takes those counts back out with ``captured_launches`` and adds
them again with ``add_launches`` at every replay: a replay counts as one
launch of each kernel it holds.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

launch_counts: Dict[str, int] = {
    "decode_detect": 0,  # K1, kernels/decode.py
    "int8_mm_fused": 0,  # K2, kernels/int8.py
    "int8_conv3x3_fused": 0,  # K3, kernels/int8.py
    "int8_conv_f32": 0,  # kernels/int8.py
    "int8_group_conv_f32": 0,  # kernels/int8.py, csrc/int8_group_conv.cu (codes in)
    "int8_dw_conv_f32": 0,  # kernels/int8.py, csrc/int8_group_conv.cu (depthwise, float in)
    "int8_act_absmax": 0,  # the dynamic scale's reduction before int8_dw_conv_f32
    "hsv_jitter": 0,  # K4, kernels/hsv.py
    "stem_conv": 0,  # the fused serving stem, kernels/stem.py
    "nms_sweep": 0,  # the v8-family heads' NMS from the boxes, kernels/nms.py (one a call)
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Around a graph capture: yields a dict that holds, on exit, the
    launches the wrappers counted inside, and takes them out of
    ``launch_counts`` again (a capture launches nothing)."""
    before = dict(launch_counts)
    record: Dict[str, int] = {}
    try:
        yield record
    finally:
        for k in launch_counts:
            record[k] = launch_counts[k] - before[k]
            launch_counts[k] -= record[k]


def add_launches(record: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``record``."""
    for k, n in record.items():
        launch_counts[k] += n

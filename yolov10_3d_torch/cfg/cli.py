"""Command line of the port (the ``serve`` mode of ``yolov10_3d_tpu/cfg/cli.py``).

    python -m yolov10_3d_torch.cfg.cli serve model=yolov10s.yaml imgsz=640 \\
        conf=0.25 batch=32 max_delay_ms=10 host=127.0.0.1 port=8000 [device=cpu]

starts the dynamic-batching inference server (``engine/server.py``) on a
model built from its YAML with seeded random weights (checkpoint loading is
ROADMAP queue 1, item 5-ckpt), on the card unless ``device=cpu``. The other
modes of the JAX command line (train, val, predict, export, benchmark,
explorer) are ROADMAP queue 1, item 15.
"""

from __future__ import annotations

import ast
import sys
from typing import Any, Dict, List

HELP = """python -m yolov10_3d_torch.cfg.cli serve key=value ...

  model=yolov10s.yaml imgsz=640 conf=0.25 batch=32 max_delay_ms=10
  host=127.0.0.1 port=8000 device=cuda
"""


def parse_kv(args: List[str]) -> Dict[str, Any]:
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got {a!r}\n\n{HELP}")
        k, v = a.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def make_server(kv: Dict[str, Any]):
    """The ``InferenceServer`` of ``serve``'s key=value settings; returns
    (server, host, port). Unknown keys raise."""
    from ..engine.model import YOLOv10
    from ..engine.server import InferenceServer

    kv = dict(kv)
    model = YOLOv10(str(kv.pop("model", "yolov10n.yaml")), device=str(kv.pop("device", "cuda")))
    srv = InferenceServer(
        model,
        imgsz=kv.pop("imgsz", 640),
        conf=float(kv.pop("conf", 0.25)),
        max_batch=int(kv.pop("batch", 32)),
        max_delay_ms=float(kv.pop("max_delay_ms", 10.0)),
        devices=int(kv.pop("devices", 1)),
    )
    host, port = str(kv.pop("host", "127.0.0.1")), int(kv.pop("port", 8000))
    if kv:
        srv.batcher.stop()
        raise SystemExit(f"unknown serve keys {sorted(kv)}\n\n{HELP}")
    return srv, host, port


def entrypoint(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(HELP)
        return 0
    if argv[0] != "serve":
        raise NotImplementedError(
            f"mode {argv[0]!r}: the port's command line has the serve mode only; the others "
            "are ROADMAP queue 1, item 15")
    srv, host, port = make_server(parse_kv(argv[1:]))
    srv.serve(host=host, port=port)
    return 0


if __name__ == "__main__":
    sys.exit(entrypoint())

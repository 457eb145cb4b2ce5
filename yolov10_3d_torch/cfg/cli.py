"""Command line of the port (``yolov10_3d_tpu/cfg/cli.py``'s predict, val,
train and serve modes).

    python -m yolov10_3d_torch.cfg.cli [TASK] MODE key=value ...

    predict model=yolov10s.pt source=images/ imgsz=640 save=True [device=cpu]
    val model=runs/train/weights/best.ckpt data=coco128.yaml imgsz=640
    train model=yolov10s.yaml data=coco128.yaml epochs=100 imgsz=640
    detect3d train model=yolov10s_3D.yaml data=kitti.yaml
    serve model=yolov10s.yaml imgsz=640 conf=0.25 batch=32 max_delay_ms=10 \\
        host=127.0.0.1 port=8000

``model`` is a YAML (seeded random weights), a ``.ckpt`` or a ``.pt``; the
model runs on the card unless ``device=cpu``. TASK is optional, as in the
JAX command line (the model's head decides). ``predict`` prints each
frame's detections; ``val`` prints the metrics; ``train`` resumes from
``save_dir/weights/last.ckpt`` when it exists and ``resume`` is not given.
``serve`` starts the dynamic-batching inference server
(``engine/server.py``). ``export`` and ``benchmark`` are ROADMAP queue 1,
item 15; ``track`` is item 19.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Any, Dict, List

TASKS = {"detect", "detect3d", "segment", "classify", "pose", "obb"}
MODES = {"train", "val", "predict", "export", "track", "benchmark"}
UNPORTED_MODES = {"export": "15", "benchmark": "15", "track": "19"}

HELP = """python -m yolov10_3d_torch.cfg.cli [TASK] MODE key=value ...

  MODE: predict | val | train | serve
  predict model=yolov10s.pt source=images/ imgsz=640 save=True
  val model=best.ckpt data=coco128.yaml imgsz=640
  train model=yolov10s.yaml data=coco128.yaml epochs=100 imgsz=640
  serve model=yolov10s.yaml imgsz=640 conf=0.25 batch=32 max_delay_ms=10
        host=127.0.0.1 port=8000
  every mode: device=cuda (default) or device=cpu
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
    if argv[0] == "serve":
        srv, host, port = make_server(parse_kv(argv[1:]))
        srv.serve(host=host, port=port)
        return 0
    task, mode, rest = None, None, []
    for a in argv:
        if a in TASKS and task is None:
            task = a
        elif a in MODES and mode is None:
            mode = a
        else:
            rest.append(a)
    kv = parse_kv(rest)
    mode = mode or str(kv.pop("mode", "predict"))
    if mode in UNPORTED_MODES:
        raise NotImplementedError(f"mode {mode!r} is not ported: ROADMAP queue 1, item "
                                  f"{UNPORTED_MODES[mode]}")
    if mode not in ("predict", "val", "train"):
        raise SystemExit(f"unknown mode {mode!r}\n\n{HELP}")
    from ..engine.model import YOLOv10

    model = YOLOv10(str(kv.pop("model", "yolov10n.yaml")), device=str(kv.pop("device", "cuda")))
    if mode == "predict":
        source = kv.pop("source", None)
        if source is None:
            raise SystemExit("predict requires source=...")
        for r in model.predict(source, **kv):
            print(f"{r.path}: {len(r)} detections")
            for d in r.summary():
                print(f"  {d['name']} {d['confidence']:.3f} {d['box']}")
        return 0
    if mode == "val":
        res = model.val(**kv)
        print({k: round(v, 5) for k, v in res.items() if isinstance(v, float)})
        return 0
    last = Path(str(kv.get("save_dir", "runs/train"))) / "weights" / "last.ckpt"
    if "resume" not in kv and last.exists():
        print(f"resuming from existing checkpoint {last}")
        kv["resume"] = True
    model.train(**kv)
    return 0


if __name__ == "__main__":
    sys.exit(entrypoint())

"""Native checkpoint save and load (the port's copy of
``yolov10_3d_tpu/utils/checkpoint.py``, on the port's own msgpack codec,
``utils/msgpack.py``).

The file: ``MAGIC``, the 8-byte little-endian length of a JSON meta header,
the header, then the msgpack blob of ``{params, batch_stats, ema_params,
opt_state}``. Trees are nested dicts of numpy arrays in the flax layout
(``utils/weights.py`` ``torch_to_flax_variables``), with every dict's keys
sorted, as the JAX package writes them, so that either package reads what
the other writes and the same tree gives the same bytes.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import msgpack

MAGIC = b"Y10TPU1\n"


def to_numpy_tree(tree: Any) -> Any:
    """Dicts with their keys sorted (as ``jax.tree.map`` rebuilds them),
    lists kept, and every leaf an ndarray (torch tensors by their values;
    bfloat16 ones stay tensors, which the codec writes as flax does)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to the host, one copy per leaf,
    so that a thread may encode them while the originals change (on a CPU
    model ``.cpu()`` alone would hand back the live storage). Other leaves
    are kept as they are."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
    return tree


def save_checkpoint(
    path,
    *,
    params: Any,
    batch_stats: Any = None,
    ema_params: Any = None,
    opt_state: Any = None,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the file atomically (a sibling ``.tmp``, then a rename). ``meta``
    holds JSON: model_yaml, nc, names, epoch, best_fitness, train_args, step."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = to_numpy_tree({
        "params": params,
        "batch_stats": batch_stats or {},
        "ema_params": ema_params or {},
        "opt_state": opt_state if opt_state is not None else {},
    })
    parts = msgpack.pack_parts(tree)
    header = json.dumps(meta or {}).encode()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for part in parts:
            f.write(part)
    tmp.replace(path)
    return str(path)


def load_checkpoint(path) -> Dict[str, Any]:
    """{params, batch_stats, ema_params, opt_state, meta}."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not a yolov10_3d_tpu checkpoint")
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        tree = msgpack.unpackb(f.read())
    tree["meta"] = meta
    return tree


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def strip_optimizer(path, out_path=None) -> str:
    """Drop the optimizer state, promote the EMA weights to ``params`` and
    halve float32 leaves to float16 (the JAX ``strip_optimizer``): about a
    4x smaller file for distribution."""
    ckpt = load_checkpoint(path)
    params = ckpt.get("ema_params") or ckpt["params"]

    def halve(x):
        x = np.asarray(x)
        return x.astype(np.float16) if x.dtype == np.float32 else x

    meta = dict(ckpt.get("meta") or {})
    meta["stripped"] = True
    return save_checkpoint(
        out_path or path,
        params=_map_leaves(halve, params),
        batch_stats=_map_leaves(halve, ckpt.get("batch_stats") or {}),
        ema_params=None,
        opt_state=None,
        meta=meta,
    )


class AsyncCheckpointer:
    """Writes checkpoints on one background thread.

    The caller hands over host trees that nothing else will change (the
    trainer's snapshot copies every leaf); encoding and the atomic write run
    here, so the train loop never waits on the disk. At most one pending
    write per path: a newer submit replaces a queued one (last write wins,
    which is what ``last.ckpt`` means). A write's error is raised on the
    next ``submit`` or ``wait``. ``submitted``, ``written`` and ``superseded``
    count the writes; ``write_seconds`` holds each write's encode-and-write
    time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[str, dict] = {}
        self._error: Optional[BaseException] = None
        self._wake = threading.Event()
        self._stop = False
        self._idle = threading.Event()
        self._idle.set()
        self.submitted = self.written = self.superseded = 0
        self.write_seconds: List[float] = []
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            self._wake.wait()
            with self._lock:
                if not self._pending:
                    self._wake.clear()
                    self._idle.set()
                    if self._stop:
                        return
                    continue
                path, item = next(iter(self._pending.items()))
                del self._pending[path]
                self._idle.clear()
            try:
                t0 = time.perf_counter()
                save_checkpoint(path, **item)
                with self._lock:
                    self.write_seconds.append(time.perf_counter() - t0)
                    self.written += 1
            except BaseException as e:  # raised on the next submit() or wait()
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    if not self._pending:
                        self._idle.set()

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, path, **save_kwargs):
        """Queue a write of host trees (``save_checkpoint``'s keywords)."""
        self._raise_pending_error()
        with self._lock:
            if str(path) in self._pending:
                self.superseded += 1
            self._pending[str(path)] = save_kwargs
            self.submitted += 1
            self._idle.clear()
            self._wake.set()

    def wait(self):
        """Block until every queued write is on disk; raise a write's error."""
        while True:
            with self._lock:
                empty = not self._pending
            if empty and self._idle.is_set():
                break
            time.sleep(0.005)
        self._raise_pending_error()

    @property
    def closed(self) -> bool:
        return self._stop

    def close(self):
        """Drain the queue and stop the thread."""
        try:
            self.wait()
        finally:
            with self._lock:
                self._stop = True
                self._wake.set()
            self._thread.join()

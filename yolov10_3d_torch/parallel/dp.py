"""Data-parallel training with the JAX package's global-batch semantics
(port of the dp axis of ``yolov10_3d_tpu/parallel/mesh.py``).

JAX runs one jitted step over the global batch, sharded by rows, so a dp
step is the one-device step on the same global batch. Here each rank is a
process with its own device, and the step is made global where it reduces
over the batch:

- every rank loads the same global batch (same loader, same seed) and keeps
  rows ``[r B / n, (r + 1) B / n)`` (``rows``);
- BatchNorm takes its statistics over the global batch: the trainer swaps
  the model's BatchNorm modules for ``GlobalBatchNorm2d``
  (``global_batchnorm``), which sums the per-channel moments over the
  ranks with autograd through the reduction;
- the losses divide by global counts and scale by the global batch size:
  the trainer hands them the group (``DataParallel.sum``, ``.world``), so
  the ranks' losses sum to the global loss;
- the step sums the ranks' gradients (``DataParallel.sum_grads``, not
  DDP's mean), so every rank applies the same update, and the EMA and
  optimizer stay identical on every rank.

``launch`` runs rank 0 in the calling process and ranks 1..n-1 in spawned
processes, joined to one process group through a file in a fresh temporary
directory: NCCL for distinct CUDA devices, gloo otherwise (NCCL refuses two
ranks on one device; gloo also serves CPU ranks).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

TIMEOUT = datetime.timedelta(minutes=30)  # a collective waiting on a lost rank raises


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's rank in a group of ``world``; the batch reductions the
    losses and the step take (``train/loss.py`` ``ONE_PROCESS`` is the
    same interface for one process)."""
    rank: int
    world: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, outside autograd (counts and
        normalisers)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    @torch.no_grad()
    def sum_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every parameter's gradient over the ranks (one flat buffer per
        dtype; a parameter without a gradient counts as zeros)."""
        by_dtype: dict = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        for group in by_dtype.values():
            flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                              for p in group])
            dist.all_reduce(flat)
            offset = 0
            for p in group:
                n = p.numel()
                g = flat[offset:offset + n].view_as(p)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
                offset += n


_CURRENT: Optional[DataParallel] = None


def current() -> Optional[DataParallel]:
    """The data-parallel group this process trains in, or None."""
    return _CURRENT


def world() -> int:
    return _CURRENT.world if _CURRENT is not None else 1


def is_main() -> bool:
    return _CURRENT is None or _CURRENT.rank == 0


def parse_devices(device: Union[None, str, int, Sequence]) -> Optional[List[str]]:
    """The devices of a device list, one per rank, or None for one device:
    ``"0,1"`` or ``[0, 1]`` -> ``["cuda:0", "cuda:1"]``; ``"cpu"`` entries
    are CPU ranks."""
    if isinstance(device, (list, tuple)):
        items = [str(d).strip() for d in device]
    elif isinstance(device, str) and "," in device:
        items = [d.strip() for d in device.split(",") if d.strip()]
    else:
        return None
    return [f"cuda:{d}" if d.isdigit() else d for d in items]


def backend_for(devices: Sequence[str]) -> str:
    """NCCL for distinct CUDA devices; gloo for CPU ranks or shared devices."""
    cuda = all(d.startswith("cuda") for d in devices)
    return "nccl" if cuda and len(set(devices)) == len(devices) else "gloo"


def global_batch(batch: int, n: int) -> int:
    """The global batch of ``n`` ranks: rounded down to a multiple of n, at
    least n (JAX's ``args.batch - args.batch % n_dev``)."""
    return batch - batch % n if batch >= n else n


def rows(n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global``."""
    if _CURRENT is None:
        return slice(0, n_global)
    per = n_global // _CURRENT.world
    return slice(_CURRENT.rank * per, (_CURRENT.rank + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the ranks' gradients (the
    gradient of the sum of their losses)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """A BatchNorm that trains on the global batch of the ranks: the mean and
    the mean squared deviation in the parameters' dtype from the ranks'
    per-channel sums (autograd through the reduction), the running
    statistics updated with torch's momentum and the Bessel factor of the
    global count, the output in the input's dtype. In eval it is torch's."""

    world: int = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1] * self.world
        xf = x.to(self.weight.dtype)
        mean = _AllReduceSum.apply(xf.sum((0, 2, 3))) / n
        d = xf - mean[:, None, None]
        var = _AllReduceSum.apply((d * d).sum((0, 2, 3))) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * (n / max(n - 1, 1) * m))
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (d * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def global_batchnorm(model: nn.Module) -> nn.Module:
    """``model`` with every ``nn.BatchNorm2d`` made a ``GlobalBatchNorm2d``
    of this process's group (in place: the same parameters and buffers, the
    same state-dict keys); unchanged without a group."""
    if _CURRENT is None:
        return model
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
            m.world = _CURRENT.world
    return model


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values in ``tensors`` on every rank."""
    if _CURRENT is None:
        return
    for t in tensors:
        dist.broadcast(t, 0)


def broadcast_float(x: float, device: torch.device) -> float:
    """Rank 0's ``x`` on every rank."""
    if _CURRENT is None:
        return x
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    dist.broadcast(t, 0)
    return float(t.item())


def _join(rank: int, n: int, devices: Sequence[str], init_file: str) -> None:
    global _CURRENT
    dev = devices[rank]
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    dist.init_process_group(backend_for(devices), init_method=f"file://{init_file}", rank=rank,
                            world_size=n, timeout=TIMEOUT)
    _CURRENT = DataParallel(rank, n)


def _leave() -> None:
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn: Callable, args: Any, rank: int, devices: Sequence[str], init_file: str,
               threads: int) -> None:
    torch.set_num_threads(threads)
    _join(rank, len(devices), devices, init_file)
    try:
        fn(args, rank, devices[rank])
    finally:
        _leave()


def launch(fn: Callable[[Any, int, str], Any], args: Any, devices: Sequence[str],
           main: Optional[Callable[[], Any]] = None) -> Any:
    """Run ``fn(args, rank, device)`` on every rank of ``devices`` (rank 0:
    ``main()`` when given) and return rank 0's result. Rank 0 runs here;
    ranks 1..n-1 run in spawned processes (``fn`` and ``args`` must
    pickle), each holding torch at this process's thread count. The
    children are joined, or terminated when rank 0 raises; a child that
    failed raises here."""
    import torch.multiprocessing as mp

    n = len(devices)
    tmp = tempfile.mkdtemp(prefix="yolo-dp-")
    init_file = os.path.join(tmp, "init")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, list(devices), init_file, torch.get_num_threads()))
             for r in range(1, n)]
    for p in procs:
        p.start()
    ok = False
    try:
        _join(0, n, devices, init_file)
        try:
            out = main() if main is not None else fn(args, 0, devices[0])
        finally:
            _leave()
        ok = True
    finally:
        for p in procs:
            if not ok:
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"data-parallel ranks {failed} failed (exit codes "
                           f"{[procs[r - 1].exitcode for r in failed]})")
    return out

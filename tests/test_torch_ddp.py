"""Data-parallel training (``parallel/dp.py``) on the CPU: its pieces in
this process (the global BatchNorm in a one-rank group, device lists and
JAX's batch rounding). Two gloo ranks against one process stepping on the
global batch, as JAX's dp step equals its one-device step on the global
batch, are the trainers' device-list cases (``tests/test_torch_augment.py``,
``tests/test_torch_train3d.py``).
"""

import copy

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_torch.parallel import dp


def test_global_batchnorm_at_world_one(tmp_path):
    """``GlobalBatchNorm2d`` in a one-rank gloo group (this process) is
    torch's BatchNorm: the same output, input and parameter gradients and
    running statistics (Bessel factor of the count), in float32 and with
    a bfloat16 input (amp); ``DataParallel.sum`` and ``sum_grads`` are
    identities there. Without a group ``global_batchnorm`` changes
    nothing."""
    model = torch.nn.Sequential(torch.nn.BatchNorm2d(8, eps=1e-3, momentum=0.03))
    assert type(dp.global_batchnorm(model)[0]) is torch.nn.BatchNorm2d
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 8, 6, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 8, 6, 5)).astype(np.float32))
    dp._join(0, 1, ["cpu"], str(tmp_path / "init"))
    try:
        ranks = dp.current()
        for dtype in (torch.float32, torch.bfloat16):
            ref = model[0]
            glob = dp.global_batchnorm(copy.deepcopy(torch.nn.Sequential(ref)))[0]
            assert isinstance(glob, dp.GlobalBatchNorm2d) and glob.world == 1
            outs = []
            for bn in (ref, glob):
                bn.train()
                xi = x.to(dtype).clone().requires_grad_()
                bn.zero_grad()
                y = bn(xi)
                y.float().mul(g).sum().backward()
                outs.append((y, xi.grad, bn.weight.grad.clone(), bn.bias.grad.clone(),
                             bn.running_mean.clone(), bn.running_var.clone()))
                assert y.dtype == dtype
            tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
                dict(rtol=2 ** -7, atol=2 ** -7)
            for a, b in zip(*outs):
                torch.testing.assert_close(b.float(), a.float(), **tol)
            glob.load_state_dict(ref.state_dict())  # eval: torch's own BatchNorm
            torch.testing.assert_close(glob.eval()(x), ref.eval()(x), rtol=0, atol=0)
        t = torch.arange(4.0)
        assert torch.equal(ranks.sum(t), t)
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.arange(3.0)
        ranks.sum_grads([p])
        assert torch.equal(p.grad, torch.arange(3.0))
    finally:
        dp._leave()
    assert dp.current() is None


@pytest.mark.parametrize("device,devices,backend,batch", [
    ("0,1", ["cuda:0", "cuda:1"], "nccl", 14), ([0, 0], ["cuda:0", "cuda:0"], "gloo", 15),
    ("cpu,cpu,cpu", ["cpu"] * 3, "gloo", 2),
])
def test_device_lists(device, devices, backend, batch):
    """A device list: one rank a device, NCCL only for distinct cards, the
    batch rounded down to a multiple of the ranks and at least one each
    (JAX's rule); one device is no list."""
    assert dp.parse_devices(device) == devices
    assert dp.backend_for(devices) == backend
    assert dp.global_batch(batch, len(devices)) == {14: 14, 15: 14, 2: 3}[batch]
    assert dp.parse_devices("cuda:0") is None and dp.parse_devices("cpu") is None

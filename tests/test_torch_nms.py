"""The port's NMS and v8-family epilogues against the JAX package's, on the
same numpy inputs: ``non_max_suppression`` (ties, rows under conf,
agnostic, the ``extra`` payload, fewer anchors than ``pre_topk``), the
rotated NMS of the OBB validator, ``nms_numpy``, ``v8_detections`` from raw
maps, and ``decode_kpts``, ``decode_obb_angle``, ``process_masks`` and
``probiou``. On the CPU the sweep is its twin (``kernels/nms.py``), JAX's
loop in PyTorch; the card test of the kernel holds it to that twin bit for
bit (``tests/test_torch_kernels.py``).

Keep masks, labels, indices and the order of the kept rows must be equal;
floats equal too where both sides gather the same values (boxes, scores,
payload), and within 1e-6 for the epilogues' arithmetic.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.engine.validator_tasks import OBBValidator as JaxOBBValidator
from yolov10_3d_tpu.ops import boxes as JB
from yolov10_3d_tpu.ops import nms as JN
from yolov10_3d_tpu.ops import postprocess as JP
from yolov10_3d_torch.engine.validator_tasks import OBBValidator
from yolov10_3d_torch.kernels import nms as KN
from yolov10_3d_torch.ops import boxes as B
from yolov10_3d_torch.ops import nms as N
from yolov10_3d_torch.ops import postprocess as P

EPILOGUE_TOL = 1e-6


def _preds(seed: int, b: int, a: int, nc: int, grid: bool):
    """(b, a, 4 + nc) xywh + scores; ``grid``: coordinates on a pixel grid
    and scores in steps of 1/32 (exact IoU and score ties), a third of the
    rows under 0.25."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 120, (b, a, 2))
    wh = rng.uniform(4, 50, (b, a, 2))
    scores = rng.uniform(0, 1, (b, a, nc))
    if grid:
        xy, wh, scores = np.round(xy), np.round(wh), np.round(scores * 32) / 32
        scores[:, ::3] *= 0.2
        xy[:, 1::5], wh[:, 1::5] = xy[:, ::5][:, : xy[:, 1::5].shape[1]], wh[:, ::5][
            :, : wh[:, 1::5].shape[1]]
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


def _eq(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, (want.shape, got.shape)
    assert np.array_equal(want.astype(got.dtype), got), np.abs(want - got).max()


def test_non_max_suppression_matches_jax():
    """Every output equal, over ties, rows under conf, agnostic, extra, and
    A < pre_topk (K = A) and A > pre_topk (the pre-top-k cut)."""
    cases = [dict(seed=0, a=300, grid=True), dict(seed=1, a=300, grid=True, agnostic=True),
             dict(seed=2, a=40, grid=False, max_det=60), dict(seed=3, a=1500, grid=True),
             dict(seed=4, a=200, grid=False, iou=0.45, conf=0.5)]
    for c in cases:
        preds = _preds(c["seed"], 2, c["a"], 5, c["grid"])
        extra = np.random.default_rng(c["seed"]).normal(size=(2, c["a"], 7)).astype(np.float32)
        kw = dict(conf_thres=c.get("conf", 0.25), iou_thres=c.get("iou", 0.7),
                  max_det=c.get("max_det", 100), agnostic=c.get("agnostic", False))
        fn = jax.jit(functools.partial(JN.non_max_suppression, **kw))
        want = fn(jnp.asarray(preds), extra=jnp.asarray(extra))
        got = N.non_max_suppression(torch.from_numpy(preds), extra=torch.from_numpy(extra), **kw)
        assert int(np.asarray(want[3]).sum()) > 5, c
        for w, g in zip(want, got):
            _eq(w, g)


def test_rotated_nms_matches_jax_obb_validator():
    """The OBB validator's forward from the same maps: JAX's ``_forward_fn``
    with a model that returns them, the port's ``OBBValidator.forward``."""
    rng = np.random.default_rng(5)
    shapes, nc = [(8, 8), (4, 4), (2, 2)], 3
    det = [rng.normal(size=(2, h, w, 64 + nc)).astype(np.float32) for h, w in shapes]
    for d in det:
        d[..., 64:] *= 3  # spread scores, some under conf
    angle = [rng.normal(size=(2, h, w, 1)).astype(np.float32) for h, w in shapes]

    class Maps:
        def apply(self, v, x, train=False):
            return v

    class Spec:
        strides = (8, 16, 32)

    Spec.nc = nc

    class PortMaps(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x):
            nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()  # noqa: E731
            return {"det": [nchw(d) for d in det], "angle": [nchw(a) for a in angle]}

    x = np.zeros((2, 64, 64, 3), np.float32)
    for conf, iou, max_det in ((0.001, 0.7, 300), (0.25, 0.3, 20)):
        fwd = JaxOBBValidator(Maps(), Spec())._forward_fn(max_det, conf, iou)
        want = fwd({"det": [jnp.asarray(d) for d in det],
                    "angle": [jnp.asarray(a) for a in angle]}, jnp.asarray(x))
        got = OBBValidator(PortMaps(), Spec()).forward(torch.from_numpy(x), max_det, conf, iou)
        assert int(np.asarray(want[3]).sum()) > 3
        _eq(want[3], got[3])
        _eq(want[2], got[2])
        np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.asarray(want[1]), got[1].numpy(), atol=1e-6, rtol=0)


def _jax_rot_sweep(rb, lb, ok, iou):
    """The OBB validator's rotated sweep of one image (``rot_nms`` in
    ``engine/validator_tasks.py``, local to its forward), written out."""
    k = rb.shape[0]
    pair = JB.probiou(rb[:, None, :], rb[None, :, :])
    pair = jnp.where(lb[:, None] == lb[None, :], pair, 0.0)
    pair = jnp.where(ok[None, :] & ok[:, None], pair, 0.0)

    def body(i, keepm):
        row = (pair[i] > iou) & (jnp.arange(k) > i) & keepm[i]
        return keepm & ~row

    return jax.lax.fori_loop(0, k, body, jnp.ones(k, bool)) & ok


@pytest.mark.parametrize("entry", ["iou", "rotated"])
def test_nms_twin_entries_match_jax(entry):
    """The NMS kernel's twins from the boxes (``kernels/nms.py``), image by
    image, against JAX's sweeps on the same numpy inputs: ``nms_fixed``
    (pixel-grid boxes: IoU ties at 0.5, duplicates) and the OBB validator's
    rotated sweep (3 labels, a fifth of the rows failing ok)."""
    rng = np.random.default_rng(9)
    if entry == "iou":
        xy = np.round(rng.uniform(0, 60, (2, 150, 2)))
        boxes = np.concatenate([xy, xy + np.round(rng.uniform(2, 20, (2, 150, 2)))],
                               -1).astype(np.float32)
        boxes[:, 1::6] = boxes[:, ::6][:, : boxes[:, 1::6].shape[1]]
        got = KN.nms_iou(torch.from_numpy(boxes), 0.5, torch.ones((2, 150), dtype=torch.bool))
        fn = jax.jit(lambda b: JN.nms_fixed(b, jnp.zeros(b.shape[0]), 0.5))
        want = np.stack([np.asarray(fn(jnp.asarray(b))) for b in boxes])
    else:
        rb = np.concatenate([rng.uniform(0, 100, (2, 150, 2)), rng.uniform(4, 40, (2, 150, 2)),
                             rng.uniform(-1.5, 1.5, (2, 150, 1))], -1).astype(np.float32)
        lb = rng.integers(0, 3, (2, 150))
        ok = rng.uniform(size=(2, 150)) < 0.8
        got = KN.nms_rotated(torch.from_numpy(rb), torch.from_numpy(lb), 0.3,
                             torch.from_numpy(ok))
        fn = jax.jit(functools.partial(_jax_rot_sweep, iou=0.3))
        want = np.stack([np.asarray(fn(jnp.asarray(r), jnp.asarray(b), jnp.asarray(o)))
                         for r, b, o in zip(rb, lb, ok)])
    assert 10 < int(want.sum()) < want.size  # some kept, some removed
    _eq(want, got)


def test_nms_numpy_matches_jax():
    rng = np.random.default_rng(6)
    for n in (1, 30, 200):
        xy = np.round(rng.uniform(0, 100, (n, 2)))
        boxes = np.concatenate([xy, xy + np.round(rng.uniform(5, 40, (n, 2)))], -1)
        scores = np.round(rng.uniform(0, 1, n) * 16) / 16  # ties
        for thr in (0.3, 0.7):
            assert np.array_equal(JN.nms_numpy(boxes, scores, thr), N.nms_numpy(boxes, scores, thr))


def test_v8_detections_match_jax():
    """Decode + NMS from raw maps (NHWC to JAX, NCHW to the port)."""
    rng = np.random.default_rng(7)
    shapes, nc = [(16, 16), (8, 8), (4, 4)], 4
    maps = [rng.normal(size=(2, h, w, 64 + nc)).astype(np.float32) * 2 for h, w in shapes]
    fn = jax.jit(functools.partial(JP.v8_detections, strides=(8, 16, 32), nc=nc, conf=0.1,
                                   max_det=50))
    want = fn([jnp.asarray(m) for m in maps])
    got = P.v8_detections([torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps],
                          (8, 16, 32), nc, conf=0.1, max_det=50)
    assert int(np.asarray(want["valid"]).sum()) > 10
    for k in ("valid", "labels"):
        _eq(want[k], got[k])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(np.asarray(want[k]), got[k].numpy(), atol=1e-4, rtol=1e-6)


def test_task_epilogues_match_jax():
    """decode_kpts, decode_obb_angle, process_masks and probiou within 1e-6
    (the pixel outputs relative to their size). probiou of near-identical
    boxes (above 0.95) takes sqrt(1 - exp(-bd)) of a tiny bd, where one ulp
    of exp (XLA's and torch's differ) moves the result by up to 7e-5: those
    pairs are held to 1e-4, far from any NMS threshold."""
    rng = np.random.default_rng(8)
    shapes, strides = [(8, 8), (4, 4), (2, 2)], (8, 16, 32)
    kp = [rng.normal(size=(2, h, w, 51)).astype(np.float32) for h, w in shapes]
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    want = np.asarray(jax.jit(lambda f: JP.decode_kpts(f, strides, (17, 3)))(kp))
    got = P.decode_kpts([nchw(a) for a in kp], strides, (17, 3)).numpy()
    np.testing.assert_allclose(want, got, rtol=EPILOGUE_TOL, atol=EPILOGUE_TOL)
    ang = [rng.normal(size=(2, h, w, 1)).astype(np.float32) * 3 for h, w in shapes]
    np.testing.assert_allclose(np.asarray(jax.jit(JP.decode_obb_angle)(ang)),
                               P.decode_obb_angle([nchw(a) for a in ang]).numpy(),
                               rtol=EPILOGUE_TOL, atol=EPILOGUE_TOL)

    protos = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    coefs = rng.normal(size=(2, 10, 32)).astype(np.float32) * 0.3
    xy = rng.uniform(0, 50, (2, 10, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (2, 10, 2))], -1).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, c, b: JP.process_masks(p, c, b, (64, 64)))(
        protos, coefs, boxes))
    got = P.process_masks(nchw(protos), torch.from_numpy(coefs), torch.from_numpy(boxes),
                          (64, 64)).numpy()
    np.testing.assert_allclose(want, got, rtol=0, atol=EPILOGUE_TOL)
    assert np.array_equal(want > 0, got > 0)  # the crops are the same pixels

    ob = np.concatenate([rng.uniform(0, 100, (40, 2)), rng.uniform(2, 60, (40, 2)),
                         rng.uniform(-np.pi, np.pi, (40, 1))], -1).astype(np.float32)
    ob[5] = ob[4]  # identical boxes
    want = np.asarray(jax.jit(JB.probiou)(ob[:, None], ob[None]))
    got = B.probiou(torch.from_numpy(ob)[:, None], torch.from_numpy(ob)[None]).numpy()
    far = want < 0.95
    assert far.sum() > 1500
    np.testing.assert_allclose(want[far], got[far], rtol=0, atol=EPILOGUE_TOL)
    np.testing.assert_allclose(want[~far], got[~far], rtol=0, atol=1e-4)

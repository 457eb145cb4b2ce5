"""The port's training losses against the JAX package on the CPU: box
geometry, the task-aligned assigner, the v10 dual-assignment loss (its six
terms and total) and its gradients with respect to the head maps, and the
head's bias init."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.nn.heads import detect_bias_init as jax_detect_bias_init
from yolov10_3d_tpu.ops import boxes as JB
from yolov10_3d_tpu.train import loss as JL
from yolov10_3d_tpu.train.tal import assign as jax_assign
from yolov10_3d_torch.nn.heads import detect_bias_init
from yolov10_3d_torch.ops import boxes as PB
from yolov10_3d_torch.train import loss as PL
from yolov10_3d_torch.train.tal import assign
from yolov10_3d_torch.utils.weights import load_flax_variables

from _helpers import build_jax

NC = 80
STRIDES = (8, 16, 32)
SHAPES = [(8, 8), (4, 4), (2, 2)]  # 64 x 64 input


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread is as fast, and the test
    workers that run side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _boxes(rng, n, lo=0.0, hi=64.0, size=(2, 12)):
    """(n, 4) xyxy boxes of sides in ``size`` inside [lo, hi]."""
    xy = rng.uniform(lo, hi - size[1], (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_bbox_ciou_and_bbox2dist_match_jax():
    """CIoU of xyxy boxes (the JAX bbox_iou as the loss and the assigner call
    it), bbox2dist and xywh2xyxy on random boxes. Bar: 1e-6 abs."""
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 500), _boxes(rng, 500)
    b2[:100] = b1[:100] + rng.normal(0, 1, (100, 4)).astype(np.float32)  # overlapping pairs
    want = np.asarray(JB.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=False, ciou=True))
    np.testing.assert_allclose(PB.bbox_ciou(_t(b1), _t(b2)).numpy(), want, rtol=0, atol=1e-6)
    pts = rng.uniform(0, 64, (500, 2)).astype(np.float32)
    want = np.asarray(JB.bbox2dist(jnp.asarray(pts), jnp.asarray(b1), 15))
    np.testing.assert_allclose(PB.bbox2dist(_t(pts), _t(b1), 15).numpy(), want, rtol=0, atol=1e-6)
    want = np.asarray(JB.xywh2xyxy(jnp.asarray(b1)))
    np.testing.assert_allclose(PB.xywh2xyxy(_t(b1)).numpy(), want, rtol=0, atol=1e-6)


def _assign_case(seed, B=2, M=6, C=5):
    rng = np.random.default_rng(seed)
    anc, _ = JB.make_anchors(SHAPES, STRIDES, 0.5)
    anc = np.asarray(anc * np.asarray(JB.make_anchors(SHAPES, STRIDES, 0.5)[1]))
    A = anc.shape[0]
    scores = rng.uniform(0.01, 0.99, (B, A, C)).astype(np.float32)  # continuous: no ties
    centre = np.repeat(anc[None], B, 0)
    half = rng.uniform(2, 14, (B, A, 2)).astype(np.float32)
    pd = np.concatenate([centre - half, centre + half], -1).astype(np.float32)
    gt = np.stack([_boxes(rng, M, 0, 64, (12, 40)) for _ in range(B)])
    labels = rng.integers(0, C, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    mask[1, -2:] = False
    return scores, pd, anc, labels, gt, mask


@pytest.mark.parametrize("topk", [10, 1])
def test_assign_matches_jax(topk):
    """fg_mask and the fg anchors' target_gt_idx equal; target_scores and
    target_bboxes within 1e-5 (random scores, no ties)."""
    scores, pd, anc, labels, gt, mask = _assign_case(topk)
    fn = jax.jit(functools.partial(jax_assign, topk=topk, num_classes=5))
    want = fn(*(jnp.asarray(a) for a in (scores, pd, anc, labels, gt, mask)))
    got = assign(*(_t(a) for a in (scores, pd, anc, labels, gt, mask)), topk=topk)
    fg = np.asarray(want.fg_mask)
    assert fg.sum() >= 8  # topk 1: at most one anchor per valid GT (10)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg], np.asarray(want.target_gt_idx)[fg])
    np.testing.assert_array_equal(got.target_labels.numpy()[fg], np.asarray(want.target_labels)[fg])
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(want.target_bboxes),
                               rtol=0, atol=1e-5)


def _loss_case(seed, B=2, M=5):
    """Raw head maps of both branches (NHWC for JAX) and padded targets."""
    rng = np.random.default_rng(seed)
    maps = {br: [rng.normal(0, 2, (B, h, w, 64 + NC)).astype(np.float32) for h, w in SHAPES]
            for br in ("one2many", "one2one")}
    xy = rng.uniform(0.2, 0.8, (B, M, 2))
    wh = rng.uniform(0.1, 0.5, (B, M, 2))
    batch = {
        "gt_labels": rng.integers(0, NC, (B, M)).astype(np.int32),
        "gt_bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
        "mask_gt": np.array([[True] * M, [True] * (M - 2) + [False] * 2]),
    }
    return maps, batch


def _port_inputs(maps, batch, grad=False):
    pm = {br: [_t(m.transpose(0, 3, 1, 2)).requires_grad_(grad) for m in ms]
          for br, ms in maps.items()}
    return pm, {k: _t(v) for k, v in batch.items()}


def _jax_loss():
    return jax.jit(functools.partial(JL.v10_detect_loss, nc=NC, strides=STRIDES,
                                     gains=(5.0, 1.0, 1.5)))


def test_v10_detect_loss_matches_jax():
    """The six gained terms and the total on the same raw maps. Bar: rtol
    2e-4 (PARITY.md section 2.2)."""
    maps, batch = _loss_case(0)
    total, aux = _jax_loss()({k: [jnp.asarray(m) for m in v] for k, v in maps.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()})
    pm, pb = _port_inputs(maps, batch)
    ptotal, paux = PL.v10_detect_loss(pm, pb, nc=NC, strides=STRIDES, gains=(5.0, 1.0, 1.5))
    assert set(paux) == set(aux)
    for k in aux:
        assert float(aux[k]) > 0, k
        np.testing.assert_allclose(float(paux[k]), float(aux[k]), rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(total), rtol=2e-4)


def test_v10_detect_loss_gradients_match_jax():
    """d total / d maps: port autograd against jax.grad through the JAX
    package's analytic BCE and DFL backward passes. Bar: rtol 3e-4 of each
    map's largest gradient (PARITY.md section 2.2)."""
    maps, batch = _loss_case(1)

    def total(m):
        return JL.v10_detect_loss(m, {k: jnp.asarray(v) for k, v in batch.items()}, nc=NC,
                                  strides=STRIDES, gains=(5.0, 1.0, 1.5))[0]

    want = jax.jit(jax.grad(total))({k: [jnp.asarray(m) for m in v] for k, v in maps.items()})
    pm, pb = _port_inputs(maps, batch, grad=True)
    PL.v10_detect_loss(pm, pb, nc=NC, strides=STRIDES, gains=(5.0, 1.0, 1.5))[0].backward()
    for br in maps:
        for g_port, g_jax in zip(pm[br], want[br]):
            g_jax = np.asarray(g_jax).transpose(0, 3, 1, 2)
            scale = np.abs(g_jax).max()
            assert scale > 0
            np.testing.assert_allclose(g_port.grad.numpy(), g_jax, rtol=0, atol=3e-4 * scale)


def test_detect_bias_init_matches_jax():
    """The head's bias init on the same JAX-initialised yolov10n: every
    parameter of the port's head equals the JAX one after the init."""
    from yolov10_3d_torch.nn.build import build_model

    _, spec, variables = build_jax("n")
    params = dict(variables["params"])
    key = f"model_{spec.head_index}"
    params[key] = jax_detect_bias_init(params[key], spec.nc, spec.strides)
    want = load_flax_variables(build_model("yolov10_3d_torch/cfg/models/v10/yolov10n.yaml",
                                           device="cpu")[0],
                               {"params": params, "batch_stats": variables["batch_stats"]})
    model, pspec = build_model("yolov10_3d_torch/cfg/models/v10/yolov10n.yaml", device="cpu")
    load_flax_variables(model, variables)
    detect_bias_init(model.model[pspec.head_index], pspec.nc, pspec.strides)
    got, ref = model.state_dict(), want.state_dict()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)

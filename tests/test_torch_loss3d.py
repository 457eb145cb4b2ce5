"""The port's 3D training losses against the JAX package on the CPU:
``ops/geometry3d.py`` (the 3D box corners), ``train/tal3d.py`` (the 3D
task-aligned assigner), ``train/loss3d.py`` (both branches of
``dd_detection_loss`` and the dual ``detect3d_loss``, with and without HTL
weights, and their gradients with respect to the head maps),
``train/fgdm.py`` (the LID bins and the foreground depth-map loss) and
``train/htl.py`` (the HTL weights), at the 96x320 KITTI size of
tests/test_train3d_e2e.py (630 anchors, nc=3).

The inputs are seeded numpy draws shaped like a 3D head's output: class
logits around -1, 2D and 3D offsets and sizes in grid units, 24 heading
values, depths of 5-50 m; the targets are objects of the three classes with
KITTI's P2 calibration scaled to the frame. Bars (those of ROADMAP and
tests/test_torch_loss.py): the corners 1e-4; the assigner's fg_mask and
target GT equal on these inputs (no near-ties at the top-k cut), its target
scores 1e-5; every loss term and total rtol 2e-4; the gradients 1e-4 of the
largest element of jax.grad's; the LID bins equal, the FGDM loss rtol 2e-4;
the HTL weights 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.ops import geometry3d as JG
from yolov10_3d_tpu.ops.boxes import make_anchors as jax_make_anchors
from yolov10_3d_tpu.train import fgdm as JF
from yolov10_3d_tpu.train import htl as JH
from yolov10_3d_tpu.train import loss3d as JL
from yolov10_3d_tpu.train.tal3d import assign3d as jax_assign3d
from yolov10_3d_torch.data.kitti_utils import CLS_MEAN_SIZE
from yolov10_3d_torch.ops import geometry3d as PG
from yolov10_3d_torch.train import fgdm as PF
from yolov10_3d_torch.train import htl as PH
from yolov10_3d_torch.train import loss3d as PL
from yolov10_3d_torch.train.tal3d import assign3d

NC = 3
STRIDES = (8, 16, 32)
SHAPES = [(12, 40), (6, 20), (3, 10)]  # 96 x 320 input
W, H = 320, 96
# KITTI's P2 intrinsics scaled from 1242x375 to the 320x96 frame
RW, RH = W / 1242, H / 375
CALIB = np.array([609.5593 * RW, 172.854 * RH, 721.5377 * RW, 721.5377 * RH,
                  -44.85728 / 721.5377 * RW, -0.2163791 / 721.5377 * RH], np.float32)
HYP = {"loss2d": 2.0, "cls": 1.0, "depth": 1.0, "offset3d": 10.0, "size3d": 1.0,
       "heading": 1.0, "tal_topk": 8}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jitted(fn, *args, **kw):
    """``fn(*args, **kw)`` of the JAX package under one ``jax.jit`` (eager
    JAX compiles every operation apart); a (total, terms, ...) result keeps
    its terms in the order ``fn`` builds them (jit returns a dict sorted)."""
    order = []

    def run(*a):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            order[:] = list(out[1])
        return out

    out = jax.jit(run)(*args)
    if not isinstance(out, tuple):
        return out
    return (out[0], {k: out[1][k] for k in order}, *out[2:])


def _maps(rng, B):
    """Raw head maps (NHWC, as JAX has them) of one branch."""
    out = []
    for h, w in SHAPES:
        parts = [rng.normal(-1.0, 1.5, (B, h, w, NC)),  # class logits
                 rng.normal(0.0, 0.3, (B, h, w, 2)),  # o2d
                 rng.uniform(0.5, 6.0, (B, h, w, 2)),  # s2d (grid units)
                 rng.normal(0.0, 0.3, (B, h, w, 2)),  # o3d
                 rng.normal(0.0, 0.3, (B, h, w, 3)),  # s3d
                 rng.normal(0.0, 1.0, (B, h, w, 24)),  # heading bins and residuals
                 rng.uniform(5.0, 50.0, (B, h, w, 1)),  # depth
                 rng.normal(0.0, 0.5, (B, h, w, 1))]  # depth uncertainty
        out.append(np.concatenate(parts, -1).astype(np.float32))
    return out


def _case(seed, B=2, M=8):
    """Head maps of both branches and a padded 3D batch."""
    rng = np.random.default_rng(seed)
    maps = {br: _maps(rng, B) for br in ("one2many", "one2one")}
    c2d = np.stack([rng.uniform(30, W - 30, (B, M)), rng.uniform(20, H - 20, (B, M))], -1)
    s2d = np.stack([rng.uniform(12, 60, (B, M)), rng.uniform(10, 40, (B, M))], -1)
    batch = {
        "gt_labels": rng.integers(0, NC, (B, M)).astype(np.int32),
        "gt_bboxes": (np.concatenate([c2d, s2d], -1) / [W, H, W, H]).astype(np.float32),
        "gt_center_2d": c2d.astype(np.float32),
        "gt_size_2d": s2d.astype(np.float32),
        "gt_center_3d": (c2d + rng.normal(0, 2, (B, M, 2))).astype(np.float32),
        "gt_size_3d": rng.normal(0, 0.2, (B, M, 3)).astype(np.float32),
        "gt_depth": rng.uniform(5, 50, (B, M)).astype(np.float32),
        "gt_heading_bin": rng.integers(0, 12, (B, M)).astype(np.float32),
        "gt_heading_res": rng.uniform(-0.26, 0.26, (B, M)).astype(np.float32),
        "mask_gt": np.array([[True] * M, [True] * (M - 3) + [False] * 3]),
        "calib": np.repeat(CALIB[None], B, 0),
        "mean_sizes": np.repeat(CLS_MEAN_SIZE.astype(np.float32)[None], B, 0),
    }
    return maps, batch


def _port(maps, batch, grad=False):
    pm = {br: [_t(m.transpose(0, 3, 1, 2)).requires_grad_(grad) for m in ms]
          for br, ms in maps.items()}
    return pm, {k: _t(v) for k, v in batch.items()}


def _jax(maps, batch):
    return ({br: [jnp.asarray(m) for m in ms] for br, ms in maps.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("heading", ["logits", "index"])
def test_get_3d_keypoints_matches_jax(heading):
    """Camera-frame corners from a projected centre, depth, size and heading
    (12 bin logits and residuals, or a bin index and its residual). Bar 1e-4."""
    rng = np.random.default_rng(3)
    B, N = 2, 64
    c3d = np.stack([rng.uniform(0, W, (B, N)), rng.uniform(0, H, (B, N))], -1)
    dep = rng.uniform(3, 60, (B, N, 1))
    size = rng.uniform(0.5, 4.5, (B, N, 3))
    if heading == "logits":
        hb, hr = rng.normal(0, 1, (B, N, 12)), rng.uniform(-0.3, 0.3, (B, N, 12))
    else:
        hb, hr = rng.integers(0, 12, (B, N, 1)).astype(np.float64), rng.uniform(-0.3, 0.3, (B, N, 1))
    args = [a.astype(np.float32) for a in (c3d, dep, size, hb, hr, np.repeat(CALIB[None], B, 0))]
    want = np.asarray(_jitted(JG.get_3d_keypoints, *map(jnp.asarray, args)))
    got = PG.get_3d_keypoints(*map(_t, args)).numpy()
    assert got.shape == (B, N, 8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _assign_inputs(maps, batch, topk):
    """The assigner's inputs as dd_detection_loss builds them, numpy."""
    x = np.concatenate([m.reshape(m.shape[0], -1, m.shape[-1]) for m in maps], 1)
    anchors, strides = (np.asarray(a) for a in jax_make_anchors(SHAPES, STRIDES, 0.5))
    o2d, s2d = x[..., NC:NC + 2], x[..., NC + 2:NC + 4]
    centers = anchors[None] + o2d
    pred_bboxes = np.concatenate([centers - s2d / 2, centers + s2d / 2], -1) * strides[None]
    gt = batch["gt_bboxes"] * np.array([W, H, W, H], np.float32)
    gt_xyxy = np.concatenate([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2] + gt[..., 2:] / 2], -1)
    mask_gt = (gt_xyxy.sum(-1) > 0) & batch["mask_gt"]
    gts = (batch["gt_labels"], gt_xyxy * mask_gt[..., None], batch["gt_center_2d"],
           batch["gt_size_2d"], batch["gt_center_3d"], batch["gt_size_3d"],
           batch["gt_depth"][..., None], batch["gt_heading_bin"][..., None],
           batch["gt_heading_res"][..., None])
    scores = 1 / (1 + np.exp(-x[..., :NC].astype(np.float64)))
    return dict(pd_scores=scores.astype(np.float32), pd_bboxes=pred_bboxes.astype(np.float32),
                pd_3d=x[..., NC + 4:].copy(), anc_points=(anchors * strides).astype(np.float32),
                gts=gts, mask_gt=mask_gt, stride_tensor=strides, calibs=batch["calib"],
                mean_sizes=CLS_MEAN_SIZE.astype(np.float32)), dict(topk=topk, num_classes=NC)


@pytest.mark.parametrize("topk", [8, 1])
def test_assign3d_matches_jax(topk):
    """Both branches' assignments (top-8 and top-1) on the same decoded
    predictions: fg_mask and target GT equal, target scores within 1e-5,
    the gathered targets within 1e-6."""
    maps, batch = _case(0)
    inputs, kw = _assign_inputs(maps["one2many"], batch, topk)

    def conv(f, v):
        return tuple(f(a) for a in v) if isinstance(v, tuple) else f(v)

    want = jax.jit(functools.partial(jax_assign3d, **kw))(
        **{k: conv(jnp.asarray, v) for k, v in inputs.items()})
    got = assign3d(**{k: conv(_t, v) for k, v in inputs.items()}, **kw)
    assert int(got.fg_mask.sum()) > 10
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    fg = got.fg_mask.numpy()
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg], np.asarray(want.target_gt_idx)[fg])
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=0, atol=1e-5)
    for name in ("target_labels", "target_center_2d", "target_size_2d", "target_center_3d",
                 "target_size_3d", "target_depth", "target_heading_bin", "target_heading_res"):
        np.testing.assert_allclose(getattr(got, name).numpy().astype(np.float64)[fg],
                                   np.asarray(getattr(want, name), np.float64)[fg],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("topk", [8, 1])
def test_dd_detection_loss_matches_jax(topk):
    """One branch's six terms and total (the one2many branch at top-8, the
    one2one at top-1), and its assignment's fg_mask. Bar rtol 2e-4."""
    maps, batch = _case(1)
    jm, jb = _jax(maps, batch)
    total, items, aux = _jitted(JL.dd_detection_loss, jm["one2many"], jb, nc=NC,
                                strides=STRIDES, hyp=HYP, tal_topk=topk, return_aux=True)
    pm, pb = _port(maps, batch)
    ptotal, pitems, paux = PL.dd_detection_loss(pm["one2many"], pb, nc=NC, strides=STRIDES,
                                                hyp=HYP, tal_topk=topk, return_aux=True)
    assert list(pitems) == list(items)
    for k in items:
        assert float(items[k]) > 0, k
        np.testing.assert_allclose(float(pitems[k]), float(items[k]), rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(total), rtol=2e-4)
    np.testing.assert_array_equal(paux["fg_mask"].numpy(), np.asarray(aux["fg_mask"]))


@pytest.mark.parametrize("htl", [False, True])
def test_detect3d_loss_matches_jax(htl):
    """The dual loss's 12 terms and total, plain and HTL-weighted (the
    total becomes (w * terms).sum() * B). Bar rtol 2e-4."""
    maps, batch = _case(2)
    if htl:
        batch["htl_weights"] = np.random.default_rng(4).uniform(0, 1, 12).astype(np.float32)
    total, items = _jitted(JL.detect3d_loss, *_jax(maps, batch), nc=NC, strides=STRIDES,
                           hyp=HYP)
    ptotal, pitems = PL.detect3d_loss(*_port(maps, batch), nc=NC, strides=STRIDES, hyp=HYP)
    assert list(pitems) == list(items) == list(PL.ITEM_KEYS)
    for k in items:
        np.testing.assert_allclose(float(pitems[k]), float(items[k]), rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(total), rtol=2e-4)
    if htl:
        w = batch["htl_weights"]
        np.testing.assert_allclose(float(ptotal), float(np.dot(
            w, [float(pitems[k]) for k in PL.ITEM_KEYS])) * 2, rtol=1e-5)


@pytest.mark.parametrize("htl", [False, True])
def test_detect3d_loss_gradients_match_jax(htl):
    """d total / d maps of both branches: port autograd against jax.grad.
    Bar: 1e-4 of each map's largest element of jax.grad's."""
    maps, batch = _case(5)
    if htl:
        batch["htl_weights"] = np.random.default_rng(6).uniform(0, 1, 12).astype(np.float32)
    jb = _jax(maps, batch)[1]

    def total(m):
        return JL.detect3d_loss(m, jb, nc=NC, strides=STRIDES, hyp=HYP)[0]

    want = jax.jit(jax.grad(total))(_jax(maps, batch)[0])
    pm, pb = _port(maps, batch, grad=True)
    PL.detect3d_loss(pm, pb, nc=NC, strides=STRIDES, hyp=HYP)[0].backward()
    for br in maps:
        for g_port, g_jax in zip(pm[br], want[br]):
            g_jax = np.asarray(g_jax).transpose(0, 3, 1, 2)
            scale = np.abs(g_jax).max()
            assert scale > 0
            np.testing.assert_allclose(g_port.grad.numpy(), g_jax, rtol=0, atol=1e-4 * scale)


def _depth_case(seed, B=2):
    rng = np.random.default_rng(seed)
    dm = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for _ in range(6):  # foreground planes, some beyond the 120 m range
            y0, x0 = rng.integers(0, H - 20), rng.integers(0, W - 40)
            dm[b, y0:y0 + rng.integers(5, 20), x0:x0 + rng.integers(8, 40)] = rng.uniform(0.5, 130)
    logits = rng.normal(0, 2, (B, 6, 20, 81)).astype(np.float32)  # P4's grid, NHWC
    return dm, logits


@pytest.mark.parametrize("mode", ["LID", "UD", "SID"])
def test_bin_depths_match_jax(mode):
    """Depths (background 0, beyond range, in range) -> integer bins: equal."""
    dm, _ = _depth_case(7)
    want = np.asarray(JF.bin_depths(jnp.asarray(dm), 1.0, 120.0, 80, mode))
    got = PF.bin_depths(_t(dm), 1.0, 120.0, 80, mode).numpy()
    assert (got == 80).any() and (got < 80).any()
    np.testing.assert_array_equal(got, want)


def test_foreground_depth_map_loss_matches_jax():
    """The focal loss over LID bins with fg/bg weights, the port's NCHW
    logits against JAX's NHWC ones; the target map nearest-downsampled from
    96x320 to 6x20. Bar rtol 2e-4."""
    dm, logits = _depth_case(8)
    kw = dict(depth_min=1.0, depth_max=120.0)
    want = float(_jitted(JF.foreground_depth_map_loss, jnp.asarray(logits), jnp.asarray(dm),
                         **kw))
    got = float(PF.foreground_depth_map_loss(_t(logits.transpose(0, 3, 1, 2)), _t(dm), **kw))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_htl_weights_match_jax():
    """HierarchicalTaskLearning over 12 epochs of falling, noisy loss terms
    (the ramp starts once 5 epochs are recorded), and its state_dict round
    trip. Bar 1e-6."""
    rng = np.random.default_rng(9)
    base = rng.uniform(1, 20, 12)
    losses = [base * (0.9 ** e) + rng.normal(0, 0.05, 12) for e in range(12)]
    jh, ph = JH.HierarchicalTaskLearning(max_epochs=20), PH.HierarchicalTaskLearning(max_epochs=20)
    assert PH.LOSS_GRAPH == JH.LOSS_GRAPH and PL.ITEM_KEYS == JL.ITEM_KEYS
    ramped = False
    for e, loss in enumerate(losses):
        want, got = jh.compute_weight(loss, e), ph.compute_weight(loss, e)
        assert got.dtype == np.float32 and got.shape == (12,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"epoch {e}")
        ramped |= bool(got[2] > 0)
    assert ramped
    again = PH.HierarchicalTaskLearning(max_epochs=20)
    again.load_state_dict(ph.state_dict())
    np.testing.assert_allclose(again.compute_weight(losses[-1], 12),
                               jh.compute_weight(losses[-1], 12), rtol=0, atol=1e-6)


def test_distillation_hook_adds_dis():
    """The loss's distillation hook (refused until the DINO teacher was
    ported): ``distill_fn(preds, batch, aux)`` gets the one2many
    assignment, its value is the ``dis`` item and adds to the total; a hook
    that raises stops the loss."""
    maps, batch = _case(2)
    preds, pbatch = _port(maps, batch)
    total, items = PL.detect3d_loss(preds, pbatch, nc=NC, strides=STRIDES, hyp=HYP)
    seen = {}

    def hook(p, b, aux):
        seen.update(aux)
        return torch.tensor(0.25)

    total_d, items_d = PL.detect3d_loss(preds, pbatch, nc=NC, strides=STRIDES, hyp=HYP,
                                        distill_fn=hook)
    assert float(items_d["dis"]) == 0.25 and float(total_d - total) == pytest.approx(0.25)
    assert set(seen) == {"fg_mask", "target_gt_idx"}
    anchors = sum(m.shape[2] * m.shape[3] for m in preds["one2many"])
    assert seen["fg_mask"].shape == seen["target_gt_idx"].shape == (2, anchors)
    with pytest.raises(ValueError, match="no teacher"):
        PL.detect3d_loss(preds, pbatch, nc=NC, strides=STRIDES, hyp=HYP,
                         distill_fn=lambda *a: (_ for _ in ()).throw(ValueError("no teacher")))


def test_fgdm_term_in_detect3d_loss_matches_jax():
    """detect3d_loss with the FGDM hook adds the weighted ``fgdm`` term
    (weight 2) to the total. Bar rtol 2e-4."""
    maps, batch = _case(10)
    dm, logits = _depth_case(11)
    batch["depth_map"] = dm
    jm, jb = _jax(maps, batch)
    jm["depth_maps"] = (jnp.asarray(logits),)
    total, items = _jitted(
        JL.detect3d_loss, jm, jb, nc=NC, strides=STRIDES, hyp=HYP,
        fgdm_loss_fn=functools.partial(JF.foreground_depth_map_loss, depth_max=120.0))
    pm, pb = _port(maps, batch)
    pm["depth_maps"] = (_t(logits.transpose(0, 3, 1, 2)),)
    ptotal, pitems = PL.detect3d_loss(
        pm, pb, nc=NC, strides=STRIDES, hyp=HYP,
        fgdm_loss_fn=functools.partial(PF.foreground_depth_map_loss, depth_max=120.0))
    assert "fgdm" in pitems
    for k in items:
        np.testing.assert_allclose(float(pitems[k]), float(items[k]), rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(total), rtol=2e-4)

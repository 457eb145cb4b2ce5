"""``use_dino_depth`` validation in the port (``engine/validator3d.py``
``Detection3DValidator.dino_depth``, ``YOLOv10.val(use_dino_depth=True,
dino_path=...)``) against the JAX validator on the CPU: yolov10n_3D at
96x320 on the 4 val frames of ``make_kitti_tree``, the JAX facade's
variables calibrated in the port (as tests/test_torch_val3d.py), and a
``dino_path`` file in the reference's ``save()`` layout written from JAX's
``export_dinov2_state_dict`` (the JAX tests' tiny arch as "small" in both
packages, LayerScale and the head's BatchNorm drawn).

Bars, those of tests/test_torch_val3d.py: per image file the same rows and
classes, paired by class and 2D box: box 0.1 px, score 1e-4 + 1e-3
max(1, |ln score|) of the score, sizes and depth (now the teacher's) 1e-3
relative, angles 1e-3; the metrics 1e-6. Without ``dino_path`` the flag
raises ``ValueError``; the substitution replaces column 33 alone, at the
clamped integer centre.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from _helpers import make_kitti_tree
from test_torch_predictor import JaxFacade, port_to_flax
import yolov10_3d_tpu.models.dino as JD
import yolov10_3d_torch.models.dino as PD
from yolov10_3d_tpu.data import kitti as JK
from yolov10_3d_tpu.data.dataset import DataLoader as JaxDataLoader
from yolov10_3d_tpu.engine import validator3d as JV
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data import kitti as TK
from yolov10_3d_torch.engine import validator3d as TV
from yolov10_3d_torch.utils.parity import calibrate, compare_kitti_rows
from yolov10_3d_torch.utils.weights import load_flax_variables

RES = [320, 96]  # W, H
SCORE_TOL, BOX_TOL, REL_TOL, ANGLE_TOL = 1e-4, 0.1, 1e-3, 1e-3
TINY = dict(embed_dim=32, depth=4, num_heads=2)
NAMES = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}


@pytest.fixture(scope="module")
def dino_val(tmp_path_factory):
    saved = JD.DINOV2_ARCHS["small"], PD.DINOV2_ARCHS["small"]
    JD.DINOV2_ARCHS["small"], PD.DINOV2_ARCHS["small"] = dict(TINY), dict(TINY)
    try:
        root = tmp_path_factory.mktemp("kitti_dino_val")
        yaml_path = make_kitti_tree(root, n_images=4, draw_boxes=True, val_all=True)
        model = JD.DinoDepther()
        v = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 56, 56, 3), jnp.float32))
        rng = np.random.default_rng(3)
        v = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.normal(0, 0.3, a.shape).astype(np.float32)
                          if p[-1].key == "gamma" else
                          rng.normal(0, 0.5, a.shape).astype(np.float32) + 1.0
                          if p[-1].key == "var" else np.asarray(a)), v)
        params = dict(v["params"])  # depths of tens of metres, as a trained head gives
        params["head"] = {**params["head"], "conv_depth": {
            **params["head"]["conv_depth"], "bias": np.full((1,), 20.0, np.float32)}}
        v = {"params": params,
             "batch_stats": jax.tree.map(np.abs, v["batch_stats"])}  # a variance is positive
        path = root / "depther.pt"
        torch.save({k: torch.from_numpy(np.array(a))
                    for k, a in JD.export_dinov2_state_dict(v).items()}, path)

        jm = JaxFacade("yolov10n_3D.yaml")
        port = YOLOv10("yolov10n_3D.yaml", device="cpu")
        load_flax_variables(port.model, jm.variables)
        jds = JK.KITTIDataset(root, "val", args=types.SimpleNamespace(kitti_resolution=RES))
        batches = list(JaxDataLoader(jds, 2, shuffle=False, drop_last=False))
        x = torch.from_numpy(np.concatenate([b["img"] for b in batches])).permute(0, 3, 1, 2)
        calibrate(port.model, x.float().div(255.0).contiguous())
        jm.variables = port_to_flax(jm.variables, port.model)

        jax_rows = {}
        decode = jds.decode_preds

        def record(*a, **k):  # the JAX rows before the text formatting
            out = decode(*a, **k)
            jax_rows.update(out)
            return out

        jds.decode_preds = record
        args = dict(use_dino_depth=True, dino_path=str(path))
        want = JV.Detection3DValidator(jm.model, jm.spec, types.SimpleNamespace(**args), NAMES)(
            jm.variables, jds, batches, save_dir=str(root / "jax"))
        tds = TK.KITTIDataset(root, "val", args={"kitti_resolution": RES})
        validator = TV.Detection3DValidator(port.model, port.spec, args, NAMES)
        got = validator(tds, batches, save_dir=str(root / "port"))
        plain = TV.Detection3DValidator(port.model, port.spec, {}, NAMES)
        plain(tds, batches, save_dir=str(root / "plain"))
        facade = port.val(data=str(yaml_path), batch=2, kitti_resolution=RES,
                          save_dir=str(root / "facade"), **args)
        yield dict(root=root, path=path, port=port, want=want, got=got, jax_rows=jax_rows,
                   validator=validator, plain=plain, facade=facade, batches=batches)
    finally:
        JD.DINOV2_ARCHS["small"], PD.DINOV2_ARCHS["small"] = saved


def test_dino_depth_rows_match_jax(dino_val):
    v = dino_val["validator"]
    stats = compare_kitti_rows(dino_val["jax_rows"], v.results, SCORE_TOL, BOX_TOL, REL_TOL,
                               ANGLE_TOL)
    assert stats["n_rows"] == sum(len(r) for r in v.results.values()) > 100, stats
    # the teacher moved the depths: the z column differs from the plain run's
    z = np.array([r[11] for f in sorted(v.results) for r in v.results[f]])
    z_plain = np.array([r[11] for f in sorted(v.results) for r in dino_val["plain"].results[f]])
    assert z.shape == z_plain.shape and not np.allclose(z, z_plain)
    assert v.timings["teacher"] > 0 and v.dino_teacher is not None


def test_dino_depth_metrics_match_jax(dino_val):
    want = dino_val["want"]
    for got in (dino_val["got"], dino_val["facade"]):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_dino_depth_substitutes_column_33(dino_val):
    """Column 33 alone is replaced, by the teacher's map at the clamped
    integer centre (columns 4:6); the input rows are not modified."""
    v = dino_val["validator"]
    img = dino_val["batches"][0]["img"]
    rng = np.random.default_rng(0)
    preds = rng.uniform(0, 1, (2, 5, 37)).astype(np.float32)
    preds[..., 33] = 50.0
    preds[..., 4] = [[3.0, 60.0, 95.5, -7.0, 400.0]] * 2
    preds[..., 5] = [[2.0, 30.0, 10.0, 5.0, -3.0]] * 2
    out = v.dino_depth(preds, img)
    np.testing.assert_array_equal(out[..., :33], preds[..., :33])
    np.testing.assert_array_equal(out[..., 34:], preds[..., 34:])
    assert np.all(preds[..., 33] == 50.0)
    depth = v.dino_teacher(torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0)[0].numpy()
    cx = np.clip(preds[..., 4].astype(np.int64), 0, RES[0] - 1)
    cy = np.clip(preds[..., 5].astype(np.int64), 0, RES[1] - 1)
    np.testing.assert_array_equal(out[..., 33], depth[np.arange(2)[:, None], cy, cx])


def test_use_dino_depth_requires_dino_path(dino_val):
    v = TV.Detection3DValidator(dino_val["port"].model, dino_val["port"].spec,
                                {"use_dino_depth": True}, NAMES)
    with pytest.raises(ValueError, match="dino_path"):
        v.dino_depth(np.zeros((1, 2, 37), np.float32), np.zeros((1, 96, 320, 3), np.uint8))


def test_rows_record_the_centre_their_depth_was_read_at(dino_val):
    """Each row's projected 3D centre is kept (``validator.centres``); its
    depth z is the teacher's map at that centre's pixel (``dino_pixel``)."""
    v = dino_val["validator"]
    img = np.concatenate([b["img"] for b in dino_val["batches"]])
    depth = v.dino_teacher(torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0)[0].numpy()
    for k, name in enumerate(sorted(v.results)):
        rows, centres = np.asarray(v.results[name]), np.asarray(v.centres[name])
        assert len(rows) == len(centres) > 0
        cy, cx = TV.dino_pixel(centres, depth.shape[1:])
        np.testing.assert_allclose(rows[:, 11], depth[k, cy, cx], rtol=1e-6)


def test_lookup_flips_are_counted_not_held():
    """Two centres on either side of a pixel edge read neighbouring pixels:
    the pair's depth is not held and the flip is counted. The same depth gap
    at one pixel fails, and so do centres further apart than the box bar."""
    row = [0.0, 0.3, 10.0, 20.0, 60.0, 50.0, 1.5, 1.6, 3.9, 2.0, 1.0, 20.0, 0.4, 0.9]
    moved = row[:9] + [v * 1.01 for v in row[9:12]] + row[12:]
    ref, got = {"a.txt": [row]}, {"a.txt": [moved]}
    args = (SCORE_TOL, BOX_TOL, REL_TOL, ANGLE_TOL, None, None)
    stats = compare_kitti_rows(ref, got, *args, {"a.txt": [(40.9999, 30.5)]},
                               {"a.txt": [(41.0001, 30.5)]}, (96, 320))
    assert stats["n_lookup_flips"] == 1 and stats["n_rows"] == 1
    with pytest.raises(AssertionError, match="depth_rel_err"):
        compare_kitti_rows(ref, got, *args, {"a.txt": [(40.2, 30.5)]},
                           {"a.txt": [(40.2001, 30.5)]}, (96, 320))
    with pytest.raises(AssertionError, match="centre_err"):
        compare_kitti_rows(ref, {"a.txt": [row]}, *args, {"a.txt": [(40.2, 30.5)]},
                           {"a.txt": [(40.5, 30.5)]}, (96, 320))

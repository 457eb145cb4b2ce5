"""The DINOv2 depth teacher in the port (``models/dino.py``: the ViT, the depth
head, the teacher's normalisation and resizes, and ``dino_path`` files)
against the JAX package's ``models/dino.py`` and
``Detection3DTrainer._load_dino_teacher`` on the CPU.

The JAX tests' tiny arch (embed 32, depth 4, 2 heads) with the 37x37
position grid; LayerScale and the head's BatchNorm drawn away from their
initial values (at 1e-5 the blocks would add almost nothing). Files are
written from JAX's ``export_dinov2_state_dict`` (the reference's ``save()``
layout) as ``.pt`` and ``.npz``, and as a bare backbone. Bars: depth and
embeddings 1e-4 + 1e-4 |y|; the resizes 1e-5 + 1e-5 |y| on every shape pair
of the 384x1280 path (position grid 37x37 -> 27x91, the frame 384x1280 ->
378x1274, the depth 27x91 -> 384x1280) and of 96x320.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
import yolov10_3d_tpu.models.dino as JD
import yolov10_3d_torch.models.dino as PD
from yolov10_3d_tpu.engine.trainer3d import Detection3DTrainer as JaxTrainer3D

TINY = dict(embed_dim=32, depth=4, num_heads=2)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_depther():
    """JAX DinoDepther variables of the tiny arch, out_indices (1, 3), with
    LayerScale and the head's BatchNorm drawn."""
    model = JD.DinoDepther(out_indices=(1, 3), arch_override=TINY)
    v = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 56, 56, 3), jnp.float32))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.5, a.shape).astype(np.float32) if p[-1].key == "gamma"
                      else rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
                      if p[-1].key == "var" else
                      rng.normal(0, 0.3, a.shape).astype(np.float32)
                      if p[-1].key == "mean" else np.asarray(a)), v)
    return v, JD.export_dinov2_state_dict(v)


def _port_depther(sd, out_indices=(1, 3)):
    m = PD.DinoDepther(out_indices=out_indices, arch_override=TINY)
    missing, unexpected = m.load_state_dict({k: torch.from_numpy(np.array(a))
                                             for k, a in sd.items()}, strict=False)
    assert missing == ["backbone.mask_token"] and not unexpected
    return m


def _imgs(seed, h, w, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("hw", [(96, 320), (90, 130)])
def test_teacher_matches_jax(jax_depther, hw):
    """The teacher at 96x320 and at a size that is no multiple of 14 (the
    frame resized down to 84x126 first, the depth back up): depth (B, H, W)
    and embeddings (B, 2 x 32, H // 14, W // 14)."""
    v, sd = jax_depther
    imgs = _imgs(1, *hw)
    jt = JD.make_dino_teacher(v, out_indices=(1, 3), arch_override=TINY)
    d_want, e_want = jt(jnp.asarray(imgs))
    teacher = PD.make_dino_teacher(_port_depther(sd), device="cpu")
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    with torch.autocast("cpu", dtype=torch.bfloat16):  # the teacher stays float32
        d_got, e_got = teacher(x)
    assert d_got.dtype == e_got.dtype == torch.float32 and not d_got.requires_grad
    assert d_got.shape == (2, *hw) and e_got.shape == (2, 64, hw[0] // 14, hw[1] // 14)
    _close(d_got.numpy(), d_want, "depth")
    _close(e_got.permute(0, 2, 3, 1).numpy(), e_want, "embeddings")
    assert float(d_got.max()) > 0


@pytest.mark.parametrize("src,dst", [((37, 37), (27, 91)), ((37, 37), (6, 22)),
                                     ((384, 1280), (378, 1274)), ((96, 320), (84, 308)),
                                     ((27, 91), (384, 1280)), ((6, 22), (96, 320))])
def test_resize_matches_jax(src, dst):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``:
    antialiased where it shrinks (37 -> 27 rows while 37 -> 91 columns grow)."""
    x = np.random.default_rng(2).normal(size=(1, 3, *src)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 3, *dst), "bilinear")
    got = PD.resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pos_embed_resize_matches_jax(jax_depther):
    """The position embedding on the 384x1280 path's 27x91 patch grid: the
    backbone's ``patch_pos`` against JAX's resize of the same grid."""
    v, sd = jax_depther
    pos = np.asarray(v["params"]["backbone"]["pos_embed"])
    want = jax.image.resize(jnp.asarray(pos[:, 1:].reshape(1, 37, 37, 32)), (1, 27, 91, 32),
                            "bilinear").reshape(1, 27 * 91, 32)
    got = _port_depther(sd).backbone.patch_pos(27, 91).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture()
def tiny_small(monkeypatch):
    """Both packages' "small" arch set to the tiny one (the JAX tests' way)."""
    monkeypatch.setitem(JD.DINOV2_ARCHS, "small", dict(TINY))
    monkeypatch.setitem(PD.DINOV2_ARCHS, "small", dict(TINY))


@pytest.mark.parametrize("fmt", ["pt", "npz", "bare"])
def test_dino_path_files_match_jax(tiny_small, tmp_path, fmt, caplog):
    """``dino_path`` files, loaded by the port's ``load_dino_teacher`` and by
    JAX's ``_load_dino_teacher``: the reference layout as ``.pt`` (a state
    dict of tensors) and ``.npz``, and a bare backbone (``.npz``): the
    embeddings equal JAX's; the depth too where the file has the head. A
    bare backbone's head is the port's seeded one, with a warning."""
    model = JD.DinoDepther()  # "small" = tiny here, out_indices (2, 5, 8, 11) -> (2,)
    v = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, 56, 56, 3), jnp.float32))
    sd = JD.export_dinov2_state_dict(v)
    if fmt == "pt":
        path = tmp_path / "depther.pt"
        torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, path)
    else:
        if fmt == "bare":
            sd = {k[len("backbone."):]: a for k, a in sd.items() if k.startswith("backbone.")}
        path = tmp_path / "depther.npz"
        np.savez(path, **sd)
    imgs = _imgs(5, 56, 70)
    d_want, e_want = JaxTrainer3D._load_dino_teacher(str(path))(jnp.asarray(imgs))
    with caplog.at_level(logging.WARNING):
        teacher = PD.load_dino_teacher(path, device="cpu")
    assert ("no head" in caplog.text) == (fmt == "bare")
    d_got, e_got = teacher(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    _close(e_got.permute(0, 2, 3, 1).numpy(), e_want, "embeddings")
    if fmt != "bare":
        _close(d_got.numpy(), d_want, "depth")


def test_width_selects_the_arch_or_raises(monkeypatch):
    """The arch is the one whose width is cls_token's; a width that matches
    none raises ValueError naming the widths."""
    monkeypatch.setitem(PD.DINOV2_ARCHS, "base", dict(TINY))
    src = PD.DinoDepther("base").init_weights(1)
    sd = {k: t for k, t in src.state_dict().items() if k != "backbone.mask_token"}
    model = PD.load_dino_state_dict(sd)
    assert len(model.backbone.blocks) == 4 and model.backbone.embed_dim == 32
    for k, t in model.state_dict().items():
        if k != "backbone.mask_token":
            assert torch.equal(t, sd[k]), k
    sd["backbone.cls_token"] = torch.zeros(1, 1, 48)
    with pytest.raises(ValueError, match="embed_dim 48 matches no DINOv2 arch"):
        PD.load_dino_state_dict(sd)


def test_public_dinov2_names_load_into_the_backbone():
    """torch.hub dinov2's own names (with mask_token) load strict into the
    backbone; the save() layout into the DinoDepther."""
    src = PD.DinoDepther(arch_override=TINY).init_weights(2)
    bare = {k[len("backbone."):]: t for k, t in src.state_dict().items()
            if k.startswith("backbone.")}
    assert {"cls_token", "pos_embed", "mask_token", "patch_embed.proj.weight",
            "blocks.0.attn.qkv.weight", "blocks.0.ls1.gamma", "blocks.3.mlp.fc2.bias",
            "norm.weight"} <= set(bare)
    dst = PD.DinoDepther(arch_override=TINY)
    dst.backbone.load_state_dict(bare, strict=True)
    dst.load_state_dict(src.state_dict(), strict=True)

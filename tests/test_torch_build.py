"""YAML compiler and full-model parity of the PyTorch port against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.nn.build import parse_model_yaml as jax_parse
from yolov10_3d_torch.cfg import CFG_DIR, load_yaml
from yolov10_3d_torch.nn.build import YOLOModel, parse_model_yaml
from yolov10_3d_torch.utils.weights import load_flax_variables

from _helpers import CFG_DIR as JAX_CFG_DIR
from _helpers import apply_model
from test_torch_blocks import randomize

SCALES = "nsmblx"


def _yaml(scale):
    return CFG_DIR / "models" / "v10" / f"yolov10{scale}.yaml"


@pytest.mark.parametrize("scale", SCALES)
def test_load_yaml_matches_pyyaml(scale):
    """The port's YAML reader gives what PyYAML gives on the model files."""
    with open(_yaml(scale)) as f:
        assert load_yaml(_yaml(scale)) == yaml.safe_load(f)


@pytest.mark.parametrize("scale", SCALES)
def test_parse_model_yaml_matches_jax(scale):
    """Layers (module, args, c2, f, n, stride), save list and strides agree."""
    want = jax_parse(f"yolov10_3d_tpu/cfg/models/v10/yolov10{scale}.yaml")
    got = parse_model_yaml(_yaml(scale))
    assert [dataclasses.asdict(s) for s in got.layers] == [
        dataclasses.asdict(s) for s in want.layers
    ]
    assert (got.nc, got.save, got.strides, got.head_index, got.head_module) == (
        want.nc, want.save, want.strides, want.head_index, want.head_module
    )


def test_full_model_parity_yolov10n():
    """Raw one2many and one2one maps of yolov10n at 64x96 within 2e-4, the bar
    tests/test_model_parity.py holds the JAX model to against the torch
    reference; params and BN statistics randomised, converted, strict load."""
    model, spec = jax_build_model(f"{JAX_CFG_DIR}/yolov10n.yaml")
    tree = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))  # randomize draws every leaf anew
    variables = randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree), seed=7)
    port = YOLOModel(parse_model_yaml(_yaml("n")))
    load_flax_variables(port, variables)
    assert sum(p.numel() for p in port.parameters()) == sum(
        np.asarray(v).size for v in jax.tree.leaves(variables["params"])
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 96, 3), dtype=np.float32) * 0.5 + 0.5
    want = apply_model(model, variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)), fast_eval=False)
        fast = port(torch.from_numpy(x.transpose(0, 3, 1, 2)), fast_eval=True)
    assert set(fast) == {"one2one"}
    for branch in ("one2many", "one2one"):
        for i, (a, b) in enumerate(zip(want[branch], got[branch])):
            err = np.abs(np.asarray(a).transpose(0, 3, 1, 2) - b.numpy()).max()
            assert err < 2e-4, f"{branch}[{i}] max abs err {err}"
    for a, b in zip(got["one2one"], fast["one2one"]):
        assert torch.equal(a, b)

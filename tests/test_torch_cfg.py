"""The port's ``get_cfg`` (``yolov10_3d_torch/cfg``) against the JAX
package's (``yolov10_3d_tpu/cfg``): every key of JAX's default.yaml with
JAX's value after its coercion, the same coercion of overrides, and the
same refusal of unknown keys. The port's one key of its own is ``stream``.
"""

import pytest

from yolov10_3d_tpu import cfg as jax_cfg
from yolov10_3d_torch import cfg as port_cfg

# overrides as a CLI or a caller gives them: strings, numbers, bools, None
OVERRIDES = {
    "epochs": "3", "patience": 7.0, "lr0": "0.02", "momentum": 1, "box": 7, "time": "1.5",
    "conf": "0.25", "iou": 1, "max_det": 10.0, "line_width": "2", "workspace": 8,
    "half": "True", "save": "false", "verbose": "1", "plots": "yes", "amp": "no",
    "int8": True, "seed": True, "kobj": "2.0", "crop_fraction": 0.5, "classes": [0, 2],
    "imgsz": 320, "task": "detect", "mode": "predict", "freeze": 10, "name": None,
    "stream_buffer": "false", "tal_alpha": "0.25", "close_mixup": "2",
}


def test_defaults_match_jax():
    """Every key of JAX's file, equal in value and type to JAX's
    ``get_cfg().to_dict()``; nothing else but ``stream``."""
    want = jax_cfg.get_cfg().to_dict()
    got = port_cfg.get_cfg()
    assert len(want) == 151 and set(got) - set(want) == {"stream"}
    for k, v in want.items():
        assert k in got and got[k] == v and type(got[k]) is type(v), (k, got.get(k), v)


def test_overrides_coerce_as_jax():
    """A sweep of overrides given as strings, numbers and bools coerces as
    in JAX (int, float and fraction keys, bools spelled as strings, None
    kept for a known key); a value that does not convert raises ValueError
    in both, and in the port a bool key's string that is no bool spelling."""
    want = jax_cfg.get_cfg(overrides=OVERRIDES).to_dict()
    got = port_cfg.get_cfg(OVERRIDES)
    for k in OVERRIDES:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), (k, got[k], want[k])
    assert got["half"] is True and got["amp"] is False and got["epochs"] == 3
    for bad in ({"epochs": "three"}, {"lr0": "fast"}):
        with pytest.raises(ValueError):
            jax_cfg.get_cfg(overrides=bad)
        with pytest.raises(ValueError, match=next(iter(bad))):
            port_cfg.get_cfg(bad)
    # the one difference: a bool key's string that spells neither value,
    # which JAX reads as False, raises
    assert jax_cfg.get_cfg(overrides={"spd_serving": "all"}).spd_serving is False
    with pytest.raises(ValueError, match="spd_serving"):
        port_cfg.get_cfg({"spd_serving": "all"})


def test_unknown_keys_raise_as_in_jax():
    """An unknown key raises KeyError in both; an unknown key with the value
    None is dropped by both."""
    for bad in ({"no_such_key": 1}, {"halfs": True, "conf": 0.5}):
        with pytest.raises(KeyError):
            jax_cfg.get_cfg(overrides=bad)
        with pytest.raises(KeyError, match="unknown config keys"):
            port_cfg.get_cfg(bad)
    got = port_cfg.get_cfg({"no_such_key": None, "conf": None})
    assert "no_such_key" not in got and got["conf"] is None
    assert "no_such_key" not in jax_cfg.get_cfg(overrides={"no_such_key": None}).to_dict()

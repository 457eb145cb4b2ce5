"""Block-level parity of the PyTorch port against the JAX package.

Each case builds the flax block (jitted init), draws every parameter and BN
statistic from a seeded numpy generator, converts the tree with the port's
``utils/weights.py``, loads it with strict=True and feeds both sides the same
numpy input (NHWC for JAX, NCHW for the port).

Bar: max abs error < 2e-4, the block-forward bar the JAX package met against
the torch reference (PARITY.md). Both sides are float32 on the CPU; the gap is
summation order in the convolutions and the attention matmuls.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.nn import heads as JH
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_torch.nn import heads as TH
from yolov10_3d_torch.nn import modules as TM
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict, load_flax_variables

TOL = 2e-4


def randomize(variables, seed):
    """Seeded random params and BN statistics in realistic ranges (the JAX
    init leaves BN at identity, which would not test the BN conversion)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        if hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree)
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan_in), a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if leaf == "mean":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        raise KeyError(path)

    return {k: walk(v, (k,)) for k, v in variables.items()}


def _seq_input(kind):
    return kind in ("concat", "head")


CASES = {
    # name: (flax module, port module, input shapes (NHWC), kind)
    "conv_k1": (JM.Conv(24, 1), TM.Conv(16, 24, 1), [(2, 8, 10, 16)], "block"),
    "conv_k3_s2": (JM.Conv(24, 3, 2), TM.Conv(16, 24, 3, 2), [(2, 8, 10, 16)], "block"),
    "conv_dw_noact": (JM.Conv(16, 3, g=16, act=False), TM.Conv(16, 16, 3, g=16, act=False),
                      [(2, 8, 10, 16)], "block"),
    "bottleneck": (JM.Bottleneck(16), TM.Bottleneck(16, 16), [(2, 8, 8, 16)], "block"),
    "c2f": (JM.C2f(32, n=2, shortcut=True), TM.C2f(16, 32, n=2, shortcut=True),
            [(2, 8, 8, 16)], "block"),
    "sppf": (JM.SPPF(32, 5), TM.SPPF(32, 32, 5), [(2, 8, 8, 32)], "block"),
    "scdown": (JM.SCDown(32, 3, 2), TM.SCDown(16, 32, 3, 2), [(2, 8, 10, 16)], "block"),
    "repvggdw": (JM.RepVGGDW(16), TM.RepVGGDW(16), [(2, 9, 9, 16)], "block"),
    "cib": (JM.CIB(16, shortcut=True, e=1.0), TM.CIB(16, 16, True, e=1.0),
            [(2, 8, 8, 16)], "block"),
    "cib_lk": (JM.CIB(16, shortcut=True, e=1.0, lk=True),
               TM.CIB(16, 16, True, e=1.0, lk=True), [(2, 8, 8, 16)], "block"),
    "c2fcib_lk": (JM.C2fCIB(32, n=2, shortcut=True, lk=True),
                  TM.C2fCIB(32, 32, n=2, shortcut=True, lk=True), [(2, 8, 8, 32)], "block"),
    # num_heads = c // 64: widths of 128 and up give heads
    "attention": (JM.Attention(128, num_heads=2), TM.Attention(128, num_heads=2),
                  [(2, 6, 5, 128)], "block"),
    "psa": (JM.PSA(256), TM.PSA(256, 256), [(2, 4, 5, 256)], "block"),
    "concat": (JM.Concat(), TM.Concat(1), [(2, 4, 4, 8), (2, 4, 4, 12)], "concat"),
    "upsample": (JM.Upsample(2), TM.Upsample(2), [(2, 3, 5, 8)], "plain"),
    "v10detect": (JH.V10Detect(nc=80, ch=(32, 64, 128)), TH.V10Detect(80, (32, 64, 128)),
                  [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128)], "head"),
}


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    jmod, _, _, kind = CASES[name]
    if kind in ("block", "head"):  # modules with a train flag
        return (jax.jit(functools.partial(jmod.init, train=False)),
                jax.jit(functools.partial(jmod.apply, train=False)))
    return jax.jit(jmod.init), jax.jit(jmod.apply)


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_parity(name):
    _, tmod, shapes, kind = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    xs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jin = [jnp.asarray(x) for x in xs] if _seq_input(kind) else jnp.asarray(xs[0])
    init, apply = _jax_fns(name)
    variables = init(jax.random.PRNGKey(0), jin)
    if variables:
        variables = randomize(jax.device_get(variables), seed=len(name))
        load_flax_variables(tmod, variables)
    want = apply(variables, jin)

    tin = [torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in xs]
    tmod.eval()
    with torch.no_grad():
        got = tmod(tin) if _seq_input(kind) else tmod(tin[0])
    if kind == "head":
        assert set(got) == set(want) == {"one2many", "one2one"}
        pairs = [(w, g) for b in want for w, g in zip(want[b], got[b])]
    else:
        pairs = [(want, got)]
    for w, g in pairs:
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err < TOL, f"{name}: max abs err {err}"


def test_converter_emits_no_dfl_and_loads_strictly():
    """The port's DFL decode has no parameters: no dfl key, strict load of a
    whole head passes, and every key of the port's state_dict is covered."""
    jmod, tmod, shapes, _ = CASES["v10detect"]
    init, _ = _jax_fns("v10detect")
    variables = jax.device_get(init(jax.random.PRNGKey(0), [jnp.zeros(s) for s in shapes]))
    sd = flax_to_torch_state_dict(variables)
    assert not any("dfl" in k for k in sd)
    assert set(sd) == set(TH.V10Detect(80, (32, 64, 128)).state_dict())

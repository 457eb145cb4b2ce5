"""int8 of the YOLOv10-3D head in the PyTorch port against the JAX package's
int8 mode, on the CPU (the kernels' plain twins), yolov10n_3D at 96x320.

This module holds scope k3deep (the JAX Predictor's); ``test_torch_int8_3d_k3``
and ``test_torch_int8_3d_all`` collect the same tests at scopes k3 and all
(``SCOPE``; why three files: ROADMAP, "Tier-1 and the scheduler").

One module fixture: yolov10n_3D built by the JAX facade with flax's initial
values (``test_torch_predictor.jax_variables``), its variables loaded into
the port (strict), calibrated there on the served frames for int8 at the
module's scope (``utils/parity.calibrate(..., int8=...)``, head scales
fitted to the int8 outputs) and copied back. JAX then runs one traced apply
under ``set_int8_mode(True, 8/127, scope)`` (switched off in a finally),
one2many branches included, with the ``_Int8Conv`` calls, every ``Conv``'s
input and output and the head's input features captured, and one in
float32. Under the int8 mode the JAX
head runs its dense route (``heads3d.py`` ``_fusable``), as the port's does.

int8 across the two frameworks is chaotic on a random net: an ulp of
difference that feeds a quantizer (torch's and XLA's float convs, XLA's
fused multiply-add in the BatchNorm, and XLA's weight scale ``max|w| /
127``, a true division inside this model's program but a product with
fl(1/127) in an ``int8_conv`` jitted alone, which the port follows) moves a
code across a rounding boundary now and then, and the flipped codes
multiply through the quantizers after it (ROADMAP queue 3). At this size
the free-running maps agree to 2.5e-3 at k3deep, but at k3 (every 1x1
float) and all they move by up to 1.8 and 0.3, which moves detections by a
pixel. So the detections are held with the head run on JAX's own int8 neck
features (two quantizers deep), the whole forward by its maps, and every
gated conv on JAX's own input to it, where the cause of each difference is
shown: the few output channels where the weight scale's rounding sets a
weight code apart match JAX once the port takes the true division's codes.
Known risk: the k3 maps' bar has little margin (1.83 against 2.08); a
code flipped elsewhere on another CPU could cross it, and the per-conv
check would then show whether a conv or the chaos moved.

Bars, and what this CPU run measured:
- the port's gated convs, by module path, are JAX's ``_Int8Conv`` calls at
  every scope (one2many included); the head's standard branches but
  ``dep`` hand int8 codes from their first conv to their second (K3);
- the one2one head maps of each scope differ from JAX's by at most a tenth
  of JAX's own int8-versus-float32 gap (tests/test_torch_int8.py's bar;
  measured 2.5e-3 of 19.4 at k3deep, 1.83 of 20.8 at k3, 0.32 of 19.9 at
  all);
- the detections of the port's head on JAX's int8 neck features against
  JAX's, decoded alike (``ops/postprocess.py`` ``decode_detect3d``,
  ``v10_3d_postprocess``, max_det 50): score 1e-3,
  the int8 bar of tests/test_torch_int8.py, which widens the float score
  bar 1e-4 of tests/test_torch_detect3d.py ten times; 2D box and projected
  3D centre 0.1 px, s3d and dep_un 1e-3, tests/test_torch_detect3d.py's
  column bars, which tests/test_torch_int8.py's box bar does not widen
  (measured over the three scopes, 194-196 of 200 detections compared:
  score 6.0e-7, box 6.1e-5 px, centre 3.6e-3 px, s3d 8.3e-7, dep_un
  1.7e-6);
- every gated conv given JAX's input to it: int8 codes one step apart in
  at most 1e-4 of them (at least one); float outputs within 1e-5 +
  1e-5 |y| but in the channels whose weight code the scale's rounding
  moves, which meet that bar with the true division's codes (measured:
  118/145/155 convs at k3/k3deep/all; one code flipped at one or two fused
  sites; two float convs, model.23.o3d.2.1 and model.23.o2m_heads.6.0.1,
  one channel each, both witnessed);
- a sparse request under int8 runs the dense head: its maps equal the
  dense ones (``torch.equal``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_int8 import _int8_paths, _nchw
from test_torch_int8_all import jax_int8_mode
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.nn.heads3d import V10Detect3d as JaxHead3d
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.kernels import launch_counts
from yolov10_3d_torch.nn.heads3d import SPARSE_K
from yolov10_3d_torch.nn.quant import (Int8Config, _weights, pad_channels, plan_int8,
                                       quantize_act, quantize_weight)
from yolov10_3d_torch.ops import postprocess as TP
from yolov10_3d_torch.utils.parity import calibrate, match_detections, smooth_images
from yolov10_3d_torch.utils.weights import _dotted, load_flax_variables

HW = (96, 320)  # the KITTI size of tests/test_train3d_e2e.py: P3 12x40, P4 6x20, P5 3x10
CONF = 0.01
SCORE_TOL, BOX_TOL, REG_TOL = 1e-3, 0.1, 1e-3
COLS = {"center3d": (slice(6, 8), BOX_TOL), "s3d": (slice(8, 11), REG_TOL),
        "dep_un": (slice(11, 12), REG_TOL)}
SCOPE = "k3deep"  # the scope of this module's tests


@pytest.fixture(scope="module")
def pair(request):
    scope = request.module.SCOPE
    cfg = Int8Config(scope=scope)
    imgs = smooth_images(np.random.default_rng(1), [HW] * 2)
    batch, _ = preprocess_batch(imgs, [HW[1], HW[0]])
    x = _nchw(batch)
    jm = JaxFacade("yolov10n_3D.yaml")
    port = YOLOv10("yolov10n_3D.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    calibrate(port.model, x, int8=cfg)
    jm.variables = port_to_flax(jm.variables, port.model)

    def apply(v, x):  # the facade's model runs its one2many branches too
        neck, convs = [], {}

        def icpt(next_fun, args, kwargs, ctx):
            if isinstance(ctx.module, JaxHead3d) and ctx.method_name == "__call__":
                neck.extend(args[0])
            out = next_fun(*args, **kwargs)
            if isinstance(ctx.module, JM.Conv) and ctx.method_name == "__call__":
                convs[_dotted(ctx.module.scope.path)] = (args[0], out)
            return out

        with fnn.intercept_methods(icpt):
            out, state = jm.model.apply(
                v, x, train=False, mutable=["intermediates"],
                capture_intermediates=lambda m, _: isinstance(m, JM._Int8Conv))
        return out["one2one"], state["intermediates"], neck, convs

    with jax_int8_mode(scope):
        feats, inter, neck, convs = jax.jit(apply)(jm.variables, jnp.asarray(batch))
    feats32 = jax.jit(lambda v, x: jm.model.apply(v, x, train=False)["one2one"])(
        jm.variables, jnp.asarray(batch))
    before = dict(launch_counts)
    head = port.model.model[port.spec.head_index]
    with torch.no_grad():
        port8 = port.model(x, fast_eval=True, int8=cfg)["one2one"]
        head8 = head([_nchw(f) for f in neck], one2many=False,
                     plan=plan_int8(port.model, HW, cfg))["one2one"]
    return dict(port=port, cfg=cfg, jax8=[np.asarray(f) for f in feats], inter=inter,
                port8=port8, head8=head8, launched=launch_counts != before,
                jax32=[np.asarray(f) for f in feats32],
                convs={k: (np.asarray(a), np.asarray(b)) for k, (a, b) in convs.items()})


def test_plan3d_matches_jax_gate(pair):
    """The plan of the whole 3D model (one2many included) gates exactly the
    convs JAX quantizes; the head's K3 sites are the first convs of its
    standard branches but dep's, one2one and one2many."""
    port = pair["port"]
    plan = plan_int8(port.model, HW, pair["cfg"], one2many=True)
    assert set(plan.paths()) == _int8_paths(pair["inter"])
    head = f"model.{port.spec.head_index}"
    k3 = {n for n, r in plan.paths().items() if r == "int8_conv3x3_fused" and n.startswith(head)}
    names = ("cls", "o2d", "s2d", "o3d", "s3d", "hd", "dep_un")
    want = {f"{head}.{b}.{lv}.0" for b in names for lv in range(3)}
    want |= {f"{head}.o2m_heads.{j}.{lv}.0" for j in (0, 1, 2, 3, 4, 5, 7) for lv in range(3)}
    assert k3 == want


def test_maps3d_match_jax(pair):
    """The port's int8 one2one maps against JAX's at the same scope, within a
    tenth of JAX's own int8-versus-float32 gap; the CPU launches no kernel."""
    assert not pair["launched"]
    want = pair["jax8"]
    err = max(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
              for g, w in zip(pair["port8"], want))
    effect = max(np.abs(a - b).max() for a, b in zip(want, pair["jax32"]))
    assert effect > 0.05 and err <= 0.1 * effect, (err, effect)


def _true_division_codes(conv):
    """The conv's int8 weight codes and per-channel scale with the scale
    computed as JAX's source writes it, ``max|w| / 127`` as a float32
    division, not as the port's product with fl(1/127)."""
    w = conv.conv.weight.detach().float()
    sw = w.abs().amax(dim=(1, 2, 3)) / 127.0 + 1e-12
    return torch.round(w / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8), sw


def test_convs3d_match_jax_on_its_inputs(pair):
    """Every gated conv of JAX's free-running int8 forward, run by the port's
    route on JAX's own input to it, against JAX's output of it. Fused routes'
    int8 codes: at most one step apart, in at most 1e-4 of them (at least
    one). Float outputs: within 1e-5 + 1e-5 |y|, except in the output
    channels whose weight codes the two roundings of the weight scale set
    apart; there the conv run with the true division's codes must be within
    the same bar (the witness that JAX's whole program divides, module
    docstring)."""
    port, cfg = pair["port"], pair["cfg"]
    plan = plan_int8(port.model, HW, cfg, one2many=True)
    deq = float(np.float32(cfg.act_scale))
    with torch.no_grad():
        for name, route in plan.paths().items():
            xin, want = pair["convs"][name]
            conv = port.model.get_submodule(name)
            got = plan.run(conv, _nchw(xin), route)
            if got.dtype == torch.int8:
                ref = quantize_act(_nchw(want), cfg.act_scale)[0].permute(0, 2, 3, 1)
                d = (got.int() - ref.int()).abs()
                n = int((d > 0).sum())
                assert int(d.max()) <= 1 and n <= max(1, 1e-4 * d.numel()), (name, n)
                continue
            bar = 1e-5 + 1e-5 * np.abs(want)
            off = np.abs(got.permute(0, 2, 3, 1).numpy() - want) > bar
            if not off.any():
                continue
            wq, _ = quantize_weight(conv.conv.weight.detach().float())
            wq_div, sw_div = _true_division_codes(conv)
            moved = set((wq != wq_div).flatten(1).any(1).nonzero()[:, 0].tolist())
            assert set(np.nonzero(off.reshape(-1, off.shape[-1]).any(0))[0].tolist()) <= moved, \
                name
            own = _weights(conv, cfg.act_scale)
            conv.int8_cache = dataclasses.replace(
                own, w=pad_channels(wq_div.permute(0, 2, 3, 1), own.w.shape[-1]), sw=sw_div,
                ep=torch.cat([(sw_div * deq)[None], own.ep[1:]]))
            try:
                witness = plan.run(conv, _nchw(xin), route).permute(0, 2, 3, 1).numpy()
            finally:
                conv.int8_cache = own
            assert (np.abs(witness - want) <= bar).all(), name


def _rows(feats, strides, nc):
    """[x1, y1, x2, y2, score, class, centre3d (2), s3d (3), dep_un] rows per
    image above CONF, from the decode and top-k of the served route."""
    reg, scores, labels = TP.v10_3d_postprocess(TP.decode_detect3d(feats, strides, nc),
                                                SPARSE_K, nc)
    rows = torch.cat([reg[..., :4], scores.sigmoid()[..., None], labels[..., None].float(),
                      reg[..., 4:9], reg[..., -1:]], -1).numpy().astype(np.float64)
    return [r[r[:, 4] > CONF] for r in rows]


def test_detections3d_match_jax(pair):
    """The 3D detections of the port's int8 head on JAX's int8 neck features
    against JAX's int8 maps, decoded alike: score 1e-3; box and centre
    0.1 px; s3d and dep_un 1e-3."""
    spec = pair["port"].spec
    want = _rows([_nchw(f) for f in pair["jax8"]], spec.strides, spec.nc)
    got = _rows(pair["head8"], spec.strides, spec.nc)
    stats = [match_detections(a, b, CONF, SCORE_TOL, BOX_TOL, COLS) for a, b in zip(want, got)]
    n = sum(s["n_compared"] for s in stats)
    assert n >= 0.5 * sum(s["n_ref"] + s["n_got"] for s in stats), stats


def test_sparse_equals_dense_under_int8(pair):
    """A sparse request under int8 runs the dense head (JAX's ``_fusable``):
    the same maps, bit for bit. At 96x640 the P3 map (12x80) is large
    enough for the sparse route, which float32 still takes there."""
    model, nc = pair["port"].model, pair["port"].spec.nc
    x = torch.rand((1, 3, 96, 640), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        dense = model(x, fast_eval=True, int8=pair["cfg"])["one2one"]
        sparse = model(x, fast_eval=True, int8=pair["cfg"], sparse=True)["one2one"]
        float_sparse = model(x, fast_eval=True, sparse=True)["one2one"]
    assert all(torch.equal(a, b) for a, b in zip(sparse, dense))
    assert (float_sparse[0][:, nc:] == 0).any()  # zeros off the float32 route's candidates

"""The port's top-k (``ops/topk.py`` ``topk_lowest_index``) against
``jax.lax.top_k`` on tied inputs: the selection itself, the 2D and 3D
postprocess, the sparse 3D head's candidates and the sparse head end to end.

Ties are what serving produces: float32 sigmoids saturate at 1.0, scores
repeat at the precision a model resolves, and flat image regions (letterbox
padding) give identical logits. ``jax.lax.top_k`` gives ties to the lowest
index; every test asserts equal indices, not only equal values: the
postprocess inputs carry each anchor's index in a box or regression column,
so the selected rows name the anchors that were kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import port_to_flax
from yolov10_3d_tpu.nn.heads3d import V10Detect3d as JaxV10Detect3d
from yolov10_3d_tpu.ops import postprocess as JP
from yolov10_3d_torch.nn.heads3d import SPARSE_K, V10Detect3d, candidates
from yolov10_3d_torch.ops import postprocess as TP
from yolov10_3d_torch.ops.topk import topk_lowest_index

KINDS = ("rounded", "tied", "saturated")


def _scores(kind, shape, seed):
    """Scores in [0, 1] with ties: rounded to 0.01, all 0.5, or rounded with
    30% saturated at 1.0 (float32)."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.uniform(0, 1, shape), 2)
    if kind == "tied":
        s = np.full(shape, 0.5)
    elif kind == "saturated":
        s[rng.uniform(0, 1, shape) < 0.3] = 1.0
    return s.astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(8400, 300), (24000, 300), (50, 50)])
def test_topk_lowest_index_matches_jax(kind, n, k):
    s = _scores(kind, (2, n), n + k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_v, got_i = topk_lowest_index(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    if kind == "tied":
        np.testing.assert_array_equal(got_i.numpy(), np.broadcast_to(np.arange(k), (2, k)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_det", [300, 20])
def test_v10_postprocess_ties_match_jax(kind, max_det):
    """2D: box column 0 holds the anchor index, so equal boxes are equal
    anchor indices; labels are the class indices of the second selection."""
    A, nc = 2100, 80
    rng = np.random.default_rng(max_det)
    boxes = rng.uniform(0, 640, (2, A, 4)).astype(np.float32)
    boxes[..., 0] = np.arange(A)
    preds = np.concatenate([boxes, _scores(kind, (2, A, nc), A)], -1)
    want = JP.v10_postprocess(jnp.asarray(preds), max_det, nc)
    got = TP.v10_postprocess(torch.from_numpy(preds), max_det, nc)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_det", [50, 100])
def test_v10_3d_postprocess_ties_match_jax(kind, max_det):
    """3D: raw class logits (here the tied scores) and 35 regression values,
    the first of which holds the anchor index."""
    A, nc = 1520, 3
    rng = np.random.default_rng(max_det + 1)
    reg = rng.normal(0, 1, (2, A, 35)).astype(np.float32)
    reg[..., 0] = np.arange(A)
    preds = np.concatenate([_scores(kind, (2, A, nc), A), reg], -1)
    want = JP.v10_3d_postprocess(jnp.asarray(preds), max_det, nc)
    got = TP.v10_3d_postprocess(torch.from_numpy(preds), max_det, nc)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_candidates_match_jax(kind):
    """The sparse head's candidates of one scale on a tied class map, against
    the JAX head's selection (``nn/heads3d.py`` ``_sparse_forward_feat``:
    ``jax.lax.top_k`` of the max class logit over the H x W anchors)."""
    B, nc, H, W = 2, 3, 16, 76
    cls_map = _scores(kind, (B, H, W, nc), H * W)  # JAX's NHWC
    want = jax.lax.top_k(jnp.asarray(cls_map).max(axis=-1).reshape(B, H * W), SPARSE_K)[1]
    got = candidates(torch.from_numpy(cls_map.transpose(0, 3, 1, 2).copy()), SPARSE_K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# A small 3D head: yolov10n_3D's three scales at 128x608 (P3 16x76 runs
# sparse, P4 and P5 dense), 16-channel branches.
HEAD_CH = (16, 32, 64)
HEAD_SHAPES = [(16, 76), (8, 38), (4, 19)]
BRANCH_C = tuple((f"{n}_c", 16) for n in ("cls", "o2d", "s2d", "o3d", "s3d", "hd", "dep",
                                            "dep_un"))


def _tie_groups(cls_map, k):
    """Per image: (anchors above the k-th max class logit, anchors tied with it)."""
    s = cls_map.amax(1).flatten(1)
    kth = torch.sort(s, 1, descending=True).values[:, k - 1 : k]
    return [(int(a), int(t)) for a, t in zip((s > kth).sum(1), (s == kth).sum(1))]


def test_sparse_3d_head_on_tied_input_matches_jax():
    """Flat features (image 0 at 0.1, image 1 at 0.3 everywhere, as a
    letterboxed border gives): every interior anchor of a scale has the same
    logits, and the P3 top-50 cut falls inside a tied group. The port's
    sparse head keeps JAX's candidates (equal non-zero masks; values within
    the bar of tests/test_torch_detect3d.py, 1e-4 + 1e-4 |y|), the
    detections through the shared decode and top-k are JAX's (the 2D box
    columns are anchor positions, so equal rows are equal anchors), and the
    port's sparse detections equal its dense ones: the decode's top-k picks
    only candidates under the same tie rule."""
    nc = 3
    jhead = JaxV10Detect3d(nc=nc, ch=HEAD_CH, cfg=(("channels", BRANCH_C),), sparse_eval=True,
                           eval_one2many=False)
    xs = [np.stack([np.full((h, w, c), v, np.float32) for v in (0.1, 0.3)])
          for (h, w), c in zip(HEAD_SHAPES, HEAD_CH)]
    with torch.random.fork_rng():  # seeded random weights, copied into the JAX tree
        torch.manual_seed(0)
        head = V10Detect3d(nc, HEAD_CH, {"channels": dict(BRANCH_C)}).eval()
    tree = jax.eval_shape(lambda x: jhead.init(jax.random.PRNGKey(0), x, train=False),
                          [jnp.asarray(x) for x in xs])
    variables = port_to_flax(tree, head)
    jax_maps = jax.jit(lambda v, xs: jhead.apply(v, xs, train=False)["one2one"])(
        variables, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        txs = [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() for x in xs]
        sparse = head(txs, one2many=False, sparse=True)["one2one"]
        dense = head(txs, one2many=False)["one2one"]
    for above, tied in _tie_groups(sparse[0][:, :nc], SPARSE_K):
        assert above < SPARSE_K < above + tied  # the cut splits a tied group

    for j, s in zip(jax_maps, sparse):
        j, s = np.asarray(j), s.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(np.abs(s[..., nc:]).sum(-1) > 0,
                                      np.abs(j[..., nc:]).sum(-1) > 0)
        np.testing.assert_allclose(s, j, rtol=1e-4, atol=1e-4)

    strides = (8, 16, 32)
    want = JP.v10_3d_postprocess(
        JP.decode_detect3d(list(jax_maps), strides, nc), SPARSE_K, nc)
    got = TP.v10_3d_postprocess(TP.decode_detect3d(sparse, strides, nc), SPARSE_K, nc)
    got_dense = TP.v10_3d_postprocess(TP.decode_detect3d(dense, strides, nc), SPARSE_K, nc)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0][..., :4].numpy(), np.asarray(want[0])[..., :4],
                               rtol=0, atol=0.1)  # 2D box in px: the anchor's position
    assert torch.equal(got[2], got_dense[2]) and torch.equal(got[1], got_dense[1])
    np.testing.assert_allclose(got[0].numpy(), got_dense[0].numpy(), rtol=1e-4, atol=1e-4)

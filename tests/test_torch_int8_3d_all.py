"""The tests of tests/test_torch_int8_3d.py at int8 scope all: the 3D plan
against JAX's gate, the whole int8 forward's maps, every gated conv on JAX's
own input to it and the head's detections against JAX's, and a sparse
request under int8 equal to the dense one, with that module's bars."""

from test_torch_int8_3d import (  # noqa: F401  (collected here at this SCOPE)
    pair, test_convs3d_match_jax_on_its_inputs, test_detections3d_match_jax,
    test_maps3d_match_jax, test_plan3d_matches_jax_gate, test_sparse_equals_dense_under_int8,
)
from _torch_threads import torch_threads  # noqa: F401  (autouse)

SCOPE = "all"

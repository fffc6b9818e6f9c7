"""The port's pyramid resize matrices against the weights the JAX pipeline
really multiplies by, compared exactly.

``extract_orb_batch`` calls ``resize_weights`` while traced under
``jax.jit``; there the reference's call into jax's private
``compute_weight_mat`` yields a tracer, ``np.asarray`` raises, and its
explicit-formula branch runs. The test captures the weights on that same
branch with ``jax.make_jaxpr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_detailed_comments_kor_tpu.ops import pyramid as jpyr
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as tpyr


def _jax_pipeline_weights(pairs):
    """The weights JAX's resize_weights returns while traced under jit —
    the branch extract_orb_batch actually runs."""
    got = {}

    def f():
        for i, o in pairs:
            got[(i, o)] = jpyr.resize_weights(i, o)
        return jnp.zeros(())

    jax.make_jaxpr(f)()
    return got


@pytest.mark.parametrize("hw", [(480, 752), (240, 376)])
def test_resize_matrices_equal(hw):
    shapes = tpyr.level_shapes(hw[0], hw[1], 8, 1.2)
    assert shapes == jpyr.level_shapes(hw[0], hw[1], 8, 1.2)
    pairs = []
    for a, b in zip(shapes[:-1], shapes[1:]):
        pairs += [(a[0], b[0]), (a[1], b[1])]
    ref = _jax_pipeline_weights(pairs)
    for (i, o), w in ref.items():
        assert isinstance(w, np.ndarray)
        mine = tpyr.resize_weights(i, o)
        assert mine.dtype == np.float32 and np.array_equal(mine, w), (i, o)

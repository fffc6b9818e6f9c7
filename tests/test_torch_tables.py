"""The port's ORB constant tables and descriptor packing against the JAX
reference. Both are compared exactly: the tables are built by the same
numpy code, and packing is integer bit arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu.ops import orb as jorb
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as torb


def test_orb_tables_equal():
    for t in ("_W_MOM", "_BR", "_BC", "_BIN_LIN", "_PATTERN"):
        a, b = getattr(jorb, t), getattr(torb, t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t


def test_pack_descriptors_bit_layout():
    """Packed words are the reference's uint32 words, held as int32 bits."""
    rng = np.random.default_rng(1)
    bits = (rng.random((37, 256)) > 0.5).astype(np.uint8)
    packed_j = np.asarray(jorb.pack_descriptors(jnp.asarray(bits)))
    packed_t = torb.pack_descriptors(torch.from_numpy(bits))
    assert packed_t.dtype == torch.int32
    assert np.array_equal(packed_t.numpy().view(np.uint32), packed_j)
    assert np.array_equal(torb.unpack_descriptors(packed_t).numpy(), bits)

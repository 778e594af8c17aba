"""K3's plain version (``sfd2_torch/ops/gather.py``) against the JAX
package's row gather: the Pallas kernel in interpret mode and ``jnp.take``.

A gather moves values without arithmetic, so every comparison is exact.
The kernel's own tests are in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.ops.cuda_gather import gather_rows_cuda
from sfd2_torch.ops.gather import gather_rows_plain
from sfd2_tpu.ops.pallas_gather import gather_rows_pallas

torch.set_num_threads(2)


@pytest.mark.parametrize("c", [1, 3, 6, 8, 9])
@pytest.mark.parametrize("sort", [False, True])
def test_gather_matches_pallas_interpret(rng, c, sort):
    """Bundle adjustment's widths; table and index counts not multiples of 128."""
    table = rng.normal(size=(300, c)).astype(np.float32)
    idx = rng.integers(0, 300, size=517).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    got = gather_rows_cuda(torch.from_numpy(table), torch.from_numpy(idx))  # CPU: plain
    ref = gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take(jnp.asarray(table),
                                                                   jnp.asarray(idx), axis=0)))


def test_gather_large_table_matches_take(rng):
    """A many-chunk table (the TPU kernel's bounded walk) and an unsorted index."""
    table = rng.normal(size=(20_000, 3)).astype(np.float32)
    idx = rng.integers(0, 20_000, size=4096).astype(np.int32)
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take(jnp.asarray(table),
                                                                   jnp.asarray(idx), axis=0)))


def test_gather_wrapper_on_cpu_counts_no_launch(rng):
    table = torch.from_numpy(rng.normal(size=(10, 9)).astype(np.float32))
    idx = torch.tensor([3, 3, 0, 9], dtype=torch.int32)
    before = gather_rows_cuda.launches
    assert torch.equal(gather_rows_cuda(table, idx), table[idx.long()])
    assert gather_rows_cuda.launches == before

"""The port's bitonic row sort (mcmc_ammsb_tpu_torch/ops/sort.py) against
numpy's sort and the JAX package's bitonic_sort_rows (tests/test_sort.py's
cases): the same static compare-exchange network as torch ops, padding
with +-inf or the integer limits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.ops.sort import bitonic_sort_rows as jax_sort
from mcmc_ammsb_tpu_torch.ops.sort import bitonic_sort_rows


@pytest.mark.parametrize("n", [1, 2, 7, 32, 100, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sort_matches_numpy_and_jax(n, dtype):
    rng = np.random.RandomState(n)
    if dtype == np.float32:
        x = rng.randn(16, n).astype(np.float32)
    else:
        x = rng.randint(-1000, 1000, (16, n)).astype(np.int32)
    got = bitonic_sort_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x, axis=-1))
    np.testing.assert_array_equal(got, np.asarray(jax_sort(jnp.asarray(x))))


def test_sort_descending_and_batch_dims():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 33).astype(np.float32)
    got = bitonic_sort_rows(torch.from_numpy(x), descending=True).numpy()
    np.testing.assert_array_equal(got, -np.sort(-x, axis=-1))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sort(jnp.asarray(x), descending=True)))


def test_sort_with_duplicates_infinities_and_integer_limits():
    """Duplicates sort stably in value; +-inf and the integer limits in
    the data do not collide with the padding (5 lanes pad to 8)."""
    x = torch.tensor([[3, 1, 3, 1], [2, 2, 2, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(bitonic_sort_rows(x).numpy(),
                                  [[1, 1, 3, 3], [2, 2, 2, 2]])
    f = torch.tensor([[float("inf"), -1.0, float("-inf"), 0.5, 2.0]])
    np.testing.assert_array_equal(bitonic_sort_rows(f).numpy(),
                                  np.sort(f.numpy(), axis=-1))
    np.testing.assert_array_equal(
        bitonic_sort_rows(f, descending=True).numpy(),
        -np.sort(-f.numpy(), axis=-1))
    i = torch.tensor([[np.iinfo(np.int32).max, 7, np.iinfo(np.int32).min,
                       0, -3]], dtype=torch.int32)
    np.testing.assert_array_equal(bitonic_sort_rows(i).numpy(),
                                  np.sort(i.numpy(), axis=-1))


@pytest.mark.cuda
def test_sort_on_gpu_equals_torch_sort():
    """On a GPU: equal to torch.sort on the card's tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.randn(64, 100, device="cuda")
    assert torch.equal(bitonic_sort_rows(x), torch.sort(x, dim=-1).values)

"""The port's Threefry draw table against the reference's _stable_bits_table:
bit for bit, for random int32 uids (rescue uids >= 1 << 30 included), several
seeds and every parity of max_steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telomeri_tpu.walk.engine import _stable_bits_table
from telomeri_tpu_torch.walk.engine import stable_bits_table


def _uids(rng, n=64):
    base = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
    rescue = (1 << 30) + rng.integers(0, 1 << 24, n // 4, dtype=np.int64)
    return np.concatenate([[0, 1, 2**31 - 1], base, rescue]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("max_steps", [1, 9, 10, 24, 32, 63])
def test_bits_table_bitwise_equal_reference(rng, seed, max_steps):
    uid = _uids(rng)
    ref = np.asarray(_stable_bits_table(seed, jnp.asarray(uid), max_steps))
    got = stable_bits_table(seed, torch.from_numpy(uid), max_steps)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))


def test_bits_table_prefix_stable_in_max_steps(rng):
    uid = torch.from_numpy(_uids(rng))
    long = stable_bits_table(3, uid, 32)
    for s in (1, 9, 10, 24):
        torch.testing.assert_close(stable_bits_table(3, uid, s), long[:s], rtol=0, atol=0)

"""The port's Threefry draw table against the reference's _stable_bits_table:
bit for bit, for random int32 uids (rescue uids >= 1 << 30 included), several
seeds and every parity of max_steps. And the walk-scan kernel's own draw
(csrc/walk_scan.cu computes it in registers, so no table exists on its path),
transcribed statement for statement into scalar numpy.uint32 arithmetic: held
against both tables and against jax.random's fold_in, so that the kernel's
arithmetic is checked before a card compiles it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telomeri_tpu.walk.engine import _stable_bits_table
from telomeri_tpu_torch.kernels.walk_common import stable_bits_table


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


def _rotl32(x: np.uint32, r: int) -> np.uint32:
    return np.uint32((int(x) << r | int(x) >> (32 - r)) & 0xFFFFFFFF)


def _kernel_threefry2x32(k0, k1, x0, x1):
    """csrc/walk_scan.cu threefry2x32, in numpy.uint32 (sums wrap as in C)."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for j in range(4):
                x0 = x0 + x1
                x1 = _rotl32(x1, rot[i % 2][j]) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _kernel_draws(seed: int, uid: int, max_steps: int) -> tuple[np.ndarray, tuple]:
    """The kernel's sequence for one walk: the fold-in once, then one block for
    every two steps, in groups of four steps as the kernel's loop runs them.
    Returns (the S draws as int32 bit patterns, the folded key)."""
    u32 = lambda v: np.uint32(int(v) & 0xFFFFFFFF)
    k0, k1 = _kernel_threefry2x32(np.uint32(0), u32(seed), np.uint32(0), u32(uid))
    out = []
    for s0 in range(0, max_steps, 4):
        y0 = y1 = np.uint32(0)
        for i in range(4):
            s = s0 + i
            if s < max_steps:
                if i % 2 == 0:
                    y0, y1 = _kernel_threefry2x32(k0, k1, u32(s), u32(s + 1))
                out.append(y1 if i % 2 else y0)
    return np.array(out, np.uint32).view(np.int32), (k0, k1)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -7, -2**31])
@pytest.mark.parametrize("max_steps", [1, 24, 33])
def test_kernel_threefry_transcription_equals_both_tables_and_jax(rng, seed, max_steps):
    import jax

    uid = _uids(rng, 8)
    ref = np.asarray(_stable_bits_table(seed, jnp.asarray(uid), max_steps)).view(np.int32)
    port = stable_bits_table(seed, torch.from_numpy(uid), max_steps).numpy()
    base = jax.random.key(seed, impl="threefry2x32")
    for j, u in enumerate(uid):
        draws, key = _kernel_draws(seed, int(u), max_steps)
        np.testing.assert_array_equal(draws, ref[:, j], err_msg=f"uid {u}")
        np.testing.assert_array_equal(draws, port[:, j], err_msg=f"uid {u}")
        folded = np.asarray(jax.random.key_data(jax.random.fold_in(base, u)))
        assert (int(key[0]), int(key[1])) == (int(folded[0]), int(folded[1]))

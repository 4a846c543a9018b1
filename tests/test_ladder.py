"""Direct unit tests for device/_ladder.py against naive window packing.

The ladders are the source of truth for the device k-mer paths; this
locks their recurrences independently of ``device.kmers``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu.device import _ladder


def _roll_left(x, j):
    return x if j == 0 else jnp.roll(x, -j, axis=-1)


def naive_parts(codes, k):
    """Reference implementation: per-window python packing."""
    b, l = codes.shape
    fwd_hi = np.zeros((b, l), np.uint64)
    fwd_lo = np.zeros((b, l), np.uint64)
    rc_hi = np.zeros((b, l), np.uint64)
    rc_lo = np.zeros((b, l), np.uint64)
    valid = np.zeros((b, l), bool)
    for r in range(b):
        for p in range(l - k + 1):
            win = codes[r, p : p + k]
            if (win > 3).any():
                continue
            valid[r, p] = True
            fwd = 0
            for c in win:
                fwd = (fwd << 2) | int(c)
            rc = 0
            for c in win[::-1]:
                rc = (rc << 2) | (3 - int(c))
            fwd_hi[r, p] = fwd >> 32
            fwd_lo[r, p] = fwd & 0xFFFFFFFF
            rc_hi[r, p] = rc >> 32
            rc_lo[r, p] = rc & 0xFFFFFFFF
    return fwd_hi, fwd_lo, rc_hi, rc_lo, valid


@pytest.mark.parametrize("k", [1, 2, 3, 7, 11, 16, 17, 19, 24, 31])
def test_canonical_parts_vs_naive(k):
    rng = np.random.default_rng(k)
    codes_np = rng.choice(
        np.array([0, 1, 2, 3, 255], np.uint32), size=(4, 48), p=[0.23, 0.23, 0.23, 0.23, 0.08]
    )
    codes = jnp.asarray(codes_np)
    fh, fl, rh, rl, vu = _ladder.canonical_parts(codes, k, _roll_left)
    nfh, nfl, nrh, nrl, nv = naive_parts(codes_np, k)
    num = 48 - k + 1
    v = nv[:, :num]
    for got, exp, name in [
        (fh, nfh, "fwd_hi"),
        (fl, nfl, "fwd_lo"),
        (rh, nrh, "rc_hi"),
        (rl, nrl, "rc_lo"),
    ]:
        g = np.asarray(got)[:, :num][v].astype(np.uint64)
        e = exp[:, :num][v]
        assert np.array_equal(g, e), (k, name)
    assert np.array_equal((np.asarray(vu)[:, :num] != 0), v)

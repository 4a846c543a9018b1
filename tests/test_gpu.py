"""Card-only checks: the compiled device steps on an NVIDIA GPU.

Every test takes the ``gpu`` fixture, which skips unless JAX's default
device is a GPU.  ``chip_smoke.py`` runs these on the card with
``NEEDLETAIL_TEST_PLATFORM=gpu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu.utils.kmer_oracle import KmerTally

pytestmark = pytest.mark.gpu


def _reads(b, l, seed):
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(b, l))
    seqs[rng.random((b, l)) < 0.001] = ord("N")
    lengths = rng.integers(l - 20, l + 1, b).astype(np.int32)
    return seqs, lengths


@pytest.mark.parametrize("k", [9, 21, 31])
def test_hash_step_matches_oracle_at_full_batch(gpu, k):
    from needletail_tpu.device.hashcount import (
        canonical_hash_keys_packed,
        hash_histogram,
    )
    from needletail_tpu.encoding import pack_codes_host

    seqs, lengths = _reads(65536, 152, seed=k)
    codes, vbits = pack_codes_host(seqs, lengths)
    keys, total, fwd = canonical_hash_keys_packed(
        jnp.asarray(codes), jnp.asarray(vbits), jnp.asarray(lengths), k
    )
    oracle = KmerTally(k)
    oracle.add(seqs, lengths)
    assert (int(total), int(fwd)) == (oracle.total, oracle.forward)
    assert np.array_equal(np.asarray(hash_histogram(keys)), oracle.table)


def test_donated_hash_state_survives_repeat_runs(gpu, data_dir):
    """The hash step donates its table and tallies; a second run in the
    same process must not read a donated buffer."""
    from needletail_tpu.device.pipeline import hash_count_file

    path = str(data_dir / "PRJNA271013_head.fq")
    first = hash_count_file(path, k=21, batch_size=512)
    second = hash_count_file(path, k=21, batch_size=512)
    assert first[:3] == second[:3] == (250_000, 209_965, 106_181)
    assert np.array_equal(first[3], second[3])

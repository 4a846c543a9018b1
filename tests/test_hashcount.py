"""The hash-count step (``device.hashcount``) and the numpy oracle it is
held to (``utils.kmer_oracle``), which is itself checked against the host
``bitkmer`` path."""

import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu.bitkmer import bit_kmers
from needletail_tpu.device.hashcount import (
    canonical_hash_keys,
    canonical_hash_keys_packed,
    check_table_bits,
    hash_histogram,
)
from needletail_tpu.encoding import pack_codes_host
from needletail_tpu.utils.kmer_oracle import KmerTally, canonical_windows

C1 = np.uint32(0x9E3779B1)
C2 = np.uint32(0x85EBCA77)


def random_batch(b, l, seed, alphabet=b"ACGTNacgtuU"):
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(alphabet, np.uint8), size=(b, l))
    lengths = rng.integers(0, l + 1, size=b).astype(np.int32)
    return seqs.astype(np.uint8), lengths


def oracle_keys(seqs, lengths, k, normalized, table_bits=16):
    """[B, L-k+1] int32 hash keys, -1 where the window is invalid."""
    values, valid, _ = canonical_windows(seqs, lengths, k, normalized)
    hi = (values >> np.uint64(32)).astype(np.uint32)
    lo = (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h = ((lo * C1) ^ (hi * C2)) & np.uint32((1 << table_bits) - 1)
    return np.where(valid, h.astype(np.int32), -1)


@pytest.mark.parametrize("transport", ["ascii", "packed"])
@pytest.mark.parametrize("normalized", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("k", [2, 8, 15, 16, 17, 21, 31])
def test_hash_keys_match_numpy_hash(k, normalized, transport):
    seqs, lengths = random_batch(48, 64, seed=k)
    if transport == "ascii":
        keys, total, fwd = canonical_hash_keys(
            jnp.asarray(seqs), jnp.asarray(lengths), k, normalized=normalized
        )
    else:
        codes, vbits = pack_codes_host(seqs, lengths, normalized=normalized)
        keys, total, fwd = canonical_hash_keys_packed(
            jnp.asarray(codes),
            None if vbits is None else jnp.asarray(vbits),
            jnp.asarray(lengths),
            k,
        )
    want = oracle_keys(seqs, lengths, k, normalized)
    assert np.array_equal(np.asarray(keys), want)
    oracle = KmerTally(k, normalized=normalized)
    oracle.add(seqs, lengths)
    assert (int(total), int(fwd)) == (oracle.total, oracle.forward)
    assert np.array_equal(np.asarray(hash_histogram(keys)), oracle.table)


class TestHashHistogram:
    def test_matches_bincount(self):
        rng = np.random.default_rng(0)
        keys = rng.integers(-1, 1 << 16, size=(64, 128)).astype(np.int32)
        got = np.asarray(hash_histogram(jnp.asarray(keys)))
        assert np.array_equal(got, np.bincount(keys[keys >= 0], minlength=1 << 16))

    def test_all_invalid(self):
        keys = jnp.full((32, 128), -1, jnp.int32)
        assert int(np.asarray(hash_histogram(keys)).sum()) == 0

    def test_minus_one_never_wraps_to_last_bin(self):
        keys = jnp.asarray(np.array([-1, -1, -1, 5], np.int32))
        got = np.asarray(hash_histogram(keys))
        assert got[-1] == 0 and got[5] == 1 and got.sum() == 1

    def test_last_bin_counts(self):
        keys = jnp.asarray(np.array([(1 << 16) - 1] * 3 + [0], np.int32))
        got = np.asarray(hash_histogram(keys))
        assert got[-1] == 3 and got[0] == 1 and got.sum() == 4

    def test_keys_past_the_table_drop(self):
        keys = jnp.asarray(np.array([0, 15, 16, 40000], np.int32))
        got = np.asarray(hash_histogram(keys, 16))
        assert got.shape == (16,) and got[0] == got[15] == 1 and got.sum() == 2


@pytest.mark.parametrize("bits", [17, 20])
def test_table_bits_limit(bits):
    with pytest.raises(ValueError, match="2\\^16 bins"):
        check_table_bits(bits)


@pytest.mark.parametrize("k", [1, 2, 8, 15, 16, 17, 21, 31])
def test_oracle_matches_host_bitkmer(k):
    """The oracle's canonical windows equal ``bitkmer.bit_kmers`` with
    ``canonical_form=True`` on a few hundred records (raw mode)."""
    seqs, lengths = random_batch(300, 64, seed=100 + k, alphabet=b"ACGTNacgt")
    values, valid, fwd = canonical_windows(seqs, lengths, k, normalized=False)
    for i in range(seqs.shape[0]):
        got = [
            (int(p), int(values[i, p]), not bool(fwd[i, p]))
            for p in np.flatnonzero(valid[i])
        ]
        want = [
            (p, v[0], rc)
            for p, v, rc in bit_kmers(
                bytes(seqs[i, : lengths[i]]), k, canonical_form=True
            )
        ]
        assert got == want, i

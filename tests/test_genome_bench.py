"""BASELINE config #4 machinery (VERDICT r3 #3): the genome benchmark's
device flush (ladder extraction -> sort -> run-length -> compaction ->
mod-2^32 spectrum checksum) must agree with the host-oracle
``genome_spectrum`` path, and the synthetic genome must be byte-stable
across rounds (the golden asserts in bench.py depend on it)."""

import hashlib

import numpy as np
import pytest

from needletail_tpu.utils.synth import synthetic_genome

N = 200_000
K = 31


def test_synthetic_genome_deterministic():
    a = synthetic_genome(N, seed=31)
    b = synthetic_genome(N, seed=31)
    assert a == b
    assert a.startswith(b">synth ")
    seq = bytes(a[a.index(b"\n") + 1 :]).replace(b"\n", b"")
    assert len(seq) == N
    assert set(seq) <= set(b"ACGT")
    # bench.py's 5 Mbp goldens ride on this exact byte stream staying
    # fixed; lock the prefix generator via a digest of the small case
    assert hashlib.sha256(a).hexdigest() == (
        "dd74a0f992c6ffe4969480b66b5cce1ee89c9fce7b23430d28b513f9e83f4c53"
    )


def test_synthetic_genome_line_wrap():
    fa = synthetic_genome(1003, seed=7, line_width=60)
    lines = fa.split(b"\n")
    assert lines[0].startswith(b">")
    body = lines[1:-1] if lines[-1] == b"" else lines[1:]
    assert all(len(l) == 60 for l in body[:-1])
    assert len(body[-1]) == 1003 % 60
    assert sum(len(l) for l in body) == 1003


@pytest.fixture(scope="module")
def genome_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("genome") / "synth.fa"
    p.write_bytes(synthetic_genome(N, seed=31))
    return str(p)


def test_bench_flush_matches_host_oracle(genome_file):
    import jax
    import jax.numpy as jnp

    from needletail_tpu.device import count as _count
    from needletail_tpu.device import kmers as _kmers
    from needletail_tpu.device.tiling import genome_spectrum, tile_sequence

    # host-oracle spectrum (the correctness-tested path)
    n_bases, (keys, counts) = genome_spectrum(
        genome_file, K, sparse_format="arrays"
    )
    assert n_bases == N
    M = np.uint64(0xFFFFFFFF)
    c = counts.astype(np.uint64)
    want = (
        len(keys),
        int(counts.sum()),
        int(((keys & M) * c).sum() & M),
        int(((keys >> np.uint64(32)) * c).sum() & M),
    )

    # bench.py's one-flush device-resident formulation
    fa = open(genome_file, "rb").read()
    seq = bytes(fa[fa.index(b"\n") + 1 :]).replace(b"\n", b"")
    tiles, lens = tile_sequence(seq, K, tile_len=8192)

    @jax.jit
    def flush(tiles, lengths):
        # mirrors bench.py's genome_flush: no distinct-to-front compaction
        # (mostly-distinct regime); checksums read the run heads directly
        win = _kmers.canonical_kmers(tiles, lengths, K)
        hi, lo = _count.mask_keys(win)
        pad = (-lo.shape[0]) % (1 << 20)
        if pad:
            fill = jnp.full((pad,), 0xFFFFFFFF, dtype=jnp.uint32)
            hi = jnp.concatenate([hi, fill])
            lo = jnp.concatenate([lo, fill])
        hi_s, lo_s, cnt = _count.unique_counts(hi, lo)
        cu = cnt.astype(jnp.uint32)
        n = jnp.sum((cnt > 0).astype(jnp.int32))
        return jnp.stack(
            [
                n.astype(jnp.uint32),
                cnt.sum().astype(jnp.uint32),
                jnp.sum(lo_s * cu, dtype=jnp.uint32),
                jnp.sum(hi_s * cu, dtype=jnp.uint32),
            ]
        )

    got = np.asarray(flush(jnp.asarray(tiles), jnp.asarray(lens)))
    assert tuple(int(x) for x in got) == want


class TestAdaptiveCompaction:
    """finalize_sparse with distinct-to-front device compaction equals the
    host compaction, for a mostly-distinct stream (whole-genome regime) and
    for a low-diversity one."""

    def _parts(self, keys64):
        import jax.numpy as jnp

        hi = (keys64 >> np.uint64(32)).astype(np.uint32)
        lo = (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return [(jnp.asarray(hi), jnp.asarray(lo))]

    def test_mostly_distinct_skips_compaction(self):
        from needletail_tpu.device.count import finalize_sparse

        rng = np.random.default_rng(5)
        keys = rng.choice(2**40, size=20_000, replace=False).astype(np.uint64)
        want_k, want_c = finalize_sparse(
            self._parts(keys), pad_multiple=8192, device_compact=False
        )
        got_k, got_c = finalize_sparse(
            self._parts(keys), pad_multiple=8192, device_compact=True,
        )
        assert np.array_equal(want_k, got_k)
        assert np.array_equal(want_c, got_c)
        assert (got_c == 1).all() and len(got_k) == 20_000

    def test_low_diversity_still_compacts(self):
        from needletail_tpu.device.count import finalize_sparse

        rng = np.random.default_rng(6)
        distinct = rng.choice(2**40, size=500, replace=False).astype(np.uint64)
        keys = np.repeat(distinct, rng.integers(16, 120, size=500))
        want_k, want_c = finalize_sparse(
            self._parts(keys), pad_multiple=8192, device_compact=False
        )
        got_k, got_c = finalize_sparse(
            self._parts(keys), pad_multiple=8192, device_compact=True,
        )
        assert np.array_equal(want_k, got_k)
        assert np.array_equal(want_c, got_c)

    def test_device_compaction_counts_distinct(self):
        import jax.numpy as jnp

        from needletail_tpu.device import count as dcount

        keys = np.arange(16384, dtype=np.uint64) * 7919
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi_s, lo_s, counts = dcount.unique_counts(
            jnp.asarray(hi), jnp.asarray(lo)
        )
        h_c, l_c, c_c, n = dcount.compact_runs_device(hi_s, lo_s, counts)
        assert int(n) == 16384
        got = (np.asarray(h_c).astype(np.uint64) << np.uint64(32)) | np.asarray(l_c)
        assert np.array_equal(got, keys)
        assert (np.asarray(c_c) == 1).all()


def test_tile_keys_match_ladder_on_tiles(genome_file):
    """genome_spectrum's tile key step (packed transport, tile-owned
    window slice) equals the XLA ladder over the same halo tiles."""
    import jax.numpy as jnp

    from needletail_tpu.device import count as _count
    from needletail_tpu.device import kmers as _kmers
    from needletail_tpu.device.tiling import make_tile_key_fn, tile_sequence
    from needletail_tpu.encoding import pack_codes_host

    fa = open(genome_file, "rb").read()
    seq = bytes(fa[fa.index(b"\n") + 1 :]).replace(b"\n", b"")
    tiles, lens = tile_sequence(seq, K, tile_len=8192)
    win = _kmers.canonical_kmers(jnp.asarray(tiles), jnp.asarray(lens), K)
    hi_x, lo_x = _count.mask_keys(win)
    w = win.hi.shape[1]
    # the packed transport needs a multiple of 8 bases per row
    padded = np.pad(tiles, ((0, 0), (0, -tiles.shape[1] % 8)))
    codes, vbits = pack_codes_host(padded, lens)
    hi, lo = make_tile_key_fn(K, 8192, packed=True)(
        jnp.asarray(codes), jnp.asarray(lens),
        None if vbits is None else jnp.asarray(vbits),
    )
    n = tiles.shape[0]
    own = min(8192, w)
    assert np.array_equal(
        np.asarray(hi), np.asarray(hi_x).reshape(n, w)[:, :own].reshape(-1)
    )
    assert np.array_equal(
        np.asarray(lo), np.asarray(lo_x).reshape(n, w)[:, :own].reshape(-1)
    )

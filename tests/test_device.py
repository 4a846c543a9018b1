"""Device (JAX) path tests, run on CPU backend.

Parity oracle: the host implementations (needletail_tpu.sequence/kmer/
bitkmer), themselves locked to the reference by tests/test_sequence_ops.py,
plus the 28S.fasta golden invariants (ref benches/benchmark.rs:43-67)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu import bitkmer as hb
from needletail_tpu import kmer as hk
from needletail_tpu import sequence as hs
from needletail_tpu.batch import ReadBatch, read_batches
from needletail_tpu.device import count as dcount
from needletail_tpu.device import kmers as dkmers
from needletail_tpu.device import ops as dops
from needletail_tpu.device import pipeline as dpipe
from needletail_tpu.parser import parse_fastx_file


def batch_of(seqs, quals=None, max_len=None):
    L = max_len or max(len(s) for s in seqs)
    arr = np.zeros((len(seqs), L), dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    q = None
    if quals is not None:
        q = np.zeros((len(seqs), L), dtype=np.uint8)
        for i, s in enumerate(quals):
            q[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return jnp.asarray(arr), jnp.asarray(lengths), (jnp.asarray(q) if q is not None else None)


class TestElementwiseOps:
    def test_normalize_matches_host(self):
        cases = [b"ACGTU", b"acgtu", b"BDHVRYSWKM", b"bdhvryswkm", b"N.N-N~N", b"xyz123"]
        seqs, lengths, _ = batch_of(cases, max_len=16)
        for iupac in (False, True):
            out, keep = dops.normalize(seqs, iupac=iupac)
            out = np.asarray(out)
            keep = np.asarray(keep)
            for i, case in enumerate(cases):
                host = hs.normalize(case, iupac)
                host = host if host is not None else case
                dev = bytes(out[i, : lengths[i]][keep[i, : lengths[i]]])
                assert dev == host, (case, iupac)

    def test_complement_matches_host(self):
        data = bytes(range(1, 256))
        seqs, lengths, _ = batch_of([data])
        out = np.asarray(dops.complement(seqs))
        assert bytes(out[0]) == bytes(hs.COMPLEMENT_LUT[np.frombuffer(data, np.uint8)])

    def test_reverse_complement(self):
        cases = [b"AACC", b"acgt", b"NRYK", b"A"]
        seqs, lengths, _ = batch_of(cases, max_len=8)
        out = np.asarray(dops.reverse_complement(seqs, lengths))
        for i, case in enumerate(cases):
            assert bytes(out[i, : len(case)]) == hs.reverse_complement(case)
            assert not out[i, len(case) :].any()  # padding stays zero

    def test_quality_mask(self):
        seqs, lengths, quals = batch_of([b"AGCT"], quals=[b"AAA0"])
        out = np.asarray(dops.quality_mask(seqs, quals, jnp.uint8(ord("5"))))
        assert bytes(out[0, :4]) == b"AGCN"

    def test_decode_phred(self):
        seqs, lengths, quals = batch_of([b"XXXX"], quals=[b"IIII"])
        scores, ok = dops.decode_phred(quals, offset=33)
        assert np.asarray(scores)[0, :4].tolist() == [40, 40, 40, 40]
        assert bool(np.asarray(ok).all())

    def test_encode_2bit_semantics(self):
        seqs, _, _ = batch_of([b"ACGTacgtUuNx-"], max_len=16)
        norm = np.asarray(dops.encode_2bit(seqs, normalized=True))[0]
        raw = np.asarray(dops.encode_2bit(seqs, normalized=False))[0]
        # normalized: U/u -> T code 3
        assert norm[:13].tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 3, 3, 255, 255, 255]
        # raw: U invalid
        assert raw[:13].tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 255, 255, 255, 255, 255]


def host_canonical_values(seq: bytes, k: int):
    """Oracle: canonical bitkmer values + positions + flags via host path."""
    return list(hb.bit_kmers(seq, k, True))


class TestKmerWindows:
    @pytest.mark.parametrize("k", [1, 2, 3, 8, 15, 16, 17, 21, 31])
    def test_canonical_parity_vs_host(self, k):
        rng = np.random.default_rng(42 + k)
        seqs = []
        for _ in range(6):
            n = int(rng.integers(k, 80))
            s = bytes(rng.choice(list(b"ACGTacgtNu-"), size=n).astype(np.uint8))
            seqs.append(s)
        arr, lengths, _ = batch_of(seqs, max_len=96)
        win = dkmers.canonical_kmers(arr, lengths, k, normalized=False)
        hi = np.asarray(win.hi)
        lo = np.asarray(win.lo)
        valid = np.asarray(win.valid)
        was_rc = np.asarray(win.was_rc)
        for i, s in enumerate(seqs):
            expected = host_canonical_values(s, k)
            got_pos = np.nonzero(valid[i])[0].tolist()
            assert got_pos == [p for (p, _, _) in expected], (s, k)
            for (p, (val, _), rc_flag) in expected:
                dev_val = (int(hi[i, p]) << 32) | int(lo[i, p])
                assert dev_val == val, (s, k, p)
                assert bool(was_rc[i, p]) == rc_flag, (s, k, p)

    @pytest.mark.parametrize("k", [4, 16, 17, 31])
    def test_forward_parity_vs_host(self, k):
        rng = np.random.default_rng(7 + k)
        s = bytes(rng.choice(list(b"ACGTN"), size=70).astype(np.uint8))
        arr, lengths, _ = batch_of([s], max_len=70)
        win = dkmers.pack_kmers(arr, lengths, k, normalized=False)
        hi = np.asarray(win.hi)[0]
        lo = np.asarray(win.lo)[0]
        valid = np.asarray(win.valid)[0]
        expected = list(hb.bit_kmers(s, k, False))
        assert np.nonzero(valid)[0].tolist() == [p for (p, _, _) in expected]
        for (p, (val, _), _) in expected:
            assert ((int(hi[p]) << 32) | int(lo[p])) == val


class TestCounting:
    def test_dense_spectrum_small(self):
        arr, lengths, _ = batch_of([b"ACGTA", b"AAAA"], max_len=8)
        win = dkmers.canonical_kmers(arr, lengths, 2, normalized=False)
        spec = np.asarray(dcount.dense_spectrum(win, 2))
        # host oracle
        expected = np.zeros(16, dtype=np.int64)
        for s in [b"ACGTA", b"AAAA"]:
            for (_, (v, _), _) in hb.bit_kmers(s, 2, True):
                expected[v] += 1
        assert (spec == expected).all()

    def test_sorted_spectrum_matches_dense(self):
        rng = np.random.default_rng(3)
        seqs = [bytes(rng.choice(list(b"ACGTN"), size=50).astype(np.uint8)) for _ in range(4)]
        arr, lengths, _ = batch_of(seqs, max_len=64)
        win = dkmers.canonical_kmers(arr, lengths, 5, normalized=False)
        spec = np.asarray(dcount.dense_spectrum(win, 5))
        hi, lo, counts = dcount.sorted_spectrum(win)
        d = dcount.spectrum_to_dict(hi, lo, counts, 5)
        dense_d = {i: int(c) for i, c in enumerate(spec) if c}
        assert d == dense_d

    def test_sorted_spectrum_large_k(self):
        rng = np.random.default_rng(5)
        seqs = [bytes(rng.choice(list(b"ACGT"), size=60).astype(np.uint8)) for _ in range(3)]
        arr, lengths, _ = batch_of(seqs, max_len=64)
        win = dkmers.canonical_kmers(arr, lengths, 21, normalized=False)
        hi, lo, counts = dcount.sorted_spectrum(win)
        d = dcount.spectrum_to_dict(hi, lo, counts, 21)
        # host oracle
        expected = {}
        for s in seqs:
            for (_, (v, _), _) in hb.bit_kmers(s, 21, True):
                expected[v] = expected.get(v, 0) + 1
        assert d == expected


class TestGoldenFile:
    def test_readme_pipeline_device(self):
        n_bases, n_aaaa = dpipe.readme_pipeline("tests/data/28S.fasta")
        assert n_bases == 738580
        assert n_aaaa == 8108  # host-verified canonical AAAA tally

    def test_k31_totals_match_reference_bench(self):
        # ref benches/benchmark.rs:43-44,66-67: 718,007 canonical 31-mers,
        # 350,983 in forward orientation
        total = 0
        fwd = 0
        for batch in read_batches("tests/data/28S.fasta", batch_size=128):
            win = dkmers.canonical_kmers(
                jnp.asarray(batch.seqs), jnp.asarray(batch.lengths), 31
            )
            total += int(dcount.valid_count(win))
            fwd += int(dcount.forward_count(win))
        assert total == 718007
        assert fwd == 350983

    def test_fastq_batches(self):
        got = 0
        for batch in read_batches("tests/data/PRJNA271013_head.fq", batch_size=256):
            got += batch.num_bases
            assert batch.quals is not None
        assert got == 250000  # ref benches/benchmark.rs:97


class TestMultiK:
    def test_multi_k_tally_matches_per_k(self):
        from needletail_tpu.device.pipeline import multi_k_tally

        rng = np.random.default_rng(2)
        seqs = rng.choice(list(b"ACGTN"), size=(8, 64)).astype(np.uint8)
        lengths = np.full(8, 64, np.int32)
        s, l = jnp.asarray(seqs), jnp.asarray(lengths)
        out = multi_k_tally(s, l, ks=(4, 21, 31))
        for k, (total, fwd) in out.items():
            win = dkmers.canonical_kmers(s, l, k)
            assert int(total) == int(np.asarray(win.valid).sum())
            assert int(fwd) == int(
                (np.asarray(win.valid) & ~np.asarray(win.was_rc)).sum()
            )


class TestDenseSpectrum:
    """dense_spectrum (scatter-add into [4^k]) equals the numpy oracle's
    canonical counts bin for bin."""

    @pytest.mark.parametrize("k", [4, 8, 9])
    def test_matches_host(self, k):
        from needletail_tpu.utils.kmer_oracle import canonical_windows

        rng = np.random.default_rng(k)
        seqs = rng.choice(list(b"ACGTN"), size=(32, 64)).astype(np.uint8)
        lengths = rng.integers(0, 65, size=32).astype(np.int32)
        win = dkmers.canonical_kmers(jnp.asarray(seqs), jnp.asarray(lengths), k)
        got = np.asarray(dcount.dense_spectrum(win, k))
        values, valid, _ = canonical_windows(seqs, lengths, k)
        want = np.bincount(values[valid].astype(np.int64), minlength=4**k)
        assert np.array_equal(got, want)


class TestHashCountFile:
    def test_matches_streamed_oracle(self, data_dir):
        from needletail_tpu.device.pipeline import hash_count_file

        n_bases, total, fwd, table = hash_count_file(
            str(data_dir / "PRJNA271013_head.fq"), k=21, batch_size=512
        )
        assert n_bases == 250_000
        # golden canonical k=21 tallies for this corpus (host-verified)
        assert (total, fwd) == (209_965, 106_181)
        assert table.sum() == total
        assert table.shape == (65536,)

    def test_small_table_bits(self, data_dir):
        from needletail_tpu.device.pipeline import hash_count_file

        n_bases, total, fwd, table = hash_count_file(
            str(data_dir / "test.fa"), k=4, table_bits=10, batch_size=8
        )
        assert table.shape == (1024,)
        assert table.sum() == total > 0

    def test_host_workers_parity(self, data_dir):
        from needletail_tpu.device.pipeline import hash_count_file

        path = str(data_dir / "PRJNA271013_head.fq")
        a = hash_count_file(path, k=9, batch_size=512)
        b = hash_count_file(path, k=9, batch_size=512, host_workers=2)
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        assert np.array_equal(a[3], b[3])


class TestSparseStreamingMemory:
    def test_merge_sorted_spectra(self):
        ak = np.array([1, 5, 9], np.uint64); ac = np.array([2, 1, 4], np.int64)
        bk = np.array([0, 5, 10], np.uint64); bc = np.array([7, 3, 1], np.int64)
        k_, c_ = dcount.merge_sorted_spectra(ak, ac, bk, bc)
        assert list(k_) == [0, 1, 5, 9, 10]
        assert list(c_) == [7, 2, 4, 4, 1]
        # identity with empties
        k2, c2 = dcount.merge_sorted_spectra(np.zeros(0, np.uint64), np.zeros(0, np.int64), ak, ac)
        assert np.array_equal(k2, ak) and np.array_equal(c2, ac)

    def test_accumulator_flush_equals_single_pass(self):
        rng = np.random.default_rng(0)
        parts = []
        for s in range(5):
            seqs = rng.choice(list(b"ACGTN"), size=(16, 48)).astype(np.uint8)
            lengths = rng.integers(0, 49, 16).astype(np.int32)
            win = dkmers.canonical_kmers(jnp.asarray(seqs), jnp.asarray(lengths), 13)
            parts.append(dcount.mask_keys(win))
        # tiny flush budget forces several host merges
        acc = dcount.SparseSpectrumAccumulator(flush_lanes=100)
        for hi, lo in parts:
            acc.add(hi, lo)
        k1, c1 = acc.finish()
        k2, c2 = dcount.finalize_sparse(parts, pad_multiple=128)
        assert np.array_equal(k1, k2) and np.array_equal(c1, c2)


class TestLimbAccumulation:
    def test_acc64_carry(self):
        from needletail_tpu.utils.limbs import acc64, limbs_to_int

        lo = jnp.asarray(0xFFFFFFFE, jnp.uint32)
        hi = jnp.asarray(3, jnp.uint32)
        lo2, hi2 = acc64(lo, hi, jnp.asarray(5, jnp.int32))
        assert limbs_to_int(lo2, hi2) == (3 << 32) + 0xFFFFFFFE + 5


class TestBucketedCounting:
    def test_bucketed_equals_flat(self, tmp_path):
        from needletail_tpu.device.pipeline import count_file

        rng = np.random.default_rng(2)
        p = tmp_path / "mixed.fq"
        with open(p, "wb") as f:
            for i, ln in enumerate([30] * 20 + [200] * 5 + [700]):
                seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), ln).tobytes()
                f.write(b"@r%d\n" % i + seq + b"\n+\n" + b"I" * ln + b"\n")
        nb1, spec1 = count_file(str(p), k=11, batch_size=8)
        nb2, spec2 = count_file(str(p), k=11, batch_size=8, bucketed=True)
        assert nb1 == nb2
        assert np.array_equal(spec1, spec2)


class TestQualityAwareCounting:
    def test_quality_cutoff_matches_host_mask(self, tmp_path):
        from needletail_tpu.device.pipeline import count_file
        from needletail_tpu import sequence as hseq
        from needletail_tpu.bitkmer import bit_kmers
        import collections

        rng = np.random.default_rng(4)
        p = tmp_path / "q.fq"
        recs = []
        with open(p, "wb") as f:
            for i in range(40):
                ln = int(rng.integers(10, 60))
                seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln).tobytes()
                qual = rng.integers(33, 74, ln, dtype=np.uint8).tobytes()
                recs.append((seq, qual))
                f.write(b"@r%d\n" % i + seq + b"\n+\n" + qual + b"\n")
        cutoff = 20  # phred score; raw byte cutoff = 33 + 20
        k = 9
        host = collections.Counter()
        for seq, qual in recs:
            masked = hseq.quality_mask(seq, qual, 33 + cutoff)
            for (_p_, (v, _k), _rc) in bit_kmers(masked, k, canonical_form=True):
                host[v] += 1
        nb, spec = count_file(str(p), k=k, batch_size=16, quality_cutoff=cutoff)
        dev = {key: int(c) for key, c in enumerate(spec) if c}
        assert dev == dict(host)

    def test_quality_cutoff_requires_fastq(self, data_dir):
        from needletail_tpu.device.pipeline import count_file

        with pytest.raises(ValueError, match="qualities"):
            count_file(str(data_dir / "test.fa"), k=4, quality_cutoff=20)


class TestRandomizedDeviceHostParity:
    """Randomized full-alphabet (IUPAC, gaps, u/U, lowercase) cross-check:
    device canonical windows vs the host normalize+bitkmer oracle."""

    def test_sweep(self):
        import collections

        from needletail_tpu import sequence as hseq

        rng = np.random.default_rng(123)
        for _ in range(25):
            b = int(rng.integers(1, 8))
            l = int(rng.integers(1, 70))
            k = int(rng.integers(1, 32))
            if l < k:
                continue
            seqs = rng.choice(list(b"ACGTNacgtun.-"), size=(b, l)).astype(np.uint8)
            lengths = rng.integers(0, l + 1, b).astype(np.int32)
            win = dkmers.canonical_kmers(jnp.asarray(seqs), jnp.asarray(lengths), k)
            host = collections.Counter()
            for r in range(b):
                raw = seqs[r, : lengths[r]].tobytes()
                s = hseq.normalize(raw, False)
                if s is None:
                    s = raw
                for (_p, (v, _k), _rc) in hb.bit_kmers(s, k, canonical_form=True):
                    host[v] += 1
            hi = np.asarray(win.hi)[np.asarray(win.valid)].astype(np.uint64)
            lo = np.asarray(win.lo)[np.asarray(win.valid)].astype(np.uint64)
            dev = collections.Counter(((hi << np.uint64(32)) | lo).tolist())
            assert dev == host, (b, l, k)


def test_count_file_host_workers_parity(data_dir):
    from needletail_tpu.device.pipeline import count_file

    path = str(data_dir / "PRJNA271013_head.fq")
    nb1, s1 = count_file(path, k=8, batch_size=512)
    nb2, s2 = count_file(path, k=8, batch_size=512, host_workers=2)
    assert nb1 == nb2
    assert np.array_equal(s1, s2)

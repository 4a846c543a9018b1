"""2-bit packed host->device transport.

Locks three invariants:
  * the C framer's packed fills are bit-exact vs the numpy oracle
    (``encoding.pack_codes_host``) on real corpora and adversarial bytes;
  * every device consumer (unpack_codes -> precoded ladders, the packed
    hash step) produces results identical to the ASCII path;
  * the e2e drivers (count_file / multi_k_count_file / hash_count_file)
    give bit-identical outputs with ``packed`` on and off, across worker
    counts and both IPC transports.
"""

import numpy as np
import pytest

from needletail_tpu.batch import PackedReadBatch, ReadBatch
from needletail_tpu.encoding import (
    ENCODE_NORMALIZED_LUT,
    ENCODE_RAW_LUT,
    encode_lut,
    pack_codes_host,
    unpack_codes_host,
)
from needletail_tpu.io import native
from needletail_tpu.io.fast_batch import fast_read_batches

FQ = "tests/data/PRJNA271013_head.fq"
FA = "tests/data/28S.fasta"


class TestHostPacking:
    def test_luts_differ_only_in_u(self):
        diff = np.flatnonzero(ENCODE_NORMALIZED_LUT != ENCODE_RAW_LUT)
        assert set(diff.tolist()) == {ord("U"), ord("u")}

    @pytest.mark.parametrize("path", [FQ, FA])
    def test_framer_matches_numpy_oracle(self, path):
        for a, p in zip(
            fast_read_batches(path, batch_size=300),
            fast_read_batches(path, batch_size=300, packed=True),
        ):
            oracle = PackedReadBatch.from_read_batch(a)
            assert np.array_equal(p.codes, oracle.codes)
            assert np.array_equal(p.lengths, a.lengths)
            # validity shape (clean / dense / lean) matches the oracle
            assert (p.vbits is None) == (oracle.vbits is None)
            assert (p.vrows is None) == (oracle.vrows is None)
            if p.vbits is not None:
                assert np.array_equal(p.vbits, oracle.vbits)
            if p.vrows is not None:
                assert np.array_equal(p.vrow_idx, oracle.vrow_idx)
                assert np.array_equal(p.vrows, oracle.vrows)

    def test_clean_input_ships_no_vbits(self, tmp_path):
        p = tmp_path / "clean.fq"
        p.write_bytes(b"@r1\nACGTACGT\n+\nIIIIIIII\n" * 64)
        batches = list(fast_read_batches(str(p), packed=True))
        assert len(batches) == 1
        assert batches[0].vbits is None
        assert batches[0].num_bases == 8 * 64

    def test_ambiguous_input_ships_vbits(self, tmp_path):
        p = tmp_path / "dirty.fq"
        p.write_bytes(b"@r1\nACGTNNAC\n+\nIIIIIIII\n")
        (b,) = fast_read_batches(str(p), packed=True)
        # one dirty read out of one: the lean rule keeps the dense plane
        # only when ragged rows would cost more; either way validity ships
        assert b.vbits is not None or b.vrows is not None
        u = b.unpack_host()
        assert (u[0, 4:6] == 255).all()
        assert (u[0, :4] != 255).all()

    def test_pack_row_adversarial(self):
        rng = np.random.default_rng(1)
        for norm in (True, False):
            lut = np.ascontiguousarray(encode_lut(norm))
            for trial in range(40):
                n = int(rng.integers(1, 200))
                if trial % 3 == 0:
                    seq = rng.choice(
                        np.frombuffer(b"ACGTNacgtnUu \t~", np.uint8), n
                    )
                else:
                    seq = rng.integers(1, 256, n, dtype=np.uint8)
                ml = -(-n // 8) * 8
                code = np.zeros(ml // 4, np.uint8)
                vb = np.zeros(ml // 8, np.uint8)
                inv = native.pack_row(seq, lut, code, vb)
                seqs2 = np.zeros((1, ml), np.uint8)
                seqs2[0, :n] = seq
                oc, ov = pack_codes_host(
                    seqs2, np.array([n], np.int32), normalized=norm
                )
                assert np.array_equal(code, oc[0])
                if ov is None:
                    full = np.packbits(np.arange(ml) < n, bitorder="little")
                    assert np.array_equal(vb, full)
                    assert inv == 0
                else:
                    assert np.array_equal(vb, ov[0])
                assert inv == int((lut[seq] > 3).sum())

    def test_unpack_host_roundtrip(self):
        rng = np.random.default_rng(2)
        seqs = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (16, 64))
        lengths = rng.integers(0, 65, 16).astype(np.int32)
        codes, vbits = pack_codes_host(seqs, lengths)
        u = unpack_codes_host(codes, vbits)
        lut = encode_lut(True)
        expect = lut[seqs]
        in_len = np.arange(64)[None, :] < lengths[:, None]
        assert np.array_equal(
            np.where(in_len, u, 0), np.where(in_len, expect, 0)
        )

    def test_packed_rounds_max_len(self):
        """An explicit max_len not divisible by 8 rounds UP (the drivers
        auto-select packed transport, so every ASCII-legal max_len must
        work) — planes quantize, results stay identical."""
        got = list(fast_read_batches(FQ, packed=True, max_len=130))
        ref = list(fast_read_batches(FQ, packed=True, max_len=136))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.num_bases == b.num_bases
            assert np.array_equal(a.codes, b.codes)
            assert np.array_equal(a.lengths, b.lengths)

    def test_pad_reads_to(self):
        (b,) = fast_read_batches(FQ, batch_size=4096, packed=True)
        padded = b.pad_reads_to(4096)
        assert padded.num_reads == 4096
        assert padded.num_bases == b.num_bases
        assert np.array_equal(padded.codes[: b.num_reads], b.codes)


class TestDeviceConsumers:
    def test_unpack_codes_matches_encode(self):
        import jax.numpy as jnp

        from needletail_tpu.device.ops import encode_2bit, unpack_codes

        (a,) = fast_read_batches(FQ, batch_size=4096)
        (p,) = fast_read_batches(FQ, batch_size=4096, packed=True)
        vb = p.dense_vbits()
        dev = np.asarray(unpack_codes(jnp.asarray(p.codes),
                                      jnp.asarray(vb) if vb is not None else None))
        ref = np.asarray(encode_2bit(jnp.asarray(a.seqs)))
        in_len = np.arange(a.seqs.shape[1])[None, :] < a.lengths[:, None]
        assert np.array_equal(np.where(in_len, dev, 0), np.where(in_len, ref, 0))

    def test_precoded_canonical_kmers(self):
        import jax.numpy as jnp

        from needletail_tpu.device.kmers import canonical_kmers
        from needletail_tpu.device.ops import unpack_codes

        (a,) = fast_read_batches(FA, batch_size=4096)
        (p,) = fast_read_batches(FA, batch_size=4096, packed=True)
        w1 = canonical_kmers(jnp.asarray(a.seqs), jnp.asarray(a.lengths), 21)
        pvb = p.dense_vbits()
        codes = unpack_codes(
            jnp.asarray(p.codes),
            jnp.asarray(pvb) if pvb is not None else None,
        )
        w2 = canonical_kmers(codes, jnp.asarray(p.lengths), 21, precoded=True)
        assert np.array_equal(np.asarray(w1.valid), np.asarray(w2.valid))
        v = np.asarray(w1.valid)
        for f in ("hi", "lo", "was_rc"):
            x1 = np.asarray(getattr(w1, f))[v]
            x2 = np.asarray(getattr(w2, f))[v]
            assert np.array_equal(x1, x2), f

    def test_packed_hash_keys_match_ascii(self):
        import jax.numpy as jnp

        from needletail_tpu.device.hashcount import (
            canonical_hash_keys,
            canonical_hash_keys_packed,
        )

        (a,) = fast_read_batches(FQ, batch_size=2000, max_len=128)
        (p,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
        k1, t1, f1 = canonical_hash_keys(
            jnp.asarray(a.seqs), jnp.asarray(a.lengths), 21, table_bits=16
        )
        pvb = p.dense_vbits()
        k2, t2, f2 = canonical_hash_keys_packed(
            jnp.asarray(p.codes),
            jnp.asarray(pvb) if pvb is not None else None,
            jnp.asarray(p.lengths),
            21,
            table_bits=16,
        )
        assert int(t1) == int(t2) == 209_965
        assert int(f1) == int(f2) == 106_181
        assert np.array_equal(np.asarray(k1), np.asarray(k2))


class TestLeanTransport:
    """The VERDICT r4 #1 transport diet: ragged dirty-row validity planes
    + narrow wire lengths, expanded on device, bit-identical to dense."""

    def test_lean_wins_on_real_corpus(self):
        (p,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
        assert p.vbits is None and p.vrows is not None
        assert p.vrow_idx.shape[0] == p.vrows.shape[0] < 16
        # wire accounting: codes + u8 lengths + padded lean planes
        assert p.wire_nbytes() < p.codes.nbytes + 2000 * 4 + 2000 * 16

    def test_dense_wins_when_every_read_dirty(self, tmp_path):
        f = tmp_path / "alln.fq"
        f.write_bytes(b"@r\nNNNNNNNN\n+\nIIIIIIII\n" * 32)
        (b,) = fast_read_batches(str(f), packed=True)
        assert b.vrows is None and b.vbits is not None

    def test_expand_vrows_matches_dense(self):
        import jax.numpy as jnp

        from needletail_tpu.batch import pad_vrow_planes
        from needletail_tpu.device.ops import expand_vrows
        from needletail_tpu.encoding import pack_codes_host

        (a,) = fast_read_batches(FQ, batch_size=2000, max_len=128)
        (p,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
        assert p.vrows is not None
        idx, rows = pad_vrow_planes(p.vrow_idx, p.vrows)
        plane = np.asarray(
            expand_vrows(jnp.asarray(idx), jnp.asarray(rows), p.num_reads)
        )
        _, dense = pack_codes_host(a.seqs, a.lengths)
        got = np.unpackbits(plane, axis=1, bitorder="little")
        want = np.unpackbits(dense, axis=1, bitorder="little")
        in_len = np.arange(128)[None, :] < p.lengths[:, None]
        assert np.array_equal(got & in_len, want & in_len)

    def test_hash_count_file_lean_equals_dense_vbits_path(self, tmp_path):
        """Force a dense-vbits stream (every read dirty) and a lean stream
        (few dirty) of the same k-mer content; tables agree with ASCII."""
        from needletail_tpu.device.pipeline import hash_count_file

        r_ascii = hash_count_file(FQ, 21, batch_size=512, max_len=128,
                                  packed=False, double_buffer=False)
        r_lean = hash_count_file(FQ, 21, batch_size=512, max_len=128,
                                 packed=True, double_buffer=False)
        assert r_ascii[:3] == r_lean[:3]
        assert np.array_equal(r_ascii[3], r_lean[3])

    def test_wire_lengths_dtype(self):
        from needletail_tpu.batch import length_wire_dtype

        assert length_wire_dtype(128) == np.uint8
        assert length_wire_dtype(255) == np.uint8
        assert length_wire_dtype(256) == np.uint16
        assert length_wire_dtype(65535) == np.uint16
        assert length_wire_dtype(65536) == np.int32

    def _roundtrip(self, p, batch_size):
        """wire_frame -> unwire -> resolve must reproduce codes, lengths
        and the dense validity plane (in-length bits) of the batch."""
        import jax.numpy as jnp

        from needletail_tpu.device.ops import resolve_vbits, unwire

        buf, layout = p.wire_frame(batch_size)
        assert buf.nbytes == layout.nbytes
        codes, lengths, vbits, vidx, vrows = unwire(jnp.asarray(buf), layout)
        assert codes.shape == (batch_size, p.codes.shape[1])
        assert np.array_equal(np.asarray(codes)[: p.num_reads], p.codes)
        got_len = np.asarray(lengths)
        assert got_len.dtype == np.int32
        assert np.array_equal(got_len[: p.num_reads], p.lengths)
        assert not got_len[p.num_reads :].any()
        plane = resolve_vbits(vbits, vidx, vrows, batch_size)
        want = p.dense_vbits()
        if want is None:
            assert plane is None
            return
        got = np.unpackbits(np.asarray(plane)[: p.num_reads], axis=1,
                            bitorder="little")
        want = np.unpackbits(want, axis=1, bitorder="little")
        in_len = np.arange(got.shape[1])[None, :] < p.lengths[:, None]
        assert np.array_equal(got & in_len, want & in_len)

    def test_wire_frame_roundtrip_lean(self):
        (p,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
        assert p.vrows is not None
        self._roundtrip(p, 2048)  # padded read dim
        self._roundtrip(p, 2000)  # exact read dim

    def test_wire_frame_roundtrip_dense_and_clean(self, tmp_path):
        dirty = tmp_path / "dirty.fq"
        dirty.write_bytes(b"@r\nACGTNNACGT\n+\nIIIIIIIIII\n" * 4)
        (p,) = fast_read_batches(str(dirty), batch_size=4, packed=True)
        assert p.vbits is not None  # every read dirty -> dense wins
        self._roundtrip(p, 8)
        clean = tmp_path / "clean.fq"
        clean.write_bytes(b"@r\nACGTACGT\n+\nIIIIIIII\n" * 3)
        (c,) = fast_read_batches(str(clean), batch_size=3, packed=True)
        assert c.vbits is None and c.vrows is None
        self._roundtrip(c, 4)

    def test_wire_frame_u16_lengths(self):
        """max_len > 255 rides little-endian u16 length entries."""
        seqs = np.full((3, 304), ord("A"), np.uint8)
        lengths = np.array([304, 257, 12], np.int32)
        rb = ReadBatch(seqs=seqs, lengths=lengths, quals=None, ids=[b"a", b"b", b"c"])
        p = PackedReadBatch.from_read_batch(rb)
        self._roundtrip(p, 4)


class TestDriverParity:
    def test_max_len_quantum_uniform_across_transports(self, tmp_path):
        """An explicit max_len quantizes up to a multiple of 8 in the
        drivers for BOTH transports: toggling packed/quality must never
        flip a read between accepted and 'exceeds max_len'."""
        from needletail_tpu.device.pipeline import count_file

        p = tmp_path / "long.fq"
        rng = np.random.default_rng(3)
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 133).tobytes()
        p.write_bytes(b"@r0\n" + seq + b"\n+\n" + b"I" * 133 + b"\n")
        # packed (auto) path accepts the 133-base read under max_len=130
        nb1, t1 = count_file(str(p), 5, max_len=130, host_workers=1)
        # quality path forces ASCII transport — must accept identically
        nb2, t2 = count_file(
            str(p), 5, max_len=130, quality_cutoff=1, host_workers=1
        )
        nb3, t3 = count_file(str(p), 5, max_len=136, host_workers=1)
        assert nb1 == nb2 == nb3 == 133
        assert np.array_equal(t1, t3)
        assert np.array_equal(t1, t2)  # 'I' quals are all above cutoff 1

    def test_hash_count_file(self):
        from needletail_tpu.device.pipeline import hash_count_file

        r1 = hash_count_file(FQ, 21, batch_size=512, max_len=128, packed=False)
        r2 = hash_count_file(FQ, 21, batch_size=512, max_len=128, packed=True)
        assert r1[:3] == r2[:3] == (250_000, 209_965, 106_181)
        assert np.array_equal(r1[3], r2[3])

    def test_count_file_sparse(self):
        from needletail_tpu.device.pipeline import count_file

        nb1, (k1, c1) = count_file(
            FA, k=21, dense=False, sparse_format="arrays",
            batch_size=128, packed=False,
        )
        nb2, (k2, c2) = count_file(
            FA, k=21, dense=False, sparse_format="arrays",
            batch_size=128, packed=True,
        )
        assert nb1 == nb2 == 738_580
        assert np.array_equal(k1, k2) and np.array_equal(c1, c2)

    def test_count_file_dense(self):
        from needletail_tpu.device.pipeline import count_file

        nb1, s1 = count_file(FQ, k=8, batch_size=512, packed=False)
        nb2, s2 = count_file(FQ, k=8, batch_size=512, packed=True)
        assert nb1 == nb2 and np.array_equal(s1, s2)

    def test_multi_k(self):
        from needletail_tpu.device.pipeline import multi_k_count_file

        nb1, sp1 = multi_k_count_file(FA, (4, 21), batch_size=128, packed=False)
        nb2, sp2 = multi_k_count_file(FA, (4, 21), batch_size=128, packed=True)
        assert nb1 == nb2
        assert np.array_equal(sp1[4], sp2[4])
        assert np.array_equal(sp1[21][0], sp2[21][0])
        assert np.array_equal(sp1[21][1], sp2[21][1])

    def test_packed_conflicts_raise(self):
        from needletail_tpu.device.pipeline import count_file

        with pytest.raises(ValueError, match="packed"):
            count_file(FQ, k=4, packed=True, quality_cutoff=20)
        with pytest.raises(ValueError, match="packed"):
            count_file(FQ, k=4, packed=True, bucketed=True)


class TestWorkerTransport:
    @pytest.mark.parametrize("shared_mem", [True, False])
    def test_parallel_packed_matches_single(self, shared_mem):
        from needletail_tpu.io.parallel_host import parallel_read_batches

        def digest(batches):
            bases = code_sum = vb_sum = 0
            for b in batches:
                bases += b.num_bases
                code_sum += int(b.codes.astype(np.int64).sum())
                vb = b.dense_vbits()
                if vb is not None:
                    vb_sum += int(vb.astype(np.int64).sum())
            return bases, code_sum, vb_sum

        single = digest(
            fast_read_batches(FQ, batch_size=256, max_len=128, packed=True)
        )
        multi = digest(
            parallel_read_batches(
                FQ, workers=2, batch_size=256, max_len=128, packed=True,
                shared_mem=shared_mem,
            )
        )
        assert single == multi
        assert single[0] == 250_000

    def test_parallel_packed_unquantized_max_len(self):
        """A non-multiple-of-8 explicit max_len must quantize ONCE at the
        driver so the shm pool's plane widths agree with the workers'
        (review finding: the pool was sized with the raw max_len while
        workers quantized, crashing every packed write)."""
        from needletail_tpu.io.parallel_host import parallel_read_batches

        def digest(batches):
            bs = list(batches)
            return sum(b.num_bases for b in bs), sum(
                int(b.codes.astype(np.int64).sum()) for b in bs
            )

        # FQ reads are 125 bases: 125 quantizes to 128 in both paths
        single = digest(
            fast_read_batches(FQ, batch_size=256, max_len=125, packed=True)
        )
        multi = digest(
            parallel_read_batches(
                FQ, workers=2, batch_size=256, max_len=125, packed=True,
                shared_mem=True,
            )
        )
        assert single == multi
        assert single[0] == 250_000


class TestShardedPacked:
    def test_sharded_count_file_parity(self):
        import jax

        from needletail_tpu.parallel import make_mesh
        from needletail_tpu.parallel.exact import sharded_count_file

        mesh = make_mesh(jax.devices(), data=8, table=1)
        nb1, (k1, c1) = sharded_count_file(
            FA, 21, mesh=mesh, batch_size=128, packed=False, host_workers=1
        )
        nb2, (k2, c2) = sharded_count_file(
            FA, 21, mesh=mesh, batch_size=128, packed=True, host_workers=1
        )
        assert nb1 == nb2 == 738_580
        assert np.array_equal(k1, k2) and np.array_equal(c1, c2)

    def test_hash_step_parity(self):
        import jax
        import jax.numpy as jnp

        from needletail_tpu.parallel import make_mesh
        from needletail_tpu.parallel.sharded import make_hash_update_step

        mesh = make_mesh(jax.devices(), data=8, table=1)
        (a,) = fast_read_batches(FQ, batch_size=2000, max_len=128)
        (p,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
        pa, pp = a.pad_reads_to(2048), p.pad_reads_to(2048)
        init_a, step_a, place_a = make_hash_update_step(mesh, k=21)
        init_p, step_p, place_p = make_hash_update_step(
            mesh, k=21, packed=True
        )
        sa = step_a(
            init_a(), *place_a(jnp.asarray(pa.seqs), jnp.asarray(pa.lengths))
        )
        pvb = pp.dense_vbits()
        vb = jnp.asarray(pvb) if pvb is not None else None
        sp = step_p(
            init_p(),
            *place_p(jnp.asarray(pp.codes), jnp.asarray(pp.lengths), vb),
        )
        assert int(sa.total) == int(sp.total) == 209_965
        assert int(sa.fwd) == int(sp.fwd)
        assert np.array_equal(sa.table, sp.table)

"""Multi-device tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu.device import count as dcount
from needletail_tpu.device import kmers as dkmers
from needletail_tpu.parallel import (
    init_count_state,
    make_mesh,
    mesh_shape_for,
    sharded_spectrum,
)
from needletail_tpu.parallel.sharded import make_update_step


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU sim"
    return make_mesh()


def random_batch(b=16, l=64, seed=0, alphabet=b"ACGTN"):
    rng = np.random.default_rng(seed)
    seqs = rng.choice(list(alphabet), size=(b, l)).astype(np.uint8)
    lengths = np.full(b, l, np.int32)
    return jnp.asarray(seqs), jnp.asarray(lengths)


def test_mesh_shape_heuristic():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(16) == (4, 4)
    assert mesh_shape_for(4) == (2, 2)
    assert mesh_shape_for(2) == (2, 1)
    assert mesh_shape_for(1) == (1, 1)
    assert mesh_shape_for(6) == (3, 2)


def test_sharded_equals_single_device(mesh):
    seqs, lengths = random_batch()
    spec = sharded_spectrum(mesh, seqs, lengths, k=5)
    ref = dcount.dense_spectrum(dkmers.canonical_kmers(seqs, lengths, 5), 5)
    assert (np.asarray(spec) == np.asarray(ref)).all()


def test_sharded_noncanonical(mesh):
    seqs, lengths = random_batch(seed=3)
    spec = sharded_spectrum(mesh, seqs, lengths, k=4, canonical=False)
    ref = dcount.dense_spectrum(dkmers.pack_kmers(seqs, lengths, 4), 4)
    assert (np.asarray(spec) == np.asarray(ref)).all()


def test_streaming_state_accumulates(mesh):
    k = 5
    state = init_count_state(mesh, k)
    step, place, _ = make_update_step(mesh, k)
    ref_total = np.zeros(4**k, dtype=np.int64)
    for seed in range(3):
        seqs, lengths = random_batch(seed=seed)
        ref = dcount.dense_spectrum(dkmers.canonical_kmers(seqs, lengths, k), k)
        ref_total += np.asarray(ref)
        s, l = place(seqs, lengths)
        state = step(state, s, l)
    assert (np.asarray(state.table) == ref_total).all()
    assert int(state.n_reads) == 48
    assert int(state.n_bases) == 48 * 64


def test_data_axis_only_mesh():
    mesh = make_mesh(data=8, table=1)
    seqs, lengths = random_batch(seed=9)
    spec = sharded_spectrum(mesh, seqs, lengths, k=4)
    ref = dcount.dense_spectrum(dkmers.canonical_kmers(seqs, lengths, 4), 4)
    assert (np.asarray(spec) == np.asarray(ref)).all()


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.asarray(out).sum() > 0


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


class TestHashPipeline:
    """Production hash pipeline: hash step inside shard_map, table
    merged/sharded with psum_scatter over the data axis."""

    def _run(self, table_bits, k=9, steps=1):
        from needletail_tpu.device.hashcount import canonical_hash_keys
        from needletail_tpu.parallel import make_hash_update_step, make_mesh

        mesh = make_mesh(data=8, table=1)
        init, step, place = make_hash_update_step(
            mesh, k, table_bits=table_bits
        )
        state = init()
        rng = np.random.default_rng(42)
        expected = np.zeros(1 << table_bits, np.int64)
        exp_total = 0
        for s in range(steps):
            seqs = rng.choice(list(b"ACGTN"), size=(64, 32)).astype(np.uint8)
            lengths = rng.integers(0, 33, size=64).astype(np.int32)
            sj, lj = place(jnp.asarray(seqs), jnp.asarray(lengths))
            state = step(state, sj, lj)
            # single-device oracle on the full batch
            keys, total, _ = canonical_hash_keys(
                jnp.asarray(seqs), jnp.asarray(lengths), k,
                table_bits=table_bits,
            )
            keys = np.asarray(keys)
            expected += np.bincount(keys[keys >= 0], minlength=1 << table_bits)
            exp_total += int(total)
        assert np.array_equal(np.asarray(state.table), expected)
        assert int(state.total) == exp_total

    def test_matches_single_device(self):
        self._run(table_bits=16)

    def test_small_table_bits(self):
        self._run(table_bits=12)

    def test_streaming_accumulates(self):
        self._run(table_bits=16, steps=3)

    def test_rejects_table_axis(self):
        from needletail_tpu.parallel import make_hash_update_step, make_mesh

        mesh = make_mesh(data=2, table=4)
        with pytest.raises(ValueError):
            make_hash_update_step(mesh, 9)


def test_hash_state_checkpoint_roundtrip(tmp_path):
    from needletail_tpu.parallel import make_hash_update_step, make_mesh
    from needletail_tpu.parallel.checkpoint import load_hash_state, save_hash_state

    mesh = make_mesh(data=8, table=1)
    init, step, place = make_hash_update_step(mesh, 9)
    rng = np.random.default_rng(5)
    seqs = rng.choice(list(b"ACGT"), size=(64, 32)).astype(np.uint8)
    lengths = np.full(64, 32, np.int32)
    state = step(init(), *place(jnp.asarray(seqs), jnp.asarray(lengths)))
    p = tmp_path / "ck.npz"
    save_hash_state(p, state, byte_offset=1234, k=9, input_path="reads.fq")
    loaded, off, k, ip = load_hash_state(p, mesh=mesh)
    assert off == 1234 and k == 9 and ip == "reads.fq"
    assert np.array_equal(np.asarray(loaded.table), np.asarray(state.table))
    assert int(loaded.total) == int(state.total)
    # resuming must continue exact accumulation
    resumed = step(loaded, *place(jnp.asarray(seqs), jnp.asarray(lengths)))
    twice = step(state, *place(jnp.asarray(seqs), jnp.asarray(lengths)))
    assert np.array_equal(np.asarray(resumed.table), np.asarray(twice.table))


def test_bucketed_sharded_hash_matches_unbucketed(tmp_path):
    """Bucketed framing (one compiled step per bucket width) through the
    sharded hash pipeline yields the identical table (SURVEY section 7
    hard part 4 x the mesh pipeline)."""
    import numpy as _np

    from needletail_tpu.io.bucketed import bucketed_read_batches
    from needletail_tpu.io.fast_batch import fast_read_batches
    from needletail_tpu.parallel import make_hash_update_step, make_mesh

    rng = _np.random.default_rng(11)
    p = tmp_path / "mixed.fq"
    with open(p, "wb") as f:
        for i in range(600):
            ln = int(rng.choice([36, 100, 150, 300]))
            seq = rng.choice(_np.frombuffer(b"ACGTN", _np.uint8), ln).tobytes()
            f.write(b"@r%d\n" % i + seq + b"\n+\n" + b"I" * ln + b"\n")

    mesh = make_mesh(data=8, table=1)
    k, bs = 21, 64

    def run(batches):
        init, step, place = make_hash_update_step(mesh, k)
        state = init()
        n_bases = 0
        for batch in batches:
            n_bases += batch.num_bases
            if batch.max_len < k:
                continue
            b = batch if batch.num_reads == bs else batch.pad_reads_to(bs)
            s, l = place(jnp.asarray(b.seqs), jnp.asarray(b.lengths))
            state = step(state, s, l)
        return n_bases, int(state.total), int(state.fwd), np.asarray(state.table)

    flat = run(fast_read_batches(str(p), batch_size=bs))
    buck = run(bucketed_read_batches(str(p), batch_size=bs, with_quals=False))
    assert flat[0] == buck[0]
    assert flat[1] == buck[1] and flat[2] == buck[2]
    assert np.array_equal(flat[3], buck[3])


class TestShardedHashCountFile:
    """The mesh twin of hash_count_file (file driver over
    make_hash_update_step): same framing front, bit-identical table."""

    def test_matches_flat_driver(self):
        import jax

        from needletail_tpu.device.pipeline import hash_count_file
        from needletail_tpu.parallel import (
            make_mesh,
            sharded_hash_count_file,
        )

        path = "tests/data/PRJNA271013_head.fq"
        ref = hash_count_file(path, 9, batch_size=512, max_len=128)
        mesh = make_mesh(jax.devices(), data=8, table=1)
        got = sharded_hash_count_file(
            path, 9, mesh=mesh, batch_size=512, max_len=128,
            host_workers=1,
        )
        assert got[:3] == ref[:3]
        assert np.array_equal(got[3], ref[3])

    def test_checkpoint_interchangeable_with_flat(self, tmp_path):
        """kind="hash" checkpoints cross mesh sizes: a stream checkpointed
        by the FLAT driver resumes on an 8-device mesh (and lands on the
        uninterrupted table bit-for-bit)."""
        import jax

        from needletail_tpu.device.pipeline import hash_count_file
        from needletail_tpu.parallel import (
            make_mesh,
            sharded_hash_count_file,
        )
        from needletail_tpu.parallel.checkpoint import (
            load_stream_checkpoint,
            save_stream_checkpoint,
        )
        from needletail_tpu.io.fast_batch import fast_read_batches

        src = open("tests/data/PRJNA271013_head.fq", "rb").read() * 2
        corpus = tmp_path / "reads.fq"
        corpus.write_bytes(src)
        ref = hash_count_file(str(corpus), 9, batch_size=512, max_len=128)

        # checkpoint the prefix with the FLAT driver
        it = iter(fast_read_batches(str(corpus), batch_size=512,
                                    max_len=128, packed=True))
        next(it)
        off = next(it).file_offset
        it.close()
        prefix = tmp_path / "prefix.fq"
        prefix.write_bytes(src[:off])
        ck = str(tmp_path / "hash.npz")
        hash_count_file(
            str(prefix), 9, batch_size=512, max_len=128,
            checkpoint_every=2, checkpoint_path=ck, host_workers=1,
        )
        mid = load_stream_checkpoint(ck)
        save_stream_checkpoint(
            ck, "hash", 9, off, mid["n_bases"],
            {"table": mid["arrays"]["table"]}, input_path=str(corpus),
            meta=mid["meta"],
        )
        # resume with the SHARDED driver over 8 devices
        mesh = make_mesh(jax.devices(), data=8, table=1)
        resumed = sharded_hash_count_file(
            str(corpus), 9, mesh=mesh, batch_size=512, max_len=128,
            resume_from=ck, host_workers=1,
        )
        assert resumed[:3] == ref[:3]
        assert np.array_equal(resumed[3], ref[3])

    def test_metered(self):
        import jax

        from needletail_tpu.parallel import (
            make_mesh,
            sharded_hash_count_file,
        )
        from needletail_tpu.utils.profiling import ThroughputMeter

        mesh = make_mesh(jax.devices(), data=8, table=1)
        meter = ThroughputMeter()
        nb, total, fwd, _t = sharded_hash_count_file(
            "tests/data/PRJNA271013_head.fq", 21, mesh=mesh,
            batch_size=512, max_len=128, host_workers=1, meter=meter,
        )
        assert (nb, total, fwd) == (250_000, 209_965, 106_181)
        d = meter.as_dict()
        for stage in ("frame", "dispatch", "drain", "wall"):
            assert stage in d

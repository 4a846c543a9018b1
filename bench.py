"""Headline benchmark: FASTQ -> canonical k=21 k-mer counting, bases/sec.

Workload (BASELINE.json config #3 shape): the reference FASTQ parse corpus
(PRJNA271013_head.fq — 2,000 reads, 250,000 bases, ref benches/benchmark.rs:74-128),
tiled to a device-resident batch, streamed through the program's own hash
step (``pipeline._hash_step_fn``): 2-bit encode -> rolling canonical k=21
windows -> hash-table scatter-add + total/forward tallies.  Embedded
correctness asserts (criterion-style, ref benchmark.rs:43-44): per-copy
canonical-21-mer totals must equal the host-verified 209,965 / 106,181.

Prints ONE JSON line with the rates and the device they ran on
(``device.platform`` / ``kind`` / ``count``); a CPU run measures XLA's CPU
backend, not an accelerator.
"""

from __future__ import annotations

import json
import time

import numpy as np

# golden per-copy counts for PRJNA271013_head.fq @ k=21 (host-verified
# against the reference semantics by tests/test_device.py)
GOLD_BASES = 250_000
GOLD_TOTAL_K21 = 209_965
GOLD_FWD_K21 = 106_181

K = 21
TABLE_BITS = 16
TILE = 256  # 2,000 reads -> 512,000 reads, 64M bases per step
STEPS = 15


def main() -> None:
    import jax
    import jax.numpy as jnp

    from needletail_tpu.device.pipeline import _count_step_fns, _hash_step_fn
    from needletail_tpu.io.fast_batch import fast_read_batches as read_batches

    # ---- host framing: load + tile the corpus -------------------------
    t_parse = time.perf_counter()
    batches = list(
        read_batches("tests/data/PRJNA271013_head.fq", batch_size=2000, max_len=128)
    )
    parse_s = time.perf_counter() - t_parse
    assert len(batches) == 1
    batch = batches[0]
    assert batch.num_bases == GOLD_BASES, batch.num_bases

    seqs = np.tile(batch.seqs, (TILE, 1))
    lengths = np.tile(batch.lengths, TILE)
    n_bases_step = int(lengths.sum())

    dev_seqs = jax.device_put(jnp.asarray(seqs))
    dev_lengths = jax.device_put(jnp.asarray(lengths))

    # the shipped ASCII hash step (hash_count_file(packed=False) runs it)
    step = _hash_step_fn(K, TABLE_BITS, False, True)

    def fresh():
        return (
            jnp.zeros(1 << TABLE_BITS, jnp.uint32),
            jnp.zeros(1 << TABLE_BITS, jnp.uint32),
            jnp.zeros(4, jnp.uint32),
        )

    # ---- warmup + correctness ------------------------------------------
    _lo, _hi, tallies = step(*fresh(), dev_seqs, dev_lengths)
    total, fwd = int(tallies[0]), int(tallies[2])
    assert total == GOLD_TOTAL_K21 * TILE, (total, GOLD_TOTAL_K21 * TILE)
    assert fwd == GOLD_FWD_K21 * TILE, (fwd, GOLD_FWD_K21 * TILE)

    # ---- timed steps ----------------------------------------------------
    state = fresh()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = step(*state, dev_seqs, dev_lengths)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0

    import os
    import tempfile

    # ---- end-to-end: file -> framer -> device counting through the real
    # deliverable (hash_count_file: packed 2-bit transport, auto host
    # workers, double-buffered host->device feed); min over trials. -------
    from needletail_tpu.device.pipeline import hash_count_file
    from needletail_tpu.io.fast_batch import fast_read_batches

    with tempfile.NamedTemporaryFile(suffix=".fq", delete=False) as tmp:
        src = open("tests/data/PRJNA271013_head.fq", "rb").read()
        for _ in range(TILE):
            tmp.write(src)
        e2e_path = tmp.name
    # warm-up run compiles the e2e batch shape out of the timed measure
    hash_count_file(e2e_path, K, batch_size=131072, max_len=128)
    e2e_s = float("inf")
    for _ in range(2):
        t_e2e = time.perf_counter()
        e2e_bases, e2e_total, _fwd, _tab = hash_count_file(
            e2e_path, K, batch_size=131072, max_len=128
        )
        e2e_s = min(e2e_s, time.perf_counter() - t_e2e)
    e2e_file_bytes = os.path.getsize(e2e_path)
    assert e2e_bases == GOLD_BASES * TILE
    assert e2e_total == GOLD_TOTAL_K21 * TILE

    # ---- e2e per-stage breakdown: one metered run through
    # the same driver attributes the wall clock.  frame/h2d run in the
    # feeder thread and OVERLAP the consumer stages (wait/dispatch/drain),
    # so stage seconds sum past the wall; 'wait' ~ 0 means the feeder kept
    # the device fed.  The metered h2d blocks per batch (to measure the
    # real transfer rate), which serializes a transfer the unmetered run
    # overlaps — so the headline e2e number stays the UNMETERED min above,
    # and this breakdown explains it. ------------------------------------
    from needletail_tpu.utils.profiling import ThroughputMeter

    e2e_meter = ThroughputMeter()
    m_bases, m_total, _mf, _mt = hash_count_file(
        e2e_path, K, batch_size=131072, max_len=128, meter=e2e_meter
    )
    assert (m_bases, m_total) == (e2e_bases, e2e_total)
    e2e_stages = e2e_meter.as_dict()

    # ---- host framing alone (no device): the aggregate-ingest building
    # block — one core's framer+2-bit-pack rate; deployment scales this
    # near-linearly with framing workers over byte ranges. ---------------
    frame_s = float("inf")
    for _ in range(3):
        t_f = time.perf_counter()
        fb = 0
        for b in fast_read_batches(
            e2e_path, batch_size=131072, max_len=128, packed=True
        ):
            fb += b.num_bases
        frame_s = min(frame_s, time.perf_counter() - t_f)
    assert fb == GOLD_BASES * TILE
    os.unlink(e2e_path)
    host_framing_bases_per_sec = fb / frame_s

    # ---- EXACT spectrum engine (BASELINE "exact count-table equality"):
    # device-resident k=21 sorted-spectrum rate — the shipped count_file
    # key step, one lexicographic device sort + run-length count +
    # distinct-to-front compaction per flush.  The timed region is
    # device-resident and ends at the scalar pull of the distinct count;
    # the bulk pull of the distinct entries is timed separately
    # (exact_host_pull_s). -----------------------------------------------
    from needletail_tpu.device.count import (
        SparseSpectrumAccumulator,
        compact_runs_device,
        unique_counts,
    )

    TILE_EXACT = 64  # 16M bases/step
    STEPS_EXACT = 4
    ex_seqs = jax.device_put(jnp.asarray(np.tile(batch.seqs, (TILE_EXACT, 1))))
    ex_lengths = jax.device_put(jnp.asarray(np.tile(batch.lengths, TILE_EXACT)))
    ex_bases = int(lengths[: 2000 * TILE_EXACT].sum())
    _exact_keys = _count_step_fns(K, False, True, True, None)[1]

    def run_exact_device():
        """One flush, device-resident: extract all steps' key planes,
        sort + run-length + compact; returns the compacted device arrays
        and the distinct count (its pull is the sync)."""
        parts = [_exact_keys(ex_seqs, ex_lengths, None) for _ in range(STEPS_EXACT)]
        hi = jnp.concatenate([h for h, _ in parts])
        lo = jnp.concatenate([l for _, l in parts])
        h, l, c, n = compact_runs_device(*unique_counts(hi, lo))
        return h, l, c, int(n)

    def run_exact():
        acc = SparseSpectrumAccumulator()
        for _ in range(STEPS_EXACT):
            acc.add(*_exact_keys(ex_seqs, ex_lengths, None))
        return acc.finish()

    keys_x, counts_x = run_exact()  # warm-up compiles + correctness
    assert (
        int(counts_x.sum()) == GOLD_TOTAL_K21 * TILE_EXACT * STEPS_EXACT
    ), int(counts_x.sum())
    exact_distinct = len(keys_x)
    exact_s = float("inf")
    for _ in range(3):
        t_x = time.perf_counter()
        h_c, l_c, c_c, n_x = run_exact_device()
        exact_s = min(exact_s, time.perf_counter() - t_x)
    assert n_x == exact_distinct, (n_x, exact_distinct)
    t_p = time.perf_counter()
    pull = (np.asarray(l_c[:n_x]), np.asarray(h_c[:n_x]), np.asarray(c_c[:n_x]))
    exact_pull_s = time.perf_counter() - t_p
    got = (pull[1].astype(np.uint64) << np.uint64(32)) | pull[0]
    assert np.array_equal(got, keys_x) and np.array_equal(
        pull[2], counts_x
    ), "device-resident run disagrees with the accumulator path"
    exact_bases_per_sec = ex_bases * STEPS_EXACT / exact_s

    # ---- BASELINE config #4: whole-genome k=31 halo-tiled exact spectrum.
    # A deterministic 5 Mbp synthetic genome (utils/synth.py, seed=31)
    # runs through the shipped genome path: the packed-transport tile front
    # (device/tiling._TileStream), the public per-block step
    # (make_tile_key_fn) and the public one-flush device resolve
    # (count.finalize_sparse_device — sort + run-length, no compaction for
    # this ~100%-distinct stream).  Golden asserts (computed once from the
    # host-oracle run): 4,999,970 windows, all distinct, and a mod-2^32
    # spectrum checksum over (key, count) pairs, so the device run proves
    # key-exactness without pulling the ~5M distinct entries.  Two timings:
    # device-resident (tiles pre-staged) and the full public genome_spectrum
    # call (framing + h2d + flush). ----------------------------------------
    GEN_BASES = 5_000_000
    GOLD_GENOME_WINDOWS = 4_999_970
    GOLD_GENOME_DISTINCT = 4_999_970
    GOLD_GENOME_CKS_LO = 1_373_307_442
    GOLD_GENOME_CKS_HI = 100_106_330

    import tempfile

    from needletail_tpu.device import count as _gcount
    from needletail_tpu.device.tiling import (
        _TileStream,
        genome_spectrum,
        make_tile_key_fn,
    )
    from needletail_tpu.utils.synth import synthetic_genome

    fa = synthetic_genome(GEN_BASES, seed=31)
    with tempfile.NamedTemporaryFile(
        suffix=".fa", delete=False
    ) as tf:
        tf.write(fa)
        fa_path = tf.name

    @jax.jit
    def genome_cks(hi_s, lo_s, counts):
        # checksums read the run heads directly (counts are 0 at
        # non-heads and sentinels)
        cu = counts.astype(jnp.uint32)
        return jnp.stack(
            [
                jnp.sum((counts > 0).astype(jnp.int32)).astype(
                    jnp.uint32
                ),
                counts.sum().astype(jnp.uint32),
                jnp.sum(lo_s * cu, dtype=jnp.uint32),
                jnp.sum(hi_s * cu, dtype=jnp.uint32),
            ]
        )

    # --- device-resident: pre-stage the shipped tile front's packed
    # blocks once, then time extraction + flush on device
    t_tile = time.perf_counter()
    n_tiles = (GEN_BASES - 31 + 1 + 8191) // 8192
    stream = _TileStream(
        fa_path, 31, tile_len=8192, batch_tiles=n_tiles, packed=True
    )
    blocks = [
        (
            jax.device_put(jnp.asarray(c)),
            None if v is None else jax.device_put(jnp.asarray(v)),
            jax.device_put(jnp.asarray(l)),
        )
        for c, v, l in stream
    ]
    assert stream.n_bases == GEN_BASES
    jax.block_until_ready([b[0] for b in blocks])
    genome_tile_s = time.perf_counter() - t_tile

    _gkeys = make_tile_key_fn(31, 8192, packed=True)

    def genome_flush():
        parts = [_gkeys(c, l, v) for c, v, l in blocks]
        return genome_cks(*_gcount.finalize_sparse_device(parts))

    # warm-up compiles + correctness (the stacked pull IS the sync)
    got = np.asarray(genome_flush())
    assert got[0] == GOLD_GENOME_DISTINCT, got
    assert got[1] == GOLD_GENOME_WINDOWS, got
    assert got[2] == GOLD_GENOME_CKS_LO, got
    assert got[3] == GOLD_GENOME_CKS_HI, got
    genome_s = float("inf")
    for _ in range(3):
        t_g = time.perf_counter()
        genome_flush()
        got = np.asarray(genome_flush())
        genome_s = min(genome_s, (time.perf_counter() - t_g) / 2)
    assert got[0] == GOLD_GENOME_DISTINCT
    # report the MEASURED distinct count, never the golden constant
    genome_distinct_measured = int(got[0])
    genome_bases_per_sec = GEN_BASES / genome_s

    # --- the documented API, end to end: framing + packing + h2d +
    # extraction + flush in one genome_spectrum call (sparse_format=
    # "device" keeps the ~5M-entry result on device).  Two full API
    # calls with ONE dependent-scalar checksum sync, halved, exactly as
    # the device-resident number, so their ratio isolates what the API
    # adds (host framing + tiling + h2d).
    genome_api_s = float("inf")
    nb_api, parts_api = genome_spectrum(
        fa_path, k=31, tile_len=8192, batch_tiles=640,
        sparse_format="device",
    )  # warm-up: compiles the one-block shape
    for _ in range(2):
        t_g = time.perf_counter()
        genome_spectrum(
            fa_path, k=31, tile_len=8192, batch_tiles=640,
            sparse_format="device",
        )
        nb_api, parts_api = genome_spectrum(
            fa_path, k=31, tile_len=8192, batch_tiles=640,
            sparse_format="device",
        )
        got_api = np.asarray(genome_cks(*parts_api))
        genome_api_s = min(genome_api_s, (time.perf_counter() - t_g) / 2)
    assert nb_api == GEN_BASES
    assert got_api[0] == GOLD_GENOME_DISTINCT, got_api
    assert got_api[2] == GOLD_GENOME_CKS_LO, got_api
    assert got_api[3] == GOLD_GENOME_CKS_HI, got_api
    genome_api_bases_per_sec = GEN_BASES / genome_api_s
    os.unlink(fa_path)

    bases_per_sec = n_bases_step * STEPS / elapsed
    e2e_bases_per_sec = e2e_bases / e2e_s
    e2e_bytes_per_sec = e2e_file_bytes / e2e_s
    dev = jax.devices()
    print(
        json.dumps(
            {
                "metric": "fastq_canonical_k21_hash_count_bases_per_sec",
                "value": round(bases_per_sec, 1),
                "unit": "bases/s",
                "device": {
                    "platform": dev[0].platform,
                    "kind": dev[0].device_kind,
                    "count": len(dev),
                },
                "device_resident_bases_per_sec": round(bases_per_sec, 1),
                "host_parse_bases_per_sec": round(GOLD_BASES / parse_s, 1),
                "e2e_file_to_table_bases_per_sec": round(e2e_bases_per_sec, 1),
                "e2e_file_bytes_per_sec": round(e2e_bytes_per_sec, 1),
                "e2e_transport": "packed2bit+lean",
                "e2e_stages": e2e_stages,
                "host_framing_bases_per_sec": round(
                    host_framing_bases_per_sec, 1
                ),
                "exact_bases_per_sec": round(exact_bases_per_sec, 1),
                "exact_distinct_21mers": exact_distinct,
                "exact_timing": "device_resident",
                "exact_host_pull_s": round(exact_pull_s, 4),
                "genome_k31_bases_per_sec": round(genome_bases_per_sec, 1),
                "genome_k31_distinct": genome_distinct_measured,
                "genome_k31_host_tile_s": round(genome_tile_s, 4),
                "genome_timing": "device_resident",
                "genome_k31_api_bases_per_sec": round(
                    genome_api_bases_per_sec, 1
                ),
                "genome_path": "public (make_tile_key_fn + "
                "finalize_sparse_device; packed tile transport)",
            }
        )
    )


if __name__ == "__main__":
    main()

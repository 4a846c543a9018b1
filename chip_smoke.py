"""Smoke run of the FASTX -> canonical k-mer counting path on NVIDIA GPUs.

Drives the entry points a user calls (``hash_count_file``, ``count_file``,
``genome_spectrum`` and the ``count`` / ``hash-count`` CLI) once on a
bacterial-scale read set made from ``--seed``, and holds every result to
the plain-numpy oracle (``needletail_tpu.utils.kmer_oracle``) with zero
tolerance.  Any failure raises, so the process exits non-zero and prints
no result line.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # only the sharded path, 4 cards

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Generated
files go to ``.smoke_data/`` at the root of the checkout and are removed
at the end.  Exits non-zero, with no result line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GENOME_BASES = 4_600_000  # a bacterium (E. coli K-12 is 4.64 Mbp)
READ_LEN = 150
COVERAGE = 30
SUB_RATE = 0.01
N_RATE = 0.001
K = 21
GENOME_K = 31


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str, t0: float, bases: int = 0, **extra) -> None:
    wall = time.perf_counter() - t0
    rate = f"  {bases / wall:.6g} bases/s" if bases else ""
    more = "".join(f"  {k}={v}" for k, v in extra.items())
    print(f"phase {name}: ok  wall {wall:.3f} s{rate}{more}", flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def genome_bases(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    ]


def read_chunks(genome: np.ndarray, n_reads: int, seed: int, chunk: int = 1 << 17):
    """Yield ``(first_read_index, reads [n, READ_LEN] uint8)``: reads sampled
    uniformly from either strand, with substitutions and Ns."""
    rng = np.random.default_rng(seed + 1)
    span = np.arange(READ_LEN)
    for i0 in range(0, n_reads, chunk):
        n = min(chunk, n_reads - i0)
        starts = rng.integers(0, genome.size - READ_LEN + 1, n)
        reads = genome[starts[:, None] + span]
        rc = rng.random(n) < 0.5
        reads[rc] = _COMP[reads[rc, ::-1]]
        sub = rng.random(reads.shape) < SUB_RATE
        reads[sub] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(sub.sum()))
        ]
        reads[rng.random(reads.shape) < N_RATE] = ord("N")
        yield i0, reads


def fastq_records(i0: int, reads: np.ndarray, rng) -> bytes:
    """Fixed-width FASTQ records ``@rNNNNNNNN`` with Phred+33 qualities."""
    n = reads.shape[0]
    ids = np.arange(i0, i0 + n)[:, None] // 10 ** np.arange(7, -1, -1) % 10
    rec = np.empty((n, 11 + READ_LEN + 3 + READ_LEN + 1), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
    rec[:, 2:10] = ids + ord("0")
    rec[:, 10] = ord("\n")
    o = 11
    rec[:, o : o + READ_LEN] = reads
    o += READ_LEN
    rec[:, o : o + 3] = np.frombuffer(b"\n+\n", np.uint8)
    o += 3
    rec[:, o : o + READ_LEN] = rng.integers(35, 74, (n, READ_LEN), dtype=np.uint8)
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def make_data(workdir: Path, seed: int):
    """Write the genome FASTA, the FASTQ and a gzip copy of its first
    tenth; return paths plus the oracle tallies of each."""
    from needletail_tpu.utils.kmer_oracle import KmerTally

    genome = genome_bases(seed)
    n_reads = GENOME_BASES * COVERAGE // READ_LEN
    tenth = n_reads // 10
    fa = workdir / "genome.fa"
    with open(fa, "wb") as f:
        f.write(b">genome synthetic bacterium\n")
        full = genome[: genome.size // 80 * 80].reshape(-1, 80)
        body = np.concatenate([full, np.full((full.shape[0], 1), 10, np.uint8)], 1)
        f.write(body.tobytes())
        f.write(genome[full.size :].tobytes() + b"\n")
    fq = workdir / "reads.fq"
    fq_gz = workdir / "reads_tenth.fq.gz"
    oracle = KmerTally(K)
    oracle_tenth = KmerTally(K)
    lengths = np.full(1 << 17, READ_LEN, np.int32)
    qrng = np.random.default_rng(seed + 2)
    with open(fq, "wb") as f, gzip.open(fq_gz, "wb", compresslevel=1) as gz:
        for i0, reads in read_chunks(genome, n_reads, seed):
            data = fastq_records(i0, reads, qrng)
            f.write(data)
            lens = lengths[: reads.shape[0]]
            oracle.add(reads, lens)
            if i0 < tenth:
                m = min(reads.shape[0], tenth - i0)
                gz.write(data[: m * (len(data) // reads.shape[0])])
                oracle_tenth.add(reads[:m], lens[:m])
    return {
        "genome": genome, "fa": fa, "fq": fq, "fq_gz": fq_gz,
        "n_reads": n_reads, "tenth": tenth,
        "oracle": oracle, "oracle_tenth": oracle_tenth,
    }


def genome_oracle(genome: np.ndarray):
    from needletail_tpu.utils.kmer_oracle import canonical_windows

    vals, valid, _ = canonical_windows(genome[None, :], np.array([genome.size]), GENOME_K)
    keys, counts = np.unique(vals[valid], return_counts=True)
    return keys, counts.astype(np.int64)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_device(expect: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's default device is {devs[0].platform}")
    check(len(devs) >= expect, f"need {expect} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    from needletail_tpu.io import native

    check(native.get_lib() is not None, "native framer library did not build")
    return devs, smi


def check_spectrum(got, want, what: str) -> None:
    keys, counts = got
    check(np.array_equal(np.asarray(keys), want[0]), f"{what}: keys differ")
    check(np.array_equal(np.asarray(counts), want[1]), f"{what}: counts differ")


def run_step_phase(data) -> None:
    """The device-resident hash step alone at batch 65,536 x 152, compared
    with the oracle and timed (host clock around block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from needletail_tpu.device.pipeline import _hash_step_fn
    from needletail_tpu.encoding import pack_codes_host
    from needletail_tpu.utils.kmer_oracle import KmerTally

    b, width = 65536, 152
    reads = next(read_chunks(data["genome"], b, seed=7, chunk=b))[1]
    seqs = np.zeros((b, width), np.uint8)
    seqs[:, :READ_LEN] = reads
    lengths = np.full(b, READ_LEN, np.int32)
    codes, vbits = pack_codes_host(seqs, lengths)
    oracle = KmerTally(K)
    oracle.add(reads, lengths)
    from needletail_tpu.batch import PackedReadBatch

    batch = PackedReadBatch(codes=codes, vbits=vbits, lengths=lengths)
    buf, layout = batch.wire_frame(b)
    wire = jax.device_put(jnp.asarray(buf))
    step = _hash_step_fn(K, 16, True, True)

    def fresh():
        return (jnp.zeros(1 << 16, jnp.uint32), jnp.zeros(1 << 16, jnp.uint32),
                jnp.zeros(4, jnp.uint32))

    t0 = time.perf_counter()
    lo, hi, tal = step(*fresh(), wire, layout=layout)
    jax.block_until_ready(lo)
    compile_s = time.perf_counter() - t0
    tal = np.asarray(tal)
    check(np.array_equal(np.asarray(lo).astype(np.int64), oracle.table), "step: table differs")
    check(not np.asarray(hi).any(), "step: hi limbs set")
    check((int(tal[0]), int(tal[2])) == (oracle.total, oracle.forward), "step: tallies differ")
    state = fresh()
    n_iter = 50
    t0 = time.perf_counter()
    for _ in range(n_iter):
        state = step(*state, wire, layout=layout)
    jax.block_until_ready(state)
    per_step = (time.perf_counter() - t0) / n_iter
    print(
        f"phase hash_step: ok  batch {b}x{width}  first call {compile_s:.3f} s"
        f"  {per_step * 1e3:.4f} ms/step  {b * READ_LEN / per_step:.6g} bases/s",
        flush=True,
    )


def run_one_card(data, workdir: Path) -> None:
    from needletail_tpu import cli
    from needletail_tpu.device.pipeline import count_file, hash_count_file
    from needletail_tpu.device.tiling import genome_spectrum

    n_bases = data["n_reads"] * READ_LEN
    oracle = data["oracle"]
    spectrum = oracle.spectrum()

    run_step_phase(data)

    t0 = time.perf_counter()
    nb, total, fwd, table = hash_count_file(str(data["fq"]), k=K)
    check(nb == n_bases, f"hash_count_file: {nb} bases, expected {n_bases}")
    check((total, fwd) == (oracle.total, oracle.forward), "hash_count_file: tallies differ")
    check(np.array_equal(table, oracle.table), "hash_count_file: table differs")
    phase("hash_count_file", t0, n_bases, windows=total, forward=fwd)

    t0 = time.perf_counter()
    nb, got = count_file(str(data["fq"]), k=K, sparse_format="arrays")
    check(nb == n_bases, "count_file: base count differs")
    check_spectrum(got, spectrum, "count_file")
    phase("count_file", t0, n_bases, distinct=len(got[0]))

    t0 = time.perf_counter()
    nb, got = count_file(str(data["fq_gz"]), k=K, sparse_format="arrays")
    check(nb == data["tenth"] * READ_LEN, "count_file(gz): base count differs")
    check_spectrum(got, data["oracle_tenth"].spectrum(), "count_file(gz)")
    phase("count_file_gzip", t0, nb, distinct=len(got[0]))

    t0 = time.perf_counter()
    nb, got = genome_spectrum(str(data["fa"]), GENOME_K, sparse_format="arrays")
    check(nb == GENOME_BASES, "genome_spectrum: base count differs")
    check_spectrum(got, genome_oracle(data["genome"]), "genome_spectrum")
    phase("genome_spectrum", t0, nb, distinct=len(got[0]))

    t0 = time.perf_counter()
    out = workdir / "cli_count.npz"
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["count", "-k", str(K), str(data["fq"]), "-o", str(out)])
    check(rc == 0, f"cli count exited {rc}")
    with np.load(out) as z:
        check_spectrum((z["keys"], z["counts"]), spectrum, "cli count")
    phase("cli_count", t0, n_bases)

    t0 = time.perf_counter()
    out = workdir / "cli_hash.npz"
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["hash-count", "-k", str(K), str(data["fq"]), "-o", str(out)])
    check(rc == 0, f"cli hash-count exited {rc}")
    with np.load(out) as z:
        check(np.array_equal(z["table"], oracle.table), "cli hash-count: table differs")
    phase("cli_hash_count", t0, n_bases)

    t0 = time.perf_counter()
    goldens = [
        (ROOT / "tests/data/28S.fasta", 31, 738_580, 718_007, 350_983),
        (ROOT / "tests/data/PRJNA271013_head.fq", 21, 250_000, 209_965, 106_181),
    ]
    for path, k, bases, want_total, want_fwd in goldens:
        nb, total, fwd, table = hash_count_file(str(path), k=k)
        check((nb, total, fwd) == (bases, want_total, want_fwd), f"golden {path.name}")
        check(int(table.sum()) == want_total, f"golden {path.name}: table sum")
        nb, (keys, counts) = count_file(str(path), k=k, sparse_format="arrays")
        check(int(counts.sum()) == want_total, f"golden {path.name}: count_file sum")
    phase("goldens", t0)

    t0 = time.perf_counter()
    import pytest

    os.environ["NEEDLETAIL_TEST_PLATFORM"] = "gpu"
    with redirect_stdout(io.StringIO()) as buf:
        rc = pytest.main(
            ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(ROOT / "tests")]
        )
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc}):\n{buf.getvalue()}")
    phase("gpu_tests", t0, summary=buf.getvalue().strip().splitlines()[-1].replace(" ", "_"))


def run_four_cards(data, workdir: Path, devs) -> None:
    from needletail_tpu import cli
    from needletail_tpu.parallel import (
        make_mesh,
        sharded_count_file,
        sharded_hash_count_file,
    )

    mesh = make_mesh(devs[:4], data=4, table=1)
    n_bases = data["n_reads"] * READ_LEN
    oracle = data["oracle"]
    spectrum = oracle.spectrum()

    t0 = time.perf_counter()
    nb, total, fwd, table = sharded_hash_count_file(str(data["fq"]), K, mesh=mesh)
    check(nb == n_bases, "sharded_hash_count_file: base count differs")
    check((total, fwd) == (oracle.total, oracle.forward), "sharded_hash_count_file: tallies")
    check(np.array_equal(table, oracle.table), "sharded_hash_count_file: table differs")
    phase("sharded_hash_count_file", t0, n_bases, windows=total)

    t0 = time.perf_counter()
    nb, got = sharded_count_file(str(data["fq"]), K, mesh=mesh)
    check(nb == n_bases, "sharded_count_file: base count differs")
    check_spectrum(got, spectrum, "sharded_count_file")
    phase("sharded_count_file", t0, n_bases, distinct=len(got[0]))

    t0 = time.perf_counter()
    out = workdir / "cli_count_sharded.npz"
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["count", "--sharded", "-k", str(K), str(data["fq"]), "-o", str(out)])
    check(rc == 0, f"cli count --sharded exited {rc}")
    with np.load(out) as z:
        check_spectrum((z["keys"], z["counts"]), spectrum, "cli count --sharded")
    phase("cli_count_sharded", t0, n_bases)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded path over 4 cards (and its oracle)",
    )
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    t0 = time.perf_counter()
    devs, smi = check_device(n_cards)
    print(f"device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(smi, flush=True)  # name, power limit (nvidia-smi's own format)
    phase("device_check", t0)

    workdir = ROOT / ".smoke_data"
    workdir.mkdir(exist_ok=True)
    try:
        t0 = time.perf_counter()
        data = make_data(workdir, args.seed)
        phase(
            "data", t0, reads=data["n_reads"],
            fastq_bytes=data["fq"].stat().st_size,
            oracle_windows=data["oracle"].total,
        )
        if args.four_cards:
            run_four_cards(data, workdir, devs)
        else:
            run_one_card(data, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

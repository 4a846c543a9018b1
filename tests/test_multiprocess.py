"""True multi-process distributed test: two jax.distributed processes (Gloo
over localhost, 4 virtual CPU devices each) split a FASTQ by byte range,
frame locally, and run the sharded hash-counting step over the global
8-device mesh.  The merged table must equal the single-process oracle —
the CPU-simulated version of BASELINE config #5 (multi-host)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import DATA_DIR, REPO_ROOT

WORKER = REPO_ROOT / "tests" / "_mp_hash_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_hash_pipeline_matches_oracle(tmp_path):
    src = (DATA_DIR / "PRJNA271013_head.fq").read_bytes()
    head = b"\n".join(src.split(b"\n")[: 96 * 4]) + b"\n"  # 96 reads
    path = tmp_path / "mp.fq"
    path.write_bytes(head)
    out = tmp_path / "mp_result.npz"
    port = _free_port()

    rows_local = 64  # 8 global shards of 16 rows each; 2 x 64 local rows
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(path), str(out), str(port), str(pid), "2", str(rows_local)],
            cwd=str(REPO_ROOT),
            env={
                **os.environ,
                "PYTHONPATH": str(REPO_ROOT)
                + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            },
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=420)
        logs.append(stdout.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    with np.load(out) as z:
        table = z["table"]
        total = int(z["total"])
        fwd = int(z["fwd"])

    # single-process oracle over the same records (framing order differs
    # across ranges, but integer adds commute)
    import jax.numpy as jnp

    from needletail_tpu.device.hashcount import canonical_hash_keys
    from needletail_tpu.io.fast_batch import fast_read_batches

    batch = next(iter(fast_read_batches(str(path), batch_size=128, max_len=128)))
    b = batch.pad_reads_to(128)
    keys, t, f = canonical_hash_keys(
        jnp.asarray(b.seqs), jnp.asarray(b.lengths), 21, table_bits=16
    )
    keys = np.asarray(keys)
    expected = np.bincount(keys[keys >= 0], minlength=1 << 16)
    assert total == int(t) and fwd == int(f)
    assert np.array_equal(table, expected), "\n".join(logs)


def test_two_process_exact_spectrum_matches_oracle(tmp_path):
    """Per-process sorted-run spectra (disjoint device shards) must merge
    to the single-process exact spectrum bit-for-bit."""
    src = (DATA_DIR / "PRJNA271013_head.fq").read_bytes()
    head = b"\n".join(src.split(b"\n")[: 96 * 4]) + b"\n"  # 96 reads
    path = tmp_path / "mpx.fq"
    path.write_bytes(head)
    out = tmp_path / "mpx_result"
    port = _free_port()
    worker = REPO_ROOT / "tests" / "_mp_exact_worker.py"

    rows_local = 64
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(path), str(out), str(port), str(pid), "2", str(rows_local)],
            cwd=str(REPO_ROOT),
            env={
                **os.environ,
                "PYTHONPATH": str(REPO_ROOT)
                + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            },
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=420)
        logs.append(stdout.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    from needletail_tpu.device.count import merge_sorted_spectra

    keys = np.zeros(0, np.uint64)
    counts = np.zeros(0, np.int64)
    n_records = 0
    for pid in range(2):
        with np.load(f"{out}.p{pid}.npz") as z:
            keys, counts = merge_sorted_spectra(
                keys, counts, z["keys"], z["counts"]
            )
            n_records += int(z["local_records"])
    assert n_records == 96

    from needletail_tpu.device.pipeline import count_file

    _, (ok, oc) = count_file(
        str(path), k=21, dense=False, sparse_format="arrays",
        batch_size=64, host_workers=1,
    )
    assert np.array_equal(keys, ok)
    assert np.array_equal(counts, oc)


def test_two_process_multik_matches_oracle(tmp_path):
    """The fused multi-k pass in a 2-process SPMD job: per-process dense
    partial tables SUM to the global k=4 spectrum (disjoint bin ranges)
    and per-process sparse k=21 runs MERGE to the exact spectrum."""
    src = (DATA_DIR / "PRJNA271013_head.fq").read_bytes()
    head = b"\n".join(src.split(b"\n")[: 96 * 4]) + b"\n"  # 96 reads
    path = tmp_path / "mpk.fq"
    path.write_bytes(head)
    out = tmp_path / "mpk_result"
    port = _free_port()
    worker = REPO_ROOT / "tests" / "_mp_multik_worker.py"

    rows_local = 64
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(path), str(out), str(port), str(pid), "2", str(rows_local)],
            cwd=str(REPO_ROOT),
            env={
                **os.environ,
                "PYTHONPATH": str(REPO_ROOT)
                + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
            },
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=420)
        logs.append(stdout.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    from needletail_tpu.device.count import merge_sorted_spectra

    dense4 = None
    keys = np.zeros(0, np.uint64)
    counts = np.zeros(0, np.int64)
    n_records = 0
    for pid in range(2):
        with np.load(f"{out}.p{pid}.npz") as z:
            dense4 = z["dense4"] if dense4 is None else dense4 + z["dense4"]
            keys, counts = merge_sorted_spectra(
                keys, counts, z["keys"], z["counts"]
            )
            n_records += int(z["local_records"])
    assert n_records == 96

    from needletail_tpu.device.pipeline import count_file

    _, od4 = count_file(str(path), k=4, batch_size=64, host_workers=1)
    assert np.array_equal(dense4, od4), "\n".join(logs)
    _, (ok, oc) = count_file(
        str(path), k=21, dense=False, sparse_format="arrays",
        batch_size=64, host_workers=1,
    )
    assert np.array_equal(keys, ok)
    assert np.array_equal(counts, oc)


def test_framing_worker_imports_start_no_jax_backend():
    """Spawned framing workers import the package (which imports jax) but
    must never initialize a backend: on a GPU host each one would reserve
    most of the card's memory."""
    prog = (
        "import needletail_tpu.io.parallel_host, needletail_tpu.io.fast_batch\n"
        "from jax._src import xla_bridge\n"
        "print(xla_bridge.backends_are_initialized())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", prog],
        capture_output=True, text=True, timeout=120,
        cwd=str(pathlib.Path(__file__).resolve().parent.parent),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"

"""64-bit table-bin exactness: count-table bins must not wrap at 2^31/2^32.

The reference counts in host usize (ref src/lib.rs README loop); the device
tables accumulate as uint32 limb pairs (utils/limbs.py) so a hot bin — low-k
dense counting or a skewed hash bin on a multi-G-base corpus — stays exact.
These tests seed a bin just below the u32 edge via checkpoint
re-materialization, then drive real update steps across the carry boundary
and compare against a Python-int oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from needletail_tpu.parallel import make_hash_update_step, make_mesh
from needletail_tpu.parallel.checkpoint import CountCheckpoint, load_hash_state
from needletail_tpu.parallel.sharded import make_update_step


def test_acc64_elementwise_carry():
    from needletail_tpu.utils.limbs import acc64

    lo = jnp.array([0xFFFFFFFF, 0xFFFFFFFE, 5, 0], jnp.uint32)
    hi = jnp.array([0, 7, 0, 0xFFFFFFFF], jnp.uint32)
    inc = jnp.array([1, 3, 0, 0], jnp.int32)
    lo2, hi2 = acc64(lo, hi, inc)
    got = np.asarray(lo2).astype(np.uint64) + (
        np.asarray(hi2).astype(np.uint64) << np.uint64(32)
    )
    want = np.array(
        [1 << 32, 0xFFFFFFFE + 3 + (7 << 32), 5, 0xFFFFFFFF << 32], np.uint64
    )
    assert (got == want).all()


def test_count_state_bin_past_2_32():
    """Dense sharded table: a bin seeded at 2^32 - 2 crosses the limb
    boundary mid-step and still matches the Python-int oracle."""
    k = 4
    seeded = (1 << 32) - 2
    table = np.zeros(4**k, np.int64)
    table[0] = seeded  # canonical(AAAA) packs to 0
    mesh = make_mesh()
    state = CountCheckpoint(
        table=table, n_bases=0, n_reads=0, byte_offset=0, k=k
    ).to_state(mesh)
    step, place, _ = make_update_step(mesh, k)
    seqs = np.full((8, 64), ord("A"), np.uint8)
    lengths = np.full(8, 64, np.int32)
    state = step(state, *place(jnp.asarray(seqs), jnp.asarray(lengths)))
    got = np.asarray(state.table)
    windows = 8 * (64 - k + 1)
    assert got[0] == seeded + windows  # > 2^32: wraps to small if bins were u32
    assert got[0] > (1 << 32)
    assert got[1:].sum() == 0


def test_hash_state_bin_past_2_32(tmp_path):
    """Hash pipeline: skewed (homopolymer) bin crosses 2^32 exactly."""
    mesh = make_mesh(data=8, table=1)
    k = 9
    init, step, place = make_hash_update_step(mesh, k=k)
    seqs = np.full((64, 32), ord("A"), np.uint8)
    lengths = np.full(64, 32, np.int32)
    batch = place(jnp.asarray(seqs), jnp.asarray(lengths))

    # learn which bin the all-A k-mer hashes to (and the per-step increment)
    probe = step(init(), *batch)
    t_probe = np.asarray(probe.table)
    bin_idx = int(t_probe.argmax())
    per_step = int(t_probe[bin_idx])
    assert per_step == 64 * (32 - k + 1)
    assert t_probe.sum() == per_step

    seeded = (1 << 32) - 5
    table = np.zeros_like(t_probe)
    table[bin_idx] = seeded
    p = tmp_path / "seed.npz"
    np.savez_compressed(
        p,
        table=table,
        total=np.int64(seeded),
        fwd=np.int64(0),
        byte_offset=np.int64(0),
        k=np.int32(k),
        input_path=np.bytes_(b""),
    )
    state, _, _, _ = load_hash_state(p, mesh=mesh)
    state = step(state, *batch)
    got = np.asarray(state.table)
    assert got[bin_idx] == seeded + per_step
    assert got[bin_idx] > (1 << 32)
    assert int(state.total) == seeded + per_step


def test_count_file_dense_returns_int64(tmp_path):
    from needletail_tpu.device.pipeline import count_file

    p = tmp_path / "a.fa"
    p.write_bytes(b">r\n" + b"A" * 100 + b"\n")
    n_bases, spec = count_file(str(p), k=4)
    assert n_bases == 100
    assert spec.dtype == np.int64
    assert spec[0] == 97 and spec.sum() == 97


def test_hash_count_file_returns_int64(tmp_path):
    from needletail_tpu.device.pipeline import hash_count_file

    p = tmp_path / "a.fq"
    p.write_bytes(b"@r\n" + b"ACGT" * 16 + b"\n+\n" + b"I" * 64 + b"\n")
    n_bases, total, fwd, table = hash_count_file(str(p), k=9, batch_size=8)
    assert n_bases == 64
    assert table.dtype == np.int64
    assert table.sum() == total == 64 - 9 + 1

"""Multi-k canonical counting over a device mesh in ONE fused step.

The north-star workload is "canonical 4..31-mer counting" at pod scale
(BASELINE.json); ``device.pipeline.multi_k_count_file`` covers one chip and
``parallel.exact``/``parallel.sharded`` cover one k.  This module fuses
both axes: every batch runs a single jitted ``shard_map`` step in which

  * the 2-bit encode (or packed-transport unpack) happens ONCE per chip,
    and the power-of-two window ladders are shared across k by XLA CSE
    (k=21 reuses k=16's prefix, exactly like the single-chip multi-k path);
  * each dense k <= DENSE_STEP_K histograms locally into a full [4^k]
    table (``dense_spectrum``) and routes counts to their owners
    with one ``psum_scatter`` over ``data`` (chip d owns bins
    [d*4^k/N, (d+1)*4^k/N)) accumulated as uint32 limb pairs — the
    hash-pipeline topology with exact bins;
  * every k > 9 appends its sentinel-masked keys to a per-chip, per-k
    device buffer (one u32 plane for k <= 15, (hi, lo) pairs above);
    buffers resolve per chip with one lexicographic sort + run-length
    count (+ distinct-to-front compaction on real accelerators) and the
    host tree-merges sorted runs per k; k = 10..12 densify at finish so
    the dense [4^k] output contract of MAX_DENSE_K holds.

Exactness: integer adds commute and each window's key lives on exactly one
chip, so every per-k result is bit-identical to the corresponding
single-device ``count_file`` / per-k ``sharded_count_file`` run.

No reference equivalent (needletail is single-threaded; ref
benches/benchmark.rs:43-44 supplies the per-k correctness vectors).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..device import count as _count
from ..device import kmers as _kmers
from ..utils.limbs import acc64, limbs_to_int64_array
from .exact import (
    DEFAULT_SHARD_LANES,
    _fresh_fill,
    _require_data_mesh,
    _require_single_process,
    merge_resolved_shards,
)

__all__ = ["ShardedMultiKAccumulator", "sharded_multi_k_count_file"]

_SENTINEL = 0xFFFFFFFF

_DENSE_STEP_K = _count.DENSE_STEP_K


class ShardedMultiKAccumulator:
    """Streaming multi-k spectra over a ``data`` mesh (one step per batch).

    ``add(seqs, lengths)`` (or codes + vbits in packed mode) ingests one
    batch with rows divisible by the data axis; ``finish()`` returns
    ``{k: spectrum}`` where dense k yield int64 ``[4^k]`` arrays and
    sparse k yield ``(keys_u64, counts_i64)`` sorted pairs.
    """

    def __init__(
        self,
        mesh: Mesh,
        ks: Sequence[int],
        canonical: bool = True,
        normalized: bool = True,
        shard_lanes: int = DEFAULT_SHARD_LANES,
        packed: bool = False,
        quality_cutoff: Optional[int] = None,
        phred_offset: int = 33,
    ) -> None:
        ks = tuple(sorted({int(k) for k in ks}))
        if not ks:
            raise ValueError("ks must be non-empty")
        for k in ks:
            if not 1 <= k <= 31:
                raise ValueError(f"every k must be in [1, 31], got {k}")
        if packed and quality_cutoff is not None:
            raise ValueError("packed transport carries no quality planes")
        self._mesh = mesh
        self._n_data = _require_data_mesh(mesh)
        self._ks = ks
        # per-step dense limb tables up to DENSE_STEP_K; k = 10..12 keeps
        # the dense OUTPUT contract but accumulates through the narrow
        # sparse buffers and densifies at finish — the same routing
        # count_file uses (see count.DENSE_STEP_K)
        self._dense_ks = tuple(k for k in ks if k <= _DENSE_STEP_K)
        self._densify_ks = frozenset(
            k for k in ks if _DENSE_STEP_K < k <= _count.MAX_DENSE_K
        )
        self._sparse_ks = tuple(k for k in ks if k > _DENSE_STEP_K)
        for k in self._dense_ks:
            if (4**k) % self._n_data:
                raise ValueError(
                    f"4^{k} bins don't divide over data={self._n_data}; "
                    f"use a power-of-4-compatible mesh or drop k={k} to "
                    "the sparse path with dense output downstream"
                )
        self._cap = int(shard_lanes)
        self._packed = packed
        self._canonical = canonical
        self._normalized = normalized
        self._quality_cutoff = quality_cutoff
        self._phred_offset = phred_offset
        self._offsets = {k: 0 for k in self._sparse_ks}
        self._keys = {k: np.zeros(0, np.uint64) for k in self._sparse_ks}
        self._counts = {k: np.zeros(0, np.int64) for k in self._sparse_ks}
        self._ingested = False

        data_shard = NamedSharding(mesh, P("data"))
        self._plane_shard = NamedSharding(mesh, P("data", None))
        self._len_shard = NamedSharding(mesh, P("data"))
        self._dense = {
            k: (
                jax.device_put(jnp.zeros(4**k, jnp.uint32), data_shard),
                jax.device_put(jnp.zeros(4**k, jnp.uint32), data_shard),
            )
            for k in self._dense_ks
        }
        # k <= 15 keys fit one uint32 (2k <= 30 bits, below the sentinel):
        # buffer only the lo plane — half the HBM and a single-key flush
        # sort for those k (here that's k in 13..15; smaller k are dense)
        narrow = {k: k <= 15 for k in self._sparse_ks}
        self._narrow = narrow
        # one distinct buffer per plane per k: device_put of a shared fill
        # can alias, and every plane is donated each step (see _fresh_fill)
        self._bufs = {
            k: tuple(
                _fresh_fill(self._n_data * self._cap, data_shard)
                for _ in range(1 if narrow[k] else 2)
            )
            for k in self._sparse_ks
        }
        # position of each k's planes in the flattened buffer tuple
        plane_slices = {}
        _idx = 0
        for k in self._sparse_ks:
            n = 1 if narrow[k] else 2
            plane_slices[k] = slice(_idx, _idx + n)
            _idx += n
        n_planes = _idx

        dense_ks, sparse_ks = self._dense_ks, self._sparse_ks
        n_data = self._n_data

        def _step(dense, bufs, offsets, seqs, lengths, quals=None, vbits=None):
            """Per-chip body: one encode, every k's windows, all updates."""
            if packed:
                from ..device.ops import unpack_codes

                seqs = unpack_codes(seqs, vbits)
            if quals is not None:
                from ..device.ops import quality_mask

                # mask ONCE per chip; every k's windows then skip the
                # low-quality bases (same semantics as the per-k paths)
                seqs = quality_mask(
                    seqs, quals,
                    jnp.int32(phred_offset + (quality_cutoff or 0)),
                )
            fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
            max_l = seqs.shape[1]  # static per trace: ks wider than the
            new_dense = []         # batch have no windows and pass through
            new_bufs = []
            for i, k in enumerate(dense_ks):
                if k > max_l:
                    new_dense.extend((dense[2 * i], dense[2 * i + 1]))
                    continue
                win = fn(seqs, lengths, k, normalized=normalized,
                         precoded=packed)
                local = _count.dense_spectrum(win, k)
                upd = jax.lax.psum_scatter(
                    local, "data", scatter_dimension=0, tiled=True
                )
                lo, hi = acc64(dense[2 * i], dense[2 * i + 1], upd)
                new_dense.extend((lo, hi))
            for i, k in enumerate(sparse_ks):
                planes = bufs[plane_slices[k]]
                if k > max_l:
                    new_bufs.extend(planes)
                    continue
                win = fn(seqs, lengths, k, normalized=normalized,
                         precoded=packed)
                khi, klo = _count.mask_keys(win)
                vals = (klo,) if narrow[k] else (khi, klo)
                new_bufs.extend(
                    jax.lax.dynamic_update_slice(buf, v, (offsets[i],))
                    for buf, v in zip(planes, vals)
                )
            return tuple(new_dense), tuple(new_bufs)

        n_dense = len(dense_ks)
        n_sparse = len(sparse_ks)
        base_specs = (
            (P("data"),) * (2 * n_dense),
            (P("data"),) * n_planes,
            (P(),) * n_sparse,
            P("data", None),
            P("data"),
        )
        out_specs = (
            (P("data"),) * (2 * n_dense),
            (P("data"),) * n_planes,
        )

        def _shmap(body, in_specs):
            return jax.jit(
                jax.shard_map(
                    body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                ),
                donate_argnums=(0, 1),
            )

        def _plain(dense, bufs, offsets, seqs, lengths):
            return _step(dense, bufs, offsets, seqs, lengths)

        self._step = _shmap(_plain, base_specs)
        if quality_cutoff is not None:
            def _with_q(dense, bufs, offsets, seqs, lengths, quals):
                return _step(dense, bufs, offsets, seqs, lengths, quals=quals)

            self._step_q = _shmap(_with_q, base_specs + (P("data", None),))
        else:
            self._step_q = None
        if packed:
            def _with_vb(dense, bufs, offsets, seqs, lengths, vbits):
                return _step(dense, bufs, offsets, seqs, lengths, vbits=vbits)

            self._step_vb = _shmap(_with_vb, base_specs + (P("data", None),))
        else:
            self._step_vb = None
        self._plane_slices = plane_slices

        from ._resolve import make_sharded_resolver

        device_compact = jax.default_backend() != "cpu"
        self._device_compact = device_compact
        self._resolvers = {
            nw: make_sharded_resolver(mesh, device_compact, narrow=nw)
            for nw in sorted({narrow[k] for k in self._sparse_ks})
        }

    def lanes_for(self, batch_rows: int, max_len: int, k: int) -> int:
        w = max(max_len - k + 1, 0)
        return (batch_rows // self._n_data) * w

    def add(self, seqs, lengths, quals=None, vbits=None) -> None:
        seqs = jnp.asarray(seqs)
        lengths = jnp.asarray(lengths)
        b, l = seqs.shape
        if self._packed:
            l = l * 4
        if b % self._n_data:
            raise ValueError(
                f"batch rows {b} must divide over data={self._n_data}; "
                "pad with pad_reads_to"
            )
        if l < min(self._ks):
            return
        lanes = {k: self.lanes_for(b, l, k) for k in self._sparse_ks}
        if any(v > self._cap for v in lanes.values()):
            raise ValueError(
                "one batch overflows the per-chip key buffer; raise "
                "shard_lanes or shrink the batch"
            )
        if any(
            self._offsets[k] + lanes[k] > self._cap for k in self._sparse_ks
        ):
            self._flush()
        dense_flat = tuple(x for pair in self._dense.values() for x in pair)
        buf_flat = tuple(x for pair in self._bufs.values() for x in pair)
        offs = tuple(
            jnp.int32(self._offsets[k]) for k in self._sparse_ks
        )
        seqs_p = jax.device_put(seqs, self._plane_shard)
        lens_p = jax.device_put(lengths, self._len_shard)
        if self._quality_cutoff is not None:
            if quals is None:
                raise ValueError("quality_cutoff needs FASTQ qualities")
            q = jax.device_put(jnp.asarray(quals), self._plane_shard)
            new_dense, new_bufs = self._step_q(
                dense_flat, buf_flat, offs, seqs_p, lens_p, q
            )
        elif self._packed and vbits is not None:
            vb = jax.device_put(jnp.asarray(vbits), self._plane_shard)
            new_dense, new_bufs = self._step_vb(
                dense_flat, buf_flat, offs, seqs_p, lens_p, vb
            )
        else:
            new_dense, new_bufs = self._step(
                dense_flat, buf_flat, offs, seqs_p, lens_p
            )
        for i, k in enumerate(self._dense_ks):
            self._dense[k] = (new_dense[2 * i], new_dense[2 * i + 1])
        for k in self._sparse_ks:
            self._bufs[k] = tuple(new_bufs[self._plane_slices[k]])
            self._offsets[k] += lanes[k]
        self._ingested = True

    def _flush(self) -> None:
        data_shard = NamedSharding(self._mesh, P("data"))
        for k in self._sparse_ks:
            if self._offsets[k] == 0:
                continue
            out = self._resolvers[self._narrow[k]](*self._bufs[k])
            self._keys[k], self._counts[k] = merge_resolved_shards(
                out, self._narrow[k], self._device_compact,
                self._keys[k], self._counts[k],
            )
            self._bufs[k] = tuple(
                _fresh_fill(self._n_data * self._cap, data_shard)
                for _ in range(1 if self._narrow[k] else 2)
            )
            self._offsets[k] = 0

    def _dense_to_host(self, k: int) -> np.ndarray:
        """Host int64 view of a dense limb table.  Multi-process SPMD:
        only this process's shards are addressable — the returned array
        carries this process's bin ranges and zeros elsewhere (chip bin
        ranges are disjoint, so per-process arrays SUM to the global
        table, mirroring the sparse per-addressable-shard convention)."""
        lo, hi = self._dense[k]
        if lo.is_fully_addressable:
            return limbs_to_int64_array(lo, hi)
        out = np.zeros(4**k, np.int64)
        for shl, shh in zip(lo.addressable_shards, hi.addressable_shards):
            out[shl.index[0]] = limbs_to_int64_array(shl.data, shh.data)
        return out

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host snapshot for checkpointing: flushes the sparse buffers
        (an incremental resolve, not a reset) and pulls the dense limb
        tables; the accumulator stays live.  Keys: ``dense_{k}`` int64
        arrays, ``keys_{k}``/``counts_{k}`` sorted sparse pairs."""
        self._flush()
        arrays: Dict[str, np.ndarray] = {}
        for k in self._dense_ks:
            arrays[f"dense_{k}"] = self._dense_to_host(k)
        for k in self._sparse_ks:
            arrays[f"keys_{k}"] = self._keys[k]
            arrays[f"counts_{k}"] = self._counts[k]
        return arrays

    def restore(self, arrays: Dict[str, np.ndarray]) -> None:
        """Re-seed from a :meth:`snapshot` (checkpoint resume; fresh only)."""
        if self._ingested:
            raise ValueError("restore() only applies to a fresh accumulator")
        data_shard = NamedSharding(self._mesh, P("data"))
        from ..utils.limbs import int64_array_to_limbs

        for k in self._dense_ks:
            lo0, hi0 = int64_array_to_limbs(arrays[f"dense_{k}"])
            lo = jax.device_put(jnp.asarray(lo0), data_shard)
            hi = jax.device_put(jnp.asarray(hi0), data_shard)
            self._dense[k] = (lo, hi)
        for k in self._sparse_ks:
            if f"keys_{k}" not in arrays and f"dense_{k}" in arrays:
                # checkpoint written when k=10..12 rode the per-step dense
                # state: convert the table back to the sorted sparse form
                t = np.asarray(arrays[f"dense_{k}"]).astype(np.int64)
                nz = np.flatnonzero(t)
                self._keys[k] = nz.astype(np.uint64)
                self._counts[k] = t[nz]
                continue
            self._keys[k] = np.asarray(arrays[f"keys_{k}"], dtype=np.uint64)
            self._counts[k] = np.asarray(
                arrays[f"counts_{k}"], dtype=np.int64
            )

    def finish(
        self,
    ) -> Dict[int, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]:
        """``{k: spectrum}`` — dense int64 [4^k] arrays / sparse sorted
        (keys, counts) pairs, each bit-identical to a per-k run.

        Multi-process SPMD: each process returns its own devices'
        portion — dense arrays SUM across processes (for k <= 9 the bin
        ranges are disjoint; for the densified k = 10..12 duplicates add,
        which is the same invariant), sparse pairs merge with
        ``merge_sorted_spectra`` — the same per-addressable-shard
        convention as ``ShardedSpectrumAccumulator.finish``."""
        self._flush()
        out: Dict[int, object] = {}
        for k in self._dense_ks:
            out[k] = self._dense_to_host(k)
        for k in self._sparse_ks:
            if k in self._densify_ks:
                # dense OUTPUT contract for k <= MAX_DENSE_K: densify the
                # merged sparse spectrum (count_file's routing for 10..12)
                table = np.zeros(4**k, np.int64)
                table[self._keys[k].astype(np.int64)] = self._counts[k]
                out[k] = table
            else:
                out[k] = (self._keys[k], self._counts[k])
        return out


def sharded_multi_k_count_file(
    path,
    ks: Sequence[int],
    mesh: Mesh,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    canonical: bool = True,
    normalized: bool = True,
    shard_lanes: int = DEFAULT_SHARD_LANES,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    bucketed: bool = False,
    meter=None,
) -> Tuple[int, Dict[int, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]]:
    """Count several k values over the mesh in ONE pass over the file.

    The pod-scale twin of ``multi_k_count_file``: same framer, one fused
    per-batch step (encode shared across k), dense tables sharded over
    ``data``, sparse keys per-chip-sorted and host-merged.  Returns
    ``(n_bases, {k: spectrum})`` matching per-k ``sharded_count_file`` /
    dense ``count_file`` outputs bit-for-bit.  ``checkpoint_every``/
    ``resume_from`` behave as in ``sharded_count_file`` (record-aligned
    byte offsets, bit-identical resume; single-stream uncompressed input).
    ``quality_cutoff`` masks low-quality bases once per chip (shared by
    every k); ``bucketed=True`` length-buckets batches before sharding —
    both compose exactly as in ``sharded_count_file``; ``meter=`` stage
    attribution too (frame/dispatch/drain/wall).
    """
    from ..device.pipeline import _make_batch_source

    ks = tuple(sorted({int(k) for k in ks}))
    if packed is None:
        packed = quality_cutoff is None and not bucketed
    elif packed and quality_cutoff is not None:
        raise ValueError("packed transport carries no quality planes")
    elif packed and bucketed:
        raise ValueError(
            "bucketed framing is ASCII-shaped; drop packed=True or bucketed"
        )
    _require_single_process("sharded_multi_k_count_file")
    n_data = _require_data_mesh(mesh)
    batch_size = -(-batch_size // n_data) * n_data
    acc = ShardedMultiKAccumulator(
        mesh, ks, canonical=canonical, normalized=normalized,
        shard_lanes=shard_lanes, packed=packed,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    from .checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )

    def _check_ks(ck):
        ck_ks = tuple(int(x) for x in ck["meta"].get("ks", ()))
        if ck_ks != ks:
            raise ValueError(
                f"checkpoint {resume_from!r} is kind=sharded_multik "
                f"with ks={ck_ks}, expected ks={ks}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        ("sharded_multik", "multik"),
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers, bucketed=bucketed,
        validate=_check_ks, canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    n_bases = 0
    start_offset = 0
    if ck is not None:
        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        acc.restore(ck["arrays"])
    if bucketed:
        from ..io.bucketed import bucketed_read_batches

        batches = bucketed_read_batches(
            path, batch_size=batch_size, max_len=max_len,
            with_quals=quality_cutoff is not None,
        )
    elif ckpt_mode:
        batches = checkpoint_source(
            path, batch_size, max_len, quality_cutoff is not None,
            packed, normalized, start_offset,
            require_offsets=checkpoint_every is not None,
        )
    else:
        batches, _ = _make_batch_source(
            path, batch_size, max_len, host_workers,
            with_quals=quality_cutoff is not None, spill_dir=spill_dir,
            packed=packed, normalized=normalized,
        )

    def _save_ckpt(offset):
        from .checkpoint import counting_meta, save_stream_checkpoint

        save_stream_checkpoint(
            checkpoint_path, "sharded_multik", 0, offset, n_bases,
            acc.snapshot(), input_path=str(path),
            meta={
                "ks": np.asarray(ks, np.int32),
                **counting_meta(
                    canonical=canonical, normalized=normalized,
                    quality_cutoff=quality_cutoff,
                    phred_offset=phred_offset,
                ),
            },
        )

    import time as _time

    from ..utils.profiling import metered_iter

    t_wall0 = _time.perf_counter()
    batches = checkpointed_batches(batches, checkpoint_every, _save_ckpt)
    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches, items_of=lambda b: b.num_bases
        )
    for batch in batches:
        n_bases += batch.num_bases
        t0 = _time.perf_counter() if meter is not None else 0.0
        if batch.max_len >= min(ks):
            b = (
                batch
                if batch.num_reads == batch_size
                else batch.pad_reads_to(batch_size)
            )
            if packed:
                acc.add(b.codes, b.lengths, vbits=b.dense_vbits())
            else:
                if quality_cutoff is not None and b.quals is None:
                    raise ValueError(
                        "quality_cutoff needs FASTQ input with qualities"
                    )
                acc.add(
                    b.seqs, b.lengths,
                    b.quals if quality_cutoff is not None else None,
                )
        if meter is not None:
            meter.add(
                "dispatch", _time.perf_counter() - t0, items=batch.num_bases
            )
    t_drain = _time.perf_counter()
    out = acc.finish()
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, out

"""Distributed EXACT k-mer spectra for any k <= 31 over a ``data`` mesh.

The dense sharded table (``sharded.py``) stops at small k and the hash
pipeline is collision-lossy; this module is the multi-chip version of the
single-device sorted-spectrum path (``device/count.py``): every chip owns a
disjoint read shard, buffers its masked (hi, lo) key planes in a fixed
device buffer, resolves each ~buffer-full with ONE per-chip lexicographic
``lax.sort`` + run-length count (inside ``shard_map`` — no collectives, the
sorts run in parallel across chips), and the host tree-merges the per-chip
sorted runs with ``merge_sorted_spectra``.

Exactness: each window's key lives in exactly one chip's plane, local run
counts are exact, and the host merge sums duplicates across chips — so the
final (keys, counts) equals the reference's host hash-map bit-for-bit (the
same invariant the single-device ``count_file`` sparse path locks; ref
benches/benchmark.rs:43-44 vectors).

No reference equivalent (needletail is single-threaded); mandated by
BASELINE.json "exact count-table equality vs needletail" at pod scale.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..device import count as _count
from ..device import kmers as _kmers

__all__ = ["ShardedSpectrumAccumulator", "sharded_count_file"]

_SENTINEL = 0xFFFFFFFF

# default per-chip key-plane buffer: 2^23 lanes * 8 B = 64 MiB/chip
DEFAULT_SHARD_LANES = 1 << 23


def _fresh_fill(n: int, sharding: "NamedSharding") -> jax.Array:
    """A sentinel-filled uint32 buffer that is guaranteed its OWN storage.

    ``jax.device_put(x, sharding)`` may return an ALIAS of ``x`` when the
    array is already placed compatibly (observed on single-device meshes
    on real accelerators; the CPU backend copies).  Building two buffers
    by device_put-ing one fill array therefore hands the donation
    machinery two names for one buffer, and donating both in a single
    step is undefined behavior (the backend may reject it).  Each
    call here materializes a distinct on-device constant first, so the
    subsequent placement can alias safely.
    """
    return jax.device_put(jnp.full((n,), _SENTINEL, jnp.uint32), sharding)


def merge_resolved_shards(
    out,
    narrow: bool,
    device_compact: bool,
    keys0: np.ndarray,
    counts0: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge one resolver output into a running host spectrum.

    ``out`` is a per-shard sorted/compacted resolve (see
    ``_resolve.make_sharded_resolver``): ``(lo, counts, n)`` for narrow
    single-u32 keys or ``(hi, lo, counts, n)`` for (hi, lo) pairs.  Merges
    per ADDRESSABLE shard: in a multi-process (multi-host) job each
    process merges only its own devices' sorted runs — shards are
    disjoint, so the per-process spectra union to the global one
    (single-process sees every shard).  With ``device_compact`` each
    shard's distinct entries sit in a device-compacted prefix, so only
    its n_distinct entries cross the host link (the lanes:distinct ratio
    is routinely 50-1000x); otherwise the full shard compacts on host.
    Shared by the per-k exact accumulator and the fused multi-k one."""
    if narrow:
        lo_c, counts_c, ns = out
        hi_shards = [None] * len(lo_c.addressable_shards)
    else:
        hi_c, lo_c, counts_c, ns = out
        hi_shards = hi_c.addressable_shards
    for sh_h, sh_l, sh_c, sh_n in zip(
        hi_shards,
        lo_c.addressable_shards,
        counts_c.addressable_shards,
        ns.addressable_shards,
    ):
        if device_compact:
            n = int(np.asarray(sh_n.data)[0])
            if n == 0:
                continue
            keys = np.asarray(sh_l.data[:n]).astype(np.uint64)
            if sh_h is not None:
                keys |= (
                    np.asarray(sh_h.data[:n]).astype(np.uint64)
                    << np.uint64(32)
                )
            cnts = np.asarray(sh_c.data[:n]).astype(np.int64)
        else:
            keys, cnts = _count.compact_spectrum(
                None if sh_h is None else np.asarray(sh_h.data),
                np.asarray(sh_l.data),
                np.asarray(sh_c.data),
            )
        keys0, counts0 = _count.merge_sorted_spectra(
            keys0, counts0, keys, cnts
        )
    return keys0, counts0


def _require_single_process(driver: str) -> None:
    """The *_file drivers frame the whole file and place batches with
    ``device_put`` over the full mesh — both single-controller actions.
    In a multi-process SPMD job each process must frame its own
    ``host_shard_ranges()`` and drive the accumulator directly with
    globally-sharded arrays (see tests/_mp_exact_worker.py); a shared
    ``checkpoint_path`` would also race (every process would overwrite it
    with its process-local partial).  Fail up front with directions
    instead of deep in ``device_put``."""
    import jax

    if jax.process_count() > 1:
        raise ValueError(
            f"{driver} is a single-process driver; in a jax.distributed "
            "job, frame this process's host_shard_ranges() and feed the "
            "accumulator (ShardedSpectrumAccumulator / "
            "ShardedMultiKAccumulator) with "
            "jax.make_array_from_process_local_data, then merge the "
            "per-process partial spectra on the host "
            "(see tests/_mp_exact_worker.py for the full recipe)"
        )


def _require_data_mesh(mesh: Mesh) -> int:
    if "data" not in mesh.shape:
        raise ValueError("exact spectrum needs a mesh with a 'data' axis")
    if "table" in mesh.shape and mesh.shape["table"] != 1:
        # a table axis would replicate the read shard across its columns and
        # double-count every key plane
        raise ValueError(
            "exact spectrum shards keys over 'data' only; use table=1 "
            f"(got table={mesh.shape['table']})"
        )
    return mesh.shape["data"]


class ShardedSpectrumAccumulator:
    """Streaming exact spectrum over a ``data`` mesh.

    ``add(seqs, lengths)`` ingests one batch (rows divisible by the data
    axis; use ``place()`` or pass host arrays — they are device_put with
    the right sharding).  ``finish()`` returns ``(keys_u64, counts_i64)``
    sorted by key, exact for any 1 <= k <= 31.
    """

    def __init__(
        self,
        mesh: Mesh,
        k: int,
        canonical: bool = True,
        normalized: bool = True,
        shard_lanes: int = DEFAULT_SHARD_LANES,
        quality_cutoff: Optional[int] = None,
        phred_offset: int = 33,
        packed: bool = False,
        window_fn=None,
        window_lanes=None,
    ) -> None:
        """``window_fn(seqs, lengths) -> KmerWindows`` overrides the
        canonical k-mer extraction (e.g. (w, k) minimizer sketches);
        ``window_lanes(max_len) -> int`` must then give the per-read lane
        count that extraction emits.  Keys stay 2k-bit packed values, so
        the narrow-key/sort machinery is unchanged."""
        if not 1 <= k <= 31:
            raise ValueError(f"k must be in [1, 31], got {k}")
        if packed and quality_cutoff is not None:
            raise ValueError("packed transport carries no quality planes")
        if window_fn is not None and packed:
            raise ValueError("window_fn extraction consumes ASCII planes")
        if (window_fn is None) != (window_lanes is None):
            raise ValueError("window_fn and window_lanes come together")
        self._mesh = mesh
        self._n_data = _require_data_mesh(mesh)
        self._k = k
        self._cap = int(shard_lanes)
        self._offset = 0  # lanes used per shard (uniform across shards)
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)
        self._canonical = canonical
        self._normalized = normalized
        self._quality_cutoff = quality_cutoff
        self._phred_offset = phred_offset
        self._packed = packed
        self._lanes_per_read = window_lanes or (
            lambda max_len: max(max_len - k + 1, 0)
        )
        # k <= 15 keys fit one uint32 (2k <= 30 bits, below the sentinel):
        # buffer only the lo plane — half the buffer memory and a
        # single-key flush sort
        narrow = k <= 15
        self._narrow = narrow
        self._nbuf = 1 if narrow else 2

        buf_sharding = NamedSharding(mesh, P("data"))
        self._buf_sharding = buf_sharding
        self._data_sharding = NamedSharding(mesh, P("data", None))
        self._len_sharding = NamedSharding(mesh, P("data"))
        self._bufs = tuple(
            _fresh_fill(self._n_data * self._cap, buf_sharding)
            for _ in range(self._nbuf)
        )

        k_ = k

        def _append(bufs, offset, seqs, lengths, quals, vbits=None):
            """Per-shard body: extract this shard's masked keys, write them
            at [offset, offset + lanes) of this shard's buffer slice.
            Packed mode unpacks this shard's code plane locally."""
            if packed:
                from ..device.ops import unpack_codes

                seqs = unpack_codes(seqs, vbits)
            if quals is not None:
                from ..device.ops import quality_mask

                seqs = quality_mask(
                    seqs, quals, jnp.int32(phred_offset + (quality_cutoff or 0))
                )
            if window_fn is not None:
                win = window_fn(seqs, lengths)
            else:
                fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
                win = fn(
                    seqs, lengths, k_, normalized=normalized, precoded=packed
                )
            hi, lo = _count.mask_keys(win)
            planes = (lo,) if narrow else (hi, lo)
            return tuple(
                jax.lax.dynamic_update_slice(buf, plane, (offset,))
                for buf, plane in zip(bufs, planes)
            )

        with_quals = quality_cutoff is not None
        buf_specs = ((P("data"),) * self._nbuf,)
        base_specs = buf_specs + (
            P(),
            P("data", None),
            P("data"),
        )

        def _shmap(body, in_specs):
            return jax.jit(
                jax.shard_map(
                    body,
                    mesh=mesh,
                    in_specs=in_specs,
                    out_specs=(P("data"),) * self._nbuf,
                ),
                donate_argnums=(0,),
            )

        if with_quals:
            self._append = _shmap(_append, base_specs + (P("data", None),))
            self._append_vb = None
        else:
            def _plain(bufs, off, s, l):
                return _append(bufs, off, s, l, None)

            self._append = _shmap(_plain, base_specs)
            if packed:
                def _with_vb(bufs, off, s, l, vb):
                    return _append(bufs, off, s, l, None, vb)

                self._append_vb = _shmap(
                    _with_vb, base_specs + (P("data", None),)
                )
            else:
                self._append_vb = None

        # compact on device for real accelerators (bounds each shard's
        # host pull to its distinct entries); skip it on the CPU backend
        # where pulls are local copies
        from ._resolve import make_sharded_resolver

        device_compact = jax.default_backend() != "cpu"
        self._device_compact = device_compact
        self._resolve = make_sharded_resolver(mesh, device_compact, narrow=narrow)

    def place(self, seqs, lengths):
        """Shard a host batch over the data axis."""
        return (
            jax.device_put(jnp.asarray(seqs), self._data_sharding),
            jax.device_put(jnp.asarray(lengths), self._len_sharding),
        )

    def lanes_for(self, batch_rows: int, max_len: int) -> int:
        """Per-shard key lanes one (batch_rows, max_len) batch produces."""
        return (batch_rows // self._n_data) * self._lanes_per_read(max_len)

    def add(self, seqs, lengths, quals=None, vbits=None) -> None:
        """Ingest one batch.  In packed mode ``seqs`` is the [B, L/4] code
        plane and ``vbits`` the optional validity bitplane (None = clean)."""
        seqs = jnp.asarray(seqs)
        lengths = jnp.asarray(lengths)
        b, l = seqs.shape
        if self._packed:
            l = l * 4  # window math runs on true base length
        if b % self._n_data:
            raise ValueError(
                f"batch rows {b} must be divisible by the data axis "
                f"({self._n_data}); pad with ReadBatch.pad_reads_to"
            )
        if self._lanes_per_read(l) < 1:
            return  # no window fits (l < k, or < k + w - 1 for sketches)
        lanes = self.lanes_for(b, l)
        if lanes > self._cap:
            raise ValueError(
                f"one batch produces {lanes} lanes/shard > buffer {self._cap}; "
                "raise shard_lanes or shrink the batch"
            )
        if self._offset + lanes > self._cap:
            self._flush()
        args = [self._bufs, jnp.int32(self._offset)]
        placed = self.place(seqs, lengths)
        args.extend(placed)
        append = self._append
        if self._quality_cutoff is not None:
            if quals is None:
                raise ValueError("quality_cutoff needs FASTQ qualities")
            args.append(
                jax.device_put(jnp.asarray(quals), self._data_sharding)
            )
        elif self._packed and vbits is not None:
            args.append(
                jax.device_put(jnp.asarray(vbits), self._data_sharding)
            )
            append = self._append_vb
        self._bufs = append(*args)
        self._offset += lanes

    def _flush(self) -> None:
        if self._offset == 0:
            return
        out = self._resolve(*self._bufs)
        self._keys, self._counts = merge_resolved_shards(
            out, self._narrow, self._device_compact, self._keys, self._counts
        )
        self._bufs = tuple(
            _fresh_fill(self._n_data * self._cap, self._buf_sharding)
            for _ in range(self._nbuf)
        )
        self._offset = 0

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Final ``(keys_u64, counts_i64)``, keys ascending.

        Single process: the complete global spectrum.  Multi-process SPMD:
        each process returns the exact spectrum of the keys its own
        devices held — per-process results have disjoint provenance per
        flush and merge to the global spectrum with
        ``merge_sorted_spectra`` (keys may repeat across processes)."""
        self._flush()
        return self._keys, self._counts

    def restore(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Re-seed the merged spectrum (checkpoint resume; fresh only)."""
        if self._offset or self._keys.size:
            raise ValueError("restore() only applies to a fresh accumulator")
        self._keys = np.asarray(keys, dtype=np.uint64)
        self._counts = np.asarray(counts, dtype=np.int64)


def sharded_count_file(
    path,
    k: int,
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
) -> Tuple[int, Tuple[np.ndarray, np.ndarray]]:
    """Exact (keys_u64, counts) spectrum of a FASTX file over a data mesh.

    The multi-chip twin of ``device.pipeline.count_file``'s sparse path:
    same framer, same key semantics (including ``quality_cutoff``
    masking), per-chip sorts, host merge.  Returns ``(n_bases,
    (keys, counts))`` with keys ascending.  Input front as in
    ``count_file``: auto-sized framing workers + transparent spill decode.
    ``batch_size`` rounds up to a multiple of the data axis.
    ``packed=None`` auto-selects the 2-bit packed transport whenever no
    quality planes are needed (bit-identical results, 4x less transfer).
    ``bucketed=True`` groups reads by length bucket before sharding (one
    compiled per-shard program per bucket width; rows pad to the batch
    size so padding lanes stay inert) — result is bit-identical.
    ``meter=`` (a ``utils.profiling.ThroughputMeter``) attributes wall
    clock: ``frame`` (host framing), ``dispatch`` (placement + sharded
    step enqueue — H2D rides inside the shard placement here), ``drain``
    (final flush sort + host merge) and ``wall``.
    """
    from ..device.pipeline import _make_batch_source

    _require_single_process("sharded_count_file")
    if packed is None:
        packed = quality_cutoff is None and not bucketed
    elif packed and quality_cutoff is not None:
        raise ValueError("packed transport carries no quality planes")
    elif packed and bucketed:
        raise ValueError(
            "bucketed framing is ASCII-shaped; drop packed=True or bucketed"
        )
    n_data = _require_data_mesh(mesh)
    batch_size = -(-batch_size // n_data) * n_data
    acc = ShardedSpectrumAccumulator(
        mesh,
        k,
        canonical=canonical,
        normalized=normalized,
        shard_lanes=shard_lanes,
        quality_cutoff=quality_cutoff,
        phred_offset=phred_offset,
        packed=packed,
    )
    from .checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "sharded_exact", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers, bucketed=bucketed,
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    n_bases = 0
    start_offset = 0
    if ck is not None:
        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        acc.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])
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

        # snapshot = flush (one per-shard sort) + the merged host spectrum
        keys, counts = acc.finish()
        save_stream_checkpoint(
            checkpoint_path, "sharded_exact", k, offset, n_bases,
            {"keys": keys, "counts": counts}, input_path=str(path),
            meta=counting_meta(
                canonical=canonical, normalized=normalized,
                quality_cutoff=quality_cutoff, phred_offset=phred_offset,
            ),
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
        if batch.max_len >= k:
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
        meter.add("drain", now - t_drain, items=len(out[0]))
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, out

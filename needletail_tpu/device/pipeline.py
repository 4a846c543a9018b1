"""Fused end-to-end device pipelines and file-level drivers.

The device computation (encode -> pack -> canonicalize -> count) compiles to
a single XLA program per batch shape; the host streams framed batches in and
merges per-batch results.  This is the device equivalent of the
reference's README loop (ref src/lib.rs:6-40): parse, normalize, reverse
complement, canonical k-mers, tally.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fast_batch import fast_read_batches as read_batches
from ..bitkmer import bytes_to_bitmer
from ..utils.profiling import metered_iter
from . import count as _count
from . import kmers as _kmers

__all__ = [
    "canonical_dense_count",
    "canonical_match_count",
    "base_count",
    "count_file",
    "multi_k_count_file",
    "hash_count_file",
    "minimizer_spectrum_file",
    "quality_filter_file",
    "readme_pipeline",
    "multi_k_tally",
    "pack_target",
]


def pack_target(kmer_bytes: bytes) -> Tuple[np.uint32, np.uint32]:
    """Pack an ASCII k-mer into the (hi, lo) uint32 pair used on device."""
    value, k = bytes_to_bitmer(kmer_bytes)
    return np.uint32(value >> 32), np.uint32(value & 0xFFFFFFFF)


@partial(jax.jit, static_argnames=("k", "canonical", "normalized"))
def canonical_dense_count(
    seqs: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> jax.Array:
    """[4^k] int32 exact spectrum of (canonical) k-mers for one batch."""
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
    windows = fn(seqs, lengths, k, normalized=normalized)
    return _count.dense_spectrum(windows, k)


@partial(jax.jit, static_argnames=("k", "canonical", "normalized"))
def canonical_match_count(
    seqs: jax.Array,
    lengths: jax.Array,
    target_hi: jax.Array,
    target_lo: jax.Array,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> jax.Array:
    """Scalar count of windows whose (canonical) value equals the target."""
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
    windows = fn(seqs, lengths, k, normalized=normalized)
    return _count.match_count(windows, target_hi, target_lo)


@jax.jit
def base_count(lengths: jax.Array) -> jax.Array:
    return jnp.sum(lengths.astype(jnp.int64 if jax.config.jax_enable_x64 else jnp.int32))


# ---------------------------------------------------------------------------
# Memoized per-config jitted steps.
#
# The file drivers are called many times per process (bench loops, resumed
# streams, multi-file corpora).  A ``@jax.jit`` defined INSIDE the driver is
# a fresh closure per call, so jit's trace cache never hits and every driver
# invocation re-traces and re-lowers its step.  Each factory below caches
# the jitted step on its static config; jit then specializes per batch
# shape as usual.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _count_step_fns(
    k: int,
    packed: bool,
    canonical: bool,
    normalized: bool,
    qthresh: Optional[int],
):
    """(accumulate, keys) pair for :func:`count_file`.

    ``qthresh`` is ``phred_offset + quality_cutoff`` (or None: no quality
    masking).
    """
    narrow_keys = k <= 15
    from ..utils.limbs import acc64

    def _windows(seqs, lengths, quals, vbits):
        if packed:
            from .ops import unpack_codes

            seqs = unpack_codes(seqs, vbits)
        if quals is not None:
            from .ops import quality_mask

            seqs = quality_mask(seqs, quals, jnp.int32(qthresh))
        fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
        return fn(seqs, lengths, k, normalized=normalized, precoded=packed)

    def _resolve(seqs, lengths, vbits, vrow_idx, vrows):
        from .ops import resolve_vbits

        return (
            lengths.astype(jnp.int32),
            resolve_vbits(vbits, vrow_idx, vrows, seqs.shape[0]),
        )

    def _keys_body(seqs, lengths, quals, vbits):
        hi, lo = _count.mask_keys(_windows(seqs, lengths, quals, vbits))
        return (None if narrow_keys else hi), lo

    if packed:
        # coalesced one-buffer transport (see _hash_step_fn); quals — only
        # present under quality_cutoff — ride as their own plane since the
        # packed wire doesn't carry 1-byte/base payloads
        @partial(
            jax.jit, donate_argnums=(0, 1), static_argnames=("layout",)
        )
        def accumulate(table_lo, table_hi, wire, quals, *, layout):
            from .ops import unwire

            seqs, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            lengths, vbits = _resolve(seqs, lengths, vbits, vrow_idx, vrows)
            spec = _count.dense_spectrum(
                _windows(seqs, lengths, quals, vbits), k
            )
            return acc64(table_lo, table_hi, spec)

        @partial(jax.jit, static_argnames=("layout",))
        def keys(wire, quals, *, layout):
            from .ops import unwire

            seqs, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            lengths, vbits = _resolve(seqs, lengths, vbits, vrow_idx, vrows)
            return _keys_body(seqs, lengths, quals, vbits)

    else:

        @partial(jax.jit, donate_argnums=(0, 1))
        def accumulate(table_lo, table_hi, seqs, lengths, quals):
            spec = _count.dense_spectrum(
                _windows(seqs, lengths.astype(jnp.int32), quals, None), k
            )
            return acc64(table_lo, table_hi, spec)

        @jax.jit
        def keys(seqs, lengths, quals):
            return _keys_body(seqs, lengths.astype(jnp.int32), quals, None)

    return accumulate, keys


@lru_cache(maxsize=None)
def _hash_step_fn(k: int, table_bits: int, packed: bool, normalized: bool):
    """Fused hash-count step for :func:`hash_count_file`.

    The packed variant takes the coalesced ONE-buffer wire transport
    (``PackedReadBatch.wire_frame``) plus its static ``WireLayout``: one
    host->device transfer per batch instead of 4-5, each of which would
    cost its own host dispatch and transfer round trip.
    """
    from .hashcount import (
        canonical_hash_keys,
        canonical_hash_keys_packed,
        hash_histogram,
    )
    from ..utils.limbs import acc64

    def _fold(table_lo, table_hi, tallies, keys, t, f):
        t_lo, t_hi = acc64(tallies[0], tallies[1], t)
        f_lo, f_hi = acc64(tallies[2], tallies[3], f)
        inc = hash_histogram(keys, 1 << table_bits)
        lo, hi = acc64(table_lo, table_hi, inc)
        return lo, hi, jnp.stack([t_lo, t_hi, f_lo, f_hi])

    if packed:

        @partial(jax.jit, donate_argnums=(0, 1, 2), static_argnames=("layout",))
        def step(table_lo, table_hi, tallies, wire, *, layout):
            from .ops import resolve_vbits, unwire

            seqs, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            vb = resolve_vbits(vbits, vrow_idx, vrows, seqs.shape[0])
            keys, t, f = canonical_hash_keys_packed(
                seqs, vb, lengths, k, table_bits=table_bits
            )
            return _fold(table_lo, table_hi, tallies, keys, t, f)

    else:

        @partial(jax.jit, donate_argnums=(0, 1, 2))
        def step(table_lo, table_hi, tallies, seqs, lengths):
            keys, t, f = canonical_hash_keys(
                seqs, lengths.astype(jnp.int32), k,
                table_bits=table_bits, normalized=normalized,
            )
            return _fold(table_lo, table_hi, tallies, keys, t, f)

    return step


@lru_cache(maxsize=None)
def _hash_finalize_fn():
    """One-buffer result drain for :func:`hash_count_file`: concat the
    tallies + a hi-limb-occupancy count + the lo table plane so the host
    pulls ONCE instead of paying a device->host round trip per array.  The
    hi plane is nonzero only when some bin exceeds 2^32-1 counts; the
    driver pulls it separately in that rare case."""

    @jax.jit
    def finalize(table_lo, table_hi, tallies):
        hi_n = jnp.sum((table_hi != 0).astype(jnp.uint32))[None]
        return jnp.concatenate([tallies, hi_n, table_lo])

    return finalize


@lru_cache(maxsize=None)
def _multi_k_step_fn(
    ks: Tuple[int, ...],
    packed: bool,
    canonical: bool,
    normalized: bool,
    qthresh: Optional[int],
):
    """Per-batch multi-k step for :func:`multi_k_count_file`."""
    from ..utils.limbs import acc64

    step_dense_ks = tuple(k for k in ks if k <= _count.DENSE_STEP_K)

    def _windows(seqs, lengths, quals, k):
        if quals is not None:
            from .ops import quality_mask

            seqs = quality_mask(seqs, quals, jnp.int32(qthresh))
        fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
        return fn(seqs, lengths, k, normalized=normalized, precoded=packed)

    def _body(dense_limbs, seqs, lengths, quals, active):
        new_dense = dict(dense_limbs)
        sparse_keys = {}
        for k in active:
            win = _windows(seqs, lengths, quals, k)
            if k in step_dense_ks:
                lo, hi = dense_limbs[k]
                new_dense[k] = acc64(lo, hi, _count.dense_spectrum(win, k))
            else:
                khi, klo = _count.mask_keys(win)
                # k <= 15 keys fit one uint32: single-key flush sort
                sparse_keys[k] = ((None if k <= 15 else khi), klo)
        return new_dense, sparse_keys

    if packed:
        # coalesced one-buffer transport (see _hash_step_fn)
        @partial(
            jax.jit, donate_argnums=(0,), static_argnames=("active", "layout")
        )
        def step(dense_limbs, wire, quals, active, *, layout):
            from .ops import resolve_vbits, unpack_codes, unwire

            seqs, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            vbits = resolve_vbits(vbits, vrow_idx, vrows, seqs.shape[0])
            # one unpack shared by every k (XLA CSEs the common prefix)
            seqs = unpack_codes(seqs, vbits)
            return _body(dense_limbs, seqs, lengths, quals, active)

    else:

        @partial(jax.jit, donate_argnums=(0,), static_argnames=("active",))
        def step(dense_limbs, seqs, lengths, quals, active):
            return _body(
                dense_limbs, seqs, lengths.astype(jnp.int32), quals, active
            )

    return step


@lru_cache(maxsize=None)
def _minimizer_keys_fn(k: int, w: int, packed: bool, normalized: bool):
    """Window-minimizer key extraction for :func:`minimizer_spectrum_file`."""
    from . import minimizers as _minimizers

    def _body(seqs, lengths):
        win = _minimizers.window_minimizers(
            seqs, lengths, k, w, normalized=normalized, precoded=packed
        )
        hi, lo = _count.mask_keys(win)
        return (None if k <= 15 else hi), lo

    if packed:
        # coalesced one-buffer transport (see _hash_step_fn)
        @partial(jax.jit, static_argnames=("layout",))
        def keys(wire, *, layout):
            from .ops import resolve_vbits, unpack_codes, unwire

            seqs, lengths, vbits, vrow_idx, vrows = unwire(wire, layout)
            seqs = unpack_codes(
                seqs, resolve_vbits(vbits, vrow_idx, vrows, seqs.shape[0])
            )
            return _body(seqs, lengths)

    else:

        @jax.jit
        def keys(seqs, lengths):
            return _body(seqs, lengths.astype(jnp.int32))

    return keys


@lru_cache(maxsize=None)
def _mean_quality_fn(phred_offset: int):
    from .quality import mean_quality

    @jax.jit
    def means(quals, lengths):
        return mean_quality(quals, lengths, jnp.int32(phred_offset))

    return means


@partial(jax.jit, static_argnames=("ks", "canonical", "normalized"))
def _multi_k_tally_run(seqs, lengths, ks, canonical, normalized):
    out = {}
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
    for k in ks:
        win = fn(seqs, lengths, k, normalized=normalized)
        out[k] = (
            _count.valid_count(win),
            _count.forward_count(win),
        )
    return out


def count_file(
    path,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
    batch_size: int = 512,
    max_len: Optional[int] = None,
    dense: Optional[bool] = None,
    sparse_format: str = "dict",
    bucketed: bool = False,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
) -> Tuple[int, Union[np.ndarray, Dict[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """Stream a FASTX file through the device k-mer counter.

    Returns ``(n_bases, spectrum)`` where spectrum is a dense ``[4^k]`` numpy
    array for small k, otherwise a ``{packed_kmer: count}`` dict (or
    ``(keys_u64, counts)`` numpy arrays with ``sparse_format="arrays"`` —
    preferred for large outputs; the dict itself is the slow part).  Sparse
    counting accumulates masked key planes on device and resolves the whole
    stream with one lexicographic device sort + run-length count.

    ``bucketed=True`` groups reads by length bucket so padding lanes (and
    thus device FLOPs) track real bases on mixed-length corpora — one
    compile per bucket width instead of one corpus-wide width.

    ``quality_cutoff`` masks bases whose Phred score is below the cutoff to
    'N' before counting (FASTQ only) — the reference's ``quality_mask`` →
    count composition (ref sequence.rs:280-308), fused into the same
    compiled program via the window validity mask.

    ``packed=None`` auto-selects the 2-bit packed transport (4x fewer
    host->device bytes) whenever the batch doesn't need quality planes or
    bucketed shapes; results are bit-identical either way.

    ``checkpoint_every=N`` + ``checkpoint_path`` persist the running state
    (dense limb table or merged sparse spectrum, plus the record-aligned
    byte offset) every N batches; ``resume_from=`` continues from such a
    file with a bit-identical final spectrum.  Single-stream framing over
    an uncompressed (or BGZF) file; incompatible with ``bucketed``.
    Multi-k streams checkpoint too (kind ``"multik"``, interchangeable
    with the sharded twin's — see ``multi_k_count_file``).
    """
    if isinstance(k, (tuple, list, set, frozenset)):
        # single-pass multi-k: count_file(path, k=(4, 21, 31)) shares the
        # encode/ladder work across k values (see multi_k_count_file)
        if bucketed or dense is not None:
            raise ValueError(
                "multi-k counting does not take bucketed/dense; call "
                "multi_k_count_file directly for full control"
            )
        return multi_k_count_file(
            path,
            k,
            canonical=canonical,
            normalized=normalized,
            batch_size=batch_size,
            max_len=max_len,
            sparse_format=sparse_format,
            quality_cutoff=quality_cutoff,
            phred_offset=phred_offset,
            host_workers=host_workers,
            spill_dir=spill_dir,
            packed=packed,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
            resume_from=resume_from,
        )
    if bucketed and host_workers is not None and host_workers > 1:
        raise ValueError(
            "bucketed=True and host_workers>1 are mutually exclusive: "
            "bucketed framing is single-process (pass one or the other)"
        )
    if dense is None:
        dense = k <= _count.MAX_DENSE_K
    elif dense and k > _count.MAX_DENSE_K:
        # fail fast: a dense [4^k] output past MAX_DENSE_K would try to
        # allocate terabytes after counting the whole file
        raise ValueError(
            f"dense output needs k <= {_count.MAX_DENSE_K}, got {k}; "
            "use dense=False (sparse keys/counts) for larger k"
        )
    from ..utils.limbs import acc64, limbs_to_int64_array

    if packed is None:
        # auto: packed transport whenever quality planes / bucketed shapes
        # aren't in play (both need the ASCII path)
        packed = quality_cutoff is None and not bucketed
    elif packed and (quality_cutoff is not None or bucketed):
        raise ValueError(
            "packed transport carries no quality planes and no bucketed "
            "shapes; drop packed=True or the conflicting option"
        )

    n_bases = 0
    # uint32 limb pairs (see utils.limbs): per-batch increments are int32,
    # the running table is exact to 2^64 per bin (the reference counts in
    # host usize; int32 bins would wrap silently past 2^31)
    dense_limbs = None  # stays on device; accumulation is async-dispatched
    sparse = _count.SparseSpectrumAccumulator()
    # dense OUTPUT for k > DENSE_STEP_K accumulates through the sorted
    # sparse path and densifies at the end (see count.DENSE_STEP_K)
    densify_after = dense and k > _count.DENSE_STEP_K
    accumulate_dense = dense and not densify_after

    # keys for k <= 15 fit one uint32 (2k <= 30 bits, below the sentinel):
    # the factory drops the hi plane so the flush sort runs single-key.
    # Steps come from the memoized factory — a fresh in-driver jit would
    # re-trace on every call (see _count_step_fns).
    _accumulate, _keys = _count_step_fns(
        k,
        packed,
        canonical,
        normalized,
        None if quality_cutoff is None else phred_offset + quality_cutoff,
    )

    from ..parallel.checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "count_dense" if accumulate_dense else "count_sparse", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers, bucketed=bucketed,
        canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    start_offset = 0
    if ck is not None:
        from ..utils.limbs import int64_array_to_limbs

        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        if accumulate_dense:
            lo, hi = int64_array_to_limbs(ck["arrays"]["table"])
            dense_limbs = (jnp.asarray(lo), jnp.asarray(hi))
        else:
            sparse.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])

    def _save_ckpt(offset):
        from ..parallel.checkpoint import counting_meta, save_stream_checkpoint

        sem = counting_meta(
            canonical=canonical, normalized=normalized,
            quality_cutoff=quality_cutoff, phred_offset=phred_offset,
        )
        if accumulate_dense:
            table = (
                np.zeros(4**k, np.int64)
                if dense_limbs is None
                else np.asarray(limbs_to_int64_array(*dense_limbs))
            )
            save_stream_checkpoint(
                checkpoint_path, "count_dense", k, offset, n_bases,
                {"table": table}, input_path=str(path), meta=sem,
            )
        else:
            # finish() flushes (one sort) and leaves the accumulator live
            keys, counts = sparse.finish()
            save_stream_checkpoint(
                checkpoint_path, "count_sparse", k, offset, n_bases,
                {"keys": keys, "counts": counts}, input_path=str(path),
                meta=sem,
            )

    if bucketed:
        from ..io.bucketed import bucketed_read_batches

        batches = bucketed_read_batches(path, batch_size=batch_size, max_len=max_len)
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
    # save cadence: fires only after the driver folded each N-th batch
    batches = checkpointed_batches(batches, checkpoint_every, _save_ckpt)

    import time as _time

    def _batch_nbytes(b) -> int:
        if packed:
            return b.wire_nbytes()
        n = b.seqs.nbytes + b.lengths.nbytes
        if quality_cutoff is not None and b.quals is not None:
            n += b.quals.nbytes
        return n

    t_wall0 = _time.perf_counter()
    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches,
            nbytes_of=_batch_nbytes, items_of=lambda b: b.num_bases,
        )
    from ..batch import length_wire_dtype

    for batch in batches:
        if batch.max_len < k:
            # no window fits; bases still count
            n_bases += batch.num_bases
            continue
        t0 = _time.perf_counter() if meter is not None else 0.0
        quals = None
        if quality_cutoff is not None:
            if batch.quals is None:
                raise ValueError("quality_cutoff needs FASTQ input with qualities")
            quals = jnp.asarray(batch.quals)
        if packed:
            # coalesced one-buffer transport (no read-dim padding: the
            # jitted steps specialize once per short-final-batch shape,
            # exactly as the multi-plane transport did)
            buf, layout = batch.wire_frame(batch.num_reads)
            wire = jnp.asarray(buf)
            placed = [wire] if quals is None else [wire, quals]
        else:
            seqs = jnp.asarray(batch.seqs)
            lengths = jnp.asarray(
                batch.lengths.astype(
                    length_wire_dtype(batch.max_len), copy=False
                )
            )
            placed = [a for a in (seqs, lengths, quals) if a is not None]
        if meter is not None:
            jax.block_until_ready(placed)
            meter.add(
                "h2d", _time.perf_counter() - t0, nbytes=_batch_nbytes(batch)
            )
            t0 = _time.perf_counter()
        n_bases += batch.num_bases
        if accumulate_dense:
            if dense_limbs is None:
                dense_limbs = (
                    jnp.zeros(4**k, dtype=jnp.uint32),
                    jnp.zeros(4**k, dtype=jnp.uint32),
                )
            if packed:
                dense_limbs = _accumulate(
                    *dense_limbs, wire, quals, layout=layout
                )
            else:
                dense_limbs = _accumulate(*dense_limbs, seqs, lengths, quals)
        elif packed:
            sparse.add(*_keys(wire, quals, layout=layout))
        else:
            sparse.add(*_keys(seqs, lengths, quals))
        if meter is not None:
            meter.add(
                "dispatch", _time.perf_counter() - t0, items=batch.num_bases
            )
    t_drain = _time.perf_counter()
    if meter is not None:
        _result_meter = meter

        def _finish_meter(result):
            now = _time.perf_counter()
            _result_meter.add("drain", now - t_drain)
            _result_meter.add("wall", now - t_wall0, items=result[0])
            return result

    else:

        def _finish_meter(result):
            return result

    if accumulate_dense:
        if dense_limbs is None:
            return _finish_meter((n_bases, np.zeros(4**k, np.int64)))
        lo, hi = dense_limbs
        return _finish_meter((n_bases, limbs_to_int64_array(lo, hi)))
    if densify_after:
        keys, counts = sparse.finish()
        table = np.zeros(4**k, np.int64)
        table[keys.astype(np.int64)] = counts
        return _finish_meter((n_bases, table))
    keys, counts = sparse.finish()
    if sparse_format == "arrays":
        return _finish_meter((n_bases, (keys, counts)))
    return _finish_meter((n_bases, _count.spectrum_arrays_to_dict(keys, counts)))


def multi_k_tally(
    seqs: jax.Array,
    lengths: jax.Array,
    ks: Tuple[int, ...],
    canonical: bool = True,
    normalized: bool = True,
) -> Dict[int, Tuple[jax.Array, jax.Array]]:
    """Single compiled pass tallying several k values at once (the north-star
    "canonical 4..31-mer counting" shape): encode happens once per call and
    XLA CSEs the shared window packing across k.

    Returns {k: (total_valid, forward_count)}.
    """

    return _multi_k_tally_run(seqs, lengths, tuple(ks), canonical, normalized)


def _quantize_max_len(max_len: Optional[int]) -> Optional[int]:
    """Driver-level max_len quantum: round an explicit max_len up to a
    multiple of 8 regardless of transport, so the packed (byte-quantized
    planes) and ASCII paths accept exactly the same reads.  Delegates to
    the one packed-quantum rule in io.fast_batch."""
    from ..io.fast_batch import _effective_packed_max_len

    return _effective_packed_max_len(True, max_len)


def _make_batch_source(
    path,
    batch_size: int,
    max_len: Optional[int],
    host_workers: Optional[int],
    with_quals: bool,
    spill_dir: Optional[str] = None,
    packed: bool = False,
    normalized: bool = True,
):
    """Shared e2e input front: auto-sized multi-worker framing with
    opt-in parallel decompression.

    ``host_workers=None`` auto-sizes from the CPU count for plain files.
    Compressed input streams single-process with bounded memory by default;
    decode-to-spill (a FULL uncompressed temp copy, enabling byte-range
    workers — BGZF decodes block-parallel, other codecs serially) engages
    only when the caller opts in with an explicit ``host_workers > 1`` or a
    ``spill_dir``.  A spill target without room for the estimated
    decompressed size degrades to streaming with a warning instead of
    filling the disk.  Returns a generator; the spill file (if any) is
    removed when the generator is exhausted or closed.

    An explicit ``max_len`` quantizes UP to a multiple of 8 in BOTH
    transports (packed planes are byte-quantized; the ASCII path rounds
    identically so toggling packed/quality never flips a read between
    accepted and 'exceeds max_len').
    A LIST/TUPLE of paths chains every file through one source (counting
    state is integer adds, so multi-file spectra are exact); max_len
    should be set explicitly for mixed corpora to keep one compiled
    batch shape.
    """
    from ..io.compression import sniff_compression
    from ..io.parallel_host import auto_host_workers, parallel_read_batches

    if isinstance(path, (list, tuple)):
        if len(path) == 1:
            path = path[0]
        else:
            paths = list(path)

            def chained():
                for p in paths:
                    src, _w = _make_batch_source(
                        p, batch_size, max_len, host_workers,
                        with_quals=with_quals, spill_dir=spill_dir,
                        packed=packed, normalized=normalized,
                    )
                    yield from src

            return chained(), (host_workers or 0)

    max_len = _quantize_max_len(max_len)

    compressed = False
    if str(path) != "-":
        try:
            with open(path, "rb") as f:
                magic = f.read(2)
            compressed = len(magic) == 2 and sniff_compression(magic) is not None
        except OSError:
            pass  # let the framer surface the error with its taxonomy
    spill_opt_in = spill_dir is not None or (
        host_workers is not None and host_workers > 1
    )
    if host_workers is None:
        host_workers = auto_host_workers()
    if str(path) == "-":
        host_workers = 1  # stdin cannot be range-split; stream it
    if compressed and not spill_opt_in:
        # ADVICE r2: auto-sized workers must not silently decode a whole
        # .gz to temp disk/RAM; compressed input streams unless the caller
        # explicitly opted into the spill trade-off
        host_workers = 1
    if host_workers <= 1:
        return read_batches(
            path, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, prefetch=True,
            packed=packed, normalized=normalized,
        ), host_workers

    def gen():
        from ..io.spill import SpillSpaceError, spilled_input

        spill = spilled_input(path, dir=spill_dir, threads=host_workers)
        try:
            plain = spill.__enter__()
        except SpillSpaceError as exc:
            import warnings

            warnings.warn(
                f"falling back to single-stream framing: {exc}",
                RuntimeWarning,
                stacklevel=2,
            )
            yield from read_batches(
                path, batch_size=batch_size, max_len=max_len,
                with_quals=with_quals, prefetch=True,
                packed=packed, normalized=normalized,
            )
            return
        try:
            yield from parallel_read_batches(
                plain,
                workers=host_workers,
                batch_size=batch_size,
                max_len=max_len,
                with_quals=with_quals,
                packed=packed,
                normalized=normalized,
            )
        finally:
            spill.__exit__(None, None, None)

    return gen(), host_workers


def multi_k_count_file(
    path,
    ks,
    canonical: bool = True,
    normalized: bool = True,
    batch_size: int = 512,
    max_len: Optional[int] = None,
    sparse_format: str = "arrays",
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
) -> Tuple[int, Dict[int, Union[np.ndarray, Dict[int, int], Tuple[np.ndarray, np.ndarray]]]]:
    """Count several k values in ONE pass over the file (the north-star
    "canonical 4..31-mer counting" shape, BASELINE.json).

    Per batch, a single compiled program computes every k's windows — the
    2-bit encode happens once and XLA CSEs the shared shift-ladder
    prefixes across k — so the marginal cost of an extra k is far below a
    full extra pass (see ``benchmarks/run.py --group multi_k``).

    Returns ``(n_bases, {k: spectrum})`` where each spectrum matches what
    ``count_file(path, k=k, ...)`` returns: dense int64 ``[4^k]`` for
    k <= MAX_DENSE_K, else sparse ``(keys_u64, counts)`` (or a dict with
    ``sparse_format="dict"``).

    ``checkpoint_every=N`` + ``checkpoint_path`` persist the full
    multi-k state every N batches (kind ``"multik"``; the array schema is
    the sharded twin's snapshot — ``dense_{k}`` tables + ``keys_{k}`` /
    ``counts_{k}`` sorted pairs — so flat and
    ``parallel.sharded_multi_k_count_file`` checkpoints interchange);
    ``resume_from=`` continues bit-identically.
    """
    ks = tuple(sorted({int(k) for k in ks}))
    if not ks:
        raise ValueError("ks must be non-empty")
    for k in ks:
        if not 1 <= k <= 31:
            raise ValueError(f"every k must be in [1, 31], got {k}")
    from ..utils.limbs import acc64

    if packed is None:
        packed = quality_cutoff is None
    elif packed and quality_cutoff is not None:
        raise ValueError("packed transport carries no quality planes")

    dense_ks = tuple(k for k in ks if k <= _count.MAX_DENSE_K)
    sparse_ks = tuple(k for k in ks if k > _count.MAX_DENSE_K)
    # k <= DENSE_STEP_K scatter-adds into a dense table in-step; dense
    # OUTPUT for larger k accumulates through the (narrow single-u32)
    # sorted sparse path and densifies at the end (count_file routes
    # identically; see count.DENSE_STEP_K)
    step_dense_ks = tuple(k for k in dense_ks if k <= _count.DENSE_STEP_K)
    densify_ks = tuple(k for k in dense_ks if k > _count.DENSE_STEP_K)
    acc_sparse_ks = densify_ks + sparse_ks

    _step = _multi_k_step_fn(
        ks,
        packed,
        canonical,
        normalized,
        phred_offset + (quality_cutoff or 0) if quality_cutoff is not None else None,
    )

    dense_limbs = {
        k: (jnp.zeros(4**k, jnp.uint32), jnp.zeros(4**k, jnp.uint32))
        for k in step_dense_ks
    }
    sparse_accs = {k: _count.SparseSpectrumAccumulator() for k in acc_sparse_ks}
    n_bases = 0

    from ..parallel.checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )

    def _check_ks(ck):
        ck_ks = tuple(int(x) for x in ck["meta"].get("ks", ()))
        if ck_ks != ks:
            raise ValueError(
                f"checkpoint {resume_from!r} is a multi-k run with "
                f"ks={ck_ks}, expected ks={ks}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        ("multik", "sharded_multik"),
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_ks, canonical=canonical, normalized=normalized,
        quality_cutoff=quality_cutoff, phred_offset=phred_offset,
    )
    start_offset = 0
    if ck is not None:
        from ..utils.limbs import int64_array_to_limbs

        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        arrays = ck["arrays"]
        for k in step_dense_ks:
            lo0, hi0 = int64_array_to_limbs(arrays[f"dense_{k}"])
            dense_limbs[k] = (jnp.asarray(lo0), jnp.asarray(hi0))
        for k in acc_sparse_ks:
            if f"keys_{k}" not in arrays and f"dense_{k}" in arrays:
                # snapshot written while k=10..12 rode a dense table:
                # convert back to the sorted sparse form (same fallback as
                # the sharded twin's restore)
                t = np.asarray(arrays[f"dense_{k}"]).astype(np.int64)
                nz = np.flatnonzero(t)
                sparse_accs[k].restore(nz.astype(np.uint64), t[nz])
            else:
                sparse_accs[k].restore(
                    arrays[f"keys_{k}"], arrays[f"counts_{k}"]
                )

    def _save_ckpt(offset):
        from ..parallel.checkpoint import (
            counting_meta,
            save_stream_checkpoint,
        )
        from ..utils.limbs import limbs_to_int64_array as _comb

        arrays = {}
        for k in step_dense_ks:
            arrays[f"dense_{k}"] = np.asarray(_comb(*dense_limbs[k]))
        for k in acc_sparse_ks:
            # finish() flushes (one sort per k) and stays live
            keys, counts = sparse_accs[k].finish()
            arrays[f"keys_{k}"] = keys
            arrays[f"counts_{k}"] = counts
        save_stream_checkpoint(
            checkpoint_path, "multik", 0, offset, n_bases, arrays,
            input_path=str(path),
            meta={
                "ks": np.asarray(ks, np.int32),
                **counting_meta(
                    canonical=canonical, normalized=normalized,
                    quality_cutoff=quality_cutoff, phred_offset=phred_offset,
                ),
            },
        )

    if ckpt_mode:
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
    batches = checkpointed_batches(batches, checkpoint_every, _save_ckpt)
    for batch in batches:
        n_bases += batch.num_bases
        # only ks whose windows fit this batch shape run (static per shape)
        active = tuple(k for k in ks if k <= batch.max_len)
        if not active:
            continue
        quals = None
        if quality_cutoff is not None:
            if batch.quals is None:
                raise ValueError("quality_cutoff needs FASTQ input with qualities")
            quals = jnp.asarray(batch.quals)
        if packed:
            buf, layout = batch.wire_frame(batch.num_reads)
            dense_limbs, sparse_keys = _step(
                dense_limbs, jnp.asarray(buf), quals, active, layout=layout
            )
        else:
            from ..batch import length_wire_dtype

            dense_limbs, sparse_keys = _step(
                dense_limbs,
                jnp.asarray(batch.seqs),
                jnp.asarray(
                    batch.lengths.astype(
                        length_wire_dtype(batch.max_len), copy=False
                    )
                ),
                quals,
                active,
            )
        for k, (hi, lo) in sparse_keys.items():
            sparse_accs[k].add(hi, lo)

    out: Dict[int, object] = {}
    from ..utils.limbs import limbs_to_int64_array as _combine

    for k in step_dense_ks:
        out[k] = _combine(*dense_limbs[k])
    for k in densify_ks:
        keys, counts = sparse_accs[k].finish()
        table = np.zeros(4**k, np.int64)
        table[keys.astype(np.int64)] = counts
        out[k] = table
    for k in sparse_ks:
        keys, counts = sparse_accs[k].finish()
        out[k] = (
            _count.spectrum_arrays_to_dict(keys, counts)
            if sparse_format == "dict"
            else (keys, counts)
        )
    return n_bases, out


def hash_count_file(
    path,
    k: int,
    table_bits: int = 16,
    batch_size: int = 65536,
    max_len: Optional[int] = None,
    normalized: bool = True,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    double_buffer: bool = True,
    packed: bool = True,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
) -> Tuple[int, int, int, np.ndarray]:
    """Stream a FASTX file through the hash-counting pipeline: canonical
    k-mer extraction -> -1-masked hash keys -> scatter-add histogram,
    accumulated on device.

    Returns ``(n_bases, total_windows, forward_windows, table)`` where
    ``table`` is the int64 ``[2^table_bits]`` hash spectrum (collisions
    accumulate; use :func:`count_file` for exact per-k-mer counts).  Bins
    accumulate on device as uint32 limb pairs, exact past 2^31 even for
    skewed hash distributions.

    ``packed=True`` (default) ships batches in the 2-bit packed transport
    format — the framer packs codes host-side under the ``normalized``
    LUT, host->device transfer drops 4x, and the device step skips its
    byte encode.  Results are bit-identical either way.

    The e2e input front (``host_workers=None`` = one framing process per
    spare core for plain files; compressed input streams single-process
    unless an explicit ``host_workers>1``/``spill_dir`` opts into
    decode-to-spill; ``double_buffer`` frames + uploads the next batch
    while the device runs) exists because one framing core cannot feed a
    chip.

    ``checkpoint_every=N`` writes the full state (table limbs, tallies,
    record-aligned byte offset) to ``checkpoint_path`` every N batches;
    ``resume_from=`` restarts from such a file, re-framing ``[offset,
    EOF)`` — the final table is bit-identical to an uninterrupted run
    (integer adds commute).  Both need single-stream framing over an
    uncompressed file.

    ``meter=`` (a :class:`utils.profiling.ThroughputMeter`) records the
    per-stage breakdown the "bases/sec/chip" target demands: ``frame``
    (host framing, charged in the feeder thread), ``h2d`` (device
    placement, blocked-until-ready so the bytes/s is the real transfer
    rate), ``wait`` (consumer time blocked on the feed queue — ~0 means
    the feeder keeps up), ``dispatch`` (async step dispatch) and
    ``drain`` (final device sync + result pull).  Because frame/h2d run
    in the feeder thread, their seconds OVERLAP the consumer stages; the
    meter's ``wall`` stage is the end-to-end truth.
    """
    import time as _time

    import jax

    from .hashcount import check_table_bits

    check_table_bits(table_bits)

    from ..utils.limbs import limbs_to_int

    from ..parallel.checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )

    def _check_table_bits(ck):
        if int(ck["meta"]["table_bits"]) != table_bits:
            raise ValueError("checkpoint table_bits mismatch")

    ckpt_mode, resume_state = prepare_checkpoint_stream(
        "hash", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_table_bits, normalized=normalized,
    )
    start_offset = 0
    resume_bases = 0
    if resume_state is not None:
        start_offset = resume_state["file_offset"]
        resume_bases = resume_state["n_bases"]

    # memoized: a fresh in-driver jit re-traces per call (see _hash_step_fn)
    step = _hash_step_fn(k, table_bits, packed, normalized)

    table_lo = jnp.zeros((1 << table_bits,), jnp.uint32)
    table_hi = jnp.zeros((1 << table_bits,), jnp.uint32)
    tallies = jnp.zeros((4,), jnp.uint32)  # (total_lo, total_hi, fwd_lo, fwd_hi)
    n_bases = resume_bases
    if resume_state is not None:
        from ..utils.limbs import int64_array_to_limbs

        lo0, hi0 = int64_array_to_limbs(resume_state["arrays"]["table"])
        table_lo = jnp.asarray(lo0)
        table_hi = jnp.asarray(hi0)
        total0 = int(resume_state["meta"]["total"])
        fwd0 = int(resume_state["meta"]["fwd"])
        tallies = jnp.asarray(
            np.array(
                [
                    total0 & 0xFFFFFFFF,
                    total0 >> 32,
                    fwd0 & 0xFFFFFFFF,
                    fwd0 >> 32,
                ],
                dtype=np.uint32,
            )
        )
    if ckpt_mode:
        batches = checkpoint_source(
            path, batch_size, max_len, False, packed, normalized,
            start_offset, require_offsets=checkpoint_every is not None,
        )
    else:
        batches, _ = _make_batch_source(
            path, batch_size, max_len, host_workers,
            # the hash pipeline never reads qualities; don't ship them
            # through the worker IPC queue
            with_quals=False, spill_dir=spill_dir,
            packed=packed, normalized=normalized,
        )

    def _transport_nbytes(batch) -> int:
        """Bytes this batch ships host->device (the h2d payload)."""
        if packed:
            return batch.wire_nbytes()
        return batch.seqs.nbytes + batch.lengths.nbytes

    t_wall0 = _time.perf_counter()
    if meter is not None:
        # charged in the feeder thread: wall-clock of each framer next()
        batches = metered_iter(
            meter, "frame", batches,
            nbytes_of=_transport_nbytes, items_of=lambda b: b.num_bases,
        )

    from ..batch import length_wire_dtype

    def _place(batch):
        """(num_bases, payload, aux, file_offset): packed batches coalesce
        into one wire buffer (aux = its static WireLayout); ASCII batches
        ship (seqs, lengths)."""
        if batch.max_len < k:
            return batch.num_bases, None, None, batch.file_offset
        if packed:
            buf, layout = batch.wire_frame(batch_size)
            return batch.num_bases, jnp.asarray(buf), layout, batch.file_offset
        b = (
            batch
            if batch.num_reads == batch_size
            else batch.pad_reads_to(batch_size)
        )
        wire_lengths = jnp.asarray(
            b.lengths.astype(length_wire_dtype(b.max_len), copy=False)
        )
        return batch.num_bases, jnp.asarray(b.seqs), wire_lengths, batch.file_offset

    if meter is not None:
        _place_inner = _place

        def _place(batch):  # noqa: F811 — metered twin
            t0 = _time.perf_counter()
            out = _place_inner(batch)
            if out[1] is not None:
                # block so the recorded bytes/s is the real transfer rate,
                # not the async dispatch cost; still overlaps the consumer
                # because this runs in the feeder thread
                jax.block_until_ready(
                    [a for a in out[1:3] if a is not None and hasattr(a, "dtype")]
                )
            meter.add(
                "h2d",
                _time.perf_counter() - t0,
                nbytes=_transport_nbytes(batch),
                items=out[0],
            )
            return out

    def _save_checkpoint(offset):
        from ..parallel.checkpoint import counting_meta, save_stream_checkpoint
        from ..utils.limbs import limbs_to_int64_array

        t = np.asarray(limbs_to_int64_array(table_lo, table_hi))
        tal = np.asarray(tallies)
        save_stream_checkpoint(
            checkpoint_path,
            "hash",
            k,
            offset,
            n_bases,
            {"table": t},
            input_path=str(path),
            meta={
                "table_bits": np.int32(table_bits),
                "total": np.int64(limbs_to_int(tal[0], tal[1])),
                "fwd": np.int64(limbs_to_int(tal[2], tal[3])),
                **counting_meta(normalized=normalized),
            },
        )

    if double_buffer:
        from ..io.feed import device_feed

        # two pipeline stages in their own threads: framing (the inner
        # feed pulls the batch iterator, so scan+pack runs there) and
        # device placement (the outer feed's _place).  The metered run
        # showed the stages serialize when they share one feeder thread
        # (frame ~0.2s + h2d ~0.6s on the 64M-base bench stream) while
        # the consumer starves; splitting makes the feeder-side cost
        # max(frame, h2d) instead of their sum.
        placed = device_feed(device_feed(batches, lambda b: b), _place)
    else:
        placed = (_place(b) for b in batches)
    # the cadence wraps the PLACED stream (not the raw batches) so the
    # save fires only after the driver folded each N-th batch — device_feed
    # prefetches the inner iterator, which must not trigger early saves
    placed = checkpointed_batches(
        placed, checkpoint_every, _save_checkpoint, offset_of=lambda t: t[3]
    )
    if meter is not None:
        # consumer time blocked on the feed queue: ~0 means the feeder
        # (frame + h2d) keeps ahead of the device loop
        placed = metered_iter(meter, "wait", placed)
    for nb, payload, aux, offset in placed:
        n_bases += nb
        if payload is not None:
            t0 = _time.perf_counter() if meter is not None else 0.0
            if packed:
                table_lo, table_hi, tallies = step(
                    table_lo, table_hi, tallies, payload, layout=aux
                )
            else:
                table_lo, table_hi, tallies = step(
                    table_lo, table_hi, tallies, payload, aux
                )
            if meter is not None:
                meter.add("dispatch", _time.perf_counter() - t0, items=nb)
    t_drain = _time.perf_counter()
    # ONE device->host pull: tallies + hi-occupancy + the lo table plane
    # ride a single concat buffer; the hi plane is pulled only when some
    # bin actually overflowed 32 bits (see _hash_finalize_fn)
    out = np.asarray(_hash_finalize_fn()(table_lo, table_hi, tallies))
    total = limbs_to_int(out[0], out[1])
    fwd = limbs_to_int(out[2], out[3])
    table = out[5:].astype(np.int64)
    if out[4]:
        table += np.asarray(table_hi).astype(np.int64) << 32
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain, nbytes=table.nbytes)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, total, fwd, table


def minimizer_spectrum_file(
    path,
    k: int,
    w: int,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    normalized: bool = True,
    sparse_format: str = "arrays",
    mesh=None,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
) -> Tuple[int, Union[Dict[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """(w, k) minimizer spectrum of a FASTX file: counts of each canonical
    k-mer value that wins at least one w-window (the sketch-level analogue
    of the reference's ``minimizer`` fns, ref sequence.rs:139-152 /
    bitkmer.rs:146-162, lifted to whole-file scale).

    Counts are per *winning window* (a minimizer spanning several windows
    counts once per window), matching the usual (w, k)-sketch density.
    Returns ``(n_bases, (keys_u64, counts))`` (or a dict with
    ``sparse_format="dict"``).

    ``mesh=`` shards the sketch over a data mesh: per-chip minimizer
    extraction + per-chip sorts inside ``shard_map``, host merge — the
    same machinery as ``parallel.sharded_count_file``, bit-identical to
    the single-device run.

    Feature-matrix parity with the counting drivers:

    * ``packed`` (default on off-mesh paths) ships 2-bit code planes and
      unpacks on device (``precoded`` window extraction) — 4x fewer
      host->device bytes, bit-identical sketches.  The mesh path keeps
      ASCII planes (its ``shard_map`` window body is ASCII-shaped).
    * ``checkpoint_every=N`` + ``checkpoint_path`` persist the merged
      sketch + record-aligned offset (kind ``"minimizer"``, ``w`` in the
      meta); ``resume_from=`` continues bit-identically.  Flat and mesh
      checkpoints interchange (both store sorted keys/counts).
    * ``meter=`` attributes frame/h2d/dispatch/drain/wall stages.

    Input front as in ``count_file``: auto-sized framing workers,
    transparent spill decode, and a list of paths accumulates one sketch.
    """
    import time as _time

    import jax

    from . import minimizers as _minimizers
    from ..parallel.checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )
    from ..utils.profiling import metered_iter

    if packed is None:
        packed = mesh is None
    elif packed and mesh is not None:
        raise ValueError(
            "the mesh minimizer path rides ASCII planes (its shard_map "
            "window body is ASCII-shaped); drop packed=True or mesh="
        )

    def _check_w(ck):
        ck_w = int(ck["meta"].get("w", -1))
        if ck_w != w:
            raise ValueError(
                f"checkpoint {resume_from!r} is a (w={ck_w}, k={ck['k']}) "
                f"sketch, expected w={w}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "minimizer", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_check_w, normalized=normalized,
    )

    def _save_fn(acc, n_bases_of):
        def _save_ckpt(offset):
            from ..parallel.checkpoint import (
                counting_meta,
                save_stream_checkpoint,
            )

            keys, counts = acc.finish()  # flush; accumulator stays live
            save_stream_checkpoint(
                checkpoint_path, "minimizer", k, offset, n_bases_of(),
                {"keys": keys, "counts": counts}, input_path=str(path),
                meta={
                    "w": np.int32(w),
                    **counting_meta(normalized=normalized),
                },
            )

        return _save_ckpt

    start_offset = 0 if ck is None else ck["file_offset"]
    n_bases = 0 if ck is None else ck["n_bases"]

    def _batches():
        if ckpt_mode:
            return checkpoint_source(
                path, batch_size, max_len, False, packed, normalized,
                start_offset, require_offsets=checkpoint_every is not None,
            )
        src, _width = _make_batch_source(
            path, batch_size, max_len, host_workers,
            with_quals=False, spill_dir=spill_dir,
            packed=packed, normalized=normalized,
        )
        return src

    def _wire_nbytes(b) -> int:
        if packed:
            return b.wire_nbytes()
        return b.seqs.nbytes + b.lengths.nbytes

    if mesh is not None:
        from ..parallel.exact import (
            ShardedSpectrumAccumulator,
            _require_data_mesh,
            _require_single_process,
        )

        _require_single_process("minimizer_spectrum_file(mesh=...)")
        n_data = _require_data_mesh(mesh)
        batch_size = -(-batch_size // n_data) * n_data
        acc = ShardedSpectrumAccumulator(
            mesh, k, normalized=normalized,
            window_fn=lambda s, l: _minimizers.window_minimizers(
                s, l, k, w, normalized=normalized
            ),
            window_lanes=lambda max_l: max(max_l - k - w + 2, 0),
        )
        if ck is not None:
            acc.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])
        t_wall0 = _time.perf_counter()
        batches = checkpointed_batches(
            _batches(), checkpoint_every, _save_fn(acc, lambda: n_bases)
        )
        if meter is not None:
            batches = metered_iter(
                meter, "frame", batches,
                nbytes_of=_wire_nbytes, items_of=lambda b: b.num_bases,
            )
        for batch in batches:
            n_bases += batch.num_bases
            t0 = _time.perf_counter() if meter is not None else 0.0
            if batch.max_len >= k + w - 1:
                b = (
                    batch
                    if batch.num_reads == batch_size
                    else batch.pad_reads_to(batch_size)
                )
                acc.add(b.seqs, b.lengths)
            if meter is not None:
                meter.add(
                    "dispatch", _time.perf_counter() - t0,
                    items=batch.num_bases,
                )
        t_drain = _time.perf_counter()
        keys, counts = acc.finish()
        if meter is not None:
            now = _time.perf_counter()
            meter.add("drain", now - t_drain)
            meter.add("wall", now - t_wall0, items=n_bases)
        if sparse_format == "dict":
            return n_bases, _count.spectrum_arrays_to_dict(keys, counts)
        return n_bases, (keys, counts)

    # memoized: a fresh in-driver jit re-traces per call (see _minimizer_keys_fn)
    _keys = _minimizer_keys_fn(k, w, packed, normalized)

    from ..batch import length_wire_dtype

    sparse = _count.SparseSpectrumAccumulator()
    if ck is not None:
        sparse.restore(ck["arrays"]["keys"], ck["arrays"]["counts"])
    t_wall0 = _time.perf_counter()
    batches = checkpointed_batches(
        _batches(), checkpoint_every, _save_fn(sparse, lambda: n_bases)
    )
    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches,
            nbytes_of=_wire_nbytes, items_of=lambda b: b.num_bases,
        )
    for batch in batches:
        n_bases += batch.num_bases
        if batch.max_len < k + w - 1:
            continue
        t0 = _time.perf_counter() if meter is not None else 0.0
        if packed:
            # coalesced one-buffer transport (see _hash_step_fn)
            buf, layout = batch.wire_frame(batch.num_reads)
            placed = [jnp.asarray(buf)]
        else:
            placed = [
                jnp.asarray(batch.seqs),
                jnp.asarray(
                    batch.lengths.astype(
                        length_wire_dtype(batch.max_len), copy=False
                    )
                ),
            ]
        if meter is not None:
            jax.block_until_ready(placed)
            meter.add(
                "h2d", _time.perf_counter() - t0, nbytes=_wire_nbytes(batch)
            )
            t0 = _time.perf_counter()
        if packed:
            sparse.add(*_keys(placed[0], layout=layout))
        else:
            sparse.add(*_keys(*placed))
        if meter is not None:
            meter.add(
                "dispatch", _time.perf_counter() - t0, items=batch.num_bases
            )
    t_drain = _time.perf_counter()
    keys, counts = sparse.finish()
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain)
        meter.add("wall", now - t_wall0, items=n_bases)
    if sparse_format == "dict":
        return n_bases, _count.spectrum_arrays_to_dict(keys, counts)
    return n_bases, (keys, counts)


def quality_filter_file(
    in_path,
    out_path,
    min_mean_quality: float,
    phred_offset: int = 33,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
) -> Tuple[int, int]:
    """Filter a FASTQ file by per-read mean Phred score on device.

    Reads stream through the fast framer (with ids), mean qualities
    compute on device (``device.quality.mean_quality``), and surviving
    records write back out with the reference round-trip writer.  Returns
    ``(n_reads_in, n_reads_kept)``.
    """
    _means = _mean_quality_fn(phred_offset)

    n_in = n_kept = 0
    with open(out_path, "wb") as out:
        for batch in read_batches(
            in_path, batch_size=batch_size, max_len=max_len, with_ids=True
        ):
            if batch.quals is None:
                raise ValueError("quality filtering needs FASTQ input")
            n = batch.num_reads
            n_in += n
            means = np.asarray(
                _means(jnp.asarray(batch.quals), jnp.asarray(batch.lengths))
            )[:n]
            # assemble the batch's survivors as one bytes join (same output
            # as write_fastq with Unix endings) instead of per-record
            # writer calls — the join and the final write are C-level
            keep = np.flatnonzero(means >= min_mean_quality)
            lens = batch.lengths
            parts = []
            for i in keep:
                ln = int(lens[i])
                parts.append(
                    b"@%s\n%s\n+\n%s\n"
                    % (
                        bytes(batch.ids[i]),
                        batch.seqs[i, :ln].tobytes(),
                        batch.quals[i, :ln].tobytes(),
                    )
                )
            out.write(b"".join(parts))
            n_kept += len(keep)
    return n_in, n_kept


def readme_pipeline(path, k: int = 4, target: bytes = b"AAAA") -> Tuple[int, int]:
    """The reference README example (ref src/lib.rs:6-40) on device:
    total bases + number of canonical ``target`` k-mers."""
    assert len(target) == k
    hi, lo = pack_target(target)
    n_bases = 0
    n_matches = 0
    for batch in read_batches(path, batch_size=512):
        n_bases += batch.num_bases
        if batch.max_len < k:
            continue
        n_matches += int(
            canonical_match_count(
                jnp.asarray(batch.seqs),
                jnp.asarray(batch.lengths),
                jnp.uint32(hi),
                jnp.uint32(lo),
                k,
            )
        )
    return n_bases, n_matches

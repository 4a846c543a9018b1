"""Checkpoint / resume for streaming count jobs.

The reference has no cross-run checkpointing; within a stream its
``Position{line, byte}`` gives exact resume coordinates (ref utils.rs:53-72,
SURVEY.md §5).  Here a checkpoint is the pair
``(input byte offset per host, count-table shards)``.  Tables are integer and
order-independent, so resuming from a record-aligned byte offset reproduces
the exact final spectrum.

Storage is a plain ``.npz`` (the state is one int32 table + scalars; orbax
would be overkill and keeps this importable without an accelerator runtime).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from .sharded import CountState, HashCountState

__all__ = [
    "save_count_state",
    "load_count_state",
    "CountCheckpoint",
    "save_hash_state",
    "load_hash_state",
    "save_stream_checkpoint",
    "load_stream_checkpoint",
    "load_resume_checkpoint",
    "counting_meta",
    "check_counting_meta",
    "validate_checkpoint_args",
    "checkpoint_source",
    "prepare_checkpoint_stream",
    "checkpointed_batches",
]


def counting_meta(
    canonical: bool = True,
    normalized: bool = True,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
) -> dict:
    """Semantic counting parameters to embed in a stream checkpoint.

    A count table is only meaningful under fixed (canonical, normalized,
    quality) semantics; recording them lets resume refuse a flag mismatch
    instead of silently blending two different counting modes into one
    spectrum."""
    return {
        "canonical": np.int32(bool(canonical)),
        "normalized": np.int32(bool(normalized)),
        "quality_cutoff": np.int32(
            -1 if quality_cutoff is None else int(quality_cutoff)
        ),
        "phred_offset": np.int32(int(phred_offset)),
    }


def check_counting_meta(
    ck: dict,
    resume_from: Union[str, Path],
    canonical: bool = True,
    normalized: bool = True,
    quality_cutoff: Optional[int] = None,
    phred_offset: int = 33,
) -> None:
    """Refuse to resume ``ck`` under different counting semantics.

    Keys absent from the checkpoint (older files) pass unchecked."""
    want = counting_meta(
        canonical=canonical,
        normalized=normalized,
        quality_cutoff=quality_cutoff,
        phred_offset=phred_offset,
    )
    meta = ck.get("meta", {})
    for name, val in want.items():
        if name in meta and int(meta[name]) != int(val):
            raise ValueError(
                f"checkpoint {str(resume_from)!r} was written with "
                f"{name}={int(meta[name])} but this run uses {int(val)}; "
                "resume with the original counting flags"
            )


def load_resume_checkpoint(
    resume_from: Union[str, Path],
    kind: str,
    k: Optional[int] = None,
    validate=None,
    **meta_kwargs,
) -> dict:
    """Load + validate a resume checkpoint for one stream driver.

    The shared front half of every driver's resume path: identity check
    (``kind`` and, when given, ``k``), counting-semantics check
    (:func:`check_counting_meta` with ``meta_kwargs``), then any
    driver-specific ``validate(ck)`` (e.g. the hash table_bits or the
    multi-k ``ks`` tuple).  Returns the loaded dict; callers read
    ``file_offset`` / ``n_bases`` / ``arrays`` and re-seed their state.

    ``kind`` may be a tuple of accepted kinds — drivers whose checkpoint
    formats interchange (flat vs sharded multi-k) accept each other's."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    ck = load_stream_checkpoint(resume_from)
    if ck["kind"] not in kinds or (k is not None and ck["k"] != k):
        raise ValueError(
            f"checkpoint {str(resume_from)!r} is kind={ck['kind']} "
            f"k={ck['k']}, expected kind={'|'.join(kinds)}"
            + ("" if k is None else f" k={k}")
        )
    check_counting_meta(ck, resume_from, **meta_kwargs)
    if validate is not None:
        validate(ck)
    return ck


def validate_checkpoint_args(
    checkpoint_every, checkpoint_path, host_workers
) -> None:
    """Reject checkpoint flag combinations that would silently write
    nothing or interleave offsets (shared by every streaming driver)."""
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 (batches)")
    elif checkpoint_path is not None:
        # a path alone writes nothing — refuse instead of letting the user
        # believe the run was protected
        raise ValueError(
            "checkpoint_path without checkpoint_every writes no "
            "checkpoints; pass checkpoint_every=N (batches)"
        )
    if host_workers is not None and host_workers > 1:
        raise ValueError(
            "checkpoint/resume is single-stream (offsets must be "
            "monotonic); pass host_workers=1"
        )


def checkpoint_source(
    path, batch_size, max_len, with_quals, packed, normalized, start_offset,
    require_offsets: bool = False,
):
    """Single-stream, offset-reporting batch source for checkpoint/resume.

    Resume = re-frame ``[start_offset, EOF)``; offsets come from the
    batchers' record-aligned ``file_offset`` (io.fast_batch).  Two input
    classes support this: UNCOMPRESSED files (offsets are plain byte
    positions; mmap range framing) and BGZF files (offsets are
    decompressed-space positions; the per-block ISIZE index maps them to
    (block, skip) so resume re-decodes from the containing block —
    io.bgzf).  Ordinary gzip/bz2/xz/zstd streams can't seek to a
    decompressed offset and are rejected with a recompress-to-BGZF hint;
    multi-worker framing interleaves batches and is rejected too.  With
    ``require_offsets`` (checkpoint WRITING was requested) a framing path
    that reports no offsets raises on its first batch instead of letting
    the run finish with zero checkpoints written.
    """
    import os as _os

    from ..io.bgzf import is_bgzf
    from ..io.compression import sniff_compression
    from ..io.fast_batch import (
        _effective_packed_max_len,
        fast_read_batches_bgzf,
        fast_read_batches_range,
    )

    if isinstance(path, (list, tuple)):
        raise ValueError(
            "checkpoint/resume is single-file (offsets are per-file); "
            "run one checkpointed stream per input"
        )
    if str(path) == "-":
        raise ValueError("checkpoint/resume needs a seekable file, not stdin")
    with open(path, "rb") as f:
        magic = f.read(2)
    compressed = len(magic) == 2 and sniff_compression(magic)
    bgzf = compressed and is_bgzf(path)
    if compressed and not bgzf:
        raise ValueError(
            "checkpoint/resume needs a seekable input: an UNCOMPRESSED "
            "file or BGZF (blocked gzip, e.g. bgzip output — "
            "io.bgzf.write_bgzf recompresses); plain gzip/bz2/xz/zstd "
            "streams cannot seek to a decompressed offset"
        )
    if require_offsets:
        from ..io import native

        if not native.available():
            # the pure-Python fallback batchers report no record-aligned
            # offsets, so every cadence check would silently skip — refuse
            # up front instead of finishing with zero checkpoints written.
            # (A batch-level check would misfire: the native framers
            # legitimately emit their final EOF-tail batch with
            # file_offset=None.)
            raise ValueError(
                "checkpoint_every needs the native framer's record-aligned "
                "byte offsets; rebuild the C extension (and unset "
                "NEEDLETAIL_TPU_NO_NATIVE) or drop checkpoint_every"
            )
    if bgzf:
        return fast_read_batches_bgzf(
            path, start_offset, batch_size=batch_size,
            max_len=_effective_packed_max_len(True, max_len),
            with_quals=with_quals, packed=packed, normalized=normalized,
        )
    size = _os.path.getsize(path)
    return fast_read_batches_range(
        path, start_offset, size, batch_size=batch_size,
        # the same round-up-to-8 max_len quantum every transport applies
        max_len=_effective_packed_max_len(True, max_len),
        with_quals=with_quals, packed=packed, normalized=normalized,
    )


def prepare_checkpoint_stream(
    kind: str,
    k: Optional[int] = None,
    *,
    checkpoint_every=None,
    checkpoint_path=None,
    resume_from=None,
    host_workers=None,
    bucketed: bool = False,
    validate=None,
    **meta_kwargs,
) -> "tuple[bool, Optional[dict]]":
    """Shared front half of every streaming driver's checkpoint path.

    Validates the flag combination (including the bucketed exclusion) and
    loads + validates any resume checkpoint.  Returns ``(active, ck)``:
    ``active`` is whether checkpoint mode is on (the driver should use
    :func:`checkpoint_source` as its batch source), ``ck`` the loaded
    resume dict or ``None`` (drivers read ``file_offset`` / ``n_bases`` /
    ``arrays`` and re-seed their state).
    """
    active = (
        checkpoint_every is not None
        or resume_from is not None
        or checkpoint_path is not None
    )
    if not active:
        return False, None
    if bucketed:
        raise ValueError(
            "checkpoint/resume needs the single-shape stream, not "
            "bucketed batching"
        )
    validate_checkpoint_args(checkpoint_every, checkpoint_path, host_workers)
    ck = None
    if resume_from is not None:
        ck = load_resume_checkpoint(
            resume_from, kind, k, validate=validate, **meta_kwargs
        )
    return True, ck


def checkpointed_batches(
    source, checkpoint_every, save_fn, offset_of=None
):
    """Yield from ``source``, invoking ``save_fn(file_offset)`` after every
    ``checkpoint_every``-th item has been CONSUMED by the driver.

    The save fires when the driver pulls the next item (generator resume),
    i.e. strictly after the driver folded the previous batch into its
    state — so the saved state always includes every batch at or before
    the saved offset.  Items whose offset is ``None`` (EOF tails, sources
    without offsets) skip their save slot.  With ``checkpoint_every=None``
    this is a transparent pass-through.
    """
    if checkpoint_every is None:
        yield from source
        return
    if offset_of is None:
        offset_of = lambda b: b.file_offset  # noqa: E731
    done = 0
    for item in source:
        yield item
        done += 1
        offset = offset_of(item)
        if done % checkpoint_every == 0 and offset is not None:
            save_fn(offset)


def save_stream_checkpoint(
    path: Union[str, Path],
    kind: str,
    k: int,
    file_offset: int,
    n_bases: int,
    arrays: dict,
    input_path: Optional[str] = None,
    meta: Optional[dict] = None,
) -> None:
    """Atomically persist a mid-stream counting checkpoint.

    ``kind`` names the driver ("hash" / "count_dense" / "count_sparse" /
    "sharded_exact"); ``file_offset`` is the record-aligned byte offset the
    batcher reported for the last folded batch (resume = re-frame
    ``[file_offset, EOF)``; integer adds commute, so the final table is
    bit-identical to an uninterrupted run — ref utils.rs:53-72 position
    semantics, SURVEY §5).  Written to a temp file + ``os.replace`` so a
    kill mid-save never corrupts the previous checkpoint.
    """
    import os
    import tempfile

    path = str(path)
    payload = {
        "kind": np.bytes_(kind.encode()),
        "k": np.int32(k),
        "file_offset": np.int64(file_offset),
        "n_bases": np.int64(n_bases),
        "input_path": np.bytes_(str(input_path or "").encode()),
    }
    for name, arr in arrays.items():
        payload["arr_" + name] = np.asarray(arr)
    for name, val in (meta or {}).items():
        payload["meta_" + name] = np.asarray(val)
    fd, tmp = tempfile.mkstemp(
        suffix=".npz.tmp", dir=os.path.dirname(path) or "."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_stream_checkpoint(path: Union[str, Path]) -> dict:
    """Load a :func:`save_stream_checkpoint` file.

    Returns ``{kind, k, file_offset, n_bases, input_path, arrays: {...},
    meta: {...}}``.
    """
    out = {"arrays": {}, "meta": {}}
    with np.load(path, allow_pickle=False) as z:
        for name in z.files:
            if name.startswith("arr_"):
                out["arrays"][name[4:]] = z[name]
            elif name.startswith("meta_"):
                out["meta"][name[5:]] = z[name]
        out["kind"] = bytes(z["kind"]).decode()
        out["k"] = int(z["k"])
        out["file_offset"] = int(z["file_offset"])
        out["n_bases"] = int(z["n_bases"])
        out["input_path"] = bytes(z["input_path"]).decode() or None
    return out


class CountCheckpoint:
    """In-memory view of a saved counting job."""

    def __init__(
        self,
        table: np.ndarray,
        n_bases: int,
        n_reads: int,
        byte_offset: int,
        k: int,
        path: Optional[str] = None,
    ) -> None:
        self.table = table
        self.n_bases = n_bases
        self.n_reads = n_reads
        self.byte_offset = byte_offset
        self.k = k
        self.path = path

    def to_state(self, mesh=None) -> CountState:
        """Re-materialize a device CountState (sharded over ``mesh`` when
        given)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from ..utils.limbs import int64_array_to_limbs

        lo0, hi0 = int64_array_to_limbs(self.table)
        lo, hi = jnp.asarray(lo0), jnp.asarray(hi0)
        if mesh is not None:
            sharding = NamedSharding(mesh, P("table"))
            lo = jax.device_put(lo, sharding)
            hi = jax.device_put(hi, sharding)
        return CountState(
            table_lo=lo,
            table_hi=hi,
            n_bases_lo=jnp.asarray(self.n_bases & 0xFFFFFFFF, jnp.uint32),
            n_bases_hi=jnp.asarray(self.n_bases >> 32, jnp.uint32),
            n_reads_lo=jnp.asarray(self.n_reads & 0xFFFFFFFF, jnp.uint32),
            n_reads_hi=jnp.asarray(self.n_reads >> 32, jnp.uint32),
        )


def save_count_state(
    path: Union[str, Path],
    state: CountState,
    byte_offset: int,
    k: int,
    input_path: Optional[str] = None,
) -> None:
    """Persist (table shards gathered to host, tallies, input byte offset)."""
    np.savez_compressed(
        path,
        table=np.asarray(state.table),
        n_bases=np.int64(state.n_bases),
        n_reads=np.int64(state.n_reads),
        byte_offset=np.int64(byte_offset),
        k=np.int32(k),
        input_path=np.bytes_(str(input_path or "")),
    )


def load_count_state(path: Union[str, Path]) -> CountCheckpoint:
    with np.load(path, allow_pickle=False) as z:
        return CountCheckpoint(
            table=z["table"],
            n_bases=int(z["n_bases"]),
            n_reads=int(z["n_reads"]),
            byte_offset=int(z["byte_offset"]),
            k=int(z["k"]),
            path=bytes(z["input_path"]).decode() or None,
        )


def save_hash_state(
    path: Union[str, Path],
    state: HashCountState,
    byte_offset: int,
    k: int,
    input_path: Optional[str] = None,
) -> None:
    """Persist the hash-pipeline state (global table gathered to host,
    tallies, input byte offset).  Resume semantics match
    ``save_count_state``: integer adds commute, so resuming from a
    record-aligned offset reproduces the exact final table."""
    np.savez_compressed(
        path,
        table=np.asarray(state.table),
        total=np.int64(state.total),
        fwd=np.int64(state.fwd),
        byte_offset=np.int64(byte_offset),
        k=np.int32(k),
        input_path=np.bytes_(str(input_path or "")),
    )


def load_hash_state(
    path: Union[str, Path], mesh=None
) -> "tuple[HashCountState, int, int, Optional[str]]":
    """Returns ``(state, byte_offset, k, input_path)``; the table is placed
    sharded over ``mesh``'s data axis when a mesh is given."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ..utils.limbs import int64_array_to_limbs

    with np.load(path, allow_pickle=False) as z:
        lo0, hi0 = int64_array_to_limbs(z["table"])
        lo, hi = jnp.asarray(lo0), jnp.asarray(hi0)
        if mesh is not None:
            sharding = NamedSharding(mesh, P("data"))
            lo = jax.device_put(lo, sharding)
            hi = jax.device_put(hi, sharding)
        total = int(z["total"])
        fwd = int(z["fwd"])
        state = HashCountState(
            table_lo=lo,
            table_hi=hi,
            total_lo=jnp.asarray(total & 0xFFFFFFFF, jnp.uint32),
            total_hi=jnp.asarray(total >> 32, jnp.uint32),
            fwd_lo=jnp.asarray(fwd & 0xFFFFFFFF, jnp.uint32),
            fwd_hi=jnp.asarray(fwd >> 32, jnp.uint32),
        )
        return (
            state,
            int(z["byte_offset"]),
            int(z["k"]),
            bytes(z["input_path"]).decode() or None,
        )

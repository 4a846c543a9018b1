"""K-mer counting on device: dense spectra, targeted counts, sorted spectra.

The count table is the device analogue of a host hash map:

  * ``dense_spectrum`` — a ``4^k`` int32 table filled by scatter-add; exact
    and collective-friendly (tables merge with ``psum``).  Practical for
    k <= 12 (4^12 = 16.7M entries, 64 MiB HBM).
  * ``match_count`` — count occurrences of specific k-mers (the README
    ``AAAA`` tally, ref src/lib.rs:31-38) without materializing a table.
  * ``sorted_spectrum`` — exact counts for any k <= 31 via sort + segment
    boundaries on (hi, lo) pairs; returns fixed-shape arrays the host
    compacts into a dict.

All routines take ``KmerWindows`` so they compose with ``pack_kmers`` /
``canonical_kmers`` under one jit.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import KmerWindows

__all__ = [
    "dense_spectrum",
    "match_count",
    "valid_count",
    "forward_count",
    "sorted_spectrum",
    "unique_counts",
    "mask_keys",
    "compact_spectrum",
    "compact_runs_device",
    "finalize_sparse",
    "finalize_sparse_device",
    "merge_sorted_spectra",
    "SparseSpectrumAccumulator",
    "SPARSE_FLUSH_LANES",
    "spectrum_arrays_to_dict",
    "spectrum_to_dict",
    "merge_spectra",
    "MAX_DENSE_K",
    "DENSE_STEP_K",
]

MAX_DENSE_K = 12

# largest k whose [4^k] table accumulates per batch by scatter-add; for
# k = 10..MAX_DENSE_K the dense OUTPUT accumulates through the sorted
# sparse path and densifies at the end.  The threshold was chosen on
# another accelerator and has not been measured on a GPU.
DENSE_STEP_K = 9


@partial(jax.jit, static_argnames=("k",))
def dense_spectrum(windows: KmerWindows, k: int) -> jax.Array:
    """Exact counts for all 4^k k-mers (int32 [4^k]) by scatter-add; the
    packed k-mer value IS the bin.  Invalid windows scatter weight 0 to
    index 0, so padding is inert.
    """
    if k > MAX_DENSE_K:
        raise ValueError(f"dense spectrum needs k <= {MAX_DENSE_K}, got {k}")
    keys = jnp.where(windows.valid, windows.lo, 0).reshape(-1)
    weights = windows.valid.astype(jnp.int32).reshape(-1)
    table = jnp.zeros(4**k, dtype=jnp.int32)
    return table.at[keys].add(weights)


@jax.jit
def match_count(windows: KmerWindows, target_hi: jax.Array, target_lo: jax.Array) -> jax.Array:
    """Number of valid windows equal to the target packed k-mer."""
    hit = (windows.hi == target_hi) & (windows.lo == target_lo) & windows.valid
    return jnp.sum(hit.astype(jnp.int32))


@jax.jit
def valid_count(windows: KmerWindows) -> jax.Array:
    """Total number of valid windows (k-mers emitted)."""
    return jnp.sum(windows.valid.astype(jnp.int32))


@jax.jit
def forward_count(windows: KmerWindows) -> jax.Array:
    """Number of valid windows kept in forward orientation (not rc)."""
    fwd = windows.valid & ~windows.was_rc
    return jnp.sum(fwd.astype(jnp.int32))


_SENTINEL = 0xFFFFFFFF


@jax.jit
def unique_counts(
    hi: Optional[jax.Array], lo: jax.Array
) -> Tuple[Optional[jax.Array], jax.Array, jax.Array]:
    """Exact run counts of flat (hi, lo) key streams (any shape, flattened).

    Invalid keys must already carry the sentinel (0xFFFFFFFF, 0xFFFFFFFF);
    they sort last and count 0.  Returns ``(hi_sorted, lo_sorted, counts)``
    where ``counts[i]`` is the run length at the first element of each
    distinct key's run and 0 elsewhere.

    ``hi=None`` selects the NARROW path for keys that fit one uint32
    (k <= 15: 2k <= 30 bits, so no valid key collides with the 0xFFFFFFFF
    sentinel): a single-key sort instead of the two-key one — the returned
    hi slot is ``None``.

    Scatter/gather-free: one lexicographic ``lax.sort``, then run lengths
    come from the distance to the next run boundary via a suffix cummin.
    """
    lo = lo.reshape(-1)
    if hi is None:
        lo_s = jax.lax.sort(lo)
        hi_s = None
        boundary = lo_s[1:] != lo_s[:-1]
    else:
        hi = hi.reshape(-1)
        hi_s, lo_s = jax.lax.sort((hi, lo), num_keys=2)
        boundary = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    n = lo_s.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), dtype=bool), boundary])
    boundary_pos = jnp.where(first, pos, n)
    suf_min = jnp.flip(jax.lax.cummin(jnp.flip(boundary_pos)))  # inclusive
    next_boundary = jnp.concatenate(
        [suf_min[1:], jnp.full((1,), n, dtype=jnp.int32)]
    )
    counts = jnp.where(first, next_boundary - pos, 0)
    sentinel = jnp.uint32(_SENTINEL)
    is_sent = (
        lo_s == sentinel if hi_s is None else (hi_s == sentinel) & (lo_s == sentinel)
    )
    counts = jnp.where(is_sent, 0, counts)
    return hi_s, lo_s, counts


@jax.jit
def mask_keys(windows: KmerWindows) -> Tuple[jax.Array, jax.Array]:
    """Flat (hi, lo) keys with invalid windows replaced by the sentinel."""
    sentinel = jnp.uint32(_SENTINEL)
    hi = jnp.where(windows.valid, windows.hi, sentinel).reshape(-1)
    lo = jnp.where(windows.valid, windows.lo, sentinel).reshape(-1)
    return hi, lo


@jax.jit
def sorted_spectrum(windows: KmerWindows) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact spectrum for any k: sort (hi, lo) keys, segment-count runs.

    Returns ``(hi_sorted, lo_sorted, counts)`` of length B*W where
    ``counts[i]`` is the run length at the first element of each distinct
    key's run and 0 elsewhere; invalid windows sort last under the sentinel
    key (0xFFFFFFFF, 0xFFFFFFFF) with count 0.  ``spectrum_to_dict``
    compacts this on host.
    """
    hi, lo = mask_keys(windows)
    return unique_counts(hi, lo)


@jax.jit
def compact_runs_device(
    hi_s: Optional[jax.Array], lo_s: jax.Array, counts: jax.Array
) -> Tuple[Optional[jax.Array], jax.Array, jax.Array, jax.Array]:
    """Move the distinct run entries of ``unique_counts`` output to the
    FRONT on device (stable 1-key sort on the zero-count flag, so key
    order is preserved), returning ``(hi_c, lo_c, counts_c, n_distinct)``.
    ``hi_s=None`` (the narrow k <= 15 path) drops one payload array from
    the sort and returns ``None`` for ``hi_c``.

    This bounds the device->host pull of a sparse flush to the actual
    distinct entries (``[:n_distinct]``) instead of every window lane —
    the lanes:distinct ratio is routinely 50-1000x.
    """
    flag = (counts <= 0).astype(jnp.uint32)
    if hi_s is None:
        _, lo_c, c_c = jax.lax.sort(
            (flag, lo_s, counts), num_keys=1, is_stable=True
        )
        hi_c = None
    else:
        _, hi_c, lo_c, c_c = jax.lax.sort(
            (flag, hi_s, lo_s, counts), num_keys=1, is_stable=True
        )
    n = jnp.sum((counts > 0).astype(jnp.int32))
    return hi_c, lo_c, c_c, n


def compact_spectrum(
    hi: Optional[np.ndarray], lo: np.ndarray, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Host compaction of ``unique_counts`` output: (keys_u64, counts)
    numpy arrays for distinct valid k-mers (vectorized boolean indexing —
    no per-key Python objects, unlike ``spectrum_to_dict``).  ``hi=None``
    = the narrow path (keys are the lo plane alone)."""
    lo = np.asarray(lo)
    counts = np.asarray(counts)
    keep = counts > 0
    keys = lo[keep].astype(np.uint64)
    if hi is not None:
        keys |= np.asarray(hi)[keep].astype(np.uint64) << np.uint64(32)
    return keys, counts[keep].astype(np.int64)


def _concat_pad_parts(key_parts, pad_multiple: int):
    """Concatenate per-batch masked (hi, lo) key planes and sentinel-pad to
    a shape bucket (bounds recompiles across file sizes).  Narrow parts
    (hi None, k <= 15) stay narrow; mixing narrow and wide raises."""
    import jax.numpy as jnp

    narrow = key_parts[0][0] is None
    if any((h is None) != narrow for h, _ in key_parts):
        raise ValueError("cannot mix narrow and wide key parts in one flush")
    lo = jnp.concatenate([l.reshape(-1) for _, l in key_parts])
    hi = (
        None
        if narrow
        else jnp.concatenate([h.reshape(-1) for h, _ in key_parts])
    )
    pad = (-lo.shape[0]) % pad_multiple
    if pad:
        fill = jnp.full((pad,), _SENTINEL, dtype=jnp.uint32)
        lo = jnp.concatenate([lo, fill])
        if hi is not None:
            hi = jnp.concatenate([hi, fill])
    return hi, lo


def finalize_sparse_device(
    key_parts, pad_multiple: int = 1 << 20
) -> Tuple[Optional[jax.Array], jax.Array, jax.Array]:
    """One-flush device resolution with NO host pull: concatenate + pad the
    key planes, one lexicographic sort + run-length count.  Returns device
    arrays ``(hi_s | None, lo_s, counts)`` — sorted runs with ``counts``
    holding each distinct key's multiplicity at its run head and 0
    elsewhere (and at sentinels).  The device-resident twin of
    :func:`finalize_sparse` for callers that keep computing on device
    (checksums, spectrum set-ops, downstream kernels); distinct count is
    ``(counts > 0).sum()``."""
    import jax.numpy as jnp

    if not key_parts:
        z = jnp.zeros(0, jnp.uint32)
        return None, z, jnp.zeros(0, jnp.int32)
    hi, lo = _concat_pad_parts(key_parts, pad_multiple)
    return unique_counts(hi, lo)


def finalize_sparse(
    key_parts,
    pad_multiple: int = 1 << 20,
    device_compact: Optional[bool] = None,
):
    """Concatenate per-batch masked (hi, lo) key planes, pad with the
    sentinel to a shape bucket (bounds recompiles across file sizes), and
    resolve with one device sort: returns ``(keys_u64, counts)`` numpy.

    ``device_compact`` runs :func:`compact_runs_device` so only the
    distinct entries cross the device->host link (default: on for real
    accelerators, where the host link binds; off for the CPU backend,
    where the "pull" is a local copy and the extra stable sort is pure
    overhead).

    Parts whose hi plane is ``None`` (narrow k <= 15 keys) resolve with
    the single-key sort; mixing narrow and wide parts in one call is a
    caller bug and raises.
    """
    if device_compact is None:
        device_compact = jax.default_backend() != "cpu"
    if not key_parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    hi, lo = _concat_pad_parts(key_parts, pad_multiple)
    hi_s, lo_s, counts = unique_counts(hi, lo)
    if device_compact:
        hi_c, lo_c, c_c, n = compact_runs_device(hi_s, lo_s, counts)
        n = int(n)
        keys = np.asarray(lo_c[:n]).astype(np.uint64)
        if hi_c is not None:
            keys |= np.asarray(hi_c[:n]).astype(np.uint64) << np.uint64(32)
        return keys, np.asarray(c_c[:n]).astype(np.int64)
    return compact_spectrum(hi_s, lo_s, counts)


def merge_sorted_spectra(
    ak: np.ndarray, ac: np.ndarray, bk: np.ndarray, bc: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two key-sorted (keys_u64, counts) spectra, summing duplicates.

    Host-side and vectorized; used to bound device memory when streaming
    sparse spectra (flush every ``SPARSE_FLUSH_LANES`` window lanes instead
    of holding every batch's key planes until EOF)."""
    if not len(ak):
        return bk, bc
    if not len(bk):
        return ak, ac
    keys = np.concatenate([ak, bk])
    cnts = np.concatenate([ac, bc])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    cnts = cnts[order]
    new = np.empty(len(keys), bool)
    new[0] = True
    np.not_equal(keys[1:], keys[:-1], out=new[1:])
    # runs are contiguous after the sort: reduceat sums each run in one
    # vectorized pass (~10x np.add.at, which is unbuffered per-element)
    starts = np.flatnonzero(new)
    out = np.add.reduceat(cnts, starts)
    return keys[new], out.astype(np.int64, copy=False)


# flush threshold for streaming sparse counting: key planes held on device
# between flushes are 8 bytes/lane, so 2^26 lanes ~= 0.5 GiB
SPARSE_FLUSH_LANES = 1 << 26


class SparseSpectrumAccumulator:
    """Streaming exact-spectrum accumulation with bounded device memory:
    buffer masked (hi, lo) key planes on device, resolve each ~0.5 GiB
    flush with one device sort, merge flushes on host."""

    def __init__(self, flush_lanes: int = SPARSE_FLUSH_LANES) -> None:
        self._parts = []
        self._lanes = 0
        self._flush_lanes = flush_lanes
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.int64)

    def add(self, hi: Optional[jax.Array], lo: jax.Array) -> None:
        """Buffer one batch's masked key planes.  ``hi=None`` = narrow
        (k <= 15) keys; resolve then runs the single-key sort."""
        self._parts.append((hi, lo))
        self._lanes += lo.size
        if self._lanes >= self._flush_lanes:
            self._flush()

    def _flush(self) -> None:
        if not self._parts:
            return
        keys, counts = finalize_sparse(self._parts)
        self._parts = []
        self._lanes = 0
        self._keys, self._counts = merge_sorted_spectra(
            self._keys, self._counts, keys, counts
        )

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Merged ``(keys, counts)``; the accumulator stays usable (used
        both at EOF and to snapshot state for checkpoints)."""
        self._flush()
        return self._keys, self._counts

    def restore(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Re-seed the merged spectrum (checkpoint resume)."""
        if self._parts or self._keys.size:
            raise ValueError("restore() only applies to a fresh accumulator")
        self._keys = np.asarray(keys, dtype=np.uint64)
        self._counts = np.asarray(counts, dtype=np.int64)


def spectrum_arrays_to_dict(keys: np.ndarray, counts: np.ndarray) -> Dict[int, int]:
    """Python-dict view of a (keys, counts) spectrum (slow for large k)."""
    return {int(key): int(c) for key, c in zip(keys, counts)}


def spectrum_to_dict(
    hi: np.ndarray, lo: np.ndarray, counts: np.ndarray, k: int
) -> Dict[int, int]:
    """Host-side compaction of ``sorted_spectrum`` output to {kmer_value: count}."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    counts = np.asarray(counts)
    mask = counts > 0
    values = (hi[mask].astype(np.uint64) << np.uint64(32)) | lo[mask].astype(np.uint64)
    return {int(v): int(c) for v, c in zip(values, counts[mask])}


def merge_spectra(dicts) -> Dict[int, int]:
    """Merge per-batch spectrum dicts (host-side reduction)."""
    out: Dict[int, int] = {}
    for d in dicts:
        for kmer, c in d.items():
            out[kmer] = out.get(kmer, 0) + c
    return out

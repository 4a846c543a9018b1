"""Long-sequence tiling with (k-1)-base halos.

Whole-genome FASTA records (multi-Mbp) don't fit the short-read batch model,
and a single [1, N] row wastes the batch dimension.  The device answer
(SURVEY.md §5 "long-context"): chunk the sequence into fixed-shape tiles of
``tile_len`` bases plus a ``k-1``-base halo so every k-mer window is complete
within exactly one tile — the moral analogue of context parallelism with halo
exchange.  No window is dropped or duplicated at seams:

  * tile i covers bytes [i*tile_len, i*tile_len + tile_len + k - 1)
  * its valid windows are local positions [0, tile_len) — precisely the
    global windows starting in [i*tile_len, (i+1)*tile_len)

The reference handles long sequences by unbounded host-buffer growth and an
O(1) iterator (ref utils.rs:24-30); counts over tiles equal its stream.

The input front is the native batched framer (mmap + C scanner) and tiles
are cut with STRIDED numpy copies — no per-tile Python loop.  ``packed``
tiling strides the 2-bit code planes directly (the tile quantum and the
rounded tile width are multiples of 8 bases, so byte strides land exactly),
which cuts the host->device bytes 4x for whole-genome streams just like the
short-read packed transport.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
from numpy.lib.stride_tricks import as_strided

from ..io.fast_batch import fast_read_batches

__all__ = [
    "tile_sequence",
    "tiled_batches",
    "genome_spectrum",
    "make_tile_key_fn",
]


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _tile_plane(
    row: np.ndarray, used: int, t: int, stride: int, width: int
) -> np.ndarray:
    """Cut one record plane into ``t`` overlapping tiles with a single
    strided copy.  ``used`` = valid leading bytes of ``row``; the scratch
    is zero-padded so the final tile's tail is inert."""
    need = (t - 1) * stride + width
    buf = np.zeros(need, dtype=np.uint8)
    buf[:used] = row[:used]
    return as_strided(buf, (t, width), (stride, 1))


def tile_sequence(
    seq: bytes, k: int, tile_len: int = 8192
) -> Tuple[np.ndarray, np.ndarray]:
    """Split one sequence into halo-overlapped tiles.

    Returns ``(tiles [T, tile_len + k - 1] uint8 zero-padded, lengths [T])``.
    Feeding these to ``canonical_kmers``/``pack_kmers`` yields exactly the
    windows of the original sequence, each once.
    """
    n = len(seq)
    width = tile_len + k - 1
    if n < k:
        return np.zeros((0, width), dtype=np.uint8), np.zeros(0, dtype=np.int32)
    t = (n - k + 1 + tile_len - 1) // tile_len
    arr = np.frombuffer(seq, dtype=np.uint8)
    tiles = np.ascontiguousarray(_tile_plane(arr, n, t, tile_len, width))
    lengths = np.minimum(
        width, n - np.arange(t, dtype=np.int64) * tile_len
    ).astype(np.int32)
    return tiles, lengths


class _TileStream:
    """Framer-backed halo tiler: records stream through the native batched
    framer, each record's plane(s) are tiled with strided copies, and
    tiles regroup into fixed ``[batch_tiles, ...]`` blocks (the final
    block zero-padded with empty tiles).

    ASCII mode yields ``(tiles [BT, tile_len+k-1], lengths)``.
    Packed mode yields ``(codes [BT, W/4], vbits [BT, W/8] | None,
    lengths)`` with ``W = round8(tile_len+k-1)``; lengths still cap at the
    TRUE halo width so the byte-quantized extra lanes never create
    windows.  ``n_bases`` accumulates record bases (halo bytes are not
    double-counted) as iteration proceeds.
    """

    def __init__(
        self,
        path,
        k: int,
        tile_len: int = 8192,
        batch_tiles: int = 128,
        packed: bool = False,
        normalized: bool = True,
        frame_batch: int = 8,
    ) -> None:
        if packed and tile_len % 8:
            raise ValueError("packed tiling needs tile_len % 8 == 0")
        self._path = path
        self._k = k
        self._tile_len = tile_len
        self._bt = batch_tiles
        self._packed = packed
        self._normalized = normalized
        self._fb = frame_batch
        self.n_bases = 0

    def __iter__(self):
        k, tile_len, bt = self._k, self._tile_len, self._bt
        true_width = tile_len + k - 1
        width = _round8(true_width) if self._packed else true_width
        if self._packed:
            out_c = np.zeros((bt, width // 4), dtype=np.uint8)
            out_v = None  # allocated lazily on the first dirty record
        else:
            out_c = np.zeros((bt, width), dtype=np.uint8)
            out_v = None
        out_l = np.zeros(bt, dtype=np.int32)
        fill = 0

        def _seal():
            nonlocal out_c, out_v, out_l, fill
            block = (
                (out_c, out_v, out_l) if self._packed else (out_c, out_l)
            )
            out_c = np.zeros_like(out_c)
            out_v = None
            out_l = np.zeros(bt, dtype=np.int32)
            fill = 0
            return block

        for batch in fast_read_batches(
            self._path,
            batch_size=self._fb,
            with_quals=False,
            packed=self._packed,
            normalized=self._normalized,
        ):
            self.n_bases += batch.num_bases
            dense_v = batch.dense_vbits() if self._packed else None
            for r in range(batch.num_reads):
                n = int(batch.lengths[r])
                if n < k:
                    continue
                t = (n - k + 1 + tile_len - 1) // tile_len
                if self._packed:
                    tc = _tile_plane(
                        batch.codes[r], (n + 3) // 4, t, tile_len // 4,
                        width // 4,
                    )
                    tv = (
                        None
                        if dense_v is None
                        else _tile_plane(
                            dense_v[r], (n + 7) // 8, t, tile_len // 8,
                            width // 8,
                        )
                    )
                else:
                    tc = _tile_plane(batch.seqs[r], n, t, tile_len, width)
                    tv = None
                tl = np.minimum(
                    true_width, n - np.arange(t, dtype=np.int64) * tile_len
                ).astype(np.int32)
                i = 0
                while i < t:
                    take = min(t - i, bt - fill)
                    out_c[fill : fill + take] = tc[i : i + take]
                    if tv is not None:
                        if out_v is None:
                            # rows already sealed in this block were clean:
                            # all-ones validity (length masks the tail)
                            out_v = np.full(
                                (bt, width // 8), 0xFF, dtype=np.uint8
                            )
                        out_v[fill : fill + take] = tv[i : i + take]
                    out_l[fill : fill + take] = tl[i : i + take]
                    fill += take
                    i += take
                    if fill == bt:
                        yield _seal()
        if fill:
            yield _seal()


def tiled_batches(
    path,
    k: int,
    tile_len: int = 8192,
    batch_tiles: int = 128,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream a FASTX file as fixed-shape halo-tiled batches.

    Yields ``(tiles [batch_tiles, tile_len+k-1], lengths)`` blocks; the final
    block of each file is zero-padded with empty tiles (length 0 -> every
    window invalid).  Sequences are the newline-stripped ``seq()`` bytes, so
    wrapped FASTA records tile correctly.  Framing + tiling run at native
    speed (mmap framer + strided copies, no per-tile Python).
    """
    yield from _TileStream(path, k, tile_len, batch_tiles)


def make_tile_key_fn(
    k: int,
    tile_len: int,
    packed: bool = True,
    canonical: bool = True,
    normalized: bool = True,
):
    """The jitted per-block device step of :func:`genome_spectrum`:
    ``(tiles, lengths, vbits) -> (hi | None, lo)`` flat sentinel-masked key
    planes over the tile-owned window positions ``[0, tile_len)``.

    Public so benchmarks measure the exact shipped code path; ``hi`` is
    ``None`` for narrow (k <= 15) keys.  Feed the outputs to
    ``count.SparseSpectrumAccumulator`` / ``count.finalize_sparse_device``
    exactly as ``genome_spectrum`` does.

    Memoized on the full static config: returning a fresh jitted closure
    per call would re-trace the extraction on every ``genome_spectrum``
    invocation.
    """
    return _tile_key_fn_cached(k, tile_len, packed, canonical, normalized)


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _tile_key_fn_cached(
    k: int,
    tile_len: int,
    packed: bool,
    canonical: bool,
    normalized: bool,
):
    import jax
    import jax.numpy as jnp

    from . import kmers as _kmers

    narrow_keys = k <= 15
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers

    @jax.jit
    def _keys(tiles, lengths, vbits):
        seqs = tiles
        if packed:
            from .ops import unpack_codes

            seqs = unpack_codes(tiles, vbits)
        win = fn(seqs, lengths, k, normalized=normalized, precoded=packed)
        # win planes are already window-shaped ([B, L-k+1]); keep only the
        # tile-owned positions [0, tile_len)
        w = min(tile_len, win.lo.shape[1])
        sl = lambda p: p[:, :w]
        hi = jnp.where(sl(win.valid), sl(win.hi), jnp.uint32(0xFFFFFFFF))
        lo = jnp.where(sl(win.valid), sl(win.lo), jnp.uint32(0xFFFFFFFF))
        return (None if narrow_keys else hi.reshape(-1)), lo.reshape(-1)

    return _keys


@_lru_cache(maxsize=None)
def _dense_tile_spec_fn(k: int, packed: bool, canonical: bool, normalized: bool):
    """Memoized dense per-tile spectrum step of :func:`genome_spectrum`."""
    import jax
    import jax.numpy as jnp  # noqa: F401 — traced body below

    from . import count as _count
    from . import kmers as _kmers

    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers

    @jax.jit
    def _dense_spec(tiles, lengths, vbits):
        seqs = tiles
        if packed:
            from .ops import unpack_codes

            seqs = unpack_codes(tiles, vbits)
        win = fn(seqs, lengths, k, normalized=normalized, precoded=packed)
        return _count.dense_spectrum(win, k)

    return _dense_spec


def genome_spectrum(
    path,
    k: int,
    tile_len: int = 8192,
    batch_tiles: int = 64,
    canonical: bool = True,
    normalized: bool = True,
    dense: Optional[bool] = None,
    sparse_format: str = "dict",
    mesh=None,
    packed: Optional[bool] = None,
) -> Tuple[int, Union[np.ndarray, Dict[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """Exact k-mer spectrum of a (possibly multi-Mbp) FASTX file via halo
    tiling (BASELINE config #4: whole-bacterium k=31 spectrum).

    Returns ``(n_bases, spectrum)`` like ``pipeline.count_file`` but scales
    to arbitrarily long records with fixed device shapes.

    For large k the sparse path accumulates masked (hi, lo) key planes on
    device and resolves the whole file with ONE lexicographic device sort +
    run-length count (no per-batch host dicts).  ``sparse_format="arrays"``
    returns ``(keys_u64, counts)`` numpy arrays — for multi-Mbp genomes the
    Python dict itself is the bottleneck, so prefer arrays when consuming
    programmatically.  ``sparse_format="device"`` goes one further and
    returns the flush's DEVICE arrays ``(hi_s | None, lo_s, counts)`` —
    sorted runs, counts 0 off-run and at sentinels — without pulling them
    to host, for callers that keep computing on device (checksums,
    set operations, downstream kernels); it requires the stream to fit one
    flush (``count.SPARSE_FLUSH_LANES``).

    With ``packed`` (default on off-mesh paths), tiles ship as 2-bit code
    planes — the same transport diet as
    the short-read drivers, 4x fewer host->device bytes.  Results are
    bit-identical across transports and backends.

    ``mesh=`` shards the tiled batches over the mesh's ``data`` axis
    (tiling × sharding: genome tiles are ordinary rows, so the exact
    multi-chip sorted-run path applies; ``batch_tiles`` must divide the
    data axis).  Result is bit-identical to the single-device run.
    """
    import jax
    import jax.numpy as jnp

    from . import count as _count
    from . import kmers as _kmers

    if dense is None:
        dense = k <= _count.MAX_DENSE_K
    elif dense and k > _count.MAX_DENSE_K:
        raise ValueError(
            f"dense output needs k <= {_count.MAX_DENSE_K}, got {k}; "
            "use dense=False for larger k"
        )

    if mesh is not None:
        from ..parallel.exact import (
            ShardedSpectrumAccumulator,
            _require_single_process,
        )

        if sparse_format == "device":
            raise ValueError("sparse_format='device' is single-device only")
        _require_single_process("genome_spectrum(mesh=...)")
        # round the tile-batch rows up to the data axis (extra rows are
        # zero tiles whose windows are all invalid — exact no-ops), so any
        # mesh size works without the caller reasoning about divisibility
        n_data = mesh.shape["data"]
        batch_tiles = -(-batch_tiles // n_data) * n_data
        acc = ShardedSpectrumAccumulator(
            mesh, k, canonical=canonical, normalized=normalized
        )
        stream = _TileStream(path, k, tile_len, batch_tiles)
        for tiles, lengths in stream:
            acc.add(tiles, lengths)
        n_bases = stream.n_bases
        keys, counts = acc.finish()
        if dense:
            # same return type as the single-device dense run
            table = np.zeros(4**k, np.int64)
            table[keys.astype(np.int64)] = counts
            return n_bases, table
        if sparse_format == "arrays":
            return n_bases, (keys, counts)
        return n_bases, _count.spectrum_arrays_to_dict(keys, counts)

    if packed is None:
        packed = True
    _keys = make_tile_key_fn(
        k, tile_len, packed=packed, canonical=canonical,
        normalized=normalized,
    )
    _dense_spec = _dense_tile_spec_fn(k, packed, canonical, normalized)

    from ..utils.limbs import acc64

    dense_limbs = None  # device-resident uint32 limb pairs (exact past 2^31)
    sparse = _count.SparseSpectrumAccumulator()
    device_parts = []  # sparse_format="device": one-flush key planes
    device_lanes = 0
    stream = _TileStream(
        path, k, tile_len, batch_tiles, packed=packed, normalized=normalized
    )
    for block in stream:
        if packed:
            tiles, vbits, lengths = block
            vb = None if vbits is None else jnp.asarray(vbits)
        else:
            tiles, lengths = block
            vb = None
        dt, dl = jnp.asarray(tiles), jnp.asarray(lengths)
        if dense:
            spec = _dense_spec(dt, dl, vb)
            if dense_limbs is None:
                dense_limbs = (
                    jnp.zeros(4**k, jnp.uint32),
                    jnp.zeros(4**k, jnp.uint32),
                )
            dense_limbs = acc64(*dense_limbs, spec)
        elif sparse_format == "device":
            hi, lo = _keys(dt, dl, vb)
            device_parts.append((hi, lo))
            device_lanes += lo.size
            if device_lanes > _count.SPARSE_FLUSH_LANES:
                raise ValueError(
                    "sparse_format='device' holds the whole stream on "
                    f"device; {device_lanes} lanes exceed the flush bound "
                    f"({_count.SPARSE_FLUSH_LANES}) — use 'arrays' instead"
                )
        else:
            sparse.add(*_keys(dt, dl, vb))
    n_bases = stream.n_bases
    if dense:
        if dense_limbs is None:
            return n_bases, np.zeros(4**k, np.int64)
        lo, hi = dense_limbs
        from ..utils.limbs import limbs_to_int64_array

        return n_bases, limbs_to_int64_array(lo, hi)
    if sparse_format == "device":
        return n_bases, _count.finalize_sparse_device(device_parts)
    keys, counts = sparse.finish()
    if sparse_format == "arrays":
        return n_bases, (keys, counts)
    return n_bases, _count.spectrum_arrays_to_dict(keys, counts)

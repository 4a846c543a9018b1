"""Multi-host scale-out: process init and per-host input partitioning.

BASELINE config #5 design: each host streams a disjoint byte range of the
input FASTQ data-parallel, frames locally, and feeds its devices; the
sharded count table merges with collectives (``parallel.sharded``).  The reference
has no distributed machinery (SURVEY.md §2) — this is new design.

One process drives every device of a host; ``initialize`` is for jobs that
span several hosts (one process per host).  Several processes on one GPU
host would each try to take every card.

Range splitting re-synchronizes to record boundaries: a FASTQ record start is
a line beginning with ``@`` whose next-next line begins with ``+`` (the
``@``-in-quality ambiguity is resolved by the 4-line structure); FASTA is a
line beginning with ``>``.  Every record is owned by exactly one range: the
one containing its first byte after re-sync.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

from ..errors import ParseError
from ..io.fast_batch import RangeStream as _RangeStream
from ..parser import FastaReader, FastqReader, FastxReader

__all__ = [
    "initialize",
    "split_fastx_ranges",
    "read_range",
    "host_shard_ranges",
]

_SYNC_WINDOW = 1 << 20


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize ``jax.distributed`` (no-op when already initialized or
    single-process).  Call before any other JAX API on multi-host pods."""
    import jax

    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


_SYNC_DEPTH = 2


def _is_fastq_record_start(
    buf: bytes, pos: int, depth: int = _SYNC_DEPTH
) -> Optional[bool]:
    """``True``/``False`` when ``pos`` does/doesn't start a FASTQ record;
    ``None`` when the window is too short to decide (caller extends).

    Validates ``depth`` consecutive full record structures — ``@`` start,
    ``+`` separator AND seq/qual length equality (trailing-CR aware) —
    because the cheap 2-line heuristic is foolable: a quality line starting
    ``@`` followed by a read whose sequence starts ``+`` mimics a record
    start (sequences may contain any byte; the reference validates only
    markers + lengths, ref fastq.rs:240-285).  A chain of ``depth``
    length-consistent fake records is vanishingly unlikely on real data.
    Truncated-at-EOF candidates stay ``None`` → the caller skips them, so
    near-EOF cuts degrade to range imbalance, never to misparsing.
    """
    from ..parser.utils import trim_cr

    if buf[pos : pos + 1] != b"@":
        return False
    if pos > 0 and buf[pos - 1 : pos] != b"\n":
        return False
    p = pos
    for d in range(depth):
        nls = []
        q = p
        for _ in range(4):
            i = buf.find(b"\n", q)
            if i < 0:
                return None  # undecidable in this window
            nls.append(i)
            q = i + 1
        if buf[p : p + 1] != b"@":
            return False
        if buf[nls[1] + 1 : nls[1] + 2] != b"+":
            return False
        seq = trim_cr(buf[nls[0] + 1 : nls[1]])
        qual = trim_cr(buf[nls[2] + 1 : nls[3]])
        if len(seq) != len(qual):
            return False
        p = nls[3] + 1
        if p >= len(buf) and d + 1 < depth:
            # complete records up to the window's end, but depth not
            # reached: undecidable — the caller extends, and at true EOF
            # skips the candidate (conservative: imbalance, never misparse)
            return None
    return True


def _sync_forward(path: Union[str, Path], offset: int, fasta: bool) -> int:
    """Smallest record-start position >= offset (or file size)."""
    size = os.path.getsize(path)
    if offset == 0:
        return 0
    with open(path, "rb") as f:
        # include one byte of left context so a boundary AT offset is found
        f.seek(offset - 1)
        window = f.read(_SYNC_WINDOW + 1)
        base = offset - 1
        search = 0
        at_eof = False
        while True:
            idx = window.find(b"\n>" if fasta else b"\n@", search)
            if idx < 0:
                if at_eof:
                    return size
                nxt = f.read(_SYNC_WINDOW)
                if not nxt:
                    at_eof = True
                window += nxt
                search = max(len(window) - len(nxt) - 1, 0)
                if at_eof:
                    search = len(window)  # no candidate left
                continue
            pos = idx + 1
            if fasta:
                return base + pos
            verdict = _is_fastq_record_start(window, pos)
            if verdict is None and not at_eof:
                # candidate too close to the window edge: extend, re-check
                nxt = f.read(_SYNC_WINDOW)
                if not nxt:
                    at_eof = True
                window += nxt
                search = pos - 1  # re-evaluate the same candidate
                continue
            if verdict:
                return base + pos
            search = pos + 1


def split_fastx_ranges(
    path: Union[str, Path], n: int
) -> List[Tuple[int, int]]:
    """Split an **uncompressed** FASTX file into ``n`` byte ranges aligned to
    record starts.  Ranges are disjoint, cover the file, and each record
    belongs to exactly one range.  (Compressed inputs can't be byte-range
    partitioned; decompress or chunk at the file level instead.)"""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.read(1)
    if not first:
        return [(0, 0)] * n
    fasta = first == b">"
    if first not in (b">", b"@"):
        raise ParseError.new_unknown_format(first[0])
    cuts = [0]
    for i in range(1, n):
        target = size * i // n
        cut = _sync_forward(path, target, fasta)
        cuts.append(max(cut, cuts[-1]))
    cuts.append(size)
    return [(cuts[i], cuts[i + 1]) for i in range(n)]


def read_range(path: Union[str, Path], start: int, end: int) -> FastxReader:
    """Streaming reader over one record-aligned byte range of ``path``."""
    with open(path, "rb") as f:
        first = f.read(1)
    if first not in (b">", b"@"):
        # same up-front validation as split_fastx_ranges — a compressed or
        # non-FASTX file must not silently become a misparsing FastqReader
        raise ParseError.new_unknown_format(first[0] if first else 0)
    stream = _RangeStream(path, start, end)
    if first == b">":
        return FastaReader(stream)
    return FastqReader(stream)


def host_shard_ranges(path: Union[str, Path]) -> Tuple[int, int]:
    """This process's byte range of ``path`` under jax.distributed."""
    import jax

    n = jax.process_count()
    i = jax.process_index()
    return split_fastx_ranges(path, n)[i]

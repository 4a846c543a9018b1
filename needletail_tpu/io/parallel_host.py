"""Multi-process host framing: parallel byte-range workers feeding batches.

One framing core cannot keep an accelerator busy: the host is the
deployment bottleneck (SURVEY.md §7 hard part 3).  ``parallel_read_batches``
splits an uncompressed FASTX file into record-aligned byte ranges
(``parallel.distributed.split_fastx_ranges``) and frames each range in its
own worker process with the native scanner, streaming ``ReadBatch``es back
over a queue.

Batch arrival order interleaves across workers; every record is framed by
exactly one worker, so any order-independent consumer (all the counting
pipelines — integer adds commute) gets bit-identical results.
"""

from __future__ import annotations

import multiprocessing as mp
from pathlib import Path
from typing import Iterator, Optional, Union

from ..batch import PackedReadBatch, ReadBatch
from ..errors import ParseError

__all__ = ["parallel_read_batches", "auto_host_workers"]


def auto_host_workers() -> int:
    """Default framing parallelism: all cores but one (the consumer thread
    runs device dispatch + merges), capped at 16 — beyond that the batch
    queue, not framing, binds.  Always >= 1."""
    import os

    return max(1, min((os.cpu_count() or 1) - 1, 16))

_DONE = "done"
_ERR = "err"
_BATCH = "batch"


def _worker(
    path, start, end, batch_size, max_len, with_quals, with_ids, q,
    shm_names=None, free_q=None, packed=False, normalized=True,
) -> None:
    import pickle

    from .fast_batch import fast_read_batches_range

    writer = None
    try:
        if shm_names is not None:
            from .shm_pool import SharedBatchWriter

            writer = SharedBatchWriter(
                shm_names, batch_size, max_len, with_quals, packed=packed
            )
        for b in fast_read_batches_range(
            path, start, end, batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, with_ids=with_ids,
            packed=packed, normalized=normalized,
        ):
            # the descriptor's bool marks quals (ASCII) / vbits (packed)
            second = b.dense_vbits() if packed else b.quals
            if writer is not None:
                seg = free_q.get()
                n = writer.write(seg, b)
                # planes travel by segment id; only ids (compact LazyIds
                # blobs) and the descriptor go through the pickle queue
                q.put((_BATCH, (seg, n, b.ids if with_ids else [],
                                second is not None)))
            elif packed:
                q.put((_BATCH, (b.codes, b.lengths, second, b.ids)))
            else:
                q.put((_BATCH, (b.seqs, b.lengths, second, b.ids)))
        q.put((_DONE, None))
    except BaseException as exc:  # propagate to the consumer
        # mp.Queue pickles in a feeder thread, so an unpicklable exception
        # would vanish silently — verify picklability here and degrade
        try:
            pickle.dumps(exc)
        except Exception:
            exc = ParseError.from_io(OSError(repr(exc)))
        # ship the range start so the consumer can re-base the error's
        # line number from range-relative to file-global (ref
        # errors.rs:10-24 position fidelity)
        q.put((_ERR, (exc, start)))
    finally:
        if writer is not None:
            writer.close()


def _count_newlines_before(path, stop: int) -> int:
    """Newlines in file[0:stop] — only runs on the (rare) error path, so
    a plain chunked read + bytes.count is fine."""
    remaining = stop
    count = 0
    with open(path, "rb") as f:
        while remaining > 0:
            chunk = f.read(min(remaining, 8 << 20))
            if not chunk:
                break
            count += chunk.count(b"\n")
            remaining -= len(chunk)
    return count


def _rebase_error(path, exc, range_start: int):
    """Rewrite a worker ParseError's line number to be file-global."""
    if (
        not isinstance(exc, ParseError)
        or range_start <= 0
        or exc.position is None
        or exc.position.line is None
    ):
        return exc
    try:
        lines_before = _count_newlines_before(path, range_start)
    except OSError:
        # the input vanished/became unreadable mid-error: surface the
        # worker's original (range-relative) error rather than masking it
        return exc
    from ..errors import ErrorPosition

    return ParseError(
        exc.msg,
        exc.kind,
        ErrorPosition(
            line=exc.position.line + lines_before, id=exc.position.id
        ),
        exc.format,
    )


def parallel_read_batches(
    path: Union[str, Path],
    workers: int = 2,
    batch_size: int = 8192,
    max_len: Optional[int] = None,
    with_quals: bool = True,
    with_ids: bool = False,
    shared_mem: Optional[bool] = None,
    packed: bool = False,
    normalized: bool = True,
) -> Iterator[ReadBatch]:
    """Frame an uncompressed FASTX file with ``workers`` processes.

    Falls back to the single-process fast path for ``workers <= 1``.
    Compressed inputs cannot be range-split; use ``fast_read_batches``
    (optionally with ``prefetch=True``) for those.  Errors surface with
    FILE-global line numbers and record ids, identical to the
    single-stream reader; ``with_ids=True`` ships record ids (as packed
    LazyIds) through the worker queue.

    With an explicit ``max_len``, batch planes travel through a
    shared-memory segment pool instead of the pickle queue
    (see ``io.shm_pool``): workers write planes in place and the
    consumer's only cost is one memcpy out of the segment — versus
    pickle's serialize + pipe-write + pipe-read + deserialize.  Pass
    ``shared_mem=False`` to force the pickle path.
    """
    from .fast_batch import _effective_packed_max_len, fast_read_batches

    if packed:
        with_quals = False
    # quantize BEFORE sizing the shm pool: the workers' range framers apply
    # the same rule (idempotently), so pool plane widths and worker plane
    # widths must agree or every packed write raises a broadcast error
    max_len = _effective_packed_max_len(packed, max_len)
    if workers <= 1 or str(path) == "-":
        # stdin cannot be range-split: stream it single-process
        yield from fast_read_batches(
            str(path), batch_size=batch_size, max_len=max_len,
            with_quals=with_quals, with_ids=with_ids,
            packed=packed, normalized=normalized,
        )
        return

    from .compression import sniff_compression

    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError as exc:
        # same taxonomy as the single-stream reader (ParseError(Io))
        raise ParseError.from_io(exc) from exc
    if len(magic) == 2 and sniff_compression(magic):
        raise ValueError(
            "byte-range framing needs an uncompressed file; use "
            "fast_read_batches(prefetch=True) for compressed input"
        )

    if shared_mem is None:
        shared_mem = max_len is not None
    if shared_mem and max_len is None:
        raise ValueError("shared_mem=True needs an explicit max_len")

    from ..parallel.distributed import split_fastx_ranges

    ranges = split_fastx_ranges(path, workers)
    # spawn, never fork: the consumer typically has JAX (multithreaded)
    # initialized, and forking a multithreaded process can deadlock.  The
    # workers import only host modules and never touch a JAX backend, so
    # the parent stays the one process that holds the accelerator.
    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=4 * workers)
    pool = None
    free_q = None
    shm_names = None
    if shared_mem:
        from .shm_pool import SharedBatchPool

        pool = SharedBatchPool(
            batch_size, max_len, with_quals, segments=2 * workers + 2,
            packed=packed,
        )
        shm_names = pool.names
        free_q = ctx.Queue()
        for i in range(len(shm_names)):
            free_q.put(i)
    procs = [
        ctx.Process(
            target=_worker,
            args=(str(path), start, end, batch_size, max_len, with_quals,
                  with_ids, q, shm_names, free_q, packed, normalized),
            daemon=True,
        )
        for start, end in ranges
    ]
    for p in procs:
        p.start()
    import queue as _queue

    live = len(procs)
    error = None
    try:
        while live:
            try:
                kind, payload = q.get(timeout=1.0)
            except _queue.Empty:
                # watchdog: a worker killed without its sentinel (OOM,
                # segfault in native code) must not wedge the consumer
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    hint = ""
                    if dead[0].exitcode == 1:
                        # the classic spawn-bootstrap failure: an unguarded
                        # caller script re-executes itself in the child
                        hint = (
                            " (the framing pool uses the 'spawn' start "
                            "method, which re-imports the calling script — "
                            "if this happened at startup, guard your entry "
                            "point with `if __name__ == \"__main__\":` or "
                            "pass host_workers=1)"
                        )
                    error = RuntimeError(
                        "framing worker died with exit code "
                        f"{dead[0].exitcode}{hint}"
                    )
                    break
                if all(p.exitcode is not None for p in procs) and q.empty():
                    break  # everyone exited cleanly; sentinels consumed
                continue
            if kind == _DONE:
                live -= 1
            elif kind == _ERR:
                exc, range_start = payload
                error = _rebase_error(str(path), exc, range_start)
                break
            elif pool is not None:
                seg, n, ids, has_second = payload
                seqs, quals, lengths = pool.views(seg, n)
                second = (
                    quals.copy() if (has_second and quals is not None) else None
                )
                if packed:
                    batch = PackedReadBatch(
                        codes=seqs.copy(),
                        lengths=lengths.copy(),
                        vbits=second,
                        ids=ids,
                        normalized=normalized,
                    )
                else:
                    batch = ReadBatch(
                        seqs=seqs.copy(),
                        lengths=lengths.copy(),
                        # has_second preserves pickle-path parity: FASTA
                        # input yields quals=None, never a zero plane
                        quals=second,
                        ids=ids,
                    )
                # no views survive the copy: drop them before recycling so
                # pool.close() in the finally sees no exported buffers
                del seqs, quals, lengths, second
                free_q.put(seg)
                yield batch
            elif packed:
                codes, lengths, vbits, ids = payload
                yield PackedReadBatch(
                    codes=codes, lengths=lengths, vbits=vbits, ids=ids,
                    normalized=normalized,
                )
            else:
                seqs, lengths, quals, ids = payload
                yield ReadBatch(seqs=seqs, lengths=lengths, quals=quals, ids=ids)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join()
        if pool is not None:
            pool.close()
    if error is not None:
        raise error

"""needletail_tpu — a JAX FASTX ingest and k-mer engine for accelerators.

A from-scratch framework with the capabilities of onecodex/needletail
(FASTA/FASTQ streaming parsing, sequence normalization, reverse complement,
canonical k-mers, 2-bit packed k-mers, Phred quality handling), re-designed
for an accelerator: a host-side streaming framer feeds fixed-shape padded
base tensors to jitted JAX device steps, and k-mer counting runs as sharded
scatter-add tables and sorted runs merged with collectives on a
``jax.sharding.Mesh``.

Layered API:
  * ``needletail_tpu`` (this module)  — needletail-compatible surface:
    ``parse_fastx_file``/``parse_fastx_string``/``parse_fastx_reader``,
    ``Record``, ``FastxReader``, ``normalize_seq``, ``reverse_complement``,
    ``decode_phred``, ``NeedletailError``.
  * ``needletail_tpu.parser``         — streaming framers + SequenceRecord.
  * ``needletail_tpu.sequence/kmer/bitkmer/quality`` — host sequence ops.
  * ``needletail_tpu.batch``          — padded batch ingestion for devices.
  * ``needletail_tpu.device``         — JAX device ops (normalize, rc,
    quality-mask, 2-bit encode, canonical k-mers, count tables).
  * ``needletail_tpu.parallel``       — mesh/sharding + collective merges.
"""

import os as _os


def _enable_jax_compile_cache() -> None:
    """Enable JAX's persistent compilation cache unless the user has their
    own setting.  Big-array ``lax.sort`` programs (the exact-spectrum path)
    take seconds to compile; the cache turns every repeat compile across
    processes into a disk hit.  ``JAX_COMPILATION_CACHE_DIR`` wins when
    set; otherwise the cache lives in ``.jax_cache/`` at the root of the
    checkout (a fixed path, so later processes find it again).  Opt out
    with ``NEEDLETAIL_TPU_NO_COMPILE_CACHE=1``."""
    if _os.environ.get("NEEDLETAIL_TPU_NO_COMPILE_CACHE"):
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    try:
        import jax

        if jax.config.jax_compilation_cache_dir:
            return
        # CPU-only sessions skip the cache: XLA:CPU AOT results encode the
        # compile machine's ISA features and can SIGILL on a different
        # host, and CPU compiles are fast anyway.
        if (jax.config.jax_platforms or "").strip() == "cpu":
            return
        cache_dir = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        )
        _os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:  # pragma: no cover — cache is best-effort
        pass


_enable_jax_compile_cache()

from . import bitkmer, errors, kmer, quality, sequence
from .api import (
    FastxReader,
    NeedletailError,
    Record,
    decode_phred,
    normalize_seq,
    parse_fastx_file,
    parse_fastx_string,
    reverse_complement,
)
from .errors import ParseError, ParseErrorKind, PhredOffsetError
from .seq_wrapper import Sequence
from .parser import parse_fastx_reader, parse_fastx_stdin

__version__ = "0.1.0"

__all__ = [
    "parse_fastx_file",
    "parse_fastx_string",
    "parse_fastx_reader",
    "parse_fastx_stdin",
    "Record",
    "FastxReader",
    "NeedletailError",
    "normalize_seq",
    "reverse_complement",
    "decode_phred",
    "ParseError",
    "ParseErrorKind",
    "PhredOffsetError",
    "Sequence",
    "errors",
    "sequence",
    "kmer",
    "bitkmer",
    "quality",
]

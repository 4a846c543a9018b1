"""Device compute path: jitted JAX steps over padded read batches.

Import this subpackage explicitly — the top-level ``needletail_tpu`` package
stays importable without initializing JAX.

Layout:
  * ``ops``     — elementwise LUT kernels: normalize, complement/reverse-
                  complement, quality masking, Phred decode, 2-bit encode.
  * ``kmers``   — rolling 2-bit window packing, canonical k-mers (u32 pairs
                  for k<=31), validity masks.
  * ``count``   — dense 4^k spectra, targeted k-mer match counts, sorted
                  exact spectra for large k.
  * ``hashcount`` — canonical k-mer hash keys and the hash-table update.
  * ``pipeline``— fused, jitted end-to-end batch pipelines.
"""

from . import count, kmers, minimizers, ops, pipeline, quality, tiling

__all__ = ["ops", "kmers", "count", "pipeline", "minimizers", "quality", "tiling"]

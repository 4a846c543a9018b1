"""Plain-numpy reference for canonical k-mer counts and the hash table.

Independent of ``needletail_tpu.device``: windows are packed by a
vectorized rolling 2-bit shift over a fixed-width read matrix, the
canonical value is the integer-min of forward and reverse complement
(ties keep forward), exact counts come from ``np.unique`` and the hash
table from ``np.bincount``.  ``chip_smoke.py`` and the tests hold device
results to it with zero tolerance; the tests check it in turn against the
host ``bitkmer.bit_kmers``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["canonical_windows", "KmerTally"]

_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)


def _code_lut(normalized: bool) -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = lut[base | 0x20] = code
    if normalized:  # normalization turns U into T
        lut[ord("U")] = lut[ord("u")] = 3
    return lut


def canonical_windows(
    seqs: np.ndarray, lengths: np.ndarray, k: int, normalized: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical windows of an ASCII read matrix ``seqs`` [N, L].

    Returns ``(values, valid, forward)``, each [N, L-k+1]: the canonical
    2k-bit value (uint64, first base most significant), whether the window
    lies inside the read and holds k unambiguous bases, and whether the
    forward strand won the min.
    """
    seqs = np.asarray(seqs, np.uint8)
    n, l = seqs.shape
    w = l - k + 1
    if w <= 0:
        z = np.zeros((n, 0))
        return z.astype(np.uint64), z.astype(bool), z.astype(bool)
    codes = _code_lut(normalized)[seqs]
    bad = np.zeros((n, l + 1), np.int32)
    np.cumsum(codes == 255, axis=1, out=bad[:, 1:])
    c = np.where(codes == 255, 0, codes).astype(np.uint64)
    fwd = np.zeros((n, w), np.uint64)
    rc = np.zeros((n, w), np.uint64)
    two = np.uint64(2)
    for j in range(k):
        cj = c[:, j : j + w]
        fwd = (fwd << two) | cj
        rc |= (np.uint64(3) - cj) << np.uint64(2 * j)
    pos = np.arange(w)[None, :]
    valid = (bad[:, k:] == bad[:, :w]) & (
        pos + k <= np.asarray(lengths)[:, None]
    )
    return np.minimum(fwd, rc), valid, fwd <= rc


class KmerTally:
    """Accumulates the oracle over read chunks: window totals, the hash
    table of ``hash_count_file`` and the exact spectrum of ``count_file``."""

    def __init__(self, k: int, table_bits: int = 16, normalized: bool = True):
        self.k = k
        self.table_bits = table_bits
        self.normalized = normalized
        self.total = 0
        self.forward = 0
        self.table = np.zeros(1 << table_bits, np.int64)
        self._values: List[np.ndarray] = []

    def add(self, seqs: np.ndarray, lengths: np.ndarray) -> None:
        values, valid, fwd = canonical_windows(
            seqs, lengths, self.k, self.normalized
        )
        v = values[valid]
        self.total += int(v.size)
        self.forward += int(np.count_nonzero(fwd & valid))
        hi = (v >> np.uint64(32)).astype(np.uint32)
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h = ((lo * _C1) ^ (hi * _C2)) & np.uint32((1 << self.table_bits) - 1)
        self.table += np.bincount(h, minlength=1 << self.table_bits)
        self._values.append(v)

    def spectrum(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted distinct canonical values (uint64) and their counts."""
        allv = np.concatenate(self._values) if self._values else np.zeros(0, np.uint64)
        keys, counts = np.unique(allv, return_counts=True)
        return keys, counts.astype(np.int64)

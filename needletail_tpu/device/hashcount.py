"""Canonical k-mer hash counting on device: the per-batch step of
``pipeline.hash_count_file`` and of the sharded hash pipeline.

A window's hash is ``((lo * 0x9E3779B1) ^ (hi * 0x85EBCA77)) & mask`` over
its canonical ``(hi, lo)`` value (``kmers.canonical_kmers``: integer-min of
forward and reverse complement, ties keep forward).  Invalid windows carry
the key -1 and are dropped by :func:`hash_histogram`, which scatter-adds
the valid keys into a ``[2^table_bits]`` int32 table.

Everything here is plain JAX: XLA fuses the doubling ladder, the canonical
select and the hash into one loop fusion and lowers the histogram to a
scatter with atomic adds.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import kmers as _kmers

__all__ = [
    "HASH_C1",
    "HASH_C2",
    "MAX_TABLE_BITS",
    "canonical_hash_keys",
    "check_table_bits",
    "canonical_hash_keys_packed",
    "hash_histogram",
]

HASH_C1 = 0x9E3779B1
HASH_C2 = 0x85EBCA77

# the hash table is one 2^16-bin int32 array per device (256 KiB): the
# sharded pipeline reduce-scatters it every step, so its size is an API
# contract shared by the flat and sharded drivers and their checkpoints
MAX_TABLE_BITS = 16


def check_table_bits(table_bits: int) -> None:
    """Reject a table wider than the 2^16-bin API limit."""
    if table_bits > MAX_TABLE_BITS:
        raise ValueError(
            f"the hash table holds at most 2^{MAX_TABLE_BITS} bins; "
            f"table_bits <= {MAX_TABLE_BITS}, got {table_bits}"
        )


def _hash_keys(
    win: _kmers.KmerWindows, table_bits: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    h = (win.lo * jnp.uint32(HASH_C1)) ^ (win.hi * jnp.uint32(HASH_C2))
    h = h & jnp.uint32((1 << table_bits) - 1)
    keys = jnp.where(win.valid, h.astype(jnp.int32), jnp.int32(-1))
    total = jnp.sum(win.valid.astype(jnp.int32))
    fwd = jnp.sum((win.valid & ~win.was_rc).astype(jnp.int32))
    return keys, total, fwd


@partial(jax.jit, static_argnames=("k", "table_bits", "normalized"))
def canonical_hash_keys(
    seqs: jax.Array,
    lengths: jax.Array,
    k: int,
    table_bits: int = MAX_TABLE_BITS,
    normalized: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Hash keys of every canonical window of an ASCII batch.

    Returns ``(keys, total, fwd)``: ``keys`` is int32 ``[B, L-k+1]`` with
    invalid windows (an ambiguous base, or past the read's length) at -1;
    ``total`` counts valid windows and ``fwd`` those whose forward strand
    won the canonical min.
    """
    win = _kmers.canonical_kmers(seqs, lengths, k, normalized=normalized)
    return _hash_keys(win, table_bits)


@partial(jax.jit, static_argnames=("k", "table_bits"))
def canonical_hash_keys_packed(
    codes: jax.Array,
    vbits: Optional[jax.Array],
    lengths: jax.Array,
    k: int,
    table_bits: int = MAX_TABLE_BITS,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """:func:`canonical_hash_keys` over the packed 2-bit transport.

    ``codes`` [B, L/4] uint8 plus the optional ``vbits`` [B, L/8]
    validity plane (see ``needletail_tpu.encoding``).  The normalization
    mode was applied when the batch was packed, so the keys equal
    ``canonical_hash_keys`` of the ASCII batch under that mode.
    """
    from .ops import unpack_codes

    win = _kmers.canonical_kmers(
        unpack_codes(codes, vbits), lengths, k, precoded=True
    )
    return _hash_keys(win, table_bits)


@partial(jax.jit, static_argnames=("n_bins",))
def hash_histogram(keys: jax.Array, n_bins: int = 1 << MAX_TABLE_BITS) -> jax.Array:
    """int32 ``[n_bins]`` counts of the non-negative ``keys``.

    Negative keys (the -1 of an invalid window) and keys ``>= n_bins`` are
    dropped.  They are routed to the out-of-range index ``n_bins`` first:
    a negative index would wrap to the last bin under JAX's indexing rules
    even with ``mode="drop"``.
    """
    keys = keys.reshape(-1)
    idx = jnp.where(keys >= 0, keys, n_bins)
    return jnp.zeros(n_bins, jnp.int32).at[idx].add(1, mode="drop")

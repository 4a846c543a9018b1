"""Rolling 2-bit k-mer packing and canonicalization on device.

K-mers are represented as ``(hi, lo)`` uint32 pairs holding the packed 2-bit
window (A=0 C=1 G=2 T=3, first base most significant — identical to the
reference's integer encoding, ref bitkmer.rs:26-36):

  * k <= 16: ``lo`` holds all ``2k`` bits, ``hi`` is 0.
  * 16 < k <= 31: ``hi`` holds the first ``k-16`` bases, ``lo`` the last 16.

This keeps the hot loop in native 32-bit lanes (JAX runs without 64-bit
types by default; pairs + a carry-free split make compares cheap).

Packing is a static doubling ladder of shifts over the lane dimension that
XLA fuses into a single pass over device memory.

Canonical semantics follow the *bitkmer* path of the reference: the
canonical value is ``min(fwd, rc)`` as integers and ties keep the forward
orientation (ref bitkmer.rs:136-143).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import _ladder
from .ops import encode_2bit

__all__ = ["KmerWindows", "pack_kmers", "canonical_kmers", "window_validity"]




class KmerWindows(NamedTuple):
    """Packed k-mer windows for a batch.

    ``hi``/``lo``: uint32 [B, W] (W = L - k + 1 window positions per read);
    ``valid``: bool [B, W] — all k bases unambiguous and inside the read.
    ``was_rc``: bool [B, W] — only set by ``canonical_kmers``.
    """

    hi: jax.Array
    lo: jax.Array
    valid: jax.Array
    was_rc: jax.Array


def _roll_left(x: jax.Array, j: int) -> jax.Array:
    """rolled[:, p] == x[:, p + j] (wrap-around lanes only reach windows the
    in-bounds mask rejects, since window p needs p + k <= length <= L)."""
    return x if j == 0 else jnp.roll(x, -j, axis=-1)


def window_validity(codes: jax.Array, lengths: jax.Array, k: int) -> jax.Array:
    """bool [B, W]: window has k in-bounds, unambiguous bases.

    Matches the emission set of the reference's N-skip machines
    (ref kmer.rs:84-108, bitkmer.rs:39-70).
    """
    b, l = codes.shape
    num = l - k + 1
    W, _, V = _ladder.build_ladders(codes, k, _roll_left, need_rc=False)
    valid = _ladder.compose_valid(V, k, _roll_left)[:, :num] != 0
    pos = jnp.arange(num, dtype=jnp.int32)[None, :]
    in_bounds = pos + k <= lengths[:, None]
    return valid & in_bounds


@partial(jax.jit, static_argnames=("k", "normalized", "precoded"))
def pack_kmers(
    seqs: jax.Array,
    lengths: jax.Array,
    k: int,
    normalized: bool = True,
    precoded: bool = False,
) -> KmerWindows:
    """Forward-strand packed windows for every position (no canonicalization).

    ``precoded=True``: ``seqs`` already holds 2-bit codes (0-3, 255 invalid
    — e.g. ``ops.unpack_codes`` output from the packed transport); the
    encode step is skipped.
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    codes = (
        seqs if precoded else encode_2bit(seqs, normalized=normalized)
    ).astype(jnp.uint32)
    b, l = codes.shape
    if l < k:
        raise ValueError(f"batch max_len {l} shorter than k={k}")
    num = l - k + 1
    W, _, V = _ladder.build_ladders(codes, k, _roll_left, need_rc=False)
    pos = jnp.arange(num, dtype=jnp.int32)[None, :]
    valid = (_ladder.compose_valid(V, k, _roll_left)[:, :num] != 0) & (
        pos + k <= lengths[:, None]
    )
    if k <= 16:
        lo = _ladder.compose_fwd(W, k, _roll_left)[:, :num]
        hi = jnp.zeros_like(lo)
    else:
        # hi = first k-16 bases of the window, lo = last 16 bases
        hi = _ladder.compose_fwd(W, k - 16, _roll_left)[:, :num]
        lo = _roll_left(W[16], k - 16)[:, :num]
    return KmerWindows(hi=hi, lo=lo, valid=valid, was_rc=jnp.zeros_like(valid))


@partial(jax.jit, static_argnames=("k", "normalized", "precoded"))
def canonical_kmers(
    seqs: jax.Array,
    lengths: jax.Array,
    k: int,
    normalized: bool = True,
    precoded: bool = False,
) -> KmerWindows:
    """Canonical packed windows: integer-min of forward and reverse
    complement; ties keep forward (bitkmer semantics, ref bitkmer.rs:136-143).

    ``precoded=True``: ``seqs`` holds 2-bit codes already (see
    :func:`pack_kmers`).
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    codes = (
        seqs if precoded else encode_2bit(seqs, normalized=normalized)
    ).astype(jnp.uint32)
    b, l = codes.shape
    if l < k:
        raise ValueError(f"batch max_len {l} shorter than k={k}")
    num = l - k + 1
    fwd_hi, fwd_lo, rc_hi, rc_lo, valid_u = _ladder.canonical_parts(
        codes, k, _roll_left
    )
    pos = jnp.arange(num, dtype=jnp.int32)[None, :]
    valid = (valid_u[:, :num] != 0) & (pos + k <= lengths[:, None])
    fwd_hi, fwd_lo, rc_hi, rc_lo = (
        a[:, :num] for a in (fwd_hi, fwd_lo, rc_hi, rc_lo)
    )

    use_rc = (fwd_hi > rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo > rc_lo))
    hi = jnp.where(use_rc, rc_hi, fwd_hi)
    lo = jnp.where(use_rc, rc_lo, fwd_lo)
    return KmerWindows(hi=hi, lo=lo, valid=valid, was_rc=use_rc & valid)

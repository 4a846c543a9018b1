"""Elementwise device ops: LUT gathers over padded [B, L] uint8 batches.

Each op reuses the host 256-entry tables (``needletail_tpu.sequence``), so
device results agree byte-for-byte with the host path.  All ops are
shape-preserving (fixed shapes for XLA); where the host op *compacts* the
sequence (normalize drops whitespace), the device op instead returns a keep
mask — compaction on fixed shapes is a host-side concern.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import sequence as _hostseq

# the encode tables live host-side (shared with the C framer's packed
# fills and the numpy packer); re-exported here for compatibility
from ..encoding import ENCODE_NORMALIZED_LUT, ENCODE_RAW_LUT

__all__ = [
    "normalize",
    "complement",
    "reverse_complement",
    "quality_mask",
    "decode_phred",
    "encode_2bit",
    "unpack_codes",
    "expand_vrows",
    "resolve_vbits",
    "ENCODE_RAW_LUT",
    "ENCODE_NORMALIZED_LUT",
]

_INVALID = 255


@partial(jax.jit, static_argnames=("iupac",))
def normalize(seqs: jax.Array, iupac: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Normalize bytes (ref sequence.rs:19-62 semantics) on device.

    Returns ``(normalized_bytes, keep_mask)``: whitespace bytes map to 0 with
    ``keep_mask=False`` (host normalize drops them); everything else follows
    the reference mapping.  Padding (byte 0) maps to 'N' with keep=True, so
    mask with your length vector separately.
    """
    byte_map, _ = _hostseq.normalize_luts(iupac)
    lut = jnp.asarray(byte_map)
    out = jnp.take(lut, seqs.astype(jnp.int32), axis=0)
    return out, out != 0


@jax.jit
def complement(seqs: jax.Array) -> jax.Array:
    """Per-base IUPAC complement (ref sequence.rs:68-105)."""
    lut = jnp.asarray(_hostseq.COMPLEMENT_LUT)
    return jnp.take(lut, seqs.astype(jnp.int32), axis=0)


@jax.jit
def reverse_complement(seqs: jax.Array, lengths: jax.Array) -> jax.Array:
    """Length-aware reverse complement of each row (ref sequence.rs:202-208).

    Row i's first ``lengths[i]`` positions hold the reverse complement;
    padding stays zero.
    """
    b, l = seqs.shape
    comp = complement(seqs)
    pos = jnp.arange(l, dtype=jnp.int32)[None, :]
    src = lengths[:, None] - 1 - pos  # index of the mirrored base
    in_range = src >= 0
    src = jnp.clip(src, 0, l - 1)
    flipped = jnp.take_along_axis(comp, src, axis=1)
    return jnp.where(in_range, flipped, 0).astype(jnp.uint8)


@jax.jit
def quality_mask(seqs: jax.Array, quals: jax.Array, score: jax.Array) -> jax.Array:
    """Mask bases with quality below ``score`` to 'N' (ref sequence.rs:280-296)."""
    return jnp.where(quals < score, jnp.uint8(ord("N")), seqs)


@partial(jax.jit, static_argnames=("offset",))
def decode_phred(quals: jax.Array, offset: int = 33) -> Tuple[jax.Array, jax.Array]:
    """Subtract the Phred offset; returns (scores, ok_mask) — chars below the
    offset are flagged instead of raising (ref quality.rs:15-28)."""
    ok = quals >= offset
    return (quals - jnp.uint8(offset)) * ok.astype(jnp.uint8), ok


@jax.jit
def unpack_codes(codes: jax.Array, vbits: Optional[jax.Array]) -> jax.Array:
    """Packed transport planes -> per-base 2-bit codes [B, L] (255 invalid).

    ``codes``: uint8 [B, L/4] (base j at bits ``2*(j&3)`` of byte ``j>>2``);
    ``vbits``: uint8 [B, L/8] validity bitplane or None (= all valid — the
    clean-read fast path skips the whole validity unpack).  The output is
    exactly what ``encode_2bit`` produces on the original ASCII bytes, so
    every downstream step (ladders, hash step, sharded steps) consumes
    it unchanged via their ``precoded`` path.

    The interleave rides one [B, L/4, 4] stack + reshape — a single fused
    pass under XLA; at 0.25 B/base in, this is noise next to the 4x
    host->device transfer saving.
    """
    b, lq = codes.shape
    c = codes.astype(jnp.uint8)
    parts = [(c >> jnp.uint8(2 * j)) & jnp.uint8(3) for j in range(4)]
    out = jnp.stack(parts, axis=-1).reshape(b, lq * 4)
    if vbits is not None:
        v = vbits.astype(jnp.uint8)
        vparts = [(v >> jnp.uint8(j)) & jnp.uint8(1) for j in range(8)]
        valid = jnp.stack(vparts, axis=-1).reshape(b, lq * 4)
        out = jnp.where(valid != 0, out, jnp.uint8(_INVALID))
    return out


@partial(jax.jit, static_argnames=("num_reads",))
def expand_vrows(
    vrow_idx: jax.Array, vrows: jax.Array, num_reads: int
) -> jax.Array:
    """Lean validity transport -> dense [B, L/8] bitplane on device.

    ``vrows`` [D, L/8] carries validity rows only for reads that contain an
    ambiguous base; ``vrow_idx`` [D] their row indices (padding entries use
    an out-of-range index and are dropped).  Unlisted rows expand to
    all-ones: out-of-length bits don't matter because every consumer masks
    windows by per-read length.  One [B, L/8] fill + a D-row scatter —
    noise next to the 0.125 B/base the wire no longer carries."""
    plane = jnp.full((num_reads, vrows.shape[1]), 0xFF, dtype=jnp.uint8)
    return plane.at[vrow_idx].set(vrows, mode="drop")


def resolve_vbits(
    vbits: Optional[jax.Array],
    vrow_idx: Optional[jax.Array],
    vrows: Optional[jax.Array],
    num_reads: int,
) -> Optional[jax.Array]:
    """The one transport-shape switch for jitted steps: dense plane,
    lean rows (expanded on device), or None (clean batch)."""
    if vrows is not None:
        return expand_vrows(vrow_idx, vrows, num_reads)
    return vbits


def _compose_le(bytes2d: jax.Array) -> jax.Array:
    """Little-endian int32 from a [N, size] uint8 byte-plane slice —
    endian-independent (explicit shifts, no bitcast)."""
    w = bytes2d.astype(jnp.int32)
    out = w[:, 0]
    for i in range(1, bytes2d.shape[1]):
        out = out | (w[:, i] << (8 * i))
    return out


def unwire(wire: jax.Array, layout) -> tuple:
    """Split a coalesced one-buffer batch transport back into its planes,
    in-program (see :class:`needletail_tpu.batch.WireLayout` for the wire
    contract).  Returns ``(codes, lengths_i32, vbits, vrow_idx, vrows)``
    with the same None-conventions as the multi-array transport; slices
    are static so XLA fuses them into the consuming kernels."""
    b, l4, l8, len_size, vcap, vmode = (
        layout.num_reads, layout.l4, layout.l8,
        layout.len_size, layout.vcap, layout.vmode,
    )
    codes = wire[: b * l4].reshape(b, l4)
    o = layout.codes_end
    vbits = vrow_idx = vrows = None
    if vmode == 1:
        vbits = wire[o : o + b * l8].reshape(b, l8)
    elif vmode == 2:
        vrows = wire[o : o + vcap * l8].reshape(vcap, l8)
    o = layout.val_end
    if len_size == 1:
        lengths = wire[o : o + b].astype(jnp.int32)
    else:
        lengths = _compose_le(wire[o : o + b * len_size].reshape(b, len_size))
    if vmode == 2:
        o = layout.len_end
        vrow_idx = _compose_le(wire[o : o + vcap * 4].reshape(vcap, 4))
    return codes, lengths, vbits, vrow_idx, vrows


@partial(jax.jit, static_argnames=("normalized",))
def encode_2bit(seqs: jax.Array, normalized: bool = True) -> jax.Array:
    """Map bytes to 2-bit codes (A=0 C=1 G=2 T=3; 255 = invalid).

    ``normalized=True`` composes strict normalization first, so U/u encode as
    T and IUPAC codes are invalid — matching the reference README pipeline
    (normalize -> kmers).  ``normalized=False`` is the raw ``bit_kmers`` LUT
    (ref bitkmer.rs:5-18): only ACGT/acgt valid.

    Implemented as a branchless select chain rather than a 256-entry
    ``jnp.take``, so XLA fuses it with its consumers as plain elementwise
    work instead of a gather.
    """
    up = seqs & jnp.uint8(0xDF)  # case-fold: clears the lowercase bit
    code = jnp.where(
        up == jnp.uint8(ord("A")),
        jnp.uint8(0),
        jnp.where(
            up == jnp.uint8(ord("C")),
            jnp.uint8(1),
            jnp.where(
                up == jnp.uint8(ord("G")),
                jnp.uint8(2),
                jnp.uint8(3),
            ),
        ),
    )
    is_t = up == jnp.uint8(ord("T"))
    if normalized:
        is_t = is_t | (up == jnp.uint8(ord("U")))
    valid = (
        (up == jnp.uint8(ord("A")))
        | (up == jnp.uint8(ord("C")))
        | (up == jnp.uint8(ord("G")))
        | is_t
    )
    return jnp.where(valid, code, jnp.uint8(_INVALID))

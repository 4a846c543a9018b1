"""Doubling-ladder window packing, parameterized by the roll primitive.

``device.kmers`` builds its windows from these power-of-two ladders with
``jnp.roll``; XLA fuses the shift/roll/select chains into loop fusions.

Ladder semantics over codes [*, L] uint32 (2-bit base codes, 255 invalid):

  * ``W[m][..., p]`` packs codes[p..p+m-1], first base most significant
  * ``R[m][..., p]`` packs the reverse complement (start base least
    significant): R[2m](p) = (R[m](p+m) << 2m) | R[m](p)
  * ``V[m][..., p]`` nonzero iff all m codes are unambiguous bases

``roll_left(x, j)`` must satisfy rolled[..., p] == x[..., p + j] with
wrap-around; wrapped lanes only reach windows the caller's in-bounds mask
rejects (window p needs p + k <= length <= L).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

Roll = Callable[[jax.Array, int], jax.Array]


def build_ladders(
    codes: jax.Array, k: int, roll_left: Roll, need_rc: bool
) -> Tuple[Dict[int, jax.Array], Optional[Dict[int, jax.Array]], Dict[int, jax.Array]]:
    W = {1: codes}
    R = {1: ~codes & jnp.uint32(3)} if need_rc else None
    V = {1: jnp.where(codes < jnp.uint32(4), jnp.uint32(1), jnp.uint32(0))}
    for m in (1, 2, 4, 8):
        if 2 * m > k:
            break
        W[2 * m] = (W[m] << jnp.uint32(2 * m)) | roll_left(W[m], m)
        if need_rc:
            R[2 * m] = (roll_left(R[m], m) << jnp.uint32(2 * m)) | R[m]
        V[2 * m] = V[m] & roll_left(V[m], m)
    return W, R, V


def compose_fwd(W, width: int, roll_left: Roll) -> jax.Array:
    """W-ladder entry for an arbitrary width (first base most significant)."""
    acc = None
    off = 0
    for m in (16, 8, 4, 2, 1):
        if width & m:
            part = roll_left(W[m], off)
            acc = part if acc is None else (acc << jnp.uint32(2 * m)) | part
            off += m
    return acc


def compose_rc(R, width: int, roll_left: Roll) -> jax.Array:
    """R-ladder entry: rc of window [p, p+width), accumulating low-to-high:
    R[a+b](p) = (R[b](p+a) << 2a) | R[a](p)."""
    acc = None
    off = 0
    for m in (1, 2, 4, 8, 16):
        if width & m:
            part = roll_left(R[m], off)
            acc = part if acc is None else (part << jnp.uint32(2 * off)) | acc
            off += m
    return acc


def compose_valid(V, width: int, roll_left: Roll) -> jax.Array:
    acc = None
    off = 0
    for m in (16, 8, 4, 2, 1):
        if width & m:
            part = roll_left(V[m], off)
            acc = part if acc is None else acc & part
            off += m
    return acc


def canonical_parts(
    codes: jax.Array, k: int, roll_left: Roll
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """(fwd_hi, fwd_lo, rc_hi, rc_lo, valid_u) for every window position.

    hi holds the first k-16 bases for k > 16 (zero otherwise); lo the last
    16 (or all k).  Canonical selection and bounds masking stay with the
    caller.  ``valid_u`` is uint32 0/1.
    """
    W, R, V = build_ladders(codes, k, roll_left, need_rc=True)
    valid_u = compose_valid(V, k, roll_left)
    zeros = jnp.zeros_like(codes)
    if k <= 16:
        fwd_lo = compose_fwd(W, k, roll_left)
        fwd_hi = zeros
        rc_lo = compose_rc(R, k, roll_left)
        rc_hi = zeros
    else:
        m_hi = k - 16
        fwd_hi = compose_fwd(W, m_hi, roll_left)  # first k-16 bases
        fwd_lo = roll_left(W[16], m_hi)  # last 16 bases
        rc_lo = R[16]  # rc of the first 16 bases
        # rc of the last m_hi bases = bases p+16..p+k-1
        rc_hi = roll_left(compose_rc(R, m_hi, roll_left), 16)
    return fwd_hi, fwd_lo, rc_hi, rc_lo, valid_u

"""Shared per-shard spectrum resolver for the sharded exact paths.

``exact.py`` and ``multik.py`` both end a flush the same way: per-shard
lexicographic sort + run-length count (``device/count.unique_counts``)
followed, on real accelerators, by distinct-to-front compaction
(``device/count.compact_runs_device``) so only each shard's distinct
entries cross the host link.

``narrow=True`` (keys that fit one uint32, k <= 15: 2k <= 30 bits stays
below the 0xFFFFFFFF sentinel) drops the hi plane end-to-end: the flush
sort runs single-key and resolvers take/return only the lo buffer.

No reference equivalent (needletail is single-threaded; ref
src/parser/mod.rs:85 ff. is a pull iterator).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..device import count as _count

__all__ = ["make_sharded_resolver"]

ResolveFn = Callable[..., Tuple]


def make_sharded_resolver(
    mesh: Mesh, device_compact: bool, narrow: bool = False
) -> ResolveFn:
    """Build ``resolve(buf_hi, buf_lo) -> (hi_c, lo_c, counts_c, ns)``
    (or, with ``narrow``, ``resolve(buf_lo) -> (lo_c, counts_c, ns)``).

    Per shard of the ``data`` axis: sort the buffered key lanes, run-length
    count, and (when ``device_compact``) move the distinct entries to a
    front prefix with per-shard length ``ns``.
    """
    nbuf = 1 if narrow else 2

    def _split(bufs):
        return (None, bufs[0]) if narrow else (bufs[0], bufs[1])

    def _resolve(*bufs):
        hi_s, lo_s, counts = _count.unique_counts(*_split(bufs))
        if device_compact:
            hi_s, lo_s, counts, n = _count.compact_runs_device(
                hi_s, lo_s, counts
            )
        else:
            n = jnp.sum((counts > 0).astype(jnp.int32))
        out = (lo_s, counts, n.reshape(1))
        return out if narrow else (hi_s, *out)

    return jax.jit(
        jax.shard_map(
            _resolve,
            mesh=mesh,
            in_specs=(P("data"),) * nbuf,
            out_specs=(P("data"),) * (nbuf + 2),
        ),
        donate_argnums=tuple(range(nbuf)),
    )

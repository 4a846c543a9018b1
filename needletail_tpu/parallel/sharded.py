"""Sharded k-mer counting: data-parallel reads, table-parallel spectra.

Design (BASELINE.json north star; no reference equivalent — needletail is
single-threaded):

  * Reads are sharded over the WHOLE mesh (flattened ``(data, table)``
    axes) so every device extracts a distinct read shard — extraction is
    never replicated across table columns.
  * Each device histograms its windows into a full local ``[4^k]`` table,
    then counts route to their owners with one ``psum_scatter`` over the
    ``table`` axis (column ``t`` owns the contiguous key range
    ``[t*S, (t+1)*S)``, ``S = 4^k / n_table``) followed by a ``psum``
    over ``data`` — both collectives between devices.
  * The streaming state keeps the table sharded ``P('table')`` as uint32
    limb pairs (exact past int32 per bin).

Exactness: integer adds commute, so the sharded result equals the
single-device spectrum bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..device import kmers as _kmers

__all__ = [
    "sharded_spectrum",
    "CountState",
    "init_count_state",
    "update_count_state",
    "HashCountState",
    "make_hash_update_step",
    "sharded_hash_count_file",
]


def _check_dense_k(k: int) -> None:
    """The dense sharded table keys on ``win.lo`` alone, which is only the
    full k-mer for k <= 15 (k = 16 fills all 32 bits and goes negative as
    int32; k > 16 splits into (hi, lo) and would alias).  Practical dense
    tables stop at MAX_DENSE_K anyway."""
    from ..device.count import MAX_DENSE_K

    if not 1 <= k <= MAX_DENSE_K:
        raise ValueError(
            f"dense sharded spectrum needs k in [1, {MAX_DENSE_K}], got {k}; "
            "use make_hash_update_step for larger k"
        )


def _local_partial_spectrum(seqs, lengths, k: int, canonical: bool, normalized: bool):
    """Per-device body: extract THIS device's read shard once (reads are
    sharded over the flattened (data, table) axes — no replicated
    extraction across table columns), histogram into a full local [4^k]
    table, then route counts to their owners: a reduce-scatter over
    ``table`` hands column t its key range, and a psum over ``data``
    merges the data rows.  Integer adds commute, so the result is exact
    and identical to the single-device spectrum."""
    fn = _kmers.canonical_kmers if canonical else _kmers.pack_kmers
    win = fn(seqs, lengths, k, normalized=normalized)
    keys = jnp.where(win.valid, win.lo.astype(jnp.int32), 0).reshape(-1)
    weights = win.valid.astype(jnp.int32).reshape(-1)
    local = jnp.zeros((4**k,), dtype=jnp.int32).at[keys].add(weights)
    part = jax.lax.psum_scatter(local, "table", scatter_dimension=0, tiled=True)
    return jax.lax.psum(part, axis_name="data")


def sharded_spectrum(
    mesh: Mesh,
    seqs: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
) -> jax.Array:
    """Global dense spectrum [4^k], sharded over the ``table`` axis.

    ``seqs``/``lengths`` lead dims must divide data*table (reads shard
    over the whole mesh so extraction never replicates).
    """
    _check_dense_k(k)
    fn = jax.jit(
        jax.shard_map(
            partial(
                _local_partial_spectrum,
                k=k,
                canonical=canonical,
                normalized=normalized,
            ),
            mesh=mesh,
            in_specs=(P(("data", "table"), None), P(("data", "table"))),
            out_specs=P("table"),
        )
    )
    return fn(seqs, lengths)


from ..utils.limbs import acc64 as _acc64
from ..utils.limbs import limbs_to_int as _limbs_to_int


def _limb_table_to_int64(lo, hi) -> "np.ndarray":
    """Combine uint32 limb-pair table shards into one int64 numpy array.

    Syncs device→host; only valid when the limbs are addressable (single
    process, or after a gather in multi-process jobs)."""
    from ..utils.limbs import limbs_to_int64_array

    return limbs_to_int64_array(lo, hi)


@jax.tree_util.register_dataclass
@dataclass
class CountState:
    """Streaming count-table state: the global spectrum as uint32 limb
    pairs (sharded over ``table``; exact past the int32 per-bin ceiling —
    per-step increments are int32, limbs carry via ``_acc64``) plus
    running base/read tallies (replicated limb pairs; read them via
    ``.n_bases``/``.n_reads``).  ``.table`` combines the limbs into an
    int64 numpy array (syncs; in multi-process jobs gather the limbs
    first — they are the raw fields)."""

    table_lo: jax.Array  # uint32 [4^k], sharded P('table')
    table_hi: jax.Array  # uint32 [4^k], sharded P('table')
    n_bases_lo: jax.Array
    n_bases_hi: jax.Array
    n_reads_lo: jax.Array
    n_reads_hi: jax.Array

    @property
    def table(self) -> "np.ndarray":
        """int64 [4^k] numpy view of the count table (syncs)."""
        return _limb_table_to_int64(self.table_lo, self.table_hi)

    @property
    def n_bases(self) -> int:
        return _limbs_to_int(self.n_bases_lo, self.n_bases_hi)

    @property
    def n_reads(self) -> int:
        return _limbs_to_int(self.n_reads_lo, self.n_reads_hi)


def init_count_state(mesh: Mesh, k: int) -> CountState:
    """Zero state with the table laid out across the ``table`` axis."""
    _check_dense_k(k)
    sharding = NamedSharding(mesh, P("table"))
    # distinct buffers: the update step donates the whole state pytree and
    # aliased buffers cannot be donated twice
    return CountState(
        table_lo=jax.device_put(jnp.zeros((4**k,), dtype=jnp.uint32), sharding),
        table_hi=jax.device_put(jnp.zeros((4**k,), dtype=jnp.uint32), sharding),
        n_bases_lo=jnp.zeros((), dtype=jnp.uint32),
        n_bases_hi=jnp.zeros((), dtype=jnp.uint32),
        n_reads_lo=jnp.zeros((), dtype=jnp.uint32),
        n_reads_hi=jnp.zeros((), dtype=jnp.uint32),
    )


def make_update_step(
    mesh: Mesh,
    k: int,
    canonical: bool = True,
    normalized: bool = True,
    donate: bool = True,
):
    """Build the jitted streaming step: (state, batch) -> state.

    This is the framework's "training step": shard the incoming batch over
    ``data``, accumulate into the table shards over ``table``.
    ``donate=False`` keeps the input state alive (at the cost of a table
    copy per step) for callers that inspect or checkpoint it afterwards.
    """
    _check_dense_k(k)

    # reads shard over the WHOLE mesh (extraction runs once per device,
    # never replicated across table columns); the table stays P('table')
    data_sharding = NamedSharding(mesh, P(("data", "table"), None))
    len_sharding = NamedSharding(mesh, P(("data", "table")))
    table_sharding = NamedSharding(mesh, P("table"))

    @partial(jax.jit, donate_argnums=(0,) if donate else ())
    def step(state: CountState, seqs: jax.Array, lengths: jax.Array) -> CountState:
        spec = jax.shard_map(
            partial(
                _local_partial_spectrum,
                k=k,
                canonical=canonical,
                normalized=normalized,
            ),
            mesh=mesh,
            in_specs=(P(("data", "table"), None), P(("data", "table"))),
            out_specs=P("table"),
        )(seqs, lengths)
        nb_lo, nb_hi = _acc64(
            state.n_bases_lo, state.n_bases_hi, jnp.sum(lengths.astype(jnp.int32))
        )
        # count only rows carrying bases so zero-padded rows (pad_reads_to)
        # don't inflate the tally; note this also skips legitimately empty
        # records — the base tally is always exact
        nr_lo, nr_hi = _acc64(
            state.n_reads_lo,
            state.n_reads_hi,
            jnp.sum((lengths > 0).astype(jnp.int32)),
        )
        # elementwise limb accumulate: per-step bin increments are int32
        # (bounded by batch lanes), the running table is exact to 2^64
        t_lo, t_hi = _acc64(state.table_lo, state.table_hi, spec)
        return CountState(
            table_lo=t_lo,
            table_hi=t_hi,
            n_bases_lo=nb_lo,
            n_bases_hi=nb_hi,
            n_reads_lo=nr_lo,
            n_reads_hi=nr_hi,
        )

    def place_batch(seqs, lengths):
        return (
            jax.device_put(seqs, data_sharding),
            jax.device_put(lengths, len_sharding),
        )

    return step, place_batch, table_sharding


# Bounded (mesh, k) -> step cache: evicts least-recently-used entries so
# long-lived processes that churn through many Mesh objects don't pin every
# mesh + compiled executable forever.
_UPDATE_STEP_CACHE: "dict" = {}
_UPDATE_STEP_CACHE_MAX = 8


def update_count_state(
    mesh: Mesh, state: CountState, seqs, lengths, k: int
) -> CountState:
    """One-off convenience wrapper over ``make_update_step``.

    Non-donating (the caller's state stays readable afterwards) and cached
    per (mesh, k) so repeated calls don't rebuild/recompile the step.
    """
    key = (mesh, k)
    if key in _UPDATE_STEP_CACHE:
        _UPDATE_STEP_CACHE[key] = _UPDATE_STEP_CACHE.pop(key)  # mark recent
    else:
        while len(_UPDATE_STEP_CACHE) >= _UPDATE_STEP_CACHE_MAX:
            _UPDATE_STEP_CACHE.pop(next(iter(_UPDATE_STEP_CACHE)))
        _UPDATE_STEP_CACHE[key] = make_update_step(mesh, k, donate=False)
    step, place, _ = _UPDATE_STEP_CACHE[key]
    s, l = place(jnp.asarray(seqs), jnp.asarray(lengths))
    return step(state, s, l)


# ---------------------------------------------------------------------------
# Production hash-table pipeline
# ---------------------------------------------------------------------------
#
# The dense path above replicates extraction across the ``table`` axis,
# which scales extraction cost with the table factor.  In the hash
# pipeline below every device hashes ITS OWN read shard only
# (``hashcount.canonical_hash_keys`` + ``hash_histogram``), and the
# per-device [2^16] tables merge with one ``psum_scatter`` over the
# ``data`` axis — a 256 KiB reduce-scatter per step, after which device d
# owns the contiguous global-bin range [d*2^16/N, (d+1)*2^16/N).  No key
# routing, and exact (integer adds are order-independent).  The tradeoff
# against an all-to-all-routed larger table is bin count: routing keys to
# their owners would need an owner-sorted compaction per step.


@jax.tree_util.register_dataclass
@dataclass
class HashCountState:
    """Streaming hash-spectrum state: [2^table_bits] global table sharded
    over ``data`` (each chip owns a contiguous bin range after the
    reduce-scatter) plus replicated tallies.  Table and tallies are uint32
    limb pairs — exact past the int32 ceiling even for skewed hash bins
    (e.g. homopolymer-dominated corpora); read via ``.table``/``.total``/
    ``.fwd``."""

    table_lo: jax.Array  # uint32 [2^table_bits], sharded P('data')
    table_hi: jax.Array  # uint32 [2^table_bits], sharded P('data')
    total_lo: jax.Array
    total_hi: jax.Array
    fwd_lo: jax.Array
    fwd_hi: jax.Array

    @property
    def table(self) -> "np.ndarray":
        """int64 [2^table_bits] numpy view of the hash table (syncs)."""
        return _limb_table_to_int64(self.table_lo, self.table_hi)

    @property
    def total(self) -> int:
        """Valid canonical windows counted so far (Python int, syncs)."""
        return _limbs_to_int(self.total_lo, self.total_hi)

    @property
    def fwd(self) -> int:
        """Windows where the forward strand won (Python int, syncs)."""
        return _limbs_to_int(self.fwd_lo, self.fwd_hi)


def make_hash_update_step(
    mesh: Mesh,
    k: int,
    table_bits: int = 16,
    normalized: bool = True,
    packed: bool = False,
):
    """Build the jitted hash-counting step over a 1-axis ``data`` mesh
    (or the ``data`` axis of a 2-axis mesh; the ``table`` axis, if any,
    must be 1 for this pipeline — the hash table shards over ``data``).

    Returns ``(init, step, place_batch)``.

    ``packed=True``: the step consumes the 2-bit packed transport —
    ``step(state, codes, lengths, vbits)`` with ``vbits=None`` for clean
    batches; each chip unpacks its own shard (the interleave stays local,
    nothing extra crosses the interconnect) so host->device transfer per
    device drops 4x.
    """
    from ..device.hashcount import (
        canonical_hash_keys,
        canonical_hash_keys_packed,
        check_table_bits,
        hash_histogram,
    )

    n_data = mesh.shape["data"]
    if "table" in mesh.shape and mesh.shape["table"] != 1:
        raise ValueError(
            "hash pipeline shards its table over 'data'; use a mesh with "
            f"table=1 (got table={mesh.shape['table']})"
        )
    check_table_bits(table_bits)
    n_bins = 1 << table_bits
    if n_bins % n_data:
        raise ValueError(f"2^{table_bits} bins not divisible by data={n_data}")

    data_sharding = NamedSharding(mesh, P("data", None))
    len_sharding = NamedSharding(mesh, P("data"))
    table_sharding = NamedSharding(mesh, P("data"))

    def _local(table_lo_shard, table_hi_shard, seqs, lengths, vbits=None):
        if packed:
            keys, total, fwd = canonical_hash_keys_packed(
                seqs, vbits, lengths, k, table_bits=table_bits,
            )
        else:
            keys, total, fwd = canonical_hash_keys(
                seqs, lengths, k, table_bits=table_bits,
                normalized=normalized,
            )
        local = hash_histogram(keys, n_bins)
        # the reduce-scatter stays int32 (per-step increments are bounded
        # by batch lanes); limbs carry locally after the merge
        upd = jax.lax.psum_scatter(local, "data", scatter_dimension=0, tiled=True)
        lo, hi = _acc64(table_lo_shard, table_hi_shard, upd)
        return (
            lo,
            hi,
            jax.lax.psum(total, "data"),
            jax.lax.psum(fwd, "data"),
        )

    base_specs = (P("data"), P("data"), P("data", None), P("data"))
    shard_kwargs = dict(
        mesh=mesh,
        out_specs=(P("data"), P("data"), P(), P()),
    )
    local_fn = jax.shard_map(_local, in_specs=base_specs, **shard_kwargs)
    # packed batches with ambiguous bases carry a validity plane; clean
    # ones don't — two shard_map signatures, selected at trace time
    local_fn_vb = (
        jax.shard_map(
            _local, in_specs=base_specs + (P("data", None),), **shard_kwargs
        )
        if packed
        else None
    )

    @partial(jax.jit, donate_argnums=(0,))
    def step(state: HashCountState, seqs, lengths, vbits=None) -> HashCountState:
        if vbits is None:
            lo, hi, total, fwd = local_fn(
                state.table_lo, state.table_hi, seqs, lengths
            )
        else:
            lo, hi, total, fwd = local_fn_vb(
                state.table_lo, state.table_hi, seqs, lengths, vbits
            )
        t_lo, t_hi = _acc64(state.total_lo, state.total_hi, total)
        f_lo, f_hi = _acc64(state.fwd_lo, state.fwd_hi, fwd)
        return HashCountState(
            table_lo=lo,
            table_hi=hi,
            total_lo=t_lo,
            total_hi=t_hi,
            fwd_lo=f_lo,
            fwd_hi=f_hi,
        )

    def init() -> HashCountState:
        return HashCountState(
            table_lo=jax.device_put(jnp.zeros((n_bins,), jnp.uint32), table_sharding),
            table_hi=jax.device_put(jnp.zeros((n_bins,), jnp.uint32), table_sharding),
            total_lo=jnp.zeros((), jnp.uint32),
            total_hi=jnp.zeros((), jnp.uint32),
            fwd_lo=jnp.zeros((), jnp.uint32),
            fwd_hi=jnp.zeros((), jnp.uint32),
        )

    def place_batch(seqs, lengths, vbits=None):
        placed = (
            jax.device_put(seqs, data_sharding),
            jax.device_put(lengths, len_sharding),
        )
        if vbits is None:
            return placed
        return placed + (jax.device_put(vbits, data_sharding),)

    return init, step, place_batch


def sharded_hash_count_file(
    path,
    k: int,
    mesh: Mesh,
    table_bits: int = 16,
    batch_size: int = 65536,
    max_len: Optional[int] = None,
    normalized: bool = True,
    host_workers: Optional[int] = None,
    spill_dir: Optional[str] = None,
    packed: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    meter=None,
):
    """Stream a FASTX file through the sharded hash pipeline — the mesh
    twin of ``device.pipeline.hash_count_file`` (same framing front, same
    return ``(n_bases, total, fwd, table)``, bit-identical table).

    Reads shard over ``data``; each device hashes its shard and one
    ``psum_scatter`` merges the per-device histograms into the bin range
    each device owns (``make_hash_update_step``).

    Checkpoints use the SAME ``kind="hash"`` format as the flat driver
    (global table + tallies + record-aligned offset), so a stream
    checkpointed on one mesh size resumes on another — or on a single
    chip — unchanged.  ``meter=`` attributes wall clock like the other
    sharded drivers (frame / dispatch / drain / wall; H2D rides inside
    the shard placement)."""
    import time as _time

    import numpy as np

    from ..device.pipeline import _make_batch_source
    from ..utils.profiling import metered_iter
    from .checkpoint import (
        checkpoint_source,
        checkpointed_batches,
        prepare_checkpoint_stream,
    )
    from .exact import _require_single_process

    _require_single_process("sharded_hash_count_file")
    if packed is None:
        packed = True
    n_data = mesh.shape["data"]
    batch_size = -(-batch_size // n_data) * n_data
    init, step, place = make_hash_update_step(
        mesh, k, table_bits=table_bits, normalized=normalized,
        packed=packed,
    )

    def _validate(ck):
        bits = int(ck["meta"].get("table_bits", table_bits))
        if bits != table_bits:
            raise ValueError(
                f"checkpoint {resume_from!r} has table_bits={bits}, "
                f"expected {table_bits}"
            )

    ckpt_mode, ck = prepare_checkpoint_stream(
        "hash", k,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        resume_from=resume_from, host_workers=host_workers,
        validate=_validate, normalized=normalized,
    )
    n_bases = 0
    start_offset = 0
    state = init()
    if ck is not None:
        from jax.sharding import NamedSharding as _NS

        from ..utils.limbs import int64_array_to_limbs

        start_offset = ck["file_offset"]
        n_bases = ck["n_bases"]
        lo0, hi0 = int64_array_to_limbs(ck["arrays"]["table"])
        sh = _NS(mesh, P("data"))
        total0 = int(ck["meta"]["total"])
        fwd0 = int(ck["meta"]["fwd"])
        state = HashCountState(
            table_lo=jax.device_put(jnp.asarray(lo0), sh),
            table_hi=jax.device_put(jnp.asarray(hi0), sh),
            total_lo=jnp.asarray(total0 & 0xFFFFFFFF, jnp.uint32),
            total_hi=jnp.asarray(total0 >> 32, jnp.uint32),
            fwd_lo=jnp.asarray(fwd0 & 0xFFFFFFFF, jnp.uint32),
            fwd_hi=jnp.asarray(fwd0 >> 32, jnp.uint32),
        )
    if ckpt_mode:
        batches = checkpoint_source(
            path, batch_size, max_len, False, packed, normalized,
            start_offset, require_offsets=checkpoint_every is not None,
        )
    else:
        batches, _ = _make_batch_source(
            path, batch_size, max_len, host_workers,
            with_quals=False, spill_dir=spill_dir,
            packed=packed, normalized=normalized,
        )

    def _save_ckpt(offset):
        from .checkpoint import counting_meta, save_stream_checkpoint

        save_stream_checkpoint(
            checkpoint_path, "hash", k, offset, n_bases,
            {"table": state.table}, input_path=str(path),
            meta={
                "table_bits": np.int32(table_bits),
                "total": np.int64(state.total),
                "fwd": np.int64(state.fwd),
                **counting_meta(normalized=normalized),
            },
        )

    t_wall0 = _time.perf_counter()
    batches = checkpointed_batches(batches, checkpoint_every, _save_ckpt)
    if meter is not None:
        batches = metered_iter(
            meter, "frame", batches, items_of=lambda b: b.num_bases
        )
    for batch in batches:
        n_bases += batch.num_bases
        t0 = _time.perf_counter() if meter is not None else 0.0
        if batch.max_len >= k:
            b = (
                batch
                if batch.num_reads == batch_size
                else batch.pad_reads_to(batch_size)
            )
            if packed:
                vb = b.dense_vbits()
                placed = place(
                    jnp.asarray(b.codes), jnp.asarray(b.lengths),
                    None if vb is None else jnp.asarray(vb),
                )
            else:
                placed = place(jnp.asarray(b.seqs), jnp.asarray(b.lengths))
            state = step(state, *placed)
        if meter is not None:
            meter.add(
                "dispatch", _time.perf_counter() - t0, items=batch.num_bases
            )
    t_drain = _time.perf_counter()
    table = state.table
    total = state.total
    fwd = state.fwd
    if meter is not None:
        now = _time.perf_counter()
        meter.add("drain", now - t_drain, nbytes=table.nbytes)
        meter.add("wall", now - t_wall0, items=n_bases)
    return n_bases, total, fwd, table

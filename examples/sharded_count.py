"""Sharded hash counting across every available device.

    python examples/sharded_count.py reads.fq --k 21

On a multi-host cluster each host runs this same program (SPMD) over its own
byte range (see ``needletail_tpu.parallel.distributed``); on one host it
demonstrates the mesh + psum_scatter table merge.  To try it without GPU
hardware:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/sharded_count.py tests/data/PRJNA271013_head.fq
"""

import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument(
        "--exact",
        action="store_true",
        help="exact per-k-mer spectrum (per-chip sorts + host merge) "
        "instead of the collision-accumulating hash table",
    )
    ap.add_argument(
        "--bucketed",
        action="store_true",
        help="length-bucketed framing: one compiled step per bucket "
        "width so pad lanes track real bases on mixed-length corpora",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from needletail_tpu.io.fast_batch import fast_read_batches
    from needletail_tpu.parallel import make_hash_update_step, make_mesh

    devices = jax.devices()

    if args.exact:
        from needletail_tpu.parallel import sharded_count_file

        mesh = make_mesh(devices, data=len(devices), table=1)
        t0 = time.perf_counter()
        n_bases, (keys, counts) = sharded_count_file(
            args.path, args.k, mesh=mesh, batch_size=args.batch_size
        )
        elapsed = time.perf_counter() - t0
        print(
            f"{len(devices)} devices (exact): {n_bases} bases, "
            f"{int(counts.sum())} canonical {args.k}-mers, "
            f"{len(keys)} distinct, in {elapsed:.2f}s"
        )
        return
    mesh = make_mesh(devices, data=len(devices), table=1)
    init, step, place = make_hash_update_step(mesh, args.k)
    state = init()

    if args.bucketed:
        from needletail_tpu.io.bucketed import bucketed_read_batches

        batches = bucketed_read_batches(
            args.path, batch_size=args.batch_size, with_quals=False
        )
    else:
        batches = fast_read_batches(args.path, batch_size=args.batch_size)

    n_bases = 0
    t0 = time.perf_counter()
    for batch in batches:
        n_bases += batch.num_bases
        if batch.max_len < args.k:
            continue  # no window fits; bases still counted
        b = batch if batch.num_reads == args.batch_size else batch.pad_reads_to(args.batch_size)
        state = step(state, *place(jnp.asarray(b.seqs), jnp.asarray(b.lengths)))
    total = state.total  # syncs
    elapsed = time.perf_counter() - t0

    table = state.table  # int64 numpy (gathers the limb shards)
    print(
        f"{len(devices)} devices ({dict(mesh.shape)}): {n_bases} bases, "
        f"{total} canonical {args.k}-mers ({state.fwd} forward) "
        f"in {elapsed:.2f}s"
    )
    print(f"table: {table.shape[0]} bins, {int((table > 0).sum())} nonzero")


if __name__ == "__main__":
    main()

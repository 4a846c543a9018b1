"""Worker for the multi-process hash-pipeline test (test_multiprocess.py).

Each process owns a disjoint byte range of the input FASTQ (BASELINE
config #5 shape: per-host streams over DCN, table merge over ICI), frames
it locally, and participates in the SPMD hash-counting step over the
global mesh.  Process 0 writes the all-gathered table + tallies to an
npz for the parent test to compare against a single-process oracle.
"""

import os
import sys


def main() -> None:
    path, out, port, pid_s, n_s, rows_s = sys.argv[1:7]
    pid, n, rows_local = int(pid_s), int(n_s), int(rows_s)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from needletail_tpu.parallel.distributed import (
        initialize,
        read_range,
        split_fastx_ranges,
    )

    initialize(
        coordinator_address=f"localhost:{port}", num_processes=n, process_id=pid
    )

    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from needletail_tpu.parallel import make_hash_update_step, make_mesh

    devices = jax.devices()
    mesh = make_mesh(devices, data=len(devices), table=1)
    init, step, _ = make_hash_update_step(mesh, k=21)

    # frame this process's byte range into a fixed local batch
    start, end = split_fastx_ranges(path, n)[pid]
    reader = read_range(path, start, end)
    max_len = 128
    seqs = np.zeros((rows_local, max_len), np.uint8)
    lengths = np.zeros((rows_local, ), np.int32)
    i = 0
    while (rec := reader.next()) is not None:
        s = rec.seq()
        assert i < rows_local and len(s) <= max_len
        seqs[i, : len(s)] = np.frombuffer(s, np.uint8)
        lengths[i] = len(s)
        i += 1

    data_sharding = NamedSharding(mesh, P("data", None))
    len_sharding = NamedSharding(mesh, P("data"))
    gs = jax.make_array_from_process_local_data(data_sharding, seqs)
    gl = jax.make_array_from_process_local_data(len_sharding, lengths)

    state = step(init(), gs, gl)
    # all-gather the data-sharded limb tables so process 0 can dump the
    # combined int64 table whole
    full_lo, full_hi = jax.jit(
        lambda lo, hi: (lo, hi),
        out_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P())),
    )(state.table_lo, state.table_hi)
    table = np.asarray(jax.device_get(full_lo)).astype(np.int64) + (
        np.asarray(jax.device_get(full_hi)).astype(np.int64) << 32
    )
    if pid == 0:
        np.savez(
            out,
            table=table,
            total=int(state.total),
            fwd=int(state.fwd),
            local_records=i,
        )
    print(f"[p{pid}] records={i} total={int(state.total)}", flush=True)


if __name__ == "__main__":
    main()

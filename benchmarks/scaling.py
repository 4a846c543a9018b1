#!/usr/bin/env python3
"""Scaling efficiency of the sharded hash pipeline (BASELINE metric #3:
reads/s at 1 chip .. N chips).

Weak scaling: every chip gets the same per-chip batch; perfect scaling
is reads/s proportional to chips (the per-step collective is one 256 KiB
``psum_scatter`` riding ICI).  Run on real hardware for meaningful
numbers; on the CPU simulator this validates the sweep mechanics only:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python benchmarks/scaling.py --per-chip-reads 512 --steps 3

Prints one JSON line per mesh size:
  {"devices": n, "reads_per_sec": r, "bases_per_sec": b, "efficiency": e}
"""

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--read-len", type=int, default=128)
    ap.add_argument("--per-chip-reads", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from needletail_tpu.parallel import make_hash_update_step, make_mesh

    all_devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(all_devices)]
    rng = np.random.default_rng(0)
    base = None
    for n in sizes:
        mesh = make_mesh(all_devices[:n], data=n, table=1)
        init, step, place = make_hash_update_step(mesh, args.k)
        rows = args.per_chip_reads * n
        seqs = rng.choice(
            np.frombuffer(b"ACGT", np.uint8), size=(rows, args.read_len)
        ).astype(np.uint8)
        lengths = np.full(rows, args.read_len, np.int32)
        s, l = place(jnp.asarray(seqs), jnp.asarray(lengths))
        state = step(init(), s, l)  # compile + warm
        jax.block_until_ready(state.table_lo)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step(state, s, l)
        jax.block_until_ready(state.table_lo)
        dt = time.perf_counter() - t0
        reads_per_sec = rows * args.steps / dt
        if base is None:
            base = reads_per_sec
        print(
            json.dumps(
                {
                    "devices": n,
                    "reads_per_sec": round(reads_per_sec, 1),
                    "bases_per_sec": round(reads_per_sec * args.read_len, 1),
                    "efficiency": round(reads_per_sec / (base * n), 4),
                }
            )
        )


if __name__ == "__main__":
    main()

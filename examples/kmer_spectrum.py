#!/usr/bin/env python3
"""Device k-mer spectrum of a FASTX file.

    python examples/kmer_spectrum.py reads.fq.gz --k 21 --top 10

Streams the file through the native framer into the device k-mer engine
(halo-tiled for long records) and prints the most frequent canonical k-mers.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--tile-len", type=int, default=8192)
    ap.add_argument(
        "--long", action="store_true",
        help="use halo tiling (whole-genome records)",
    )
    args = ap.parse_args()

    import numpy as np

    from needletail_tpu.bitkmer import bitmer_to_bytes
    from needletail_tpu.device.pipeline import count_file
    from needletail_tpu.device.tiling import genome_spectrum

    t0 = time.perf_counter()
    if args.long:
        n_bases, spec = genome_spectrum(args.path, k=args.k, tile_len=args.tile_len)
    else:
        n_bases, spec = count_file(args.path, k=args.k)
    dt = time.perf_counter() - t0

    if isinstance(spec, dict):
        items = sorted(spec.items(), key=lambda kv: -kv[1])[: args.top]
    else:
        spec = np.asarray(spec)
        top_idx = np.argsort(spec)[::-1][: args.top]
        items = [(int(i), int(spec[i])) for i in top_idx if spec[i] > 0]

    print(f"{n_bases} bases in {dt:.2f}s ({n_bases/dt/1e6:.1f} Mbases/s)")
    for value, count in items:
        print(f"{bitmer_to_bytes((value, args.k)).decode()}\t{count}")


if __name__ == "__main__":
    main()

"""IO/compute overlap measurement for the crispr CLI.

The reference overlaps fastx parsing with search via a threaded
InputIterator + ordered output (bin/input_iterator.rs:56-205,
bin/grep.rs:476-582). Our CLI does the same with fastx.prefetch (reader
thread parses batch N+1 while batch N scans) plus async dispatch (batch
N+1's scan is in flight before batch N's results are fetched).

This script quantifies it on a genome-scale fasta:
  (a) parse-only:  iterate record batches through fastx.read_fastx
  (b) device-only: scan pre-parsed batches through the same engine calls
  (c) end-to-end:  the actual `sassy-tpu crispr` pipeline
and reports wall(c) vs max(a, b) (overlapped) vs a+b (serial).

Usage: python scripts/bench_io_overlap.py [genome_mb] [n_guides] [--gzip]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main() -> int:
    genome_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n_guides = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    use_gzip = "--gzip" in sys.argv
    k = 3
    n = genome_mb * 1_000_000

    rng = np.random.default_rng(11)
    genome = rng.choice(BASES, size=n)
    fa = "/tmp/io_overlap_genome.fa" + (".gz" if use_gzip else "")
    raw = b">chr1\n" + genome.tobytes() + b"\n"
    if use_gzip:
        import gzip

        with gzip.open(fa, "wb", compresslevel=1) as f:
            f.write(raw)
    else:
        with open(fa, "wb") as f:
            f.write(raw)
    # crispr requires all guides to share the PAM suffix (cli.py:374-379,
    # the reference's crispr.rs behavior): 20 random bases + fixed AGG
    guides = [
        bytes(rng.choice(BASES, size=20)) + b"AGG" for _ in range(n_guides)
    ]
    gf = "/tmp/io_overlap_guides.txt"
    with open(gf, "wb") as f:
        f.write(b"\n".join(guides) + b"\n")

    from sassy_tpu.io import fastx

    batch_bytes = 32 << 20

    def record_batches():
        pending, pb = [], 0
        for rec in fastx.read_fastx(fa):
            pending.append(rec)
            pb += len(rec.seq)
            if pb >= batch_bytes:
                yield pending
                pending, pb = [], 0
        if pending:
            yield pending

    # (a) parse-only
    t0 = time.perf_counter()
    batches = list(record_batches())
    t_parse = time.perf_counter() - t0
    print(f"(a) parse-only:  {t_parse:7.2f}s "
          f"({n / t_parse / 1e6:.0f} MB/s, {len(batches)} batches)")

    # (b) device-only on the pre-parsed batches (same engine path as crispr)
    from sassy_tpu import Searcher, profiles

    searcher = Searcher(profiles.Iupac(), rc=True).with_max_n_frac(0.2)
    texts0 = [r.seq for r in batches[0]]
    searcher.search_many_with_fn_async(guides, texts0, k, True, None)()  # warm
    t0 = time.perf_counter()
    nm = 0
    fin_prev = None
    for recs in batches:
        fin = searcher.search_many_with_fn_async(
            guides, [r.seq for r in recs], k, True, None
        )
        if fin_prev is not None:
            nm += len(fin_prev())
        fin_prev = fin
    nm += len(fin_prev())
    t_dev = time.perf_counter() - t0
    print(f"(b) device-only: {t_dev:7.2f}s ({nm} matches)")

    # (d) steady-state in-process pipeline: re-parse from disk through the
    # reader thread (fastx.prefetch, the CLI's own overlap mechanism) with
    # the engine warm — the wall a long-running server pays per file
    t0 = time.perf_counter()
    nm2 = 0
    fin_prev = None
    for recs in fastx.prefetch(record_batches()):
        fin = searcher.search_many_with_fn_async(
            guides, [r.seq for r in recs], k, True, None
        )
        if fin_prev is not None:
            nm2 += len(fin_prev())
        fin_prev = fin
    nm2 += len(fin_prev())
    t_steady = time.perf_counter() - t0
    print(f"(d) steady parse+search (reader thread overlap): {t_steady:7.2f}s"
          f" ({nm2} matches)")

    # (c) end-to-end crispr CLI (own process: cold compile excluded by a
    # tiny warmup run inside the same process is not possible; report both)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "sassy_tpu.cli", "crispr",
         "-g", gf, "-k", str(k), "--max-n-frac", "0.2",
         "-o", "/tmp/io_overlap_crispr.tsv", fa],
        capture_output=True, text=True,
        env={**os.environ, "SASSY_NO_BANNER": "1"},
    )
    t_e2e = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stderr[-2000:])
        return 1
    # the CLI prints its own in-process wall (post-import, incl. compile)
    inner = [ln for ln in r.stdout.splitlines() if "Time taken" in ln]
    print(f"(c) crispr e2e:  {t_e2e:7.2f}s process wall "
          f"({inner[0].strip() if inner else 'n/a'})")
    print(f"    serial model (a+b):     {t_parse + t_dev:7.2f}s")
    print(f"    overlapped model max(): {max(t_parse, t_dev):7.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time ShardedSearch's overhang (alpha) path at the off-targets shape.

Runs ``ShardedSearch`` on a 1 x D ('pat', 'text') mesh over every visible
card (32 x 23 bp x 128 Mbp, k=3), with ``alpha=0.5`` (position-level
selection) and ``alpha=None`` (word-level fast path), and prints the median
wall time of each, a digest of the candidate lists (equal digests across
values of ``--overhang-batch`` mean equal results), every card's
``peak_bytes_in_use`` afterwards, and, with
``--trace``, the top device ops of one traced alpha=0.5 call.

``--overhang-batch B`` replaces the engine's choice of how many local
patterns the overhang path runs at once (``jax.lax.map``'s ``batch_size``,
``sharded.overhang_batch_for``): 1 runs them one after another, 32 runs
all of them in one vmapped step. Peak memory is per process, so
compare values of B in separate processes:

    python scripts/bench_sharded_alpha.py --overhang-batch 1 --trace /tmp/t1
    python scripts/bench_sharded_alpha.py --overhang-batch 32
"""

import argparse
import glob
import gzip
import hashlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def top_device_ops(outdir, rows=12):
    """Print device time per card and the top ops summed over the cards."""
    tf = sorted(glob.glob(outdir + "/plugins/profile/*/*.trace.json.gz"))[-1]
    with gzip.open(tf, "rt") as f:
        ev = json.load(f)["traceEvents"]
    devpids = {e["pid"]: e["args"].get("name", "") for e in ev
               if e.get("ph") == "M" and e.get("name") == "process_name"
               and "/device:GPU" in e["args"].get("name", "")}
    per_pid = defaultdict(float)
    agg = defaultdict(float)
    cnt = defaultdict(int)
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in devpids:
            d = e.get("dur", 0) / 1e3
            per_pid[e["pid"]] += d
            agg[e.get("name", "?")] += d
            cnt[e.get("name", "?")] += 1
    for pid, name in sorted(devpids.items()):
        print(f"  device ms {per_pid[pid]:9.3f}  {name}")
    for nm, d in sorted(agg.items(), key=lambda kv: -kv[1])[:rows]:
        print(f"  {d:9.3f} ms x{cnt[nm]:<5d} {nm[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--overhang-batch", type=int, default=None,
                    help="patterns per overhang-path step (default: sized "
                         "by the engine from the shard)")
    ap.add_argument("--bp", type=int, default=128_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="trace dir for one call")
    args = ap.parse_args()

    import jax

    from sassy_tpu.parallel import ShardedSearch, ShardedText, make_mesh
    from sassy_tpu.parallel import sharded
    from sassy_tpu.profiles import Iupac

    if args.overhang_batch is not None:
        b = args.overhang_batch
        sharded.overhang_batch_for = lambda positions, q_local: min(b, q_local)

    devs = jax.devices()
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=args.bp, dtype=np.uint8)]
    guides = [rng.choice(bases, size=23) for _ in range(32)]
    for q, g in enumerate(guides):
        at = 1000 + q * (args.bp // 40)
        genome[at : at + 23] = g
    prof = Iupac()
    mesh = make_mesh(n_text=len(devs), n_pat=1, devices=devs)
    ss = ShardedSearch(mesh=mesh, cap=1 << 14, bcap=1 << 12)
    st = ShardedText(prof, genome)
    print(f"mesh 1x{len(devs)} {devs[0].device_kind}; 32 x 23 bp x {args.bp} "
          f"bp, k=3; overhang_batch={args.overhang_batch or 'auto'}")

    for alpha in (0.5, None):
        def run():
            return ss.candidates_batch(prof, guides, st, 3, alpha=alpha)

        t0 = time.perf_counter()
        got = run()
        first = time.perf_counter() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        digest = hashlib.sha256(repr([sorted(c) for c in got]).encode())
        print(f"alpha={alpha}: {sum(map(len, got))} candidates, sha256 "
              f"{digest.hexdigest()[:16]}; first "
              f"{first:.3f} s; median {sorted(ts)[len(ts) // 2] * 1e3:.3f} ms "
              f"of {args.reps} ({', '.join(f'{t * 1e3:.3f}' for t in ts)})")
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in devs]
        print(f"alpha={alpha}: peak_bytes_in_use per card {peaks}")
        if alpha is not None and args.trace:
            with jax.profiler.trace(args.trace):
                run()
            print(f"alpha={alpha}: traced call")
            top_device_ops(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())

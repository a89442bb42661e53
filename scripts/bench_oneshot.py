"""One-shot small-search latency: time to the FIRST match set.

The reference wins interactive shapes (text_scaling q=1: 23bp x 100 kb,
k=3 -> ~48 us on one Xeon thread) because it streams from L1; every device
dispatch here pays a host round trip + program launch. This measures the
one-shot number the CLI's first query sees: a FRESH text array each call
(no PreparedText reuse, no window cache), process warm (compile + cap hints settled by a warmup on a
different text of the same bucketed size).

Reports, for n in {10k, 100k, 1M}: median / p10 / p90 of R one-shot
`Searcher.search` calls (fwd strand, pattern 23bp, k=3), plus the
amortized batched rate at the same shape for contrast.

Usage: python scripts/bench_oneshot.py [reps] [--no-fast]

``--no-fast`` disables the fused bytes path (ONE_SHOT_BYTES_MAX=0) to
measure the standard eager-pack path for comparison.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--no-fast"]
    reps = int(args[0]) if args else 20

    from sassy_tpu import Searcher, profiles

    if "--no-fast" in sys.argv:
        from sassy_tpu.ops.myers_xla import XlaEngine

        XlaEngine.ONE_SHOT_BYTES_MAX = 0
        print("(fused bytes path disabled)")

    rng = np.random.default_rng(3)
    pat = rng.choice(BASES, size=23)
    s = Searcher(profiles.Iupac(), rc=False)

    print(f"{'n':>10} {'median':>9} {'p10':>9} {'p90':>9} {'GB/s':>7}  "
          f"(one-shot Searcher.search, fresh text each call)")
    for n in (10_000, 100_000, 1_000_000):
        # warm compile + caches on same-sized throwaway texts
        for _ in range(3):
            s.search(pat, rng.choice(BASES, size=n), 3)
        times = []
        for r in range(reps):
            text = rng.choice(BASES, size=n)
            text[n // 2 : n // 2 + 23] = pat
            t0 = time.perf_counter()
            got = s.search(pat, text, 3)
            times.append(time.perf_counter() - t0)
            assert any(m.cost == 0 for m in got), (n, r)
        times.sort()
        med = statistics.median(times)
        p10 = times[max(0, int(0.1 * len(times)) - 1)]
        p90 = times[int(0.9 * len(times))]
        print(f"{n:>10} {med*1e3:8.2f}m {p10*1e3:8.2f}m {p90*1e3:8.2f}m "
              f"{n/med/1e9:7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

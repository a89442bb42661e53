"""Timing comparison of the search batching modes
(/root/reference/examples/modes.rs analog): Single pair-by-pair loops vs
the batched texts/patterns paths, same match sets.

Run: JAX_PLATFORMS=cpu python examples/modes.py   (or on the GPU)
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sassy_tpu import Searcher, profiles  # noqa: E402

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def main():
    rng = np.random.default_rng(0)
    k = 2
    patterns = [bytes(rng.choice(BASES, size=24)) for _ in range(16)]
    texts = [bytes(rng.choice(BASES, size=2000)) for _ in range(32)]

    s = Searcher(profiles.Iupac(), rc=True)

    def timed(name, fn):
        fn()  # warmup/compile
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        print(f"{name:>24}: {dt * 1e3:8.1f} ms, {len(out)} matches")
        return out

    single = timed(
        "single (pair loop)",
        lambda: [
            m
            for pi, p in enumerate(patterns)
            for t in texts
            for m in s.search(p, t, k)
        ],
    )
    many = timed("search_many (batched)", lambda: s.search_many(patterns, texts, k))
    assert len(single) == len(many)

    enc = s.encode_patterns(patterns)
    timed(
        "encoded patterns",
        lambda: [m for t in texts for m in s.search_encoded_patterns(enc, t, k)],
    )


if __name__ == "__main__":
    main()

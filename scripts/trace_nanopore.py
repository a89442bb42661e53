"""Device trace of one batched dispatch at the nanopore read-set shape.

Usage: python scripts/trace_nanopore.py [Q] [MB] [read_len] [outdir]
Prints the top device-time rows (kernels + XLA fusions) so selection
cost can be attributed op by op.
"""

import glob
import gzip
import json
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax

    from sassy_tpu.ops import batch as B
    from sassy_tpu.profiles import Iupac

    Q = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    MB = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    read_len = int(sys.argv[3]) if len(sys.argv) > 3 else 10000
    outdir = sys.argv[4] if len(sys.argv) > 4 else "/tmp/trace_nanopore"
    k = 3
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=MB * 1_000_000)
    pats = [rng.choice(bases, size=24) for _ in range(Q)]
    pos = 5000
    qi = 0
    while pos + 24 < len(text):
        text[pos : pos + 24] = pats[qi % Q]
        pos += 5000
        qi += 1
    prof = Iupac()
    eng = B.BatchEngine()
    codes = [prof.encode(p) for p in pats]
    n_reads = len(text) // read_len
    ts = B.TextSet(
        [text[i * read_len : (i + 1) * read_len] for i in range(n_reads)]
    )

    def call():
        return eng.candidates_many_flat(prof, codes, ts, k)

    call()
    t0 = time.perf_counter()
    out = call()
    wall = time.perf_counter() - t0
    print(f"warm wall: {wall*1e3:.1f} ms ({len(out[0])} matches)")

    with jax.profiler.trace(outdir):
        call()

    tracefiles = glob.glob(outdir + "/plugins/profile/*/*.trace.json.gz")
    tracefiles.sort(key=lambda p: -len(p))
    tf = sorted(tracefiles)[-1]
    with gzip.open(tf, "rt") as f:
        data = json.load(f)
    ev = data["traceEvents"]
    devpids = set()
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            nm = e["args"].get("name", "")
            if "/device:GPU" in nm and "pid" in e:
                devpids.add(e["pid"])
    agg = defaultdict(float)
    cnt = defaultdict(int)
    total = 0.0
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in devpids:
            d = e.get("dur", 0) / 1e3  # ms
            nm = e.get("name", "?")
            agg[nm] += d
            cnt[nm] += 1
            total += d
    print(f"total device ms: {total:.1f}  (pids {devpids})")
    for nm, d in sorted(agg.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {d:8.2f} ms  x{cnt[nm]:<4d} {nm[:110]}")


if __name__ == "__main__":
    main()

"""Capture a jax.profiler device trace of the headline bench call.

Usage: python scripts/trace_headline.py [outdir]
Prints the top device-time rows from the trace (fusions + kernels).
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
    import jax.numpy as jnp

    from sassy_tpu.ops.myers_xla import PreparedText
    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import make_engine

    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/trace_headline"
    n = 1 << 30
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pattern = rng.choice(bases, size=23)
    key = jax.random.PRNGKey(0)
    idx = jax.random.randint(key, (n,), 0, 4, dtype=jnp.uint8)
    text_dev = jnp.take(jnp.asarray(bases), idx.astype(jnp.int32))
    np.asarray(text_dev[:1])

    prof = Iupac()
    eng = make_engine("auto")
    prep = PreparedText(prof, text_dev)
    pcodes = prof.encode(pattern)
    # warm
    eng.candidates(prof, pcodes, prep, 3, None, None, False)
    t0 = time.perf_counter()
    eng.candidates(prof, pcodes, prep, 3, None, None, False)
    wall = time.perf_counter() - t0
    print(f"warm wall: {wall*1e3:.1f} ms")

    with jax.profiler.trace(outdir):
        eng.candidates(prof, pcodes, prep, 3, None, None, False)

    tracefiles = glob.glob(outdir + "/plugins/profile/*/*.trace.json.gz")
    tracefiles.sort(key=lambda p: -len(p))
    tf = sorted(tracefiles)[-1]
    with gzip.open(tf, "rt") as f:
        data = json.load(f)
    ev = data["traceEvents"]
    # find device pids
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
    for nm, d in sorted(agg.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {d:8.2f} ms  x{cnt[nm]:<4d} {nm[:110]}")


if __name__ == "__main__":
    main()

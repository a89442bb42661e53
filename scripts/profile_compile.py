"""Attribute cold first-call compile time at the headline shape.

Measures where the cold first search at the 1 GiB headline shape spends
its compile time:

- runs the exact headline call (23bp, k=3, 1 GiB device text) with a FRESH
  persistent-cache dir (pass --cold) or the default warm cache,
- enables jax_log_compiles and parses per-executable compile durations,
- prints each compiled executable (name, seconds) and the total, plus the
  end-to-end first-call wall time.

Usage: python scripts/profile_compile.py [--cold] [--n LOG2N]
"""

import io
import logging
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, ".")


def main():
    cold = "--cold" in sys.argv
    log2n = 30
    if "--n" in sys.argv:
        log2n = int(sys.argv[sys.argv.index("--n") + 1])
    if cold:
        cachedir = tempfile.mkdtemp(prefix="sassy_coldcache_")
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cachedir
        print(f"[cold] fresh cache dir {cachedir}")

    import jax

    jax.config.update("jax_log_compiles", True)
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setLevel(logging.DEBUG)
    lg = logging.getLogger("jax")
    lg.setLevel(logging.DEBUG)
    lg.addHandler(h)

    import jax.numpy as jnp
    import numpy as np

    from sassy_tpu.ops.myers_xla import PreparedText
    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import make_engine

    n = 1 << log2n
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pattern = rng.choice(bases, size=23)
    key = jax.random.PRNGKey(0)
    idx = jax.random.randint(key, (n,), 0, 4, dtype=jnp.uint8)
    text_dev = jnp.take(jnp.asarray(bases), idx.astype(jnp.int32))
    text_dev.block_until_ready()

    prof = Iupac()
    eng = make_engine("auto")
    t0 = time.perf_counter()
    prep = PreparedText(prof, text_dev)
    prep.planes.block_until_ready()
    t_pack = time.perf_counter() - t0
    pcodes = prof.encode(pattern)

    t0 = time.perf_counter()
    eng.candidates(prof, pcodes, prep, 3, None, None, False)
    t_first = time.perf_counter() - t0

    # parse "Finished XLA compilation of <name> in <x> sec"
    entries = re.findall(
        r"Finished XLA compilation of ([^\s]+) in ([0-9.]+) sec", buf.getvalue()
    )
    traces = re.findall(
        r"Finished tracing \+ transforming ([^\s]+) in ([0-9.]+) sec",
        buf.getvalue(),
    )
    lowering = re.findall(
        r"Finished jaxpr to MLIR module conversion jit\(([^)]+)\) in "
        r"([0-9.]+) sec",
        buf.getvalue(),
    )
    print(f"\n== first call: {t_first:.1f}s  (pack {t_pack:.1f}s, "
          f"n=2^{log2n}, backend={jax.default_backend()})")
    tot = 0.0
    for name, secs in sorted(entries, key=lambda e: -float(e[1])):
        print(f"  compile {float(secs):8.2f}s  {name}")
        tot += float(secs)
    print(f"  compile total: {tot:.1f}s over {len(entries)} executables")
    ttot = sum(float(s) for _, s in traces)
    ltot = sum(float(s) for _, s in lowering)
    print(f"  trace+transform total: {ttot:.1f}s over {len(traces)}")
    print(f"  jaxpr->MLIR total: {ltot:.1f}s over {len(lowering)}")


if __name__ == "__main__":
    main()

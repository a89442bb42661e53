"""Headline benchmark: single-card text-scan throughput.

Config mirrors the reference's flagship eval row (23bp pattern, k=3;
/root/reference/evals/src/sassy2/output-xeon-512/text_scaling_results.csv:2
-> 2.105 GB/s on one AVX-512 thread). We scan 1 GiB of random DNA,
generated on the device (a deployment keeps the genome resident in device
memory), with one 23bp pattern at k=3 through the full search pipeline:
bit-parallel scan + on-device candidate selection + packed result fetch.

Runs in one process on the GPU and exits non-zero without one. Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device", ...}.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_GBPS = 2.105  # reference sassy1, 23bp/k=3, 1 thread AVX-512
TEXT_BYTES = 1 << 30


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _log(f"no GPU (JAX platform {dev.platform!r}); nothing measured")
        return 1

    from sassy_tpu.ops.myers_xla import PreparedText
    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import make_engine

    n = TEXT_BYTES
    # device-side random DNA with a few planted (mutated) pattern copies
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pattern = rng.choice(bases, size=23)
    idx = jax.random.randint(jax.random.PRNGKey(0), (n,), 0, 4, jnp.int32)
    text_dev = jnp.asarray(bases)[idx]
    planted = pattern.copy()
    planted[11] = bases[(np.where(bases == planted[11])[0][0] + 1) % 4]
    for off in (12345, n // 2, n - 5000):
        text_dev = jax.lax.dynamic_update_slice(
            text_dev, jnp.asarray(planted), (off,)
        )
    text_dev.block_until_ready()

    prof = Iupac()
    eng = make_engine("auto")
    t0 = time.perf_counter()
    prep = PreparedText(prof, text_dev)
    prep.planes.block_until_ready()
    t_pack = time.perf_counter() - t0
    pcodes = prof.encode(pattern)

    t0 = time.perf_counter()
    cands = eng.candidates(prof, pcodes, prep, 3, None, None, False)
    warm = time.perf_counter() - t0
    if len(cands) < 3:
        _log(f"planted matches not found: {cands[:10]}")
        return 1
    _log(f"engine={eng.name} n={n} pack={t_pack:.3f}s "
         f"first_call={warm:.3f}s matches={len(cands)}")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.candidates(prof, pcodes, prep, 3, None, None, False)
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    gbps = n / med / 1e9
    print(json.dumps({
        "metric": "text_scan_23bp_k3",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / BASELINE_GBPS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "engine": eng.name,
        "median_s": med,
        "p90_s": times[int(0.9 * (len(times) - 1))],
        "samples": len(times),
        "n": n,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

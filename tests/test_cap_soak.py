"""Cap grow-retry + qid-packing stress.

The round-4 guards changed overflow/retry behavior under pressure:
``QID_PACK_MAX`` (ops/batch.py) hard-caps dispatch q-chunks at 2^15
patterns (the qid<<16|cost packing range), and the sticky cap hints
converge on a session high-water mark instead of oscillating. These
tests force both machineries at adversarial shapes:

- a pattern batch *above* 2^15 (the dispatch must split, and qids at the
  very top of the packing range must decode to the right pattern),
- match densities that overflow a deliberately tiny initial cap, forcing
  the grow-retry loop, then asserting the hint converged (the second
  call reuses the grown cap without a retry),
- a nightly soak sweeping both together, and a gpu-marked variant at the
  off-targets shape (32 x 23bp x big text).

Reference analog: sassy grows its match Vec dynamically; the fixed-cap
fetch + retry is this framework's XLA-shaped equivalent, so it needs its
own adversarial coverage (no reference counterpart to crib from).
"""

import numpy as np
import pytest

from sassy_tpu.ops.batch import QID_PACK_MAX, BatchEngine
from sassy_tpu.profiles import Iupac
from sassy_tpu.search import NumpyEngine

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _planted_text(patterns, qids, sep=8):
    """One text containing an exact copy of patterns[q] for each q in
    ``qids``, T-padded between plants; returns (text, {q: end_pos})."""
    parts, ends, pos = [], {}, 0
    tpad = np.full(sep, ord("T"), np.uint8)
    for q in qids:
        parts += [tpad, patterns[q]]
        pos += sep + len(patterns[q])
        ends[q] = pos
    parts.append(tpad)
    return np.concatenate(parts), ends


def test_qid_packing_boundary():
    """Q = 2^15 + 2 splits into [32768, 2]; qids 32766..32769 (top of the
    first chunk and both of the second) must decode to their patterns."""
    rng = np.random.default_rng(0)
    prof = Iupac()
    Q = QID_PACK_MAX + 2
    # A/C/G 10-mers: cannot match inside the T separators at k=0
    acg = BASES[:3]
    pats = [rng.choice(acg, size=10) for _ in range(Q)]
    probe = [0, 1, QID_PACK_MAX // 2, QID_PACK_MAX - 2, QID_PACK_MAX - 1,
             QID_PACK_MAX, QID_PACK_MAX + 1]
    text, ends = _planted_text(pats, probe)
    eng = BatchEngine()
    codes = [prof.encode(p) for p in pats]
    out = eng.candidates_many(prof, codes, [text], 0)
    oracle = NumpyEngine()
    for q in probe:
        got = sorted(map(tuple, out[q][0]))
        assert (ends[q], 0) in got, (q, got[:5])
        want = sorted(
            oracle.candidates(prof, codes[q], text, 0, None, None, False)
        )
        assert got == want, (q, got[:5], want[:5])
    # a random sample of non-planted qids must be oracle-exact too (a qid
    # wrap would deposit their hits onto aliased patterns)
    for q in rng.integers(0, Q, size=16).tolist():
        got = sorted(map(tuple, out[q][0]))
        want = sorted(
            oracle.candidates(prof, codes[q], text, 0, None, None, False)
        )
        assert got == want, q


@pytest.mark.parametrize("all_minima", [False, True])
def test_cap_grow_retry_converges(all_minima):
    """Match-dense tandem repeats overflow a 64-entry initial cap; the
    grow-retry must produce oracle-exact results, and the sticky hint must
    make the SECOND call run without any overflow retry."""
    rng = np.random.default_rng(1)
    prof = Iupac()
    pat = rng.choice(BASES, size=10)
    text = np.tile(pat, 500)  # 5000 chars, a match every 10 positions
    eng = BatchEngine(initial_cap=64)
    codes = [prof.encode(pat)]
    out1 = eng.candidates_many(prof, codes, [text], 2, all_minima=all_minima)
    want = sorted(
        NumpyEngine().candidates(prof, codes[0], text, 2, None, None,
                                 all_minima)
    )
    assert sorted(map(tuple, out1[0][0])) == want
    assert len(want) > 64  # the shape actually overflowed the initial cap
    hints1 = dict(eng._cap_hints)
    assert hints1, "no cap hint recorded after a grown workload"
    out2 = eng.candidates_many(prof, codes, [text], 2, all_minima=all_minima)
    assert sorted(map(tuple, out2[0][0])) == want
    # convergence: the hint did not move (same cap, same high-water mark)
    assert eng._cap_hints == hints1, (hints1, eng._cap_hints)


@pytest.mark.soak
def test_cap_qid_soak():
    """Nightly: sweep Q near 2^15 with adversarial match densities that
    force grow-retry + hint convergence in the same workload."""
    rng = np.random.default_rng(2)
    prof = Iupac()
    oracle = NumpyEngine()
    acg = BASES[:3]
    for Q in (1024, QID_PACK_MAX - 1, QID_PACK_MAX + 3):
        pats = [rng.choice(acg, size=12) for _ in range(Q)]
        probe = sorted(set(rng.integers(0, Q, size=12).tolist()
                           + [0, Q - 1, min(Q - 1, QID_PACK_MAX - 1)]))
        text, ends = _planted_text(pats, probe)
        # dense tail: tandem repeats of one probe pattern overflow the cap
        dense = np.tile(pats[probe[0]], 200)
        text = np.concatenate([text, np.full(12, ord("T"), np.uint8), dense])
        eng = BatchEngine(initial_cap=64)
        codes = [prof.encode(p) for p in pats]
        for rep in range(2):  # second rep must hit the converged hint
            out = eng.candidates_many(prof, codes, [text], 1)
            for q in probe:
                got = sorted(map(tuple, out[q][0]))
                assert (ends[q], 0) in got, (Q, rep, q)
                want = sorted(oracle.candidates(
                    prof, codes[q], text, 1, None, None, False
                ))
                assert got == want, (Q, rep, q)


@pytest.mark.gpu
def test_cap_grow_retry_hw():
    """Off-targets-shaped grow-retry on the real kernel: 32 x 23bp over a
    16 Mbp text planted every 2 kb (~8k matches) against a 256-entry
    initial cap; two runs must agree exactly and the planted ends must be
    present (the retry path re-dispatches the same device program at a
    bigger cap — compiled-kernel code when backend=pallas)."""
    import os

    if os.environ.get("SASSY_TESTS_GPU") != "1":
        pytest.skip("set SASSY_TESTS_GPU=1 to run the GPU lane")
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU")

    rng = np.random.default_rng(3)
    prof = Iupac()
    pats = [rng.choice(BASES, size=23) for _ in range(32)]
    text = rng.choice(BASES, size=16_000_000)
    planted = []
    for pos in range(2000, len(text) - 23, 2000):
        q = (pos // 2000) % 32
        text[pos : pos + 23] = pats[q]
        planted.append((q, pos + 23))
    eng = BatchEngine(initial_cap=256)
    codes = [prof.encode(p) for p in pats]
    out1 = eng.candidates_many_flat(prof, codes, [text], 3)
    out2 = eng.candidates_many_flat(prof, codes, [text], 3)
    for a, b in zip(out1, out2):
        assert (a == b).all()
    qs, _, ps, cs = out1
    assert len(qs) >= len(planted)
    got = set(zip(qs.tolist(), ps.tolist(), cs.tolist()))
    for q, end in planted:
        assert (q, end, 0) in got, (q, end)

"""GPU conformance lane: the adversarial recipes that caught the round-1
tile-boundary and plateau-state bugs, run against the scan kernel as it is
compiled for the card (interpret-mode coverage alone leaves the compiled
code path untested).

Run with:  SASSY_TESTS_GPU=1 python -m pytest tests/test_gpu_hardware.py -m gpu
(skipped without a GPU; the default test run forces the CPU backend via
conftest.py). ``-m "gpu and soak"`` adds the 10k-case oracle soak.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _require_gpu():
    if os.environ.get("SASSY_TESTS_GPU") != "1":
        pytest.skip("set SASSY_TESTS_GPU=1 to run the GPU lane")
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU")


BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    _require_gpu()
    from sassy_tpu.ops.batch import BatchEngine
    from sassy_tpu.ops.myers_pallas import PallasEngine
    from sassy_tpu.search import NumpyEngine

    return PallasEngine(), BatchEngine(), NumpyEngine()


def test_tile_boundary_lookahead_hw(engines):
    # test_regressions.py recipe, on the real kernel
    from sassy_tpu import profiles

    eng, _, oracle = engines
    prof = profiles.Iupac()
    rng = np.random.default_rng(0)
    pat = b"ACGT"
    pc = prof.encode(pat)
    for trial in range(4):
        text = rng.choice(BASES, size=200_000)
        for edge in (512, 1024, 4096, 65536, 131072):
            text[edge - 2 : edge + 2] = np.frombuffer(pat, np.uint8)
        want = oracle.candidates(prof, pc, text, 2, None, None, False)
        got = eng.candidates(prof, pc, text, 2, None, None, False)
        assert sorted(got) == sorted(want), trial


def test_plateau_state_hw(engines):
    from sassy_tpu import profiles

    eng, be, oracle = engines
    prof = profiles.Iupac()
    rng = np.random.default_rng(99)
    for trial in range(6):
        m = int(rng.integers(3, 12))
        k = int(rng.integers(0, min(m, 4)))
        pat = rng.choice(BASES, size=m)
        segs, tot = [], 0
        while tot < 100_000:
            r = int(rng.integers(20, 4000))
            segs.append(np.full(r, rng.choice(BASES), np.uint8))
            tot += r
            if rng.integers(0, 3) == 0:
                segs.append(pat.copy())
                tot += m
        text = np.concatenate(segs)[:100_000]
        allm = bool(trial % 2)
        want = oracle.candidates(prof, pat, text, k, None, None, allm)
        got = eng.candidates(prof, pat, text, k, None, None, allm)
        assert sorted(got) == sorted(want), ("pallas", trial, m, k, allm)
        gotb = be.candidates_many(prof, [pat], [text], k, None, None, allm)[0][0]
        assert sorted(map(tuple, gotb)) == sorted(map(tuple, want)), (
            "batch", trial, m, k, allm,
        )


def test_alpha_overshoot_hw(engines):
    """Overhang fast path (tail tile + strips) on the real kernel."""
    from sassy_tpu import profiles

    eng, be, oracle = engines
    prof = profiles.Iupac()
    rng = np.random.default_rng(7)
    for trial in range(4):
        n = int(rng.integers(50_000, 120_000))
        m = int(rng.integers(6, 40))
        k = int(rng.integers(0, 5))
        alpha = [0.5, 0.25, 1.0, 0.34][trial]
        text = rng.choice(BASES, size=n)
        pat = rng.choice(BASES, size=m)
        text[-m:] = pat
        text[: m] = pat
        pc = prof.encode(pat)
        want = oracle.candidates(prof, pc, text, k, alpha, None, False)
        got = eng.candidates(prof, pc, text, k, alpha, None, False)
        assert sorted(got) == sorted(want), ("pallas", trial)
        gotb = be.candidates_many(prof, [pc], [text], k, alpha, None, False)[0][0]
        assert sorted(map(tuple, gotb)) == sorted(map(tuple, want)), (
            "batch", trial,
        )


def test_batch_multi_text_hw(engines):
    from sassy_tpu import profiles

    _, be, oracle = engines
    prof = profiles.Iupac()
    rng = np.random.default_rng(5)
    texts = [rng.choice(BASES, size=int(s)) for s in (3000, 64, 40_000, 1)]
    pats = [rng.choice(BASES, size=s) for s in (8, 24, 24, 31)]
    texts[2][1000:1024] = pats[1]
    codes = [prof.encode(p) for p in pats]
    for k in (0, 3):
        for am in (False, True):
            got = be.candidates_many(prof, codes, texts, k, all_minima=am)
            for q in range(len(pats)):
                for t in range(len(texts)):
                    want = oracle.candidates(
                        prof, codes[q], texts[t], k, None, None, am
                    )
                    assert sorted(map(tuple, got[q][t])) == sorted(
                        map(tuple, want)
                    ), (k, am, q, t)


@pytest.mark.soak
def test_oracle_soak_hw(engines):
    """10k-case random+planted soak against the real kernel (nightly)."""
    from sassy_tpu import profiles

    eng, be, oracle = engines
    prof = profiles.Iupac()
    rng = np.random.default_rng(2026)
    # batch them: many (pattern, text) pairs per dispatch via the batch
    # engine; single-engine spot checks interleaved
    for round_i in range(100):
        texts = [
            rng.choice(BASES, size=int(rng.integers(10, 4000)))
            for _ in range(10)
        ]
        m = int(rng.integers(4, 50))
        pats = [rng.choice(BASES, size=m) for _ in range(10)]
        for t in texts:
            if len(t) > m and rng.random() < 0.7:
                p = int(rng.integers(0, len(t) - m))
                t[p : p + m] = pats[int(rng.integers(0, len(pats)))]
        k = int(rng.integers(0, 6))
        am = bool(round_i % 2)
        codes = [prof.encode(p) for p in pats]
        got = be.candidates_many(prof, codes, texts, k, all_minima=am)
        for q in range(10):
            for t in range(10):
                want = oracle.candidates(
                    prof, codes[q], texts[t], k, None, None, am
                )
                assert sorted(map(tuple, got[q][t])) == sorted(
                    map(tuple, want)
                ), (round_i, q, t, k, am)


def test_sharded_1dev_hw(engines):
    """shard_map code path on the card (a 1-device ('pat','text') mesh):
    the fast word-level path AND the overhang path, whose shard window
    tiles TL x WL lanes (parallel/sharded.py one_pattern). Oracle parity
    at 4 MB, then the overhang path at a 64 MB shard asserting the planted
    matches (a full oracle there would dominate the lane)."""
    import jax

    from sassy_tpu.parallel import ShardedSearch, ShardedText, make_mesh
    from sassy_tpu.profiles import Iupac

    _, _, oracle = engines
    prof = Iupac()
    rng = np.random.default_rng(11)
    n = 4_000_000
    text = rng.choice(BASES, size=n)
    pats = [rng.choice(BASES, size=20) for _ in range(4)]
    for i, p in enumerate(pats):
        text[10_000 + 50_000 * i : 10_020 + 50_000 * i] = p
    mesh = make_mesh(n_text=1, n_pat=1, devices=jax.devices()[:1])
    st = ShardedText(prof, text)
    ss = ShardedSearch(mesh=mesh, cap=1 << 12, bcap=1 << 10)
    for alpha in (None, 0.5):
        got = ss.candidates_batch(prof, pats, st, 2, alpha=alpha)
        for p, cands in zip(pats, got):
            want = oracle.candidates(
                prof, prof.encode(p), text, 2, alpha, None, False
            )
            assert sorted(cands) == sorted(want), alpha

    big = rng.choice(BASES, size=64_000_000)
    planted = []
    for i, p in enumerate(pats):
        at = 1_000_000 + 13_000_000 * i
        big[at : at + 20] = p
        planted.append(at + 20)
    got = ss.candidates_batch(
        prof, pats, ShardedText(prof, big), 2, alpha=0.5
    )
    for q, end in enumerate(planted):
        assert any(pos == end and cost == 0 for pos, cost in got[q]), (
            q, end, got[q][:5],
        )

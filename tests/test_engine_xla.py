"""Differential tests: XLA bit-parallel engine vs the NumPy oracle.

This is the analog of the reference's engine-vs-engine differential fuzz
(pattern_tiling/search.rs:690-848), with the oracle DP as ground truth.
"""

import numpy as np
import pytest

from sassy_tpu import Searcher, profiles
from sassy_tpu.oracle import end_costs
from sassy_tpu.ops.myers_xla import end_costs_xla

rng = np.random.default_rng(42)

IUPAC_CHARS = np.frombuffer(b"ACGTNRYSWKMBDHVX", dtype=np.uint8)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(n, alphabet=BASES):
    return rng.choice(alphabet, size=n).tobytes()


@pytest.mark.slow
def test_end_costs_match_oracle_dna():
    profile = profiles.Dna()
    for _ in range(25):
        m = int(rng.integers(1, 70))
        n = int(rng.integers(1, 500))
        k = int(rng.integers(0, 6))
        raw_p, raw_t = rand_seq(m), rand_seq(n)
        pat = profile.encode(raw_p)
        txt = profile.encode(raw_t)
        ours = end_costs_xla(profile, pat, np.frombuffer(raw_t, np.uint8), None, None, k)
        ref = end_costs(profile, pat, txt, None, None)
        np.testing.assert_array_equal(ours, ref)


def test_end_costs_match_oracle_iupac_with_alpha():
    profile = profiles.Iupac()
    for _ in range(15):
        m = int(rng.integers(1, 40))
        n = int(rng.integers(1, 300))
        k = int(rng.integers(0, 4))
        alpha = float(rng.choice([0.25, 0.5, 1.0]))
        raw_p, raw_t = rand_seq(m, IUPAC_CHARS), rand_seq(n, IUPAC_CHARS)
        pat = profile.encode(raw_p)
        txt = profile.encode(raw_t)
        ours = end_costs_xla(profile, pat, np.frombuffer(raw_t, np.uint8), alpha, None, k)
        ref = end_costs(profile, pat, txt, alpha, None)
        np.testing.assert_array_equal(ours, ref)


def test_end_costs_ascii():
    profile = profiles.Ascii(case_sensitive=False)
    words = b"the quick brown fox jumps over the lazy dog THE QUICK"
    alphabet = np.frombuffer(words, dtype=np.uint8)
    for _ in range(10):
        m = int(rng.integers(1, 30))
        n = int(rng.integers(1, 300))
        raw_p, raw_t = rand_seq(m, alphabet), rand_seq(n, alphabet)
        pat = profile.encode(raw_p)
        txt = profile.encode(raw_t)
        ours = end_costs_xla(profile, pat, np.frombuffer(raw_t, np.uint8), None, None, 2)
        ref = end_costs(profile, pat, txt, None, None)
        np.testing.assert_array_equal(ours, ref)


def test_long_pattern_long_text():
    profile = profiles.Dna()
    m, n, k = 301, 20000, 10
    raw_p, raw_t = rand_seq(m), rand_seq(n)
    pat = profile.encode(raw_p)
    txt = profile.encode(raw_t)
    ours = end_costs_xla(profile, pat, np.frombuffer(raw_t, np.uint8), None, None, k)
    ref = end_costs(profile, pat, txt, None, None)
    np.testing.assert_array_equal(ours, ref)


def test_overhang_example_xla_regression():
    """Pad-row eq must be unconditional: text with code-0 'X' chars + alpha
    (caught by verification; lib.rs:109-137 example)."""
    s = Searcher(profiles.Iupac(), alpha=0.5, engine="xla")
    ms = s.search(b"ACGT", b"GTXXXNNN", 1)
    got = [(m.pattern_start, m.pattern_end, m.text_start, m.text_end, m.cost) for m in ms]
    assert got == [(2, 4, 0, 2, 1), (0, 3, 5, 8, 0)]


@pytest.mark.parametrize("use_rc", [False, True])
@pytest.mark.parametrize("alpha", [None, 0.5])
def test_full_search_matches_numpy_engine(use_rc, alpha):
    profile = profiles.Iupac()
    s_np = Searcher(profile, rc=use_rc, alpha=alpha, engine="numpy")
    s_xla = Searcher(profile, rc=use_rc, alpha=alpha, engine="xla")
    for _ in range(20):
        m = int(rng.integers(3, 30))
        n = int(rng.integers(5, 400))
        k = int(rng.integers(0, 4))
        pattern = rand_seq(m)
        text = rand_seq(n)
        a = s_np.search(pattern, text, k)
        b = s_xla.search(pattern, text, k)
        assert len(a) == len(b), (pattern, text, k)
        for x, y in zip(a, b):
            assert x.same_as(y), (pattern, text, k, x, y)
        a = s_np.search_all(pattern, text, k)
        b = s_xla.search_all(pattern, text, k)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.same_as(y)


@pytest.mark.slow
def test_multi_tile_candidates_vs_oracle():
    """Exercise the T>1 halo-tiled path with realistic plans (small tests all
    fall into the single-tile fast path, which once hid a window bug)."""
    from sassy_tpu.ops.myers_xla import XlaEngine
    from sassy_tpu.search import NumpyEngine

    profile = profiles.Iupac()
    xe, ne = XlaEngine(), NumpyEngine()
    cases = [(60000, 23, 3, None), (33000, 150, 8, 0.5), (70000, 12, 2, 0.25)]
    for n, m, k, alpha in cases:
        raw_p = rng.choice(IUPAC_CHARS[:5], size=m).tobytes()
        raw_t = rng.choice(IUPAC_CHARS[:5], size=n)
        pat = profile.encode(raw_p)
        for all_minima in (False, True):
            a = xe.candidates(profile, pat, raw_t, k, alpha, None, all_minima)
            b = ne.candidates(profile, pat, raw_t, k, alpha, None, all_minima)
            assert a == b, (n, m, k, alpha, all_minima, len(a), len(b))


def test_single_text_hierarchical_prefilter():
    """Force the single-text suffix prefilter (T >= 4096 tiles) and compare
    against the non-hier engine."""
    import numpy as np

    from sassy_tpu.ops.myers_xla import XlaEngine
    from sassy_tpu.profiles import Iupac

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=3_000_000)
    pat = rng.choice(bases, size=80)
    mut = pat.copy()
    mut[7] = bases[(int(np.where(bases == mut[7])[0][0]) + 1) % 4]
    for off, what in ((5, pat), (1_499_990, mut), (2_999_900, pat)):
        text[off : off + 80] = what

    prof = Iupac()
    hier = XlaEngine(target_tiles=8192)   # T >= 4096 -> prefilter on
    base = XlaEngine(target_tiles=512)    # prefilter off
    a, s1 = hier.build_inputs(prof, prof.encode(pat), text, 4)
    assert s1["hier_s"] == 32, s1
    got = hier.candidates(prof, prof.encode(pat), text, 4, None, None, False)
    want = base.candidates(prof, prof.encode(pat), text, 4, None, None, False)
    assert got == want and len(got) >= 3, (got, want)

    # repeat searches over a PreparedText run from the cached (NW, P, T)
    # window array, which the prefilter also gathers from; results must be
    # identical
    prep = hier.prepare(prof, text)
    first = hier.candidates(prof, prof.encode(pat), prep, 4, None, None, False)
    again = hier.candidates(prof, prof.encode(pat), prep, 4, None, None, False)
    assert first == want and again == want
    assert list(prep._wins) == [(0, s1["T"], s1["W"], s1["halo"])]

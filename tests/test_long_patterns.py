"""Long-pattern (m > 64) coverage: the fori_loop row path and multi-word
pattern state.

The reference supports patterns up to ~1000 bp at GB/s (doc/abstract.md:
20-22); engines here bucket pattern rows (myers_xla._bucket_rows) and the
Pallas kernel switches from register-carried rows to a ``fori_loop`` over
rows with a global-memory carry scratch above 64 rows
(myers_pallas.UNROLL_ROWS). These tests pin correctness for that regime
on every engine; throughput rows for m in {128, 256, 512, 1000} live in
evals/ (run on the GPU).
"""

import numpy as np
import pytest

from sassy_tpu import Searcher, Strand, profiles
from sassy_tpu.ops.myers_pallas import PallasEngine

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _key(m):
    return (m.strand is Strand.RC, m.text_start, m.text_end, m.cost)


def _assert_same(a, b, ctx):
    assert sorted(map(_key, a)) == sorted(map(_key, b)), ctx


def _planted_case(rng, m, n, k, edits):
    """Random text with one mutated copy of the pattern planted mid-text."""
    pat = bytes(rng.choice(BASES, size=m))
    text = bytearray(rng.choice(BASES, size=n))
    mut = bytearray(pat)
    for _ in range(edits):
        mut[int(rng.integers(0, m))] = int(rng.choice(BASES))
    off = (n - m) // 2
    text[off : off + m] = mut
    return pat, bytes(text)


@pytest.mark.parametrize("m,k", [(65, 3), (100, 6), (130, 8), (200, 10)])
def test_pallas_fori_loop_rows_vs_oracle(m, k):
    """m > 64 forces the kernel's fori_loop row path; must match the
    oracle exactly, including a planted near-match and the RC strand."""
    rng = np.random.default_rng(m)
    pat, text = _planted_case(rng, m, 4 * m, k, k // 2)
    sp = Searcher(
        profiles.Iupac(), rc=True, engine=PallasEngine(interpret=True)
    )
    sn = Searcher(profiles.Iupac(), rc=True, engine="numpy")
    got, want = sp.search(pat, text, k), sn.search(pat, text, k)
    assert want, "planted long-pattern match must be found"
    _assert_same(got, want, (m, k))


@pytest.mark.parametrize("m,k", [(256, 12), (512, 20), (1000, 40)])
def test_xla_very_long_patterns_vs_oracle(m, k):
    """Multi-word pattern state (H up to 33 words) on the XLA engine."""
    rng = np.random.default_rng(m)
    pat, text = _planted_case(rng, m, 3 * m, k, k // 2)
    sx = Searcher(profiles.Iupac(), rc=True, engine="xla")
    sn = Searcher(profiles.Iupac(), rc=True, engine="numpy")
    got, want = sx.search(pat, text, k), sn.search(pat, text, k)
    assert want
    _assert_same(got, want, (m, k))


def test_long_pattern_exact_pin_word_straddle():
    """Pinned: an exact 130bp match planted so its rows straddle the
    32-bit word boundaries (130 = 4x32 + 2) is found at cost 0 with a
    full-length cigar by every engine."""
    rng = np.random.default_rng(42)
    pat = bytes(rng.choice(BASES, size=130))
    text = bytes(rng.choice(BASES, size=300)) + pat + bytes(
        rng.choice(BASES, size=289)
    )
    for eng in ("numpy", "xla", PallasEngine(interpret=True)):
        s = Searcher(profiles.Iupac(), rc=False, engine=eng)
        ms = [m for m in s.search(pat, text, 2) if m.cost == 0]
        assert any(
            (m.text_start, m.text_end) == (300, 430) for m in ms
        ), eng
        m0 = next(m for m in ms if m.text_start == 300)
        assert m0.cigar.to_string() == "130="


def test_long_pattern_overhang():
    """Overhang fast path with m=80: a suffix of the pattern hanging off
    the text end must cost floor(alpha * overhang)."""
    rng = np.random.default_rng(7)
    pat = bytes(rng.choice(BASES, size=80))
    # text ends exactly where the pattern's 40th char would be
    text = bytes(rng.choice(BASES, size=500)) + pat[:40]
    for eng in ("numpy", "xla"):
        s = Searcher(profiles.Iupac(), rc=False, alpha=0.5, engine=eng)
        ms = s.search(pat, text, 20)
        tail = [m for m in ms if m.text_end == len(text)]
        assert tail, eng
        assert min(m.cost for m in tail) == 20, eng  # floor(0.5 * 40)


def test_long_pattern_batch_encoded():
    """The batch (v2) engine with equal-length 96bp patterns, include_rc,
    matches per-pattern single searches."""
    rng = np.random.default_rng(11)
    pats = [bytes(rng.choice(BASES, size=96)) for _ in range(3)]
    text = bytearray(rng.choice(BASES, size=700))
    text[100:196] = pats[1]
    text[400:496] = bytes(profiles.Iupac().reverse_complement(pats[2]))
    text = bytes(text)
    s = Searcher(profiles.Iupac(), rc=True, engine="xla")
    enc = s.encode_patterns(pats, include_rc=True, rc_anchor="start")
    got = s.search_all_encoded_patterns(enc, text, 4)
    sn = Searcher(profiles.Iupac(), rc=True, engine="numpy")
    enc_n = sn.encode_patterns(pats, include_rc=True, rc_anchor="start")
    want = sn.search_all_encoded_patterns(enc_n, text, 4)
    assert any(m.cost == 0 for m in want)
    kg = sorted((m.pattern_idx,) + _key(m) for m in got)
    kw = sorted((m.pattern_idx,) + _key(m) for m in want)
    assert kg == kw


@pytest.mark.slow
def test_planted_fuzz_reference_shapes():
    """The reference's planted-match fuzz shape range (search.rs:2604-2710:
    pattern lengths 10..1000, texts 10..10000): plant a <=m/3-edit copy,
    assert the bit-parallel engine finds it near the planted position and
    every reported match's cost is real. Shapes drawn from a fixed grid so
    CPU compiles amortize."""
    from test_fuzz_oracle import apply_random_edits, verify_match

    rng = np.random.default_rng(1234)
    prof = profiles.Dna()
    s = Searcher(prof, rc=False, engine="xla")
    for m, n in ((100, 5000), (400, 8000), (1000, 10000)):
        for _ in range(6):
            pat = bytes(rng.choice(BASES, size=m))
            edits = int(rng.integers(0, m // 3))
            planted = apply_random_edits(pat, edits)
            text = bytearray(rng.choice(BASES, size=n))
            pos = int(rng.integers(0, n - len(planted) + 1))
            text[pos : pos + len(planted)] = planted
            text = bytes(text)
            ms = s.search(pat, text, edits)
            assert ms, (m, n, edits, pos)
            assert any(abs(x.text_start - pos) <= edits + 1 for x in ms)
            for x in ms:
                assert x.cost <= edits
                verify_match(prof, pat, text, x)


def test_long_pattern_tile_boundary_plant():
    """Adversarial: exact 100bp matches planted straddling 512-position
    boundaries (tile-edge multiples for small texts) — the regression
    class from round 1's lookahead bug, now at m > 64."""
    rng = np.random.default_rng(13)
    pat = bytes(rng.choice(BASES, size=100))
    text = bytearray(rng.choice(BASES, size=2600))
    for off in (412, 1948):  # ends at 512, 2048
        text[off : off + 100] = pat
    text = bytes(text)
    sn = Searcher(profiles.Iupac(), rc=False, engine="numpy")
    sx = Searcher(profiles.Iupac(), rc=False, engine="xla")
    _assert_same(sx.search(pat, text, 3), sn.search(pat, text, 3),
                 "tile boundary m=100")


def test_window_builder_halo_exceeds_w():
    """Regression (round 3): the window builder's halo strips. When the
    owned width W is smaller than the halo, a single shifted reshape can
    only supply W halo words — the builder must stack ceil(halo/W)
    strips. Checks the (NW, P, T) windows the scan kernel reads against a
    naive per-tile slice for halo > W, halo == W, and halo < W."""
    from sassy_tpu.ops.myers_xla import _kernels

    rng = np.random.default_rng(99)
    for P, T, W, halo in [(2, 5, 2, 5), (1, 4, 3, 3), (3, 6, 4, 1),
                          (2, 3, 2, 7)]:
        NW = W + halo + 1
        gw = T * W
        planes = rng.integers(0, 1 << 32, size=(P, gw), dtype=np.uint32)
        got = np.asarray(
            _kernels()["windows"](planes, T=T, W=W, halo=halo)
        ).transpose(1, 2, 0)  # (NW, P, T) -> (P, T, NW)
        flat = np.zeros((P, max(gw, T * W + W + 1, NW)), dtype=np.uint32)
        flat[:, :gw] = planes
        want = np.zeros((P, T, NW), dtype=np.uint32)
        want[:, 0, :] = flat[:, :NW]  # tile 0: owned prefix window
        for t in range(1, T):
            for w in range(NW):
                src = t * W - halo + w
                if 0 <= src < flat.shape[1]:
                    want[:, t, w] = flat[:, src]
        np.testing.assert_array_equal(got, want, err_msg=f"{(P, T, W, halo)}")


def test_xla_engine_forced_halo_gt_w():
    """End-to-end scan correctness when the layout has halo > W: force the
    planner to a degenerate geometry and compare against the oracle."""
    from sassy_tpu.search import make_engine

    rng = np.random.default_rng(123)
    pat, text = _planted_case(rng, 70, 900, 5, 2)
    eng = make_engine("xla")
    orig = eng._plan_layout
    # m_bucket=72,k=5 -> halo words = ceil(77/32) = 3; force W=2 < halo
    eng._plan_layout = lambda wn, halo, m_bucket=32: (
        (-(-max(1, -(-len(text) // 32)) // 2)), 2, halo
    )
    try:
        prof = profiles.Iupac()
        got = eng.candidates(prof, prof.encode(np.frombuffer(pat, np.uint8)),
                             np.frombuffer(text, np.uint8), 5, None, None,
                             False)
    finally:
        eng._plan_layout = orig
    sn = Searcher(profiles.Iupac(), rc=False, engine="numpy")
    want = sn._engine().candidates(
        profiles.Iupac(),
        profiles.Iupac().encode(np.frombuffer(pat, np.uint8)),
        np.frombuffer(text, np.uint8), 5, None, None, False,
    )
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))

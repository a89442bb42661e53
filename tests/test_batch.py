"""Batched cartesian-product engine vs the oracle loop.

The contract: search_many/search_texts/search_patterns/search_encoded_patterns
through the batched device engine produce exactly the matches of the
pairwise NumPy-oracle loop (including CIGARs), for short texts, long texts
that force multi-piece segmentation, rc, overhang, and all alphabets.
"""

import numpy as np
import pytest

from sassy_tpu import Searcher, profiles

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_texts(rng, count, lo, hi):
    return [bytes(rng.choice(BASES, size=int(rng.integers(lo, hi)))) for _ in range(count)]


def _assert_same(a, b, ctx=""):
    a, b = sorted(a), sorted(b)
    assert len(a) == len(b), (ctx, len(a), len(b), a[:4], b[:4])
    for x, y in zip(a, b):
        assert x.same_as(y), (ctx, x, y)


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("alpha", [None, 0.5])
def test_search_many_matches_oracle(rc, alpha):
    rng = np.random.default_rng(42 + int(rc) + (0 if alpha is None else 10))
    prof = profiles.Iupac()
    texts = _random_texts(rng, 5, 50, 400)
    m = 12
    patterns = [bytes(rng.choice(BASES, size=m)) for _ in range(4)]
    # plant matches
    texts[0] = patterns[0] + texts[0]
    texts[2] = texts[2] + patterns[3]

    batched = Searcher(prof, rc=rc, alpha=alpha, engine="xla")
    oracle = Searcher(prof, rc=rc, alpha=alpha, engine="numpy")
    got = batched.search_many(patterns, texts, 2)
    want = oracle.search_many(patterns, texts, 2)
    _assert_same(got, want, (rc, alpha))


def test_search_many_unequal_lengths():
    rng = np.random.default_rng(7)
    prof = profiles.Dna()
    texts = _random_texts(rng, 3, 100, 300)
    patterns = [
        bytes(rng.choice(BASES, size=m)) for m in (8, 23, 40, 150)
    ]
    batched = Searcher(prof, engine="xla")
    oracle = Searcher(prof, engine="numpy")
    _assert_same(
        batched.search_many(patterns, texts, 3),
        oracle.search_many(patterns, texts, 3),
        "unequal",
    )


def test_long_text_segmentation():
    """Force multi-piece segmentation by shrinking the piece size."""
    from sassy_tpu.ops.batch import BatchEngine

    rng = np.random.default_rng(9)
    prof = profiles.Iupac()
    text = rng.choice(BASES, size=7000)
    pat = rng.choice(BASES, size=24)
    for off in (0, 1000, 2040, 2047, 2048, 2049, 6976):
        text[off : off + 24] = pat

    eng = BatchEngine(w_max_words=64)  # pieces of 2048 chars
    got = eng.candidates_many(prof, [prof.encode(pat)], [text], 3)[0][0]

    s = Searcher(prof, engine="numpy")
    want = s.engine.candidates(prof, prof.encode(pat), text, 3, None, None, False)
    assert list(got) == sorted(want), (got[:10], sorted(want)[:10])


def test_search_texts_and_patterns():
    rng = np.random.default_rng(11)
    prof = profiles.Iupac()
    texts = _random_texts(rng, 6, 30, 200)
    pat = bytes(rng.choice(BASES, size=15))
    b = Searcher(prof, rc=True, engine="xla")
    o = Searcher(prof, rc=True, engine="numpy")
    _assert_same(b.search_texts(pat, texts, 2), o.search_texts(pat, texts, 2), "texts")

    pats = [bytes(rng.choice(BASES, size=15)) for _ in range(5)]
    text = texts[0] + pats[2] + texts[1]
    _assert_same(
        b.search_patterns(pats, text, 2), o.search_patterns(pats, text, 2), "patterns"
    )


def test_encoded_patterns_api():
    rng = np.random.default_rng(13)
    prof = profiles.Iupac()
    pats = [bytes(rng.choice(BASES, size=20)) for _ in range(6)]
    text = _random_texts(rng, 1, 500, 501)[0] + pats[1] + pats[4]

    b = Searcher(prof, rc=True, engine="xla")
    enc = b.encode_patterns(pats)
    assert enc.n_original == 6 and enc.include_rc
    got = b.search_encoded_patterns(enc, text, 2)

    o = Searcher(prof, rc=True, engine="numpy")
    want = []
    for pi, p in enumerate(pats):
        for m in o.search(p, text, 2):
            m.pattern_idx = pi
            want.append(m)
    _assert_same(got, want, "encoded")

    with pytest.raises(ValueError):
        b.encode_patterns([b"ACGT", b"ACGTA"])


def test_batch_ascii_profile():
    b = Searcher(profiles.Ascii(case_sensitive=False), engine="xla")
    o = Searcher(profiles.Ascii(case_sensitive=False), engine="numpy")
    texts = [b"the quick brown fox jumps over the lazy dog", b"HELLO WORLD hello"]
    pats = [b"hello", b"quick"]
    _assert_same(b.search_many(pats, texts, 1), o.search_many(pats, texts, 1), "ascii")


def test_batch_all_minima_and_overhang_steps():
    rng = np.random.default_rng(17)
    prof = profiles.Iupac()
    texts = _random_texts(rng, 3, 20, 60)
    pats = [bytes(rng.choice(BASES, size=10)) for _ in range(2)]
    b = Searcher(prof, rc=True, alpha=0.25, engine="xla")
    o = Searcher(prof, rc=True, alpha=0.25, engine="numpy")
    for pat in pats:
        _assert_same(
            b.search_all_texts(pat, texts, 4),
            o.search_all_texts(pat, texts, 4),
            "all_minima_overhang",
        )


def test_hierarchical_prefilter_exact():
    """Force the suffix-prefilter path (>=256 tiles) and compare with the
    oracle — the prefilter must be invisible in the output."""
    from sassy_tpu.ops.batch import BatchEngine

    rng = np.random.default_rng(21)
    prof = profiles.Iupac()
    # 300 short texts -> >=256 tiles in one dispatch
    texts = [rng.choice(BASES, size=160).copy() for _ in range(300)]
    pats = [rng.choice(BASES, size=72) for _ in range(3)]
    # plant exact + mutated copies incl. boundary-ish offsets
    for i in (0, 7, 123, 255, 299):
        texts[i][10:82] = pats[i % 3]
    mut = pats[1].copy()
    mut[5] = BASES[(int(np.where(BASES == mut[5])[0][0]) + 1) % 4]
    texts[50][80:152] = mut

    eng = BatchEngine()
    from sassy_tpu.ops.batch import _suffix_rows
    assert _suffix_rows(72, 2) == 32
    got = eng.candidates_many(prof, [prof.encode(p) for p in pats], texts, 2)

    from sassy_tpu.search import NumpyEngine

    oracle = NumpyEngine()
    for qi, pat in enumerate(pats):
        for ti, text in enumerate(texts):
            want = oracle.candidates(
                prof, prof.encode(pat), text, 2, None, None, False
            )
            assert list(got[qi][ti]) == sorted(want), (qi, ti, got[qi][ti], want)


def test_hierarchical_gate():
    from sassy_tpu.ops.batch import _suffix_rows

    assert _suffix_rows(24, 0) == 8
    assert _suffix_rows(80, 3) == 32  # selectivity needs 8 + 6k rows
    assert _suffix_rows(24, 3) == 0   # suffix would not be selective enough
    assert _suffix_rows(64, 5) == 0   # k too large for any suffix
    assert _suffix_rows(24, 8) == 0
    assert _suffix_rows(16, 3) == 0   # pattern not longer than suffix
    assert _suffix_rows(8, 0) == 0


@pytest.mark.slow
def test_batch_pallas_interpret():
    """The pallas batch backend (interpret mode on CPU) agrees with xla."""
    from sassy_tpu.ops.batch import BatchEngine

    rng = np.random.default_rng(33)
    prof = profiles.Iupac()
    texts = [rng.choice(BASES, size=200).copy() for _ in range(5)]
    pats = [rng.choice(BASES, size=20) for _ in range(2)]
    texts[2][50:70] = pats[0]
    qc = [prof.encode(p) for p in pats]
    a = BatchEngine(backend="pallas", interpret=True).candidates_many(
        prof, qc, texts, 2
    )
    b = BatchEngine(backend="xla").candidates_many(prof, qc, texts, 2)
    assert a == b


def test_batch_only_best_and_without_trace():
    rng = np.random.default_rng(41)
    prof = profiles.Iupac()
    pat = bytes(rng.choice(BASES, size=18))
    texts = [bytes(rng.choice(BASES, size=120)) + pat + pat for _ in range(3)]
    for conf in ("best", "notrace"):
        b = Searcher(prof, rc=True, engine="xla")
        o = Searcher(prof, rc=True, engine="numpy")
        if conf == "best":
            b.only_best_match(), o.only_best_match()
        else:
            b.without_trace(), o.without_trace()
        _assert_same(
            b.search_many([pat], texts, 2), o.search_many([pat], texts, 2), conf
        )


def test_batch_empty_and_tiny_texts():
    prof = profiles.Iupac()
    b = Searcher(prof, engine="xla")
    o = Searcher(prof, engine="numpy")
    texts = [b"", b"A", b"ACGTACGT", b""]
    pat = b"ACGT"
    _assert_same(b.search_many([pat], texts, 1), o.search_many([pat], texts, 1),
                 "empty")


def test_v2_rc_anchor_start():
    """rc_anchor='start' (v2 semantics, reference lib.rs:33-40): RC strand
    searched as RC(pattern) on the forward text. Match SETS agree with v1
    for exact matches; anchors may differ only at tied plateaus."""
    import numpy as np

    from sassy_tpu import Searcher, Strand, profiles

    prof = profiles.Dna()
    pattern = b"ATCGATCA"
    rc = bytes(prof.reverse_complement(pattern))
    text = b"GGGGGGGG" + rc + b"GGGGGGGG"
    s = Searcher(prof, rc=True, engine="xla")
    enc = s.encode_patterns([pattern], include_rc=True, rc_anchor="start")
    got = s.search_all_encoded_patterns(enc, text, 0)
    rcm = [m for m in got if m.strand is Strand.RC]
    assert len(rcm) == 1
    m = rcm[0]
    assert (m.text_start, m.text_end, m.cost) == (8, 16, 0)
    assert m.cigar.to_string() == "8="
    # and the v1 anchors give the identical exact match
    enc1 = s.encode_patterns([pattern], include_rc=True)
    got1 = s.search_all_encoded_patterns(enc1, text, 0)
    rc1 = [m for m in got1 if m.strand is Strand.RC]
    assert [(m.text_start, m.text_end, m.cost) for m in rc1] == [
        (m.text_start, m.text_end, m.cost) for m in rcm
    ]

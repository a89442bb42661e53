"""Device-side TextSet paths: on-device plane packing, device-derived
reversed planes (RC strand without a second upload), and device window
assembly — all must be bit-compatible with the host packers.

Reference analog: sassy materializes a reversed copy per text (CachedRev,
/root/reference/src/search.rs); here the reversed strand is derived on
device because the host->device link dominates fresh-text searches."""

import numpy as np
import pytest

from sassy_tpu.ops.batch import BatchEngine, TextSet
from sassy_tpu.profiles import Iupac

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _force_device_path(monkeypatch):
    # the device-assembly gate is sized for genomes; tests force it on
    monkeypatch.setattr(TextSet, "DEV_MIN_BYTES", 0)


def test_reverse_planes_matches_host_pack():
    import jax.numpy as jnp

    from sassy_tpu.ops.myers_xla import _bucket_words, _cdiv, _kernels

    rng = np.random.default_rng(9)
    prof = Iupac()
    ker = _kernels()
    args = (prof.planes, False, prof.pack_mode, prof.pack_shift,
            prof.pack_mask, tuple(prof.pack_plane_masks),
            prof.pack_fold_case)
    for n in (5, 31, 32, 33, 100, 1000, 4097):
        t = rng.choice(BASES, size=n)
        gw = _bucket_words(max(1, _cdiv(n, 32)))
        buf = np.zeros(gw * 32, np.uint8)
        buf[:n] = t
        nw, nb = np.int32(n // 32), np.int32(n % 32)
        fwd = ker["pack_jit"](jnp.asarray(buf), nw, nb, *args)
        rev = np.asarray(ker["reverse_planes"](fwd, nw, nb))
        bufr = np.zeros(gw * 32, np.uint8)
        bufr[:n] = t[::-1]
        ref = np.asarray(ker["pack_jit"](jnp.asarray(bufr), nw, nb, *args))
        assert (rev == ref).all(), n


@pytest.mark.slow
def test_batch_device_assembly_and_reverse_parity():
    rng = np.random.default_rng(11)
    prof = Iupac()
    texts = [rng.choice(BASES, size=n) for n in (40000, 7000)]
    pats = [rng.choice(BASES, size=23) for _ in range(4)]
    texts[0][1000:1023] = pats[0][::-1]
    texts[1][6977:7000] = pats[1][::-1]  # plant at the rev-text start
    texts[0][39000:39023] = pats[2]
    codes = [prof.encode(p) for p in pats]
    eng = BatchEngine(backend="pallas", interpret=True)
    ref_eng = BatchEngine(backend="xla")
    ts = TextSet(texts)
    assert eng.candidates_many(prof, codes, ts, 3) == \
        ref_eng.candidates_many(prof, codes, texts, 3)
    assert eng.candidates_many(prof, codes, ts, 3, reverse=True) == \
        ref_eng.candidates_many(
            prof, codes, [np.ascontiguousarray(t[::-1]) for t in texts], 3
        )


def test_search_many_rc_uses_shared_textset():
    from sassy_tpu import Searcher, profiles as P

    rng = np.random.default_rng(21)
    texts = [bytes(rng.choice(BASES, size=n)) for n in (30000, 9000)]
    pats = [bytes(rng.choice(BASES, size=22)) for _ in range(3)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    t0 = bytearray(texts[0])
    t0[500:522] = pats[0]
    t0[20000:20022] = pats[1].translate(comp)[::-1]
    texts[0] = bytes(t0)

    def key(ms):
        return sorted(
            (m.pattern_idx, m.text_idx, m.text_start, m.text_end, m.cost,
             str(m.strand))
            for m in ms
        )

    from sassy_tpu.ops.myers_pallas import PallasEngine

    sp = Searcher(P.Iupac(), rc=True, engine=PallasEngine(interpret=True))
    sn = Searcher(P.Iupac(), rc=True, engine="numpy")
    assert key(sp.search_many(pats, texts, 3)) == \
        key(sn.search_many(pats, texts, 3))


@pytest.mark.slow
def test_reverse_device_assembly_adversarial():
    """The round-1 bug classes (tile-boundary lookahead, plateau
    decreasing-state) replayed against the device-assembled REVERSED
    windows: exact matches planted so they straddle piece boundaries in
    reversed coordinates, plus homopolymer plateaus. Must equal the host
    path on the reversed texts bit-for-bit."""
    rng = np.random.default_rng(123)
    prof = Iupac()
    eng = BatchEngine(backend="pallas", interpret=True, cell_budget=1 << 18)
    ref = BatchEngine(backend="xla", cell_budget=1 << 18)
    for trial in range(4):
        m = int(rng.integers(4, 10))
        k = int(rng.integers(0, 3))
        pat = rng.choice(BASES, size=m)
        n = 6000
        segs, tot = [], 0
        while tot < n:
            r = int(rng.integers(30, 500))
            segs.append(np.full(r, rng.choice(BASES), np.uint8))
            tot += r
        text = np.concatenate(segs)[:n]
        # plants whose REVERSED coordinates sit at power-of-two piece
        # boundaries (reversed pos p <-> forward pos n-1-p)
        for p in (512, 1024, 4096):
            f0 = n - (p + m)
            text[f0 : f0 + m] = pat[::-1]
        ts = TextSet([text])
        got = eng.candidates_many(prof, [pat], ts, k, reverse=True)
        want = ref.candidates_many(
            prof, [pat], [np.ascontiguousarray(text[::-1])], k
        )
        assert got == want, (trial, m, k)


def test_plan_tv_genome_scale_positions():
    """Regression (round 3): a 3.12 Gbp text overflowed the int32 tile
    vectors (text_end of early pieces > 2^31). The plan must build, clamp
    text_end into int32 (piece-local overshoot is unaffected: in-piece
    positions are far below the clamp), and keep exact global positions
    via Python-int piece start_chars."""
    n = 3_120_000_000
    ts = TextSet.__new__(TextSet)
    ts.texts = []
    ts.lens = [n]
    ts._packs = {}
    pieces, tv = ts._plan_tv(0, 27, 4096, 1024)
    assert tv.dtype == np.int32
    real = [p for p in pieces if p.text_idx >= 0]
    # ownership tiles: every global position 1..n owned exactly once
    last = real[-1]
    assert last.start_char + last.valid_to == n
    assert int(tv[1].max()) <= 1 << 30
    # piece-local spans stay small
    assert int(tv[3].max()) <= 4096

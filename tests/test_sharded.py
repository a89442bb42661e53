"""Sharded (multi-device) search vs the NumPy oracle.

Runs on the 8-virtual-CPU-device mesh set up in conftest.py — the same
validation path the driver's dryrun_multichip uses.
"""

import numpy as np
import pytest

from sassy_tpu.parallel import ShardedSearch, make_mesh
from sassy_tpu.profiles import Dna, Iupac
from sassy_tpu.search import NumpyEngine

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mesh(n_text, n_pat=1):
    import jax

    if len(jax.devices()) < n_text * n_pat:
        pytest.skip("not enough devices")
    return make_mesh(n_text=n_text, n_pat=n_pat)


@pytest.mark.parametrize("n_text,n_pat", [(8, 1), (4, 2), (2, 1), (1, 1)])
def test_sharded_matches_oracle(n_text, n_pat):
    mesh = _mesh(n_text, n_pat)
    ss = ShardedSearch(mesh=mesh, cap=1 << 12, bcap=1 << 10)
    oracle = NumpyEngine()
    rng = np.random.default_rng(n_text * 10 + n_pat)
    prof = Iupac()

    for trial in range(4):
        n = int(rng.integers(200, 3000))
        m = int(rng.integers(5, 40))
        k = int(rng.integers(0, 5))
        all_minima = bool(rng.integers(0, 2))
        alpha = [None, 0.5, 0.3][trial % 3]
        text = rng.choice(BASES, size=n)
        pats = [rng.choice(BASES, size=m) for _ in range(3)]
        # plant a match
        text[50 : 50 + m] = pats[0]

        got = ss.candidates_batch(
            prof, pats, text, k, alpha=alpha, all_minima=all_minima
        )
        for pat, cands in zip(pats, got):
            want = oracle.candidates(
                prof, prof.encode(pat), text, k, alpha, None, all_minima
            )
            assert sorted(cands) == sorted(want), (
                n, m, k, alpha, all_minima, sorted(cands)[:8], sorted(want)[:8]
            )


def test_sharded_dna_profile():
    mesh = _mesh(4)
    ss = ShardedSearch(mesh=mesh)
    oracle = NumpyEngine()
    rng = np.random.default_rng(7)
    prof = Dna()
    text = rng.choice(BASES, size=1000)
    pats = [rng.choice(BASES, size=12) for _ in range(2)]
    got = ss.candidates_batch(prof, pats, text, 2)
    for pat, cands in zip(pats, got):
        want = oracle.candidates(prof, prof.encode(pat), text, 2, None, None, False)
        assert sorted(cands) == sorted(want)


def test_dryrun_entry():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    import jax

    out = jax.jit(fn)(*args)
    assert np.asarray(out).shape[0] > 2

    ge.dryrun_multichip(8)


@pytest.mark.parametrize("n_text,n_pat", [(4, 1), (2, 2)])
@pytest.mark.slow
def test_sharded_pallas_interpret_matches_oracle(n_text, n_pat):
    """The Pallas-backend sharded path (interpret mode on CPU) must agree
    with the oracle — the production multi-chip configuration runs this
    exact code with interpret=False."""
    mesh = _mesh(n_text, n_pat)
    ss = ShardedSearch(
        mesh=mesh, cap=1 << 12, bcap=1 << 10, backend="pallas", interpret=True
    )
    oracle = NumpyEngine()
    rng = np.random.default_rng(99)
    prof = Iupac()
    for trial in range(3):
        n = int(rng.integers(300, 1500))
        m = int(rng.integers(6, 30))
        k = int(rng.integers(0, 4))
        all_minima = bool(trial % 2)
        text = rng.choice(BASES, size=n)
        # trial 2: one pattern per device (exercises the q1-kernel branch)
        pats = [rng.choice(BASES, size=m) for _ in range(1 if trial == 2 else 3)]
        text[40 : 40 + m] = pats[0]
        got = ss.candidates_batch(prof, pats, text, k, all_minima=all_minima)
        for pat, cands in zip(pats, got):
            want = oracle.candidates(
                prof, prof.encode(pat), text, k, None, None, all_minima
            )
            assert sorted(cands) == sorted(want), (
                n, m, k, all_minima, sorted(cands)[:8], sorted(want)[:8]
            )


@pytest.mark.slow
def test_sharded_hier_prefilter_interpret():
    """Sharded suffix prefilter (forced on) must stay oracle-exact —
    long patterns, small k (the prefilter's target regime)."""
    mesh = _mesh(2, 1)
    ss = ShardedSearch(
        mesh=mesh, backend="pallas", interpret=True, hier=True
    )
    oracle = NumpyEngine()
    rng = np.random.default_rng(123)
    prof = Iupac()
    m, k = 80, 2
    text = rng.choice(BASES, size=4000)
    pats = [rng.choice(BASES, size=m) for _ in range(2)]
    text[100 : 100 + m] = pats[0]
    text[2000 : 2000 + m] = pats[1]
    for allm in (False, True):
        got = ss.candidates_batch(prof, pats, text, k, all_minima=allm)
        for pat, cands in zip(pats, got):
            want = oracle.candidates(
                prof, prof.encode(pat), text, k, None, None, allm
            )
            assert sorted(map(tuple, cands)) == sorted(map(tuple, want)), allm


@pytest.mark.parametrize("batch", [1, 2, None])
def test_sharded_overhang_batch_matches_oracle(monkeypatch, batch):
    """The overhang path gives the oracle's candidates whether its local
    patterns run one at a time, in batches with a remainder, or sized
    from the shard."""
    from sassy_tpu.parallel import sharded

    if batch is not None:
        monkeypatch.setattr(sharded, "overhang_batch_for", lambda p, q: batch)
    ss = ShardedSearch(mesh=_mesh(4))
    rng = np.random.default_rng(11)
    prof = Iupac()
    text = rng.choice(BASES, size=2500)
    pats = [rng.choice(BASES, size=17) for _ in range(3)]
    text[40:57] = pats[1]
    got = ss.candidates_batch(prof, pats, text, 3, alpha=0.5)
    for pat, cands in zip(pats, got):
        want = NumpyEngine().candidates(
            prof, prof.encode(pat), text, 3, 0.5, None, False
        )
        assert sorted(cands) == sorted(want)


@pytest.mark.parametrize(
    "positions,q_local,want",
    [(32_050_176, 32, 8), (780_000_000, 32, 1), (1000, 32, 32), (1000, 5, 4),
     (1000, 1, 1)],
)
def test_overhang_batch_for(positions, q_local, want):
    from sassy_tpu.parallel.sharded import overhang_batch_for

    assert overhang_batch_for(positions, q_local) == want

"""Pallas engine conformance with the kernel in interpret mode (CPU).

Small cases only — the Pallas interpreter is slow. The compiled kernel is
checked against ``scan_core`` on the GPU by chip_smoke.py.
"""

import numpy as np
import pytest

from sassy_tpu import Searcher, profiles
from sassy_tpu.ops.myers_pallas import PallasEngine


@pytest.fixture(scope="module")
def engines():
    return PallasEngine(interpret=True)


def test_pallas_matches_numpy_small(engines):
    sp = Searcher(profiles.Iupac(), rc=True, alpha=0.5, engine=engines)
    sn = Searcher(profiles.Iupac(), rc=True, alpha=0.5, engine="numpy")
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    for _ in range(3):
        pat = rng.choice(bases, size=int(rng.integers(4, 18))).tobytes()
        txt = rng.choice(bases, size=int(rng.integers(10, 150))).tobytes()
        k = int(rng.integers(0, 3))
        a = sp.search(pat, txt, k)
        b = sn.search(pat, txt, k)
        assert len(a) == len(b), (pat, txt, k)
        for x, y in zip(a, b):
            assert x.same_as(y), (pat, txt, k, x, y)


@pytest.mark.slow
def test_pallas_ascii_mode(engines):
    sp = Searcher(profiles.Ascii(case_sensitive=False), engine=engines)
    sn = Searcher(profiles.Ascii(case_sensitive=False), engine="numpy")
    a = sp.search(b"Hello", b"say hello There HELLo", 1)
    b = sn.search(b"Hello", b"say hello There HELLo", 1)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.same_as(y)

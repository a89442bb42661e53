"""The GPU scan kernel on the CPU: every variant in the Pallas interpreter
against ``scan_core`` (bit-exact), the lane padding and plans that feed it,
the one backend decision, and the compile-cache rule.

The compiled kernel is checked against the same reference on the card by
chip_smoke.py (phase "kernel").
"""

import numpy as np
import pytest

from sassy_tpu.ops import CACHE_DIR, cache_dir
from sassy_tpu.ops.backend import choose_scan
from sassy_tpu.ops.myers_pallas import (
    LANE_BLOCK,
    UNROLL_ROWS,
    PallasEngine,
    pad_lanes,
    scan_q,
)
from sassy_tpu.profiles import Ascii, Iupac

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _reference(win, tile0, pm, ip, hi, m, bm, vf, vt, k, eq_mode):
    import jax
    import jax.numpy as jnp

    from sassy_tpu.ops.minima import meta_from_words
    from sassy_tpu.ops.myers_xla import _kernels

    scan_core = _kernels()["scan_core"]
    outs = []
    for q in range(pm.shape[0]):
        hp0 = jnp.where(ip[q][:, None] != 0, jnp.uint32(0),
                        jnp.where(tile0[None, :], hi[q][:, None],
                                  jnp.uint32(1)))
        c0 = jnp.where(tile0, bm[q], m[q]).astype(jnp.int32)
        vp, vm, c = scan_core(win, pm[q], ip[q], hp0, jnp.zeros_like(hp0),
                              c0, eq_mode)
        meta, fin = meta_from_words(jax, jnp, vp, vm, c, vf, vt, k)
        outs.append((vp, vm, c, meta, fin))
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]


def _case(profile, patterns, text, W, halo, alpha=None, seed=0):
    """Windows of ``text`` on a (T, W, halo) tiling plus pattern inputs,
    shaped as the engines build them."""
    import jax.numpy as jnp

    from sassy_tpu.ops.myers_xla import (
        PreparedText,
        _kernels,
        pattern_inputs_np,
    )

    rng = np.random.default_rng(seed)
    planes = PreparedText(profile, text).planes
    T = pad_lanes(-(-planes.shape[1] // W))
    win = _kernels()["windows"](planes, T=T, W=W, halo=halo)
    per = [pattern_inputs_np(profile, profile.encode(p), alpha, None)
           for p in patterns]
    pm = jnp.asarray(np.stack([p[0] for p in per]))
    ip = jnp.asarray(np.stack([p[1] for p in per]))
    hi = jnp.asarray(np.stack([p[2] for p in per]))
    m = jnp.asarray([len(p) for p in patterns], jnp.int32)
    bm = jnp.asarray([p[3] for p in per], jnp.int32)
    tile0 = jnp.asarray(rng.integers(0, 2, T).astype(bool)).at[0].set(True)
    vf = jnp.asarray(rng.integers(-1, halo * 32 + 8, T), jnp.int32)
    vt = jnp.asarray(rng.integers(halo * 32, (W + halo + 1) * 32, T),
                     jnp.int32)
    return win, tile0, pm, ip, hi, m, bm, vf, vt


def _dna(rng, n, n_rate=0.01):
    t = rng.choice(BASES, size=n)
    t[rng.integers(0, n, int(n * n_rate))] = ord("N")
    return t


@pytest.mark.parametrize(
    "name,q,m,meta",
    [
        ("q1_short_meta", 1, 12, True),
        ("q1_short_nometa", 1, 12, False),
        ("q3_meta", 3, 23, True),
        ("q2_long_meta", 2, 70, True),
        ("q1_long_nometa", 1, 70, False),
    ],
)
def test_kernel_iupac_matches_scan_core(name, q, m, meta):
    """IUPAC text with N, ACGT-pure and degenerate patterns, overhang
    h-init, meta on and off, register rows (M <= 64) and the scratch
    rows (M > 64), one and several patterns."""
    import jax.numpy as jnp

    rng = np.random.default_rng(m * 10 + q)
    text = _dna(rng, 9000)
    pats = [rng.choice(BASES, size=m) for _ in range(q)]
    pats[-1][: min(4, m)] = np.frombuffer(b"RYNK", np.uint8)[: min(4, m)]
    W = 16
    halo = 1 if m <= 27 else 4
    args = _case(Iupac(), pats, text, W, halo, alpha=0.5)
    k = jnp.int32(3)
    want = _reference(*args, k, "iupac")
    if meta:
        got = scan_q(*args[:7], eq_mode="iupac", interpret=True,
                     vf=args[7], vt=args[8], k=k)
    else:
        got = scan_q(*args[:7], eq_mode="iupac", interpret=True)
    assert len(got) == (5 if meta else 3)
    assert (UNROLL_ROWS < args[2].shape[1]) == (m > 64)
    for nm, g, w in zip(("vp", "vm", "cost", "meta", "final"), got, want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, nm
        assert (g == w).all(), (name, nm)


def test_kernel_ascii_matches_scan_core():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    text = rng.integers(32, 127, size=5000, dtype=np.uint8)
    pats = [text[100:110].copy(), b"hello wor"]
    args = _case(Ascii(case_sensitive=False), pats, text, 16, 1)
    k = jnp.int32(2)
    want = _reference(*args, k, "ascii")
    got = scan_q(*args[:7], eq_mode="ascii", interpret=True,
                 vf=args[7], vt=args[8], k=k)
    for g, w in zip(got, want):
        assert (np.asarray(g) == w).all()


def test_kernel_rejects_unpadded_lanes():
    import jax.numpy as jnp

    win = jnp.zeros((4, 4, LANE_BLOCK + 1), jnp.uint32)
    z = jnp.zeros((1, 8), jnp.uint32)
    with pytest.raises(AssertionError):
        scan_q(win, jnp.zeros((LANE_BLOCK + 1,), bool),
               jnp.zeros((1, 8, 4), jnp.uint32), z, z,
               jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
               eq_mode="iupac", interpret=True)


@pytest.mark.parametrize("t,want", [(1, LANE_BLOCK), (LANE_BLOCK, LANE_BLOCK),
                                    (LANE_BLOCK + 1, 2 * LANE_BLOCK),
                                    (131071, 131072)])
def test_pad_lanes(t, want):
    assert pad_lanes(t) == want


@pytest.mark.parametrize("backend,t,want", [
    ("pallas", 1, LANE_BLOCK), ("pallas", LANE_BLOCK + 1, 2 * LANE_BLOCK),
    ("xla", 1, 1), ("xla", LANE_BLOCK + 1, LANE_BLOCK + 1),
])
def test_pad_lanes_for_backend(backend, t, want):
    """Only the kernel pads lanes; the XLA scan takes any lane count."""
    from sassy_tpu.ops.backend import lane_multiple, pad_lanes_for

    assert pad_lanes_for(backend, t) == want
    assert lane_multiple(backend) == (LANE_BLOCK if backend == "pallas" else 1)


@pytest.mark.parametrize("n,m,k", [(1000, 23, 3), (3_000_000, 23, 3),
                                   (200_000, 200, 10), (5_000_000, 1000, 40)])
def test_pallas_plan_pads_lanes_and_bounds_halo(n, m, k):
    """The kernel engine's plan: whole lane blocks, halo re-scan <= 25%
    (W >= 4 * halo), and tiles no wider than that floor until the plan
    has its target lane count."""
    rng = np.random.default_rng(n)
    text = rng.choice(BASES, size=n)
    eng = PallasEngine(interpret=True)
    prof = Iupac()
    _, st = eng.build_inputs(prof, prof.encode(rng.choice(BASES, size=m)),
                             text, k)
    assert st["T"] % LANE_BLOCK == 0
    assert st["W"] >= 4 * st["halo"]
    assert st["T"] * st["W"] * 32 >= n
    assert (st["W"] <= max(4 * st["halo"], 16)
            or st["T"] >= PallasEngine.TARGET_LANES)


def test_batch_plan_pads_pieces_to_lane_blocks():
    from sassy_tpu.ops.batch import BatchEngine, TextSet

    rng = np.random.default_rng(8)
    ts = TextSet([rng.choice(BASES, size=n) for n in (70_000, 333, 12_345)])
    be = BatchEngine(backend="pallas", interpret=True, cell_budget=1 << 20)
    w_chars, pad_mult, t_chunk, q_chunk = be.plan(ts, Iupac(), 24, 0, 27, 5)
    assert pad_mult == LANE_BLOCK and t_chunk % LANE_BLOCK == 0
    pieces, tv = ts._plan_tv(0, 27, w_chars, pad_mult)
    assert len(pieces) % LANE_BLOCK == 0 and tv.shape[1] == len(pieces)
    xla = BatchEngine(backend="xla", cell_budget=1 << 20)
    assert xla.plan(ts, Iupac(), 24, 0, 27, 5)[1] == 1


def test_batch_plan_keeps_chunk_positions_in_int32():
    from sassy_tpu.ops.batch import BatchEngine, TextSet

    ts = TextSet.__new__(TextSet)
    ts.texts, ts.lens, ts._packs = [], [3_000_000_000], {}
    be = BatchEngine(backend="xla", cell_budget=1 << 40)
    w_chars, _, t_chunk, _ = be.plan(ts, Iupac(), 24, 0, 27, 1)
    assert t_chunk * (w_chars + 1) < 1 << 31


@pytest.mark.parametrize(
    "platform,interpret,want",
    [("gpu", False, ("pallas", False)), ("cpu", False, ("xla", False)),
     ("cpu", True, ("pallas", True)), ("gpu", True, ("pallas", True))],
)
def test_choose_scan(monkeypatch, platform, interpret, want):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert choose_scan(interpret) == want


def test_choose_scan_refuses_other_platforms(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError):
        choose_scan()


def test_engines_follow_the_decision_on_cpu():
    from sassy_tpu.ops.batch import BatchEngine
    from sassy_tpu.ops.myers_xla import XlaEngine
    from sassy_tpu.parallel import ShardedSearch
    from sassy_tpu.search import make_engine

    assert isinstance(make_engine("auto"), XlaEngine)
    assert make_engine("auto").backend == "xla"
    assert (BatchEngine().backend, BatchEngine().interpret) == ("xla", False)
    assert ShardedSearch().backend == "xla"
    b = BatchEngine(interpret=True)
    assert (b.backend, b.interpret) == ("pallas", True)
    with pytest.raises(RuntimeError):
        PallasEngine()  # compiled kernel needs a GPU


@pytest.mark.parametrize(
    "env,platform,want",
    [({}, "gpu", CACHE_DIR), ({}, "cpu", None),
     ({"JAX_COMPILATION_CACHE_DIR": "/x"}, "gpu", None),
     ({"JAX_COMPILATION_CACHE_DIR": "/x"}, "cpu", None)],
)
def test_cache_dir_rule(env, platform, want):
    assert cache_dir(env, platform) == want


def test_cache_dir_is_in_checkout_and_ignored():
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(CACHE_DIR) == root
    r = subprocess.run(["git", "check-ignore", "-q", CACHE_DIR], cwd=root)
    assert r.returncode in (0, 128)  # ignored, or not a git checkout

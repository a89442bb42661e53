"""Smoke test of the search path on one GPU, at full size.

Runs, in one process and in order (any failed phase fails the script):

1. device     — platform, kind and count of the JAX devices; the card's
                name and power limit from nvidia-smi. Exits non-zero when
                JAX finds no GPU.
2. kernel     — every variant of the scan kernel (ops/myers_pallas.py),
                compiled for the card, against ``scan_core`` (the plain XLA
                reference) on the same windows at the planner's real lane
                counts: vp, vm, cost, meta and final must be bit-identical.
3. end-to-end — the single-pattern engines and ``Searcher.search`` over
                1 GiB (with and without overhang), and the batched engine
                at the CRISPR off-targets shape (32 x 23bp x 128 Mbp, k=3,
                forward and reversed text): candidates equal the XLA
                engine's on the same card, every planted hit is found, and
                a 1 Mbp slice equals the NumPy oracle.
4. cli        — ``crispr`` and ``search`` through ``sassy_tpu.cli.main``
                over a generated multi-record FASTA of 256 MiB; rows equal
                the library's ``Searcher`` on the same input.

Peak device memory is printed after every phase. The last line of stdout is
``{"ok": true, "device": {...}}``, printed only when every phase passed.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # ShardedSearch on a 1 x 4 mesh vs BatchEngine
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GIB = 1 << 30
OFF_TARGETS_BP = 128_000_000
SLICE_BP = 1_000_000
K = 3


def card_line() -> str:
    """nvidia-smi's name and power limit (run before JAX takes the card)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip() or r.stderr.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_line(phase: str) -> None:
    import jax

    st = jax.devices()[0].memory_stats() or {}
    log(f"[{phase}] peak_bytes_in_use={st.get('peak_bytes_in_use')} "
        f"bytes_in_use={st.get('bytes_in_use')}")


def timed(fn, reps: int = 1):
    """(result, median seconds over ``reps`` calls after one warm call)."""
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, sorted(ts)[len(ts) // 2]


def random_dna(rng, n: int, n_rate: float = 0.0) -> np.ndarray:
    text = BASES[rng.integers(0, 4, size=n, dtype=np.uint8)]
    if n_rate:
        at = rng.integers(0, n, size=int(n * n_rate))
        text[at] = ord("N")
    return text


def mutate(rng, pat: np.ndarray, edits: int) -> np.ndarray:
    out = pat.copy()
    for i in rng.choice(len(pat), size=edits, replace=False):
        out[i] = BASES[(int(np.where(BASES == out[i])[0][0]) + 1) % 4]
    return out


def revcomp(seq: np.ndarray) -> np.ndarray:
    return np.frombuffer(bytes(seq[::-1]).translate(
        bytes.maketrans(b"ACGTN", b"TGCAN")), np.uint8).copy()


# ---------------------------------------------------------------------------
# phase 2: kernel vs reference


def reference_scan(win, tile0, pm, ip, hi, m, bm, vf, vt, k, eq_mode):
    """scan_core (+ meta_from_words) per pattern: the plain reference."""
    import jax
    import jax.numpy as jnp

    from sassy_tpu.ops.minima import meta_from_words
    from sassy_tpu.ops.myers_xla import _kernels

    scan_core = _kernels()["scan_core"]

    def one(pm, ip, hi, m, bm):
        hp0 = jnp.where(ip[:, None] != 0, jnp.uint32(0),
                        jnp.where(tile0[None, :], hi[:, None], jnp.uint32(1)))
        c0 = jnp.where(tile0, bm, m).astype(jnp.int32)
        vp, vm, c = scan_core(win, pm, ip, hp0, jnp.zeros_like(hp0), c0,
                              eq_mode)
        meta, fin = meta_from_words(jax, jnp, vp, vm, c, vf, vt, k)
        return vp, vm, c, meta, fin

    return jax.vmap(one)(pm, ip, hi, m, bm)


def compare_kernel(name, win, tile0, pats, vf, vt, eq_mode, meta, interpret):
    """One kernel variant vs the reference on the same windows."""
    import jax
    import jax.numpy as jnp

    from sassy_tpu.ops.myers_pallas import scan_q

    pm, ip, hi, m, bm = (jnp.asarray(np.stack(x)) for x in zip(*pats))
    k = jnp.int32(K)
    args = (win, tile0, pm, ip, hi, m, bm, vf, vt, k)

    def kern(*a):
        if meta:
            return scan_q(*a[:7], eq_mode=eq_mode, interpret=interpret,
                          vf=a[7], vt=a[8], k=a[9])
        return scan_q(*a[:7], eq_mode=eq_mode, interpret=interpret)

    t0 = time.perf_counter()
    compiled = jax.jit(kern).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    got = jax.block_until_ready(compiled(*args))
    want = jax.block_until_ready(
        jax.jit(reference_scan, static_argnums=10)(*args, eq_mode))
    names = ("vp", "vm", "cost", "meta", "final")[: len(got)]
    for nm, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: {nm} {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        diff = int(np.count_nonzero(g != w))
        check(diff == 0, f"{name}: {nm} differs in {diff} words")
    mem = compiled.memory_analysis()
    log(f"[kernel] {name}: Q={pm.shape[0]} M={pm.shape[1]} "
        f"NW={win.shape[0]} P={win.shape[1]} T={win.shape[2]} "
        f"bit-exact ({', '.join(names)}) compile={t_compile:.1f}s "
        f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes} "
        f"temp={mem.temp_size_in_bytes}")


def engine_windows(prof, prep, pattern, eng):
    """Windows, tile-0 mask and ownership vectors the engine's plan gives
    for ``pattern`` over ``prep`` (a PreparedText)."""
    import jax.numpy as jnp

    from sassy_tpu.ops.myers_xla import _kernels

    args, st = eng.build_inputs(prof, prof.encode(pattern), prep, K)
    T, W, halo = st["T"], st["W"], st["halo"]
    win = _kernels()["windows"](args[0], T=T, W=W, halo=halo)
    tile = jnp.arange(T, dtype=jnp.int32)
    vf = jnp.where(tile == 0, -1, halo * 32)
    vt = jnp.where(tile == 0, W * 32, (halo + W) * 32)
    return win, tile == 0, vf, vt


def phase_kernel(rng, interpret=False, text_bp=GIB, ascii_bp=GIB // 4,
                 batch_bp=OFF_TARGETS_BP):
    from sassy_tpu.ops.batch import BatchEngine, TextSet
    from sassy_tpu.ops.myers_pallas import PallasEngine
    from sassy_tpu.ops.myers_xla import PreparedText, pattern_inputs_np
    from sassy_tpu.profiles import Ascii, Iupac

    import jax.numpy as jnp

    prof = Iupac()
    eng = PallasEngine(interpret=interpret)
    prep = PreparedText(prof, jnp.asarray(random_dna(rng, text_bp, 1e-4)))
    pure = rng.choice(BASES, size=23)
    degenerate = np.frombuffer(b"ACGTRYNACGTKMSWACGTBDHV", np.uint8)

    def inputs(p, profile=prof, alpha=None):
        pm, ip, hi, bm = pattern_inputs_np(
            profile, profile.encode(p), alpha, None
        )
        return pm, ip, hi, np.int32(len(p)), np.int32(bm)

    win, t0, vf, vt = engine_windows(prof, prep, pure, eng)
    pats = [inputs(pure, alpha=0.5)]
    compare_kernel("iupac m=23 pure overhang-h", win, t0, pats, vf, vt,
                   "iupac", True, interpret)
    compare_kernel("iupac m=23 degenerate", win, t0, [inputs(degenerate)],
                   vf, vt, "iupac", True, interpret)
    compare_kernel("iupac m=23 no-meta", win, t0, pats, vf, vt, "iupac",
                   False, interpret)
    for m in (200, 1000):
        p = rng.choice(BASES, size=m)
        w, t0m, vfm, vtm = engine_windows(prof, prep, p, eng)
        compare_kernel(f"iupac m={m}", w, t0m, [inputs(p)], vfm, vtm,
                       "iupac", True, interpret)
    del win, prep

    # Q=32 at the off-targets plan: the first dispatch chunk's pieces
    be = BatchEngine(backend="pallas", interpret=interpret)
    guides = [rng.choice(BASES, size=23) for _ in range(31)] + [degenerate]
    per = [inputs(g) for g in guides]
    M = per[0][0].shape[0]
    ts = TextSet([random_dna(rng, batch_bp, n_rate=1e-4)])
    w_chars, pad_mult, t_chunk, _ = be.plan(ts, prof, M, 0, M + K, len(per))
    _, planes_all, tv = ts.packed(prof, 0, M + K, w_chars, pad_mult)
    win_q = planes_all[:, :t_chunk, :].transpose(2, 0, 1)
    tvc = tv[:, :t_chunk]
    compare_kernel("iupac m=23 Q=32 off-targets plan", win_q, tvc[0] != 0,
                   per, tvc[2], tvc[3], "iupac", True, interpret)
    compare_kernel("iupac m=23 Q=32 no-meta", win_q, tvc[0] != 0, per,
                   tvc[2], tvc[3], "iupac", False, interpret)
    del win_q, planes_all

    aprof = Ascii(case_sensitive=False)
    atext = rng.integers(32, 127, size=ascii_bp, dtype=np.uint8)
    apat = atext[5000:5016].copy()
    aprep = PreparedText(aprof, atext)
    win, t0, vf, vt = engine_windows(aprof, aprep, apat, eng)
    compare_kernel("ascii m=16", win, t0, [inputs(apat, aprof)], vf, vt,
                   "ascii", True, interpret)


# ---------------------------------------------------------------------------
# phase 3: end to end


def near(ends, found, slack=K):
    """Every planted end has a reported end within ``slack`` positions (a
    mutated copy's rightmost minimum may sit beside its planted end)."""
    f = np.sort(np.fromiter(found, np.int64))
    for e in ends:
        i = np.searchsorted(f, e - slack)
        if i == len(f) or f[i] > e + slack:
            return False
    return True


def plant(rng, text, pattern, positions, edits, rc=False):
    """Plant mutated copies; returns their end positions."""
    ends = []
    for i, at in enumerate(positions):
        copy = mutate(rng, pattern, edits[i % len(edits)])
        text[at : at + len(copy)] = revcomp(copy) if rc else copy
        ends.append(at + len(copy))
    return ends


def phase_single(rng, interpret=False, text_bp=GIB):
    import jax.numpy as jnp

    from sassy_tpu import Searcher, Strand
    from sassy_tpu.ops.myers_pallas import PallasEngine
    from sassy_tpu.ops.myers_xla import PreparedText, XlaEngine
    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import NumpyEngine

    prof = Iupac()
    pattern = rng.choice(BASES, size=23)
    text = random_dna(rng, text_bp)
    step = text_bp // 8
    fwd = plant(rng, text, pattern, [12345 + i * step for i in range(4)],
                [0, 1, 2, 3])
    rcs = plant(rng, text, pattern, [54321 + i * step for i in range(4)],
                [0, 1, 2, 3], rc=True)
    tail = plant(rng, text, pattern, [text_bp - 23], [0])  # text end
    pc = prof.encode(pattern)
    prep = PreparedText(prof, jnp.asarray(text))
    kern, xla = PallasEngine(interpret=interpret), XlaEngine()
    wide = XlaEngine(target_tiles=PallasEngine.TARGET_LANES)
    for alpha in (None, 0.5):
        def run(e):
            return e.candidates(prof, pc, prep, K, alpha, None, False)

        got, t_k = timed(lambda: run(kern), reps=5)
        want, t_x = timed(lambda: run(xla), reps=1)
        _, t_w = timed(lambda: run(wide), reps=1)
        check(got == want, f"single alpha={alpha}: kernel {len(got)} "
              f"candidates vs xla {len(want)}")
        check(near(fwd + tail, [p for p, c in got]),
              f"planted fwd ends missing (alpha={alpha})")
        log(f"[single] alpha={alpha}: {len(got)} candidates == xla; "
            f"TIME engine.candidates {text_bp} bytes: kernel {t_k * 1e3:.3f} ms, "
            f"xla(T={xla.target_tiles}) {t_x * 1e3:.3f} ms, "
            f"xla(T={wide.target_tiles}) {t_w * 1e3:.3f} ms")

    ms = Searcher(prof, rc=True).search(pattern, text, K)
    msx = Searcher(prof, rc=True, engine="xla").search(pattern, text, K)

    def key(m):
        return (m.strand is Strand.RC, m.text_start, m.text_end, m.cost,
                m.cigar.to_string())

    check(sorted(map(key, ms)) == sorted(map(key, msx)),
          "Searcher.search: kernel vs xla matches differ")
    got_f = {m.text_end for m in ms if m.strand is Strand.FWD}
    got_r = {m.text_end for m in ms if m.strand is Strand.RC}
    check(near(fwd, got_f), "Searcher: planted fwd hit missing")
    check(near(rcs, got_r), "Searcher: planted rc hit missing")
    log(f"[single] Searcher(rc=True).search: {len(ms)} matches == xla, "
        f"all {len(fwd)} fwd + {len(rcs)} rc plants found")

    sl = text[:SLICE_BP].copy()
    for alpha in (None, 0.5):
        want = NumpyEngine().candidates(prof, pc, sl, K, alpha, None, False)
        got = kern.candidates(prof, pc, sl, K, alpha, None, False)
        check(got == want, f"1 Mbp slice alpha={alpha}: kernel vs oracle")
    log("[single] 1 Mbp slice == NumPy oracle (alpha None, 0.5)")


def off_targets_case(rng, n_bp):
    """32 guides (one degenerate) and a genome with planted copies."""
    guides = [rng.choice(BASES, size=23) for _ in range(32)]
    genome = random_dna(rng, n_bp)
    step = n_bp // 40
    fwd = {q: plant(rng, genome, guides[q], [1000 + q * step], [q % 4])
           for q in range(32)}
    rev = {q: plant(rng, genome, guides[q][::-1].copy(),
                    [500 + q * step + step // 2], [q % 3])
           for q in range(32)}
    return guides, genome, fwd, rev


def phase_batch(rng, interpret=False, n_bp=OFF_TARGETS_BP):
    from sassy_tpu import Searcher, Strand
    from sassy_tpu.ops.batch import BatchEngine, TextSet
    from sassy_tpu.profiles import Iupac
    from sassy_tpu.search import NumpyEngine

    prof = Iupac()
    guides, genome, fwd, rev = off_targets_case(rng, n_bp)
    codes = [prof.encode(g) for g in guides]
    ts = TextSet([genome])
    kern = BatchEngine(backend="pallas", interpret=interpret)
    xla = BatchEngine(backend="xla")
    for reverse, planted in ((False, fwd), (True, rev)):
        def run(e):
            return e.candidates_many(prof, codes, ts, K, reverse=reverse)

        got, t_k = timed(lambda: run(kern), reps=3)
        want, t_x = timed(lambda: run(xla), reps=1)
        check(got == want, f"batch reverse={reverse}: kernel vs xla")
        for q, ends in planted.items():
            # a reversed-text plant ending at forward e ends at n - e + 23
            ends = [n_bp - e + 23 for e in ends] if reverse else ends
            check(near(ends, [p for p, c in got[q][0]]),
                  f"batch q={q} plant {ends} missing (reverse={reverse})")
        n = sum(len(c[0]) for c in got)
        log(f"[batch] reverse={reverse}: {n} candidates == xla, all plants "
            f"found; TIME candidates_many 32x23bp x {n_bp} bp: kernel "
            f"{t_k * 1e3:.3f} ms, xla {t_x * 1e3:.3f} ms")
    peak_line("batch off-targets")

    ms = Searcher(prof, rc=True).search_many(guides, [genome], K)
    for q, es in fwd.items():
        got_q = [m.text_end for m in ms
                 if m.strand is Strand.FWD and m.pattern_idx == q]
        check(near(es, got_q), f"search_many: planted fwd hit q={q} missing")
    log(f"[batch] Searcher.search_many: {len(ms)} matches, plants found")

    sl = [genome[:SLICE_BP]]
    rsl = [np.ascontiguousarray(genome[:SLICE_BP][::-1])]
    got = kern.candidates_many(prof, codes, TextSet(sl), K)
    gotr = kern.candidates_many(prof, codes, TextSet(sl), K, reverse=True)
    oracle = NumpyEngine()
    for q in range(32):
        want = oracle.candidates(prof, codes[q], sl[0], K, None, None, False)
        check(list(got[q][0]) == want, f"1 Mbp slice q={q}: kernel vs oracle")
    for q in range(8):
        want = oracle.candidates(prof, codes[q], rsl[0], K, None, None, False)
        check(list(gotr[q][0]) == want, f"1 Mbp reversed slice q={q}")
    log("[batch] 1 Mbp slice == NumPy oracle (32 fwd, 8 reversed)")


# ---------------------------------------------------------------------------
# phase 4: CLI


def phase_cli(rng, records=16, record_bp=16 << 20):
    from sassy_tpu import Searcher, Strand
    from sassy_tpu.cli import _format_cigar, main as cli_main
    from sassy_tpu.profiles import Iupac

    prof = Iupac()
    guides = [np.concatenate([rng.choice(BASES, size=20),
                              np.frombuffer(b"NGG", np.uint8)])
              for _ in range(32)]
    pattern = rng.choice(BASES, size=23)
    seqs = []
    for r in range(records):
        s = random_dna(rng, record_bp, n_rate=1e-5)
        for q in range(r % 4, 32, 4):
            g = guides[q].copy()
            g[20] = BASES[q % 4]  # the N of the PAM, made concrete
            g = mutate(rng, g[:20], q % 3).tolist() + g[20:].tolist()
            at = int(rng.integers(0, record_bp - 30))
            s[at : at + 23] = revcomp(np.array(g, np.uint8)) if q % 2 else g
        plant(rng, s, pattern, [int(rng.integers(0, record_bp - 30))], [r % 3])
        seqs.append(s)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "genome.fa")
        with open(fa, "wb") as fh:
            for r, s in enumerate(seqs):
                fh.write(b">chr%d\n" % r)
                for i in range(0, len(s), 1 << 20):
                    fh.write(s[i : i + (1 << 20)].tobytes() + b"\n")
        log(f"[cli] FASTA {os.path.getsize(fa)} bytes, {records} records")
        gfile = os.path.join(tmp, "guides.txt")
        with open(gfile, "w") as fh:
            fh.write("".join(bytes(g).decode() + "\n" for g in guides))
        out_c = os.path.join(tmp, "crispr.tsv")
        out_s = os.path.join(tmp, "search.tsv")
        t0 = time.perf_counter()
        check(cli_main(["crispr", "-g", gfile, "-k", str(K), "--max-n-frac",
                        "0.1", "-o", out_c, fa]) == 0, "crispr CLI failed")
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(cli_main(["search", "-p", bytes(pattern).decode(), "-k",
                        str(K), "-o", out_s, fa]) == 0, "search CLI failed")
        t_s = time.perf_counter() - t0
        rows_c = open(out_c).read().splitlines()[1:]
        rows_s = open(out_s).read().splitlines()[1:]

    def rows(ms, names, cigar):
        return sorted(
            "\t".join(map(str, (names[m.pattern_idx], f"chr{m.text_idx}",
                                m.cost, m.strand, m.text_start, m.text_end,
                                cigar(m))))
            for m in ms
        )

    def strip(lines):  # drop the match_region column (formatting only)
        return sorted("\t".join(l.split("\t")[:6] + l.split("\t")[7:])
                      for l in lines)

    pam, pam_c = b"NGG", prof.complement(b"NGG")

    def pam_ok(_p, upto, strand):
        ref = pam if strand is Strand.FWD else pam_c
        return len(upto) >= 3 and all(
            prof.is_match(int(a), int(b)) for a, b in zip(upto[-3:], ref))

    lib_c = Searcher(prof, rc=True).with_max_n_frac(0.1).search_many_with_fn(
        [bytes(g) for g in guides], seqs, K, True, pam_ok)
    want_c = rows(lib_c, [bytes(g).decode() for g in guides],
                  lambda m: m.cigar.to_string())
    check(strip(rows_c) == want_c, f"crispr CLI rows ({len(rows_c)}) != "
          f"Searcher rows ({len(want_c)})")
    lib_s = Searcher(prof, rc=True).with_max_n_frac(0.2).search_many(
        [bytes(pattern)], seqs, K)
    want_s = rows(lib_s, ["pattern"], lambda m: _format_cigar(m, False))
    check(strip(rows_s) == want_s, f"search CLI rows ({len(rows_s)}) != "
          f"Searcher rows ({len(want_s)})")
    check(len(want_s) >= records, "search CLI: planted hits missing")
    log(f"[cli] crispr: {len(rows_c)} rows == Searcher ({t_c:.1f}s); "
        f"search: {len(rows_s)} rows == Searcher ({t_s:.1f}s)")


# ---------------------------------------------------------------------------
# --four: ShardedSearch over four cards


def phase_four(rng, devices, n_bp=OFF_TARGETS_BP, interpret=False):
    import jax

    from sassy_tpu.ops.batch import BatchEngine, TextSet
    from sassy_tpu.parallel import ShardedSearch, ShardedText, make_mesh
    from sassy_tpu.profiles import Iupac

    prof = Iupac()
    guides, genome, fwd, _ = off_targets_case(rng, n_bp)
    codes = [prof.encode(g) for g in guides]
    mesh = make_mesh(n_text=4, n_pat=1, devices=devices[:4])
    backend = "pallas" if interpret else None
    ss = ShardedSearch(mesh=mesh, cap=1 << 14, bcap=1 << 12,
                       backend=backend, interpret=interpret)
    st = ShardedText(prof, genome)
    ts = TextSet([genome])
    # the one-card reference runs first, so card 0's peak is its own: the
    # off-targets shape's device memory
    want = {}
    with jax.default_device(devices[0]):
        be = BatchEngine(backend=backend, interpret=interpret)
        for alpha in (None, 0.5):
            want[alpha] = timed(lambda: be.candidates_many(
                prof, codes, ts, K, alpha=alpha), reps=2)
    peak_line("four: one-card BatchEngine, off-targets shape")
    for alpha in (None, 0.5):
        got, t_s = timed(lambda: ss.candidates_batch(
            prof, guides, st, K, alpha=alpha), reps=2)
        want_a, t_b = want[alpha]
        for q in range(32):
            check(sorted(got[q]) == sorted(map(tuple, want_a[q][0])),
                  f"sharded q={q} alpha={alpha}: 4 cards vs 1 card differ")
        n = sum(len(c) for c in got)
        log(f"[four] alpha={alpha}: ShardedSearch 1x4 == BatchEngine "
            f"({n} candidates); TIME sharded {t_s * 1e3:.3f} ms, "
            f"one card {t_b * 1e3:.3f} ms")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only ShardedSearch on four cards vs BatchEngine")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = card_line()  # before JAX initializes the card
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"[device] platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    log(f"[device] {card}")
    if d0.platform != "gpu":
        print("no GPU found by JAX; nothing run", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"need {need} GPUs, found {len(devs)}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    if args.four:
        phases = [("four", lambda: phase_four(rng, devs))]
    else:
        phases = [("kernel", lambda: phase_kernel(rng)),
                  ("single", lambda: phase_single(rng)),
                  ("batch", lambda: phase_batch(rng)),
                  ("cli", lambda: phase_cli(rng))]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"[{name}] passed in {time.perf_counter() - t0:.1f}s")
        peak_line(name)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

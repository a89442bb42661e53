"""Runtime subsystems: checkpointed genome scan, multi-host plumbing,
diagnostics."""

import numpy as np

from sassy_tpu import Searcher, profiles
from sassy_tpu.scan import GenomeScan

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for rid, seq in recs:
            f.write(f">{rid}\n{seq.decode()}\n")


def test_genome_scan_segments_and_resume(tmp_path):
    rng = np.random.default_rng(0)
    pat = bytes(rng.choice(BASES, size=20))
    # one big record (forces segmentation) + one small
    big = bytearray(rng.choice(BASES, size=9000))
    for off in (100, 2988, 6500, 8950):  # 2988 straddles the 3000 boundary
        big[off : off + 20] = pat
    small = bytes(rng.choice(BASES, size=300)) + pat
    fa = tmp_path / "g.fa"
    _write_fasta(fa, [("chr1", bytes(big)), ("chr2", small)])

    s = Searcher(profiles.Iupac(), rc=False, engine="xla")
    ck = tmp_path / "progress.json"
    out = tmp_path / "matches.tsv"
    gs = GenomeScan(s, segment_chars=3000, checkpoint=str(ck))
    total = gs.scan(str(fa), [pat], 0, str(out))
    assert total == 5, total
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    starts = sorted(int(r[4]) for r in rows if r[1] == "chr1")
    assert starts == [100, 2988, 6500, 8950]

    # resume: simulate partial progress -> only remaining units re-scan
    import json

    out2 = tmp_path / "m2.tsv"
    header = "pat_idx\ttext_id\tcost\tstrand\tstart\tend\n"
    # pretend units 0-1 completed: checkpoint records the output offset
    # they reached (here: header + no rows kept); anything written past it
    # (a partially flushed unit killed mid-write) must be truncated away
    out2.write_text(header + "GARBAGE-PARTIAL-ROW")
    json.dump(
        {"unit": 2, "matches": 3, "out_pos": len(header)}, open(ck, "w")
    )
    total2 = gs.scan(str(fa), [pat], 0, str(out2))
    assert "GARBAGE" not in out2.read_text()
    rows2 = [l for l in out2.read_text().strip().split("\n")[1:]]
    # units 0,1 skipped: matches from segments >= 2 plus prior count
    assert total2 == 3 + len(rows2)


def test_scan_segment_boundary_exactness(tmp_path):
    """Matches spanning segment boundaries dedupe via owner-computes."""
    rng = np.random.default_rng(1)
    pat = bytes(rng.choice(BASES, size=24))
    text = bytearray(rng.choice(BASES, size=4000))
    text[1988 : 1988 + 24] = pat  # straddles a 2000-char boundary
    fa = tmp_path / "b.fa"
    _write_fasta(fa, [("c", bytes(text))])
    s = Searcher(profiles.Iupac(), rc=False, engine="xla")
    out = tmp_path / "o.tsv"
    total = GenomeScan(s, segment_chars=2000).scan(str(fa), [pat], 1, str(out))
    want = len(s.search(pat, bytes(text), 1))
    assert total == want, (total, want)


def test_multihost_single_process():
    from sassy_tpu.parallel import multihost

    multihost.initialize()  # no-op single process
    lo, hi = multihost.host_shard_of(10)
    assert (lo, hi) == (0, 10)

    rng = np.random.default_rng(2)
    text = rng.choice(BASES, size=3000)
    pats = [rng.choice(BASES, size=16) for _ in range(2)]
    prof = profiles.Iupac()
    got = multihost.global_search(prof, pats, text, 2)
    from sassy_tpu.search import NumpyEngine

    oracle = NumpyEngine()
    for pat, cands in zip(pats, got):
        want = oracle.candidates(prof, prof.encode(pat), text, 2, None, None, False)
        assert sorted(cands) == sorted(want)


def test_diagnostics():
    from sassy_tpu.diagnostics import cost_model, self_test

    info = self_test(text_bytes=20_000, verbose=False)
    assert info["throughput_gbps"] > 0
    cm = cost_model(23, 1 << 20, 3, num_patterns=4)
    assert cm["dp_cells"] == 23 * (1 << 20) * 4
    # 2^15 words x 24 bucketed rows x 4 patterns
    assert cm["word_steps"] == (1 << 15) * 24 * 4
    assert cm["int_ops"] == 17 * cm["word_steps"]
    assert cm["plane_bytes"] == 16 * (1 << 15) * 4


def test_genome_scan_multi_pattern(tmp_path):
    rng = np.random.default_rng(5)
    pats = [bytes(rng.choice(BASES, size=20)) for _ in range(3)]
    text = bytearray(rng.choice(BASES, size=4000))
    text[100:120] = pats[1]
    text[2500:2520] = pats[2]
    fa = tmp_path / "g.fa"
    _write_fasta(fa, [("c", bytes(text))])
    s = Searcher(profiles.Iupac(), rc=False, engine="xla")
    out = tmp_path / "o.tsv"
    total = GenomeScan(s, segment_chars=1500).scan(str(fa), pats, 0, str(out))
    rows = [l.split("\t") for l in out.read_text().strip().split("\n")[1:]]
    assert total == 2
    assert {(int(r[0]), int(r[4])) for r in rows} == {(1, 100), (2, 2500)}

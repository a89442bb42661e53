"""Command-line interface: grep / agrep / search / filter / crispr / test.

Behavioral port of the reference CLI (/root/reference/bin/{main,grep,crispr}.rs):
same subcommands, flags, TSV schema (README.md:211-253), pretty-printed grep
output on stderr, per-distance match histogram, PAM-filtered CRISPR search,
and `--sam` text-direction output. The execution model is device-first:
instead of a thread pool with per-thread searchers, records are batched into
one fused device dispatch per (pattern batch x record batch) work item
(grep.rs:476-582's work items map to device batches; output order is the
deterministic batch order).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .io import fastx
from .matchrec import Match, Strand
from .pretty_print import (
    PrettyPrintDirection,
    PrettyPrintStyle,
    pretty_print,
)
from .profiles import Dna, Iupac, get_profile
from .search import Searcher

TSV_HEADER = "pat_id\ttext_id\tcost\tstrand\tstart\tend\tmatch_region\tcigar\n"


def _bold(s):
    return f"\x1b[1m{s}\x1b[0m"


def _cyan_bold(s):
    return f"\x1b[1;36m{s}\x1b[0m"


# ---------------------------------------------------------------------------
# argument plumbing


def _add_base_args(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("-p", "--pattern", help="Pattern to search for")
    g.add_argument(
        "-l", "--pattern-file", help="File with one pattern per line"
    )
    g.add_argument(
        "-f", "--pattern-fasta", help="FASTA file of patterns"
    )
    p.add_argument(
        "--pattern-batch-size",
        type=int,
        default=fastx.DEFAULT_BATCH_PATTERNS,
        help="Patterns per batch (default 64)",
    )
    p.add_argument(
        "-k", type=int, required=True,
        help="Report matches up to (and including) this distance",
    )
    p.add_argument(
        "-a", "--alphabet", choices=["dna", "iupac"], default="iupac",
        help="Alphabet (default iupac; use agrep for ascii)",
    )
    p.add_argument(
        "--overhang", type=float, default=None,
        help="Cost per char of overhang alignment in [0,1]",
    )
    p.add_argument("--no-rc", action="store_true", help="Disable RC search")
    p.add_argument(
        "--max-n-frac", type=float, default=0.2,
        help="Max fraction of N bases in the matched region (default 0.2)",
    )
    p.add_argument(
        "--v2", action="store_true",
        help="Use the encoded-pattern batch path (results identical here)",
    )
    p.add_argument("-j", "--threads", type=int, default=None,
                   help="Accepted for compatibility (the device batches)")
    p.add_argument("-v", "--invert", action="store_true",
                   help="Only report non-matching records (filter output)")
    p.add_argument("--sam", action="store_true",
                   help="SAM-compatible output (text-direction region/cigar)")
    p.add_argument(
        "--engine", default="auto",
        choices=["auto", "pallas", "xla", "numpy"],
        help="Search engine (default auto)",
    )
    p.add_argument(
        "--batch-bytes", type=int, default=fastx.DEFAULT_BATCH_BYTES,
        help="Text bytes per device dispatch batch",
    )
    p.add_argument(
        "--resume", default=None, metavar="PROGRESS_JSON",
        help="Checkpoint file: save progress after each text batch and, "
             "if it exists, resume an interrupted run (requires the TSV "
             "output to be a file). Interrupted+resumed output is "
             "byte-identical to an uninterrupted run.",
    )
    p.add_argument("paths", nargs="*", help="Input fastx files (may be .gz)")


def get_patterns(args) -> tuple[list[str], list[bytes]]:
    """(ids, seqs) per grep.rs:624-661."""
    if args.pattern:
        return ["pattern"], [args.pattern.encode()]
    if args.pattern_file:
        ids, seqs = [], []
        with open(args.pattern_file) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    seqs.append(line.encode())
                    ids.append(str(len(seqs)))
        return ids, seqs
    if args.pattern_fasta:
        ids, seqs = [], []
        for rec in fastx.read_fastx(args.pattern_fasta):
            ids.append(rec.rid)
            seqs.append(rec.seq)
        return ids, seqs
    sys.exit("No --pattern, --pattern-file, or --pattern-fasta provided!")


def _stable_digest(seqs) -> str:
    """Process-stable digest of a sequence list (hash() is salted)."""
    import hashlib

    h = hashlib.sha1()
    for s in seqs:
        h.update(bytes(s))
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _open_out(path: str | None):
    if path is None:
        return None, False
    if path in ("", "-"):
        return sys.stdout, True
    return open(path, "w"), False


def _format_match_region(profile, slice_, strand: Strand, sam: bool) -> str:
    if strand is Strand.RC and not sam:
        return bytes(profile.reverse_complement(slice_)).decode(errors="replace")
    return bytes(bytearray(slice_)).decode(errors="replace")


def _format_cigar(m: Match, sam: bool) -> str:
    if m.strand is Strand.RC and sam:
        return m.cigar.reversed().to_string()
    return m.cigar.to_string()


def print_statistics(hist: list[int], out=None) -> None:
    if out is None:
        out = sys.stderr
    total = sum(hist)
    print(f"\nStatistics: total {_bold(total)}", file=out)
    digits = len(str(max(hist) if hist else 0))
    print("dist: " + " ".join(_bold(str(i).rjust(digits)) for i in range(len(hist))),
          file=out)
    print("cnt:  " + " ".join(_bold(str(c).rjust(digits)) for c in hist), file=out)


# ---------------------------------------------------------------------------
# grep / search / filter (one engine, three frontends; grep.rs README:153-155)


def run_grep_family(args, grep: bool, search_out, filter_out) -> int:
    if args.invert and filter_out is None:
        print("Warning: --invert/-v has no effect without --filter",
              file=sys.stderr)
    paths = args.paths or [""]
    pids, pseqs = get_patterns(args)
    if not pseqs:
        sys.exit("No pattern sequences found")

    profile = get_profile(args.alphabet)
    rc = not args.no_rc
    searcher = Searcher(profile, rc=rc, alpha=args.overhang, engine=args.engine)
    if args.alphabet == "iupac":
        searcher.set_max_n_frac(args.max_n_frac)

    resume = getattr(args, "resume", None)
    prog = None
    if resume is not None:
        from .scan import ScanProgress

        if search_out in (None, "", "-"):
            sys.exit("--resume requires TSV output to a file "
                     "(search -o FILE / grep --search FILE)")
        prog = ScanProgress.load(resume)
        try:
            prog.check_sig(
                f"k={args.k} rc={rc} alpha={args.overhang} "
                f"nfrac={args.max_n_frac} v2={args.v2} sam={args.sam} "
                f"bb={args.batch_bytes} pb={args.pattern_batch_size} "
                f"pats={len(pseqs)}:{_stable_digest(pseqs)} "
                f"paths={paths}"
            )
        except ValueError as e:
            sys.exit(str(e))
        search_fh, resumed = prog.reopen_output(search_out)
    else:
        search_fh, _ = _open_out(search_out)
        resumed = False
    filter_fh, _ = _open_out(filter_out)
    if search_fh is not None and not resumed:
        search_fh.write(TSV_HEADER)

    hist = (list(prog.hist) if prog is not None and prog.hist
            else [0] * (args.k + 1))
    n_pattern_batches = -(-len(pseqs) // args.pattern_batch_size)
    # fault injection for the resume tests: die (before checkpointing)
    # once this many text-batch units have written their output
    crash_after = int(os.environ.get("SASSY_CRASH_AFTER_UNIT", "-1"))
    unit = 0  # one unit = one text batch (all its pattern batches)
    group_items = 0
    for path in paths:
        pending: dict[int, tuple[fastx.Record, list[tuple[int, Match]]]] = {}
        nbatches: dict[int, int] = {}
        # the reader thread parses/packs batch N+1 while batch N scans
        items = fastx.prefetch(fastx.iter_batches(
            [path], pids, pseqs, batch_bytes=args.batch_bytes,
            batch_patterns=args.pattern_batch_size, rc=rc,
        ))
        for item in items:
            skip = prog is not None and unit < prog.unit
            if not skip:
                texts = [r.cached for r in item.records]
                if args.v2 and len({len(p) for p in item.patterns}) == 1:
                    enc = searcher.encode_patterns(item.patterns)
                    matches: list[Match] = []
                    for ti, t in enumerate(texts):
                        for m in searcher.search_encoded_patterns(
                            enc, t, args.k
                        ):
                            m.text_idx = ti
                            matches.append(m)
                else:
                    matches = searcher.search_many(
                        item.patterns, texts, args.k
                    )
                for m in matches:
                    ridx = item.record_offset + m.text_idx
                    rec = item.records[m.text_idx]
                    pending.setdefault(ridx, (rec, []))[1].append(
                        (item.pattern_offset + m.pattern_idx, m)
                    )
                    hist[m.cost] += 1
                for ti, rec in enumerate(item.records):
                    ridx = item.record_offset + ti
                    nbatches[ridx] = nbatches.get(ridx, 0) + 1
                    pending.setdefault(ridx, (rec, []))
                    if nbatches[ridx] >= n_pattern_batches:
                        rec2, ms = pending.pop(ridx)
                        _emit_record(
                            args, profile, path, rec2, ms, pids, pseqs,
                            grep, search_fh, filter_fh,
                        )
            group_items += 1
            if group_items == n_pattern_batches:
                group_items = 0
                if prog is not None and not skip:
                    search_fh.flush()
                    if 0 <= crash_after <= unit:
                        raise SystemExit(130)
                    prog.unit = unit + 1
                    prog.matches = sum(hist)
                    prog.hist = hist
                    prog.out_pos = search_fh.tell()
                    prog.save()
                unit += 1
    print_statistics(hist)
    for fh in (search_fh, filter_fh):
        if fh is not None and fh is not sys.stdout:
            fh.close()
    return 0


def _emit_record(
    args, profile, path, rec, matches, pids, pseqs, grep, search_fh, filter_fh
):
    matches.sort(key=lambda pm: pm[1].text_start)
    if filter_fh is not None:
        if bool(matches) != args.invert:
            fastx.write_record_text(filter_fh, rec)
    if grep and matches:
        print(_bold(f"{_cyan_bold(path or '-')}>{_bold(rec.rid)}"), file=sys.stderr)
        for pi, m in matches:
            s = pretty_print(
                m, pids[pi], pseqs[pi], rec.seq,
                PrettyPrintDirection.TEXT, 20, PrettyPrintStyle.FULL,
            )
            print(s, file=sys.stderr)
    if search_fh is not None:
        for pi, m in matches:
            seq = np.frombuffer(rec.seq, dtype=np.uint8)
            region = _format_match_region(
                profile, seq[m.text_start : m.text_end], m.strand, args.sam
            )
            search_fh.write(
                f"{pids[pi]}\t{rec.rid}\t{m.cost}\t{m.strand}\t"
                f"{m.text_start}\t{m.text_end}\t{region}\t"
                f"{_format_cigar(m, args.sam)}\n"
            )


# ---------------------------------------------------------------------------
# agrep: line-based ascii grep (grep.rs:133-147, 198-307)


def run_agrep(args) -> int:
    from .profiles import Ascii

    pattern = args.pattern.encode()
    searcher = Searcher(Ascii(case_sensitive=True), rc=False, engine=args.engine)
    hist = [0] * (args.k + 1)
    # all files in ONE batched dispatch (each dispatch costs a device
    # round trip); output stays grouped per file in argument order
    names = []
    texts = []
    for path in args.paths or [""]:
        if path in ("", "-"):
            texts.append(sys.stdin.buffer.read())
        else:
            with open(path, "rb") as fh:
                texts.append(fh.read())
        names.append(path)
    per_file: dict[int, list] = {}
    for m in searcher.search_many([pattern], texts, args.k):
        per_file.setdefault(m.text_idx, []).append(m)
    for ti, path in enumerate(names):
        matches = per_file.get(ti)
        if not matches:
            continue
        matches.sort(key=lambda m: m.text_start)
        print(_bold(f"{_cyan_bold(path or '-')}:"), file=sys.stderr)
        for m in matches:
            hist[m.cost] += 1
            s = pretty_print(
                m, "", pattern, texts[ti],
                PrettyPrintDirection.TEXT, args.context, PrettyPrintStyle.LINE,
            )
            print(s, file=sys.stderr)
            if args.context > 0:
                print("\x1b[36m---\x1b[0m", file=sys.stderr)
    print_statistics(hist)
    return 0


# ---------------------------------------------------------------------------
# crispr (bin/crispr.rs)


def run_crispr(args) -> int:
    with open(args.guide) as fh:
        guides = [line.strip().encode() for line in fh if line.strip()]
    print(f"[GUIDES] Found {len(guides)} guides")
    if not guides:
        return 0
    if not (0.0 <= args.max_n_frac <= 1.0):
        sys.exit("[N-chars] Error: max_n_frac must be between 0 and 1.0")

    pam = guides[0][-args.pam_length :]
    for g in guides:
        if g[-args.pam_length :] != pam:
            sys.exit(
                "[PAM] One of the guide sequences has a PAM different than "
                "the provided PAM"
            )
    print(f"[PAM] Sequence: [{pam.decode()}]")
    print(f"[PAM] PAM used to filter: {pam.decode()}")
    print(f"[PAM] Edits in PAM are allowed: {args.allow_pam_edits}")
    print(f"[N-chars] Allowing up to {args.max_n_frac * 100:.1f}% N characters")

    prof = Iupac()
    pam_compl = np.frombuffer(prof.complement(pam), dtype=np.uint8)
    pam_arr = np.frombuffer(pam, dtype=np.uint8)

    prog = None
    if args.resume is not None:
        from .scan import ScanProgress

        if not args.output:
            sys.exit("--resume requires -o FILE")
        prog = ScanProgress.load(args.resume)
        try:
            prog.check_sig(
                f"k={args.k} rc={not args.no_rc} nfrac={args.max_n_frac} "
                f"pam={args.pam_length}:{args.allow_pam_edits} "
                f"bb={args.batch_bytes} path={args.path} "
                f"guides={len(guides)}:{_stable_digest(guides)}"
            )
        except ValueError as e:
            sys.exit(str(e))
        out, resumed = prog.reopen_output(args.output)
    else:
        out = open(args.output, "w") if args.output else sys.stdout
        resumed = False
    if not resumed:
        out.write(
            "guide\ttext_id\tcost\tstrand\tstart\tend\tmatch_region\tcigar\n"
        )

    searcher = Searcher(
        prof, rc=not args.no_rc, engine=args.engine
    ).with_max_n_frac(args.max_n_frac)

    def filter_fn(_pattern, text_up_to_end, strand):
        if len(text_up_to_end) < args.pam_length:
            return False
        tail = text_up_to_end[-args.pam_length :]
        ref = pam_arr if strand is Strand.FWD else pam_compl
        return all(prof.is_match(int(a), int(b)) for a, b in zip(tail, ref))

    total = prog.matches if prog is not None else 0
    t0 = time.perf_counter()
    # all guides x a batch of records in ONE batched dispatch (the
    # reference instead threads over records, crispr.rs:188-261); the PAM
    # filter applies per candidate end position, after the batched scan.
    # 32 MiB batches: genome-scale contig sets then qualify for the
    # TextSet device-assembly path (one raw upload serves both strands),
    # and read-scale files still amortize the dispatch round trip
    batch_bytes = args.batch_bytes
    guide_strs = [g.decode() for g in guides]

    def dispatch(recs):
        texts = [r.seq for r in recs]
        return searcher.search_many_with_fn_async(
            guides, texts, args.k, True,
            None if args.allow_pam_edits else filter_fn,
        )

    def write_out(recs, matches):
        nonlocal total
        by_pair: dict = {}
        for m in matches:
            by_pair.setdefault((m.text_idx, m.pattern_idx), []).append(m)
        for ti, rec in enumerate(recs):
            seq = np.frombuffer(rec.seq, dtype=np.uint8)
            for gi, gs in enumerate(guide_strs):
                for m in by_pair.get((ti, gi), ()):
                    total += 1
                    region = _format_match_region(
                        prof, seq[m.text_start : m.text_end], m.strand, False
                    )
                    out.write(
                        f"{gs}\t{rec.rid}\t{m.cost}\t{m.strand}\t"
                        f"{m.text_start}\t{m.text_end}\t{region}\t"
                        f"{m.cigar.to_string()}\n"
                    )

    def record_batches():
        pending: list = []
        pending_bytes = 0
        for rec in fastx.read_fastx(args.path):
            pending.append(rec)
            pending_bytes += len(rec.seq)
            if pending_bytes >= batch_bytes:
                yield pending
                pending, pending_bytes = [], 0
        if pending:
            yield pending

    crash_after = int(os.environ.get("SASSY_CRASH_AFTER_UNIT", "-1"))

    def settle(unit, recs, finish):
        write_out(recs, finish())
        if prog is not None:
            out.flush()
            if 0 <= crash_after <= unit:
                raise SystemExit(130)
            prog.unit = unit + 1
            prog.matches = total
            prog.out_pos = out.tell()
            prog.save()

    # double pipeline: the reader thread parses record batch N+1 while
    # batch N scans, and batch N+1's device scan is dispatched before
    # batch N's results are fetched/postprocessed/written
    inflight = None
    for unit, recs in enumerate(fastx.prefetch(record_batches())):
        if prog is not None and unit < prog.unit:
            continue
        fin = dispatch(recs)
        if inflight is not None:
            settle(*inflight)
        inflight = (unit, recs, fin)
    if inflight is not None:
        settle(*inflight)
    print("\nSummary")
    print(f"  Total targets found:   {total}")
    print(f"  Time taken: {time.perf_counter() - t0:.3f}s")
    if out is not sys.stdout:
        out.close()
    return 0


# ---------------------------------------------------------------------------
# test: diagnostics (reference lib.rs:187-281, `sassy test`)


def run_test(_args) -> int:
    import jax

    print(f"jax backend:  {jax.default_backend()}")
    for d in jax.devices():
        print(f"device:       {d.device_kind} ({d.platform})")
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=100_000)
    pattern = rng.choice(bases, size=23)
    s = Searcher(Iupac(), rc=False)
    s.search(pattern, text, 1)  # warmup/compile
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        s.search(pattern, text, 1)
    dt = (time.perf_counter() - t0) / reps
    print(f"engine:       {s._engine().name} on {jax.default_backend()}")
    print(f"throughput:   {len(text) / dt / 1e9:.3f} GB/s (23bp, 100kb, k=1)")
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # downstream pager/head closed the pipe (e.g. `sassy-tpu search ...
        # | head`): exit quietly like grep does, not with a traceback.
        # Reopen stdout on devnull so the interpreter's shutdown flush of
        # the broken pipe does not raise a second time.
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 141  # 128 + SIGPIPE, the conventional shell status


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sassy-tpu",
        description="Approximate string matching on the GPU (JAX)",
    )
    ap.add_argument(
        "--platform", default=os.environ.get("SASSY_PLATFORM", "auto"),
        choices=["auto", "gpu", "cpu"],
        help="JAX platform to run on (default: auto = whatever JAX picks; "
             "also settable via SASSY_PLATFORM). The engine follows the "
             "platform: the scan kernel on the GPU, the XLA scan on the "
             "CPU.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grep", help="Search and pretty-print matches")
    _add_base_args(g)
    g.add_argument("-C", "--context", type=int, default=20)
    g.add_argument("--search", "--matches", nargs="?", const="-", default=None,
                   help="TSV output file ('-' or empty for stdout)")
    g.add_argument("--filter", nargs="?", const="-", default=None,
                   help="Filtered records output file")

    a = sub.add_parser("agrep", help="Line-based ascii grep")
    a.add_argument("pattern")
    a.add_argument("k", type=int)
    a.add_argument("-C", "--context", type=int, default=0)
    a.add_argument("--engine", default="auto",
                   choices=["auto", "pallas", "xla", "numpy"])
    a.add_argument("paths", nargs="*")

    s = sub.add_parser("search", help="Search, TSV to stdout")
    _add_base_args(s)
    s.add_argument("--filter", nargs="?", const="-", default=None)
    s.add_argument("-o", "--output", default="-",
                   help="TSV output file (default stdout)")

    f = sub.add_parser("filter", help="Filter matching records to stdout")
    _add_base_args(f)
    f.add_argument("--search", "--matches", nargs="?", const="-", default=None)

    c = sub.add_parser("crispr", help="CRISPR guide search with PAM filter")
    c.add_argument("-g", "--guide", required=True,
                   help="File with guide sequences (including PAM)")
    c.add_argument("-k", type=int, required=True)
    c.add_argument("-o", "--output", default=None)
    c.add_argument("--max-n-frac", type=float, required=True)
    c.add_argument("-j", "--threads", type=int, default=None)
    c.add_argument("--pam-length", type=int, default=3)
    c.add_argument("--allow-pam-edits", action="store_true")
    c.add_argument("--no-rc", action="store_true")
    c.add_argument("--engine", default="auto",
                   choices=["auto", "pallas", "xla", "numpy"])
    c.add_argument("--batch-bytes", type=int, default=32 << 20,
                   help="Record bytes per device dispatch batch")
    c.add_argument("--resume", default=None, metavar="PROGRESS_JSON",
                   help="Checkpoint file: save progress per record batch "
                        "and resume an interrupted run (requires -o FILE)")
    c.add_argument("path")

    t = sub.add_parser("test", help="Device/feature diagnostics + throughput")

    args = ap.parse_args(argv)
    if args.platform != "auto":
        # must run before any JAX backend init (the env var alone does not
        # override a preinstalled platform plugin)
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.cmd == "grep":
        return run_grep_family(args, True, args.search, args.filter)
    if args.cmd == "search":
        return run_grep_family(args, False, args.output, args.filter)
    if args.cmd == "filter":
        return run_grep_family(args, False, args.search, "-")
    if args.cmd == "agrep":
        return run_agrep(args)
    if args.cmd == "crispr":
        return run_crispr(args)
    if args.cmd == "test":
        return run_test(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())

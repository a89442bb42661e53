"""sassy_tpu: approximate string matching on the GPU, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference `sassy` library (RagnarGrootKoerkamp/sassy): find all locations in
a text where a short pattern aligns with edit distance <= k, for DNA / IUPAC
/ ASCII alphabets, with reverse-complement search, overhang alignments,
N-fraction filtering, and CIGAR traceback.

Public API mirrors the reference's (src/lib.rs:151-165 re-exports):

    from sassy_tpu import Searcher, Match, Strand, profiles

    searcher = Searcher(profiles.Iupac(), rc=False)
    matches = searcher.search(b"ATCG", b"AAAATTGAAA", k=1)
"""

from . import profiles
from .cigar import Cigar
from .matchrec import UNKNOWN, Match, Strand
from .search import CachedRev, EncodedPatterns, SearchMode, Searcher


def features() -> dict:
    """Device/feature diagnostic, the analog of the reference's
    ``sassy.features()`` (python.rs:20-24) / `sassy test` CPU-feature dump
    (lib.rs:187-255): what hardware the engines will run on, and the scan
    ``engine="auto"`` picks there."""
    import jax

    from .ops.backend import choose_scan

    devs = jax.devices()
    return {
        "backend": jax.default_backend(),
        "devices": [f"{d.device_kind} ({d.platform})" for d in devs],
        "num_devices": len(devs),
        "auto_engine": choose_scan()[0],
    }


__all__ = [
    "features",
    "Searcher",
    "Match",
    "Strand",
    "Cigar",
    "CachedRev",
    "EncodedPatterns",
    "SearchMode",
    "UNKNOWN",
    "profiles",
]

__version__ = "0.1.0"

"""Multi-host (DCN) scale-out scaffolding.

The reference is single-node (SURVEY §2.8: rayon threads only). The
scale-out story here is: per-host genome shards with ``pattern_len + k`` halos,
the pattern batch replicated on every chip, match buffers gathered with
collectives — i.e. exactly :class:`sassy_tpu.parallel.ShardedSearch` run on
a global mesh. This module holds the host-level plumbing:

- ``initialize()`` wraps ``jax.distributed.initialize`` (coordinator env
  vars or explicit args).
- ``global_search()`` builds the global ('pat', 'text') mesh over all
  processes' devices and runs the sharded search; because shard_map +
  ppermute compile to collectives over the cards' interconnect within a
  host and network transfers across hosts, the same code path covers both.
- ``host_shard_of()`` tells a host which slice of a text list it should
  read/own, for host-side IO sharding (each host reads only its records).

Single-process usage degenerates to ShardedSearch over the local devices —
which is what the tests and the driver dryrun exercise; multi-host runs
only need the coordinator address.
"""

from __future__ import annotations

import numpy as np

from ..profiles import Profile
from .sharded import ShardedSearch, make_mesh

__all__ = ["initialize", "global_search", "host_shard_of"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized or when
    running single-process with no coordinator configured)."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        import os

        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return  # single-process: nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def host_shard_of(n_items: int) -> tuple[int, int]:
    """[start, end) of the items this host owns (contiguous split)."""
    import jax

    pid, np_ = jax.process_index(), jax.process_count()
    per = -(-n_items // np_)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def global_search(
    profile: Profile,
    patterns: list[np.ndarray],
    text: np.ndarray,
    k: int,
    n_pat: int = 1,
    **kw,
) -> list[list[tuple[int, int]]]:
    """Sharded search over ALL devices in the (possibly multi-host) job.

    The text is sharded over the global 'text' mesh axis with halo exchange
    (card interconnect within a host, network across hosts); patterns
    shard over 'pat'.
    Returns per-pattern (end_pos, cost) lists, identical to the single-chip
    engines.
    """
    import jax

    n_text = len(jax.devices()) // n_pat
    mesh = make_mesh(n_text=n_text, n_pat=n_pat)
    ss = ShardedSearch(mesh=mesh)
    return ss.candidates_batch(profile, patterns, text, k, **kw)

"""Multi-chip sharded search: SPMD over a ``jax.sharding.Mesh``.

This is the multi-card scale-out of the framework (SURVEY.md §2.8 item 6): the
direct generalization of the single-chip halo tiling in ops/myers_xla.py to
a device mesh. The reference (sassy) is single-node shared-memory; its chunk
overlap + ownership-pruning scheme (/root/reference/src/search.rs:1018-1070,
1202-1240) becomes, at mesh scale:

- **text axis** (`"text"`): the packed text bit-planes are sharded into D
  contiguous shards of S words. Each shard fetches a left halo of
  ``H = ceil((m_bucket + k)/32)`` (rounded to a power of two) words from its
  left neighbor via ``lax.ppermute``, plus ``H+1`` words of right
  context (one word gives the minima rule its lookahead delta; shard 0 uses
  all H+1 because its window is left-aligned, see below). Every owned end
  position then has the full ``m+k`` left context, so per-shard costs are
  exact, and the owner-computes rule (a shard owns end positions
  ``(d*S*32, (d+1)*S*32]``; shard 0 additionally owns position 0) makes
  dedup free.
- Shard 0 carries the *true text start* boundary (the overhang alpha h-init,
  search.rs:1692-1748). A restarted DP cannot express that boundary after a
  left halo of padding, so shard 0's window is left-aligned at the text
  start: ``[owned | right H+1]`` instead of ``[left H | owned | right 1]`` —
  same static shape, different content, selected per-device.
- **pattern axis** (`"pat"`): equal-length patterns are sharded across the
  other mesh axis and batched within a device; the text is replicated along
  it. Matches are returned as fixed-capacity packed buffers per shard
  (per pattern on the overhang path) and compacted on host
  (variable-length outputs cannot cross the XLA boundary).

Costs/candidates are bit-exact with the single-card engines: all run the
same scan and the same selection (`ops/minima.py`), and the halo-restart
trajectory is the same one the single-card tiling uses.
"""

from __future__ import annotations

import numpy as np

from .. import semantics
from ..profiles import Profile
from ..ops.bitpack import WORD_BITS, pack_planes_np
from ..ops.minima import select_candidates
from ..ops.backend import choose_scan, pad_lanes_for
from ..ops.myers_xla import (
    _bucket_rows,
    _cdiv,
    _kernels,
    _next_pow2,
    pattern_inputs_np,
    suffix_rows,
)

__all__ = ["ShardedSearch", "ShardedText", "make_mesh"]

#: device bytes the overhang path's position-level selection holds per
#: shard position for each pattern in flight (peak per card grew by ~440 MB
#: per extra pattern at 32 M positions per card on an H100)
OVERHANG_BYTES_PER_POS = 14
#: device bytes the overhang path may hold for patterns in flight
OVERHANG_BUDGET = 4 << 30


def overhang_batch_for(positions: int, q_local: int) -> int:
    """Patterns per overhang-path step: the largest power of two whose
    position arrays fit ``OVERHANG_BUDGET``, within ``[1, q_local]``."""
    fit = OVERHANG_BUDGET // max(1, OVERHANG_BYTES_PER_POS * positions)
    b = 1
    while 2 * b <= min(fit, q_local):
        b *= 2
    return b


class ShardedText:
    """Reusable packed text for repeated sharded searches: the host pack +
    device upload (the dominant per-call cost at genome scale) is memoized
    per (shard count, shard words, overhang steps)."""

    def __init__(self, profile: Profile, text_raw: np.ndarray):
        from ..profiles import as_bytes_array

        self.profile = profile
        self.raw = as_bytes_array(text_raw)
        self.n = len(self.raw)
        self._codes: np.ndarray | None = None
        self._memo: dict = {}

    def planes_sharded(self, Dt: int, S: int, steps: int):
        """(Dt, P, S) device array of packed shard planes."""
        key = (Dt, S, steps)
        got = self._memo.get(key)
        if got is None:
            import jax.numpy as jnp

            profile = self.profile
            if self._codes is None:
                self._codes = profile.encode(self.raw)
            codes = self._codes
            if steps:
                pad = np.full(steps, profile.overhang_pad_code, dtype=np.uint8)
                codes = np.concatenate([codes, pad])
            planes = pack_planes_np(codes, profile.planes, Dt * S)
            got = jnp.asarray(
                planes.reshape(profile.planes, Dt, S).transpose(1, 0, 2).copy()
            )
            if len(self._memo) > 8:
                self._memo.clear()
            self._memo[key] = got
        return got


def make_mesh(n_text: int | None = None, n_pat: int = 1, devices=None):
    """Build a ('pat', 'text') mesh over the given (default: all) devices."""
    import jax

    if devices is None:
        devices = jax.devices()
    if n_text is None:
        n_text = len(devices) // n_pat
    assert n_pat * n_text <= len(devices), (n_pat, n_text, len(devices))
    arr = np.array(devices[: n_pat * n_text]).reshape(n_pat, n_text)
    return jax.sharding.Mesh(arr, ("pat", "text"))


class ShardedSearch:
    """Batched (equal-length patterns) x (one long text) search over a mesh.

    Produces the same (end_pos, cost) candidate lists as the single-chip
    engines; traceback and Match construction stay host-side (they are per-
    candidate postprocessing, off the critical path, as in the reference's
    process_matches batching, search.rs:1372-1517).

    Documented limits of the sharded path (single-chip engines have none
    of these):

    - profiles: dna/iupac only; ascii raises NotImplementedError (the
      sharded plane packer builds 4-bit IUPAC planes).
    - overhang (``alpha is not None``): computed exactly with the same
      scan, but with position-level selection per pattern, as many local
      patterns at a time as ``OVERHANG_BUDGET`` holds — the overhang tail
      tile + state-strip fast path is single-chip only.
    """

    def __init__(
        self,
        mesh=None,
        cap: int = 1 << 12,
        bcap: int = 1 << 10,
        backend: str | None = None,
        interpret: bool = False,
        hier: bool | None = None,
    ):
        self.mesh = mesh
        self.cap = cap
        self.bcap = bcap
        #: suffix prefilter: None = auto (big shards only), True/False force
        self.hier = hier
        # same scan regardless of shard count (the reference rule,
        # search.rs:592-603)
        if backend is None:
            backend, interpret = choose_scan(interpret)
        self.backend = backend
        self.interpret = interpret
        self._jitted: dict = {}

    def _get_mesh(self):
        if self.mesh is None:
            self.mesh = make_mesh()
        return self.mesh

    # -- one fused SPMD step ------------------------------------------------
    def _build(self, statics):
        """Build (and cache) the shard_mapped + jitted search step for one
        static configuration."""
        key = tuple(sorted(statics.items()))
        got = self._jitted.get(key)
        if got is not None:
            return got

        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..ops.minima import (
            compact_packed,
            select_words_tiles_q,
            tile_state_chain_codes,
        )

        ker = _kernels()
        scan_raw = ker["scan_raw"]
        windows = ker["windows_raw"]
        scan_win_q_meta = ker["scan_win_q_meta"]
        mesh = self._get_mesh()
        s = dict(statics)
        S, H, M = s["S"], s["H"], s["M"]
        NW = H + S + 1
        Dt = mesh.shape["text"]
        eq_mode, all_minima = s["eq_mode"], s["all_minima"]
        cap, bcap = s["cap"], s["bcap"]
        m, boundary_m = s["m"], s["boundary_m"]
        n, max_pos, k = s["n"], s["max_pos"], s["k"]
        alpha = s["alpha"]
        fast = s["fast"]
        backend = s["backend"]
        interpret = s["interpret"]
        hier_s = s.get("hier_s", 0)
        # local tiling of the shard window (the scan's lanes come from
        # the tile axis — a single-tile shard runs one 32-bit lane): same
        # planner rule as single-chip — tiles big enough to amortize the
        # halo re-scan once the shard fills the lane budget
        WL = min(128, max(4 * H, 16, _cdiv(NW, 64 * 1024)))
        # the kernel grid wants whole lane blocks; dummy tiles own nothing
        # and contribute no state
        TL = pad_lanes_for(backend, _cdiv(NW, WL))

        def body(planes_sh, pmasks_sh, is_pad, h_init):
            planes = planes_sh[0]  # (P, S) local shard
            idx = jax.lax.axis_index("text")
            is_first = idx == 0

            # halo exchange with the neighbouring shards
            if Dt > 1:
                left = jax.lax.ppermute(
                    planes[:, S - H :], "text", [(i, i + 1) for i in range(Dt - 1)]
                )
                right = jax.lax.ppermute(
                    planes[:, : H + 1], "text", [(i, i - 1) for i in range(1, Dt)]
                )
            else:
                left = jnp.zeros((planes.shape[0], H), planes.dtype)
                right = jnp.zeros((planes.shape[0], H + 1), planes.dtype)

            # shard 0: left-aligned window (true-start boundary at word 0);
            # others: [left halo | owned | 1 right word].
            win_first = jnp.concatenate([planes, right], axis=1)
            win_rest = jnp.concatenate([left, planes, right[:, :1]], axis=1)
            win = jnp.where(is_first, win_first, win_rest)  # (P, NW)

            offset = jnp.where(is_first, 0, idx * S * WORD_BITS - H * WORD_BITS)
            min_pos = jnp.where(is_first, 0, H * WORD_BITS + 1)
            owned_end = jnp.where(
                is_first, S * WORD_BITS, (H + S) * WORD_BITS
            )
            h_dev = jnp.where(is_first, h_init, jnp.uint32(1))
            bm_dev = jnp.where(is_first, jnp.int32(boundary_m), jnp.int32(m))

            if fast:
                # word-level path: tile the shard window locally (TL lanes),
                # intersect tile ownership with shard ownership, select at
                # word granularity, chain the minima state across shards.
                WB = WORD_BITS
                tile = jnp.arange(TL, dtype=jnp.int32)
                ws = jnp.where(tile == 0, 0, (tile * WL - H) * WB)
                lo_own = min_pos  # first owned local position
                hi_own = jnp.minimum(owned_end, jnp.int32(max_pos) - offset)
                vf_single = jnp.where(tile == 0, -1, H * WB)
                vt_raw = jnp.where(tile == 0, WL * WB, (H + WL) * WB)
                vf = jnp.maximum(vf_single, lo_own - 1 - ws)
                vt = jnp.minimum(vt_raw, hi_own - ws)
                rel_last = (jnp.int32(max_pos) - offset) - ws
                il = jnp.where(
                    (rel_last > vf) & (rel_last <= vt_raw), rel_last, -1
                )
                pos_base = offset + ws
                starts = (tile == 0) & is_first

                # all local patterns in one batched scan, with the
                # selection metadata (word screen + minima state) from
                # the scan (in-kernel on the GPU)
                Ql = pmasks_sh.shape[0]
                planes_win = windows(win, TL, WL, H)  # (NW', P, TL)
                if hier_s:
                    # hierarchical suffix prefilter (single-chip myers_xla
                    # analog): a hier_s-row suffix scan flags tiles, the
                    # full scan runs on the gathered subset. Exact: the
                    # suffix screen lower-bounds full cost, so unflagged
                    # gaps cannot carry <= k plateaus.
                    S_s = hier_s
                    s_vec = jnp.full((Ql,), S_s, jnp.int32)
                    _, _, _, meta_s, _ = scan_win_q_meta(
                        planes_win, jnp.zeros((TL,), bool), vf, vt,
                        pmasks_sh[:, -S_s:, :],
                        jnp.zeros((Ql, S_s), jnp.uint32),
                        jnp.ones((Ql, S_s), jnp.uint32),
                        s_vec, s_vec, jnp.int32(k), eq_mode, backend,
                        interpret,
                    )
                    flag = jnp.any((meta_s & 1) != 0, axis=(0, 1))
                    tcap = pad_lanes_for(backend, bcap)
                    pt = compact_packed(
                        jax, jnp, flag, tile, jnp.zeros((TL,), jnp.int32),
                        tcap, max(16, tcap // 4),
                    )
                    nflag = pt[0]
                    ids = pt[2 : 2 + tcap]
                    live = ids >= 0
                    safe = jnp.where(live, ids, 0)
                    planes_win = jnp.take(planes_win, safe, axis=2)
                    vf = jnp.where(live, jnp.take(vf, safe), 1 << 30)
                    vt = jnp.where(live, jnp.take(vt, safe), 0)
                    il = jnp.where(live, jnp.take(il, safe), -1)
                    pos_base = jnp.take(pos_base, safe)
                    starts = live & jnp.take(starts, safe)
                    tile = jnp.where(live & (safe == 0), 0, -1)
                else:
                    nflag = None
                vp_w, vm_w, cw_w, meta_w, final_q = scan_win_q_meta(
                    planes_win, tile == 0, vf, vt, pmasks_sh,
                    jnp.broadcast_to(is_pad, (Ql,) + is_pad.shape),
                    jnp.broadcast_to(h_dev, (Ql,) + h_dev.shape),
                    jnp.full((Ql,), m, jnp.int32),
                    jnp.broadcast_to(bm_dev, (Ql,)), jnp.int32(k),
                    eq_mode, backend, interpret,
                )  # (Q, NW', TL) x4 + (Q, TL)
                if all_minima:
                    st0 = jnp.zeros(final_q.shape, jnp.int32)
                else:
                    # incoming state over the interconnect: per-shard last
                    # owned delta code, exact across any number of shards
                    # (a flat shard passes the state through)
                    _, out_code = tile_state_chain_codes(
                        jax, jnp, final_q, starts, with_out=True
                    )  # (Q,)
                    scode = jnp.where(
                        out_code > 0, 2 * (idx + 2) + (out_code & 1), 0
                    )
                    codes = jax.lax.all_gather(scode, "text")  # (Dt, Q)
                    prev = jnp.max(
                        jnp.where(
                            (jnp.arange(Dt, dtype=jnp.int32) < idx)[:, None],
                            codes,
                            0,
                        ),
                        axis=0,
                    )
                    seed = jnp.where(prev > 0, 2 + (prev & 1), 0)
                    st0 = tile_state_chain_codes(
                        jax, jnp, final_q, starts, seed_code=seed
                    )
                packed = select_words_tiles_q(
                    jax, jnp, vp_w, vm_w, cw_w, meta_w, vf, vt, il,
                    pos_base, jnp.int32(k), st0, all_minima, cap, bcap,
                )  # (3 + 2*cap,) [total, naux, 0, pos, qid<<16|cost]
                if nflag is not None:
                    # prefilter overflow surfaces through naux so the
                    # host-side cap check catches it
                    packed = packed.at[1].set(jnp.maximum(packed[1], nflag))
                return packed[None, None, :]

            def one_pattern(pmask):
                # overhang path: tile the local shard window exactly like
                # the fast path (TL lanes of WL words, H-word halo re-scan)
                # so the scan runs on many lanes instead of one NW-word
                # sequential lane; selection stays position-level (exact
                # overhang costs). Positions past NW*32 come from the pad
                # tail and are excluded by owned_end/max_pos below.
                fc, fd = scan_raw(
                    win, pmask, is_pad, h_dev, jnp.int32(m), bm_dev,
                    eq_mode, TL, WL, H, backend, interpret,
                )
                if all_minima:
                    st0 = None
                else:
                    # exact cross-shard decreasing-state: each shard's last
                    # owned nonzero delta (sign-coded), combined across shards;
                    # a flat shard passes the state through, so plateaus
                    # spanning any number of shards resolve exactly (see
                    # ops/minima.py tile_state_chain)
                    pos_l = jnp.arange(1, fd.shape[0] + 1, dtype=jnp.int32)
                    owned = (pos_l >= min_pos) & (pos_l <= owned_end)
                    nz = owned & (fd != 0)
                    enc_l = jnp.where(
                        nz, 2 * pos_l + (fd > 0).astype(jnp.int32), 0
                    )
                    code = jnp.max(enc_l)
                    codes = jax.lax.all_gather(code, "text")  # (Dt,)
                    prev = jnp.max(
                        jnp.where(
                            jnp.arange(Dt, dtype=jnp.int32) < idx, codes, 0
                        )
                    )
                    st0 = jnp.where(prev > 0, prev & 1, 0)
                packed = select_candidates(
                    jax, jnp, fc, fd, bm_dev,
                    jnp.int32(n) - offset, jnp.int32(max_pos) - offset,
                    jnp.int32(k), jnp.float32(alpha),
                    all_minima, cap, bcap,
                    min_pos=min_pos, owned_end=owned_end, state0=st0,
                )
                posbuf = packed[2 : 2 + cap]
                return packed.at[2 : 2 + cap].set(
                    jnp.where(posbuf >= 0, posbuf + offset, -1)
                )

            # the position-level selection holds several int32 arrays of the
            # shard's full position count per pattern in flight
            ob = s["overhang_batch"]
            out = jax.lax.map(
                one_pattern, pmasks_sh, batch_size=ob if ob > 1 else None
            )  # (Qlocal, 2+2cap)
            return out[:, None, :]

        in_specs = (P("text", None, None), P("pat", None, None), P(), P())
        out_specs = P("pat", "text", None)
        # Disable the varying-manual-axes / replication check: the scan
        # carries inside the kernel are initialized from constants, which the
        # checker flags as unvarying vs the varying outputs.
        fn = jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        fn = jax.jit(fn)
        self._jitted[key] = fn
        del M
        return fn

    # -- host driver ----------------------------------------------------
    def candidates_batch(
        self,
        profile: Profile,
        patterns: list[np.ndarray],
        text_raw: np.ndarray,
        k: int,
        alpha: float | None = None,
        max_overhang: int | None = None,
        all_minima: bool = False,
    ) -> list[list[tuple[int, int]]]:
        """Per-pattern (end_pos, cost) candidate lists; patterns must be
        equal length. Exact same results as the single-chip engines."""
        import jax.numpy as jnp

        if profile.eq_mode != "iupac":
            raise NotImplementedError("sharded search supports dna/iupac profiles")
        mesh = self._get_mesh()
        Dt = mesh.shape["text"]
        Dp = mesh.shape["pat"]

        pcodes = [profile.encode(p) for p in patterns]
        m = len(pcodes[0])
        if any(len(c) != m for c in pcodes):
            raise ValueError("sharded batch requires equal-length patterns")

        st = (
            text_raw
            if isinstance(text_raw, ShardedText)
            else ShardedText(profile, text_raw)
        )
        n = st.n
        steps = semantics.overhang_steps(m, k, alpha, max_overhang)
        max_pos = n + steps

        m_bucket = _bucket_rows(m)
        H = _next_pow2(_cdiv(m_bucket + k, WORD_BITS))
        words_needed = max(1, _cdiv(max_pos, WORD_BITS))
        S = max(_cdiv(words_needed, Dt), H + 1)

        # packed shard planes (+ 'N' overlay for overhang), memoized on the
        # ShardedText so repeat searches skip the pack + upload
        planes_sh = st.planes_sharded(Dt, S, steps)

        # pattern inputs, padded to a multiple of the pat axis
        per = [pattern_inputs_np(profile, c, alpha, max_overhang) for c in pcodes]
        pmasks = np.stack([p[0] for p in per])  # (Q, M, planes)
        is_pad, h_init, boundary_m = per[0][1], per[0][2], per[0][3]
        Q = len(patterns)
        Qe = _cdiv(Q, Dp) * Dp
        # the packed fetch encodes qid<<16|cost per shard; per-shard qids
        # must stay below 2^15 or the shift wraps the int32 sign bit
        if Qe // Dp > (1 << 15):
            raise ValueError(
                f"per-shard pattern count {Qe // Dp} exceeds the qid<<16 "
                f"packing range (32768); split the pattern batch"
            )
        if Qe > Q:
            pmasks = np.concatenate(
                [pmasks, np.repeat(pmasks[:1], Qe - Q, axis=0)], axis=0
            )

        fast = alpha is None
        backend = self.backend
        statics = dict(
            S=S, H=H, M=pmasks.shape[1], eq_mode=profile.eq_mode,
            all_minima=all_minima, cap=self.cap, bcap=self.bcap,
            m=m, boundary_m=boundary_m, n=n, max_pos=max_pos, k=k,
            alpha=float(alpha) if alpha is not None else 0.0,
            fast=fast, backend=backend, interpret=self.interpret,
            # local patterns per overhang-path step (lax.map batch_size)
            overhang_batch=(
                0 if fast
                else overhang_batch_for((S + H + 1) * WORD_BITS, Qe // Dp)
            ),
            # hierarchical suffix prefilter (single-chip gate mirrored):
            # only pays when shards are big and the suffix is selective
            hier_s=(
                suffix_rows(m, k)
                if fast and profile.eq_mode == "iupac"
                and (self.hier or (self.hier is None and S >= (4096 * 16)))
                else 0
            ),
        )
        fn = self._build(statics)
        res = fn(
            planes_sh,
            jnp.asarray(pmasks),
            jnp.asarray(is_pad),
            jnp.asarray(h_init),
        )  # overhang: (Qe, Dt, 2+2cap); fast: (Dp, Dt, 3+2cap)
        import jax

        if jax.process_count() > 1:
            # a multi-host global array is not host-fetchable directly;
            # assemble it on every host over DCN
            from jax.experimental import multihost_utils

            out = np.asarray(
                multihost_utils.process_allgather(res, tiled=True)
            )
        else:
            out = np.asarray(res)

        cap = self.cap
        results: list[list[tuple[int, int]]] = [[] for _ in range(Q)]
        # owner-computes observability (asserted by the multichip dryrun):
        # per-shard candidate counts, the owned-word split, and any
        # ownership violations (a candidate reported by a shard that does
        # not own its end position — shard d owns (d*S*32, (d+1)*S*32],
        # shard 0 additionally owns position 0)
        words_needed_all = max(1, _cdiv(max_pos, WORD_BITS))
        stats = {
            "Dt": Dt,
            "Dp": Dp if fast else 1,
            # patterns per count-row: the fast path packs Qlocal=Qe//Dp
            # patterns into one shard row; the overhang path keeps one row
            # per pattern (global q maps to row q // Qlocal)
            "Qlocal": (Qe // Dp) if fast else 1,
            "S": S,
            "owned_words": [
                max(0, min(words_needed_all - d * S, S)) for d in range(Dt)
            ],
            "per_shard_counts": np.zeros(
                (Dp if fast else Q, Dt), np.int64
            ),
            "ownership_violations": 0,
        }
        span = S * WORD_BITS

        def _owner(pp: int) -> int:
            return 0 if pp <= 0 else (pp - 1) // span

        if fast:
            Qlocal = Qe // Dp
            for p in range(Dp):
                for d in range(Dt):
                    row = out[p, d]
                    total, naux = int(row[0]), int(row[1])
                    if total > cap or naux > self.bcap:
                        raise RuntimeError(
                            f"sharded candidate overflow (count={total}, "
                            f"cap={cap}); raise ShardedSearch(cap=...)"
                        )
                    stats["per_shard_counts"][p, d] += total
                    pos = row[3 : 3 + total]
                    qc = row[3 + cap : 3 + cap + total]
                    cost = qc & 0xFFFF
                    qid = qc >> 16
                    for qq, pp, cc in zip(
                        qid.tolist(), pos.tolist(), cost.tolist()
                    ):
                        if _owner(pp) != d:
                            stats["ownership_violations"] += 1
                        gq = p * Qlocal + qq
                        if gq < Q:
                            results[gq].append((pp, cc))
            for cands in results:
                cands.sort()
            self.last_stats = stats
            return results

        for q in range(Q):
            cands = results[q]
            for d in range(Dt):
                row = out[q, d]
                count = int(row[0])
                if count > cap or int(row[1]) > self.bcap:
                    raise RuntimeError(
                        f"sharded candidate overflow (count={count}, cap={cap}); "
                        "raise ShardedSearch(cap=...)"
                    )
                stats["per_shard_counts"][q, d] += count
                pos = row[2 : 2 + count]
                cost = row[2 + cap : 2 + cap + count]
                for pp in pos.tolist():
                    if _owner(pp) != d:
                        stats["ownership_violations"] += 1
                cands.extend(zip(pos.tolist(), cost.tolist()))
            cands.sort()  # word-level output is unsorted within a shard
        self.last_stats = stats
        return results

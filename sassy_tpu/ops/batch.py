"""Batched multi-(pattern x text) search engine — one fused dispatch.

This is the device counterpart of the reference's batch modes:

- ``search_texts`` / ``search_patterns`` lanes (one text or pattern per SIMD
  lane, /root/reference/src/search.rs:615-678),
- ``search_many``'s rayon cartesian product (search.rs:531-603), and
- Sassy2's pattern tiling (pattern batch sharing one text pass,
  reference src/pattern_tiling/) — on the device the lane budget is
  tens of thousands, so both texts and patterns batch onto the same kernel.

Design: texts are cut into **pieces** (whole short texts, or halo-overlapped
segments of long texts), each padded to a common W words. Pieces form the
tile axis T of one bit-parallel scan; every tile carries its own boundary
state: a *true-start* piece begins with the overhang-alpha h-init (as the
reference sets for all lanes in multi-lane modes, search.rs:1732-1748), a
*continuation* piece restarts with the plain cost-j boundary ``halo = M + k``
chars before its owned range (exactly the chunk-overlap rule,
search.rs:1018-1022), with ownership intervals making dedup free
(search.rs:1202-1240). Patterns vmap on top — Q x T x W in one dispatch,
sliced into dispatch groups under a cell budget so genome-scale scans fit
in HBM.

Per-tile candidate selection (ops/minima.py select_candidates_tiles) gives
each piece its own minima scan, trailing-minimum position, and overshoot
anchor, so results are bit-identical to running the single-text engine per
(pattern, text).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import semantics
from ..profiles import Profile
from .backend import choose_scan, lane_multiple, pad_lanes_for
from .bitpack import WORD_BITS
from .minima import select_candidates_tiles, select_words_tiles_q
from .myers_xla import (
    _bucket_words,
    _cdiv,
    _kernels,
    pattern_inputs_np,
    suffix_rows as _suffix_rows,
)

__all__ = ["BatchEngine", "TextSet"]

_SCALAR_MEMO: dict = {}


def _dev_scalar(val, dtype):
    """Device-resident scalar/array memo: every fresh np scalar argument to
    a jitted dispatch costs a host->device transfer; the dispatch loop's
    k/alpha/chunk-offset values repeat endlessly."""
    import jax.numpy as jnp

    key = (val, str(dtype))
    got = _SCALAR_MEMO.get(key)
    if got is None:
        if len(_SCALAR_MEMO) > 4096:
            _SCALAR_MEMO.clear()
        got = jnp.asarray(val, dtype)
        _SCALAR_MEMO[key] = got
    return got


def _bucket_cap(x: int) -> int:
    """Smallest {4,5,6,7}*2^j >= x (floor 64). Straight next_pow2 cap
    growth fetches up to 2x the payload (e.g. ~2100 matches/chunk -> cap
    4096); the quarter-octave lattice bounds waste at ~14% while keeping
    jit shape variety at 4 sizes per octave."""
    if x <= 64:
        return 64
    j = x.bit_length() - 3  # 4<<j is the largest pow2-quarter <= ~x
    for f in (4, 5, 6, 7):
        v = f << j
        if v >= x:
            return v
    return 8 << j


#: The packed candidate fetch encodes qid<<16|cost in one int32
#: (ops/minima.py select_words_tiles_q), so a single dispatch is limited to
#: 2^15 patterns: qid must stay below 32768 or the shift wraps the sign bit
#: and the decode negative-indexes silently.
QID_PACK_MAX = 1 << 15


class TextSet:
    """A reusable batch of texts: piece plans and packed planes are cached
    per (halo, steps, piece-width) so repeated searches (different patterns
    or k) skip host packing — the analog of the reference's pre-encoded v2
    chunks in its bench harness (evals/src/benchsuite/bench.rs:360-382)."""

    #: device-assembly gate: per-text jits only pay off for a few large
    #: texts (the genome/CRISPR case); read batches keep host packing
    DEV_MIN_BYTES = 32 << 20
    DEV_MAX_TEXTS = 8

    def __init__(self, texts):
        from ..profiles import as_bytes_array

        # contiguous copies: reversed-text views (negative stride) make
        # every downstream encode/slice run many times slower
        self.texts = [
            np.ascontiguousarray(as_bytes_array(t)) for t in texts
        ]
        self.lens = [len(t) for t in self.texts]
        self._packs: dict = {}
        self._rev_texts = None

    def _texts_for(self, reverse: bool):
        if not reverse:
            return self.texts
        if self._rev_texts is None:
            self._rev_texts = [
                np.ascontiguousarray(t[::-1]) for t in self.texts
            ]
        return self._rev_texts

    def _plan_tv(self, steps, halo, w_chars, pad_mult):
        key = ("plan", steps, halo, w_chars, pad_mult)
        got = self._packs.get(key)
        if got is not None:
            return got
        pieces = _plan_pieces(self.lens, steps, w_chars, halo)
        npad = (-len(pieces)) % pad_mult
        pieces = pieces + [_DUMMY] * npad
        # text_end is piece-LOCAL only as an overshoot anchor: any in-piece
        # position is <= w_chars + steps, so overshoot = max(pos - text_end,
        # 0) is 0 whenever text_end exceeds the piece span — clamping keeps
        # a >2.1 Gbp genome's early pieces inside int32 without changing
        # any overshoot cost
        tv = np.array(
            [
                [int(p.true_start) for p in pieces],
                [min(p.text_end, 1 << 30) for p in pieces],
                [p.valid_from for p in pieces],
                [p.valid_to for p in pieces],
                [p.islast_at for p in pieces],
            ],
            dtype=np.int32,
        )
        got = (pieces, tv)
        self._packs[key] = got
        return got

    def _plan_arrays(self, steps, halo, w_chars, pad_mult):
        """Vectorized piece lookup tables for the result decode:
        (text_idx int32, start_char int64) per piece (dummy = -1)."""
        key = ("plan_arrays", steps, halo, w_chars, pad_mult)
        got = self._packs.get(key)
        if got is None:
            pieces, _ = self._plan_tv(steps, halo, w_chars, pad_mult)
            got = (
                np.array([p.text_idx for p in pieces], np.int32),
                np.array([p.start_char for p in pieces], np.int64),
            )
            self._packs[key] = got
        return got

    def packed(self, profile, steps, halo, w_chars, pad_mult: int = 1,
               reverse: bool = False):
        """Returns (pieces, planes_dev, tilevec_dev): piece planes
        (P, T, W+1) uint32 on the device, with the piece count padded
        (dummy pieces) to a multiple of ``pad_mult`` at pack time, so
        dispatch-time chunking is exact device slices.

        ``reverse``: pack the character-reversed texts (the RC search
        scans the reversed text with the complemented pattern,
        search.rs:1570-1612); piece plans are length-only, so they are
        shared with the forward pack.

        For a few large texts the pieces are assembled ON DEVICE from flat
        per-text planes (see _flat_dev): a fresh genome-scale search then
        costs one raw-byte upload, both strands included, instead of a
        host pack + plane upload per strand and piece width."""
        key = (profile.name, getattr(profile, "case_sensitive", None),
               steps, halo, w_chars, pad_mult, reverse)
        got = self._packs.get(key)
        if got is not None:
            return got
        import jax.numpy as jnp

        pieces, tv = self._plan_tv(steps, halo, w_chars, pad_mult)
        geom = None
        if (
            len(self.texts) <= self.DEV_MAX_TEXTS
            and sum(self.lens) >= self.DEV_MIN_BYTES
        ):
            geom = self._dev_piece_geom(pieces, steps, halo, w_chars)
        if geom is not None:
            counts, S, hw = geom
            flats = self._flat_dev(profile, reverse)
            gws = tuple(int(f.shape[1]) for f in flats)
            P = int(flats[0].shape[0])
            asm = _assemble_fn(tuple(zip(gws, counts)), S, hw, len(pieces), P)
            planes = asm(flats)
        else:
            planes = jnp.asarray(_pack_pieces_np(
                profile, self._texts_for(reverse), pieces, w_chars, steps
            ))
        got = (pieces, planes, jnp.asarray(tv))
        self._packs[key] = got
        return got

    def _flat_dev(self, profile, reverse: bool = False):
        """Per-text flat device planes (P[+valid], GW) uint32.

        Forward planes are packed ON DEVICE from one raw-byte upload (raw
        bytes are a quarter of the plane words); reversed planes are
        derived on device from the forward ones — the reversed strand
        costs no second upload at all."""
        from .myers_xla import _kernels

        key = ("flat", profile.name,
               getattr(profile, "case_sensitive", None), reverse)
        got = self._packs.get(key)
        if got is None:
            import jax.numpy as jnp

            ker = _kernels()
            if reverse:
                fwd = self._flat_dev(profile, False)
                got = [
                    ker["reverse_planes"](
                        p, np.int32(n // WORD_BITS), np.int32(n % WORD_BITS)
                    )
                    for p, n in zip(fwd, self.lens)
                ]
            else:
                with_valid = profile.eq_mode == "ascii"
                got = []
                for t in self.texts:
                    n = len(t)
                    gw = _bucket_words(max(1, _cdiv(n, WORD_BITS)))
                    buf = np.zeros(gw * WORD_BITS, np.uint8)
                    buf[:n] = t
                    got.append(ker["pack_jit"](
                        jnp.asarray(buf), np.int32(n // WORD_BITS),
                        np.int32(n % WORD_BITS), profile.planes,
                        with_valid, profile.pack_mode, profile.pack_shift,
                        profile.pack_mask, tuple(profile.pack_plane_masks),
                        profile.pack_fold_case,
                    ))
            self._packs[key] = got
        return got

    def _dev_piece_geom(self, pieces, steps, halo, w_chars):
        """Per-text tile counts when the piece plan is the regular stride
        the device assembly reproduces (window t = words
        [t*S, t*S + S + hw + 1) of the text's flat planes); None when the
        plan is irregular (overhang clamp, degenerate widths)."""
        if steps:
            return None
        hw = _cdiv(halo, WORD_BITS)
        S = w_chars // WORD_BITS - hw
        if S < hw + 1:  # assembly builds NW<=2S columns from two reshapes
            return None
        counts = []
        per_text: dict[int, list] = {}
        for p in pieces:
            if p.text_idx >= 0:
                per_text.setdefault(p.text_idx, []).append(p)
        for t in range(len(self.lens)):
            ps = per_text.get(t, [])
            if not ps:
                return None
            for i, p in enumerate(ps):
                if p.start_char != i * S * WORD_BITS:
                    return None
            counts.append(len(ps))
        return counts, S, hw


@dataclass
class _Piece:
    """One tile of the batched scan: a text, or a halo-prefixed segment."""

    text_idx: int
    start_char: int  # text-local char index at piece position 0
    valid_from: int  # positions > valid_from are owned (-1: owns position 0)
    valid_to: int  # positions <= valid_to are owned
    text_end: int  # local position of the text end (overshoot anchor)
    islast_at: int  # trailing-minimum position (-1 for non-final segments)
    true_start: bool


def _plan_pieces(lens: list[int], steps: int, w_chars: int, halo: int) -> list[_Piece]:
    """Cut texts into pieces of <= w_chars positions each.

    Position space of text t is 1..n_t + steps (+ the boundary position 0,
    owned by the true-start piece). A continuation piece re-scans ``halo``
    chars before its owned range.
    """
    pieces: list[_Piece] = []
    for t, n in enumerate(lens):
        total = n + steps
        o = 0  # first not-yet-owned position
        first = True
        while True:
            if first:
                own = min(total, w_chars)
                start_char = 0
                vfrom = -1
            else:
                # word-aligned window start: piece planes then assemble
                # from bulk-packed words (no per-piece char repacking);
                # the halo grows by up to 31 chars, which only adds context
                start_char = (o - halo) // WORD_BITS * WORD_BITS
                vfrom = o - start_char
                own = min(total - o, w_chars - vfrom)
            if steps and o < n and n < o + own < total:
                # never split the overshoot span (n, n+steps] across pieces:
                # the word-level alpha fast path derives the final piece's
                # cross-piece state from RAW delta codes, which is exact
                # only when all prior pieces own raw (<= n) positions
                own = n - o
            last = o + own >= total
            pieces.append(
                _Piece(
                    text_idx=t,
                    start_char=start_char,
                    valid_from=vfrom,
                    valid_to=vfrom + own if not first else own,
                    text_end=n - start_char,
                    islast_at=(vfrom if not first else 0) + own if last else -1,
                    true_start=first,
                )
            )
            o += own
            first = False
            if last:
                break
    return pieces


def _w_lattice(cap: int) -> list[int]:
    """The shape-bucket lattice {4,5,6,7} * 2^j (>= 16) up to ``cap``."""
    vals = [16]
    p = 16
    while p < cap:
        for f in (20, 24, 28, 32):
            v = p * f // 16
            if v <= cap:
                vals.append(v)
        p *= 2
    return sorted(set(vals))


def _pick_w_words(
    lens: list[int], steps: int, halo: int, w_cap: int, pad_mult: int = 1
) -> int:
    """Piece-window width (words) minimizing total scanned cells.

    The kernel scans every piece's full window, so a width that divides
    the text lengths poorly pads each text by up to w_chars-1 chars
    (10 kb nanopore reads at a 4800-char window scan 14400 chars each —
    44% waste; 2560 scans 10240 — 2%). Evaluate
    the bucket lattice <= w_cap with an analytic piece-count model (exact
    planning stays in _plan_pieces; only the choice of width uses the
    model, so a model being off by a piece merely picks a near-optimal
    width). Ties prefer the widest window (fewest pieces)."""
    cands = _w_lattice(w_cap)
    if w_cap not in cands:
        cands.append(w_cap)
    ln = np.asarray(lens, np.int64) + steps
    halo_a = halo + WORD_BITS - 1  # worst-case word-aligned halo re-scan
    best_w, best_cost = None, None
    for w in cands:
        wc = w * WORD_BITS
        if wc <= halo + WORD_BITS or wc <= halo_a + WORD_BITS:
            continue
        over = np.maximum(ln - wc, 0)
        cont = -(-over // (wc - halo_a))
        n_pieces = int(np.sum(1 + cont + ((steps > 0) & (over > 0))))
        cost = _cdiv(n_pieces, pad_mult) * pad_mult * w
        if (
            best_cost is None
            or cost < best_cost
            or (cost == best_cost and w > best_w)
        ):
            best_w, best_cost = w, cost
    return best_w if best_w is not None else w_cap


_DUMMY = _Piece(-1, 0, 1 << 30, 0, 1 << 30, -1, False)


def _pack_pieces_np(
    profile: Profile,
    texts: list[np.ndarray],
    pieces: list[_Piece],
    w_chars: int,
    steps: int,
) -> np.ndarray:
    """(P[, +valid], T, W+1) uint32 bit-planes of the piece codes.

    Each piece is packed with ONE extra word of right context past its
    owned range (zeros at the text end): the rightmost-minima lookahead at
    the piece's last owned position then reads the true next delta instead
    of an artificial +1 (which would emit a spurious candidate when the
    cost keeps decreasing into the continuation piece)."""
    T = len(pieces)
    pw = w_chars + WORD_BITS
    W = pw // WORD_BITS
    with_valid = profile.eq_mode == "ascii"
    planes = profile.planes + (1 if with_valid else 0)

    # bulk-pack each text's planes ONCE (np.packbits at C speed), then
    # assemble piece windows as word slices — piece starts are
    # word-aligned by the planner, so no per-piece char repacking
    packed_texts = []
    for text in texts:
        c = profile.encode(text)
        if steps:
            c = np.concatenate(
                [c, np.full(steps, profile.overhang_pad_code, dtype=np.uint8)]
            )
        gw = -(-len(c) // WORD_BITS)
        pad = gw * WORD_BITS - len(c)
        if pad:
            c = np.concatenate([c, np.zeros(pad, np.uint8)])
        bits = c.reshape(gw, WORD_BITS)
        pt = np.empty((planes, gw), dtype=np.uint32)
        for p in range(profile.planes):
            pb = np.packbits((bits >> p) & 1, axis=-1, bitorder="little")
            pt[p] = pb.view(np.uint32).reshape(gw)
        if with_valid:
            v = np.zeros(gw * WORD_BITS, np.uint8)
            v[: len(text)] = 1
            pb = np.packbits(
                v.reshape(gw, WORD_BITS), axis=-1, bitorder="little"
            )
            pt[-1] = pb.view(np.uint32).reshape(gw)
        packed_texts.append(pt)

    out = np.zeros((planes, T, W), dtype=np.uint32)
    for i, pc in enumerate(pieces):
        if pc.text_idx < 0:
            continue
        src = packed_texts[pc.text_idx]
        w0 = pc.start_char // WORD_BITS
        assert w0 * WORD_BITS == pc.start_char, pc
        hi = min(w0 + W, src.shape[1])
        out[:, i, : hi - w0] = src[:, w0:hi]
    return out


# ---------------------------------------------------------------------------

_BATCH_JIT: dict = {}


def _assemble_fn(geoms, S, hw, T_pad, P):
    """Jit that assembles piece planes (P, T_pad, NW) uint32 from per-text
    flat planes. ``geoms``: ((gw_t, T_t), ...) per text; piece t of a text
    = flat words [t*S, t*S + S + hw + 1) — two shifted reshapes + a
    concat, no gathers."""
    key = ("asm", geoms, S, hw, T_pad, P)
    got = _BATCH_JIT.get(key)
    if got is not None:
        return got

    import jax
    import jax.numpy as jnp

    NW = S + hw + 1

    @jax.jit
    def asm(flats):
        parts = []
        for (gw_t, T_t), fl in zip(geoms, flats):
            need = (T_t + 1) * S
            if need > gw_t:
                fl = jnp.pad(fl, ((0, 0), (0, need - gw_t)))
            a = fl[:, : T_t * S].reshape(P, T_t, S)
            b = fl[:, S : (T_t + 1) * S].reshape(P, T_t, S)
            parts.append(jnp.concatenate([a, b], axis=2)[:, :, :NW])
        w = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
        if T_pad > w.shape[1]:
            w = jnp.pad(w, ((0, 0), (0, T_pad - w.shape[1]), (0, 0)))
        return w

    _BATCH_JIT[key] = asm
    return asm


def _batch_fn(
    eq_mode: str, all_minima: bool, cap: int, bcap: int, fast: bool,
    hier_s: int = 0, backend: str = "xla", interpret: bool = False,
    t_chunk: int = 0, n_prev: int = 0,
):
    key = (eq_mode, all_minima, cap, bcap, fast, hier_s, backend, interpret,
           t_chunk, n_prev)
    got = _BATCH_JIT.get(key)
    if got is not None:
        return got

    import jax
    import jax.numpy as jnp

    from .minima import compact_packed, tile_state_chain_codes

    scan_win_q = _kernels()["scan_win_q"]
    scan_win_q_meta = _kernels()["scan_win_q_meta"]

    p_pat = 4 if eq_mode == "iupac" else 8  # pattern plane count

    @jax.jit
    def run(
        planes_all,  # (P, T_all, W) uint32 — the full cached text set
        tv_all,  # (5, T_all) int32
        t0,  # () int32 chunk offset (chunk slicing stays on device:
        #      an eager slice would be one more dispatch)
        patblob,  # (Q, M*Pp + 2M + 2) uint32: pmasks | is_pad | h_init | m | bm
        k,  # () int32
        alpha,  # () float32
    ):
        Tc = t_chunk if t_chunk else planes_all.shape[1]
        planes_tw = jax.lax.dynamic_slice(
            planes_all, (0, t0, 0),
            (planes_all.shape[0], Tc, planes_all.shape[2]),
        )
        tilevec = jax.lax.dynamic_slice(tv_all, (0, t0), (5, Tc))
        Qb, cols = patblob.shape
        M = (cols - 2) // (p_pat + 2)
        pmasks = patblob[:, : M * p_pat].reshape(Qb, M, p_pat)
        is_pad = patblob[:, M * p_pat : M * p_pat + M]
        h_init = patblob[:, M * p_pat + M : M * p_pat + 2 * M]
        m_vec = patblob[:, -2].astype(jnp.int32)
        bm_vec = patblob[:, -1].astype(jnp.int32)
        true_start = tilevec[0] != 0
        text_end = tilevec[1]
        valid_from = tilevec[2]
        valid_to = tilevec[3]
        islast_at = tilevec[4]
        planes_win = planes_tw.transpose(2, 0, 1)  # (W+1, P, T)
        T = planes_tw.shape[1]
        W = planes_tw.shape[2] - 1  # owned words (last word is context)
        Q = pmasks.shape[0]
        stride = W * WORD_BITS + 1
        pos_base = jnp.arange(T, dtype=jnp.int32) * stride
        cost0 = jnp.where(
            true_start[None, :], bm_vec[:, None], m_vec[:, None]
        ).astype(jnp.int32)  # (Q, T)

        hier = fast and hier_s and hier_s < pmasks.shape[1]
        if hier:
            # hierarchical prefilter (reference general.rs:40-130): a cheap
            # suffix-rows scan flags tiles that could contain a <=k position
            # for ANY pattern in the batch; the full-rows scan runs on the
            # union of flagged tiles. Exact: full cost >= suffix cost at
            # every position, and flagged tiles re-run the identical scan.
            # The kernel's in-kernel screen (meta bit 0) IS the flag test.
            S = hier_s
            pm_s = pmasks[:, -S:, :]
            ip_s = jnp.zeros((Q, S), jnp.uint32)
            hi_s = jnp.ones((Q, S), jnp.uint32)
            s_vec = jnp.full((Q,), S, jnp.int32)
            no_t0 = jnp.zeros((T,), bool)
            _, _, _, meta_s, _ = scan_win_q_meta(
                planes_win, no_t0, valid_from, valid_to, pm_s, ip_s, hi_s,
                s_vec, s_vec, k, eq_mode, backend, interpret,
            )  # (Q, NW, T)
            flag = jnp.any((meta_s & 1) != 0, axis=(0, 1))  # (T,)
            nflag = jnp.sum(flag.astype(jnp.int32))
            tcap = pad_lanes_for(backend, bcap)
            slot = jnp.where(
                flag, jnp.cumsum(flag.astype(jnp.int32)) - 1, tcap
            )
            ids = jnp.full((tcap,), T, jnp.int32)
            ids = ids.at[slot].set(jnp.arange(T, dtype=jnp.int32), mode="drop")
            safe = jnp.minimum(ids, T - 1)
            live = ids < T

            planes_sub = jnp.take(planes_tw, safe, axis=1)
            valid_from = jnp.where(live, jnp.take(valid_from, safe), 1 << 30)
            valid_to = jnp.where(live, jnp.take(valid_to, safe), 0)
            islast_at = jnp.where(live, jnp.take(islast_at, safe), -1)
            pos_base = jnp.take(pos_base, safe)
            true_start = live & jnp.take(true_start, safe)
            text_end = jnp.take(text_end, safe)
            cost0 = jnp.where(
                live[None, :], jnp.take(cost0, safe, axis=1), m_vec[:, None]
            )
            planes_win = planes_sub.transpose(2, 0, 1)

        if fast:
            vp_q, vm_q, cw_q, meta_q, final_q = scan_win_q_meta(
                planes_win, true_start, valid_from, valid_to,
                pmasks, is_pad, h_init, m_vec, bm_vec, k,
                eq_mode, backend, interpret,
            )  # (Q, NW, T')
            # cross-piece decreasing-state chain (reset at text starts).
            # Pieces in this chunk chain exactly; a plateau crossing a
            # dispatch-chunk boundary falls back to state 0, the same
            # truncation the reference applies at every one of its internal
            # lane starts (search.rs:1040-1056).
            if all_minima:
                st0 = jnp.zeros(final_q.shape, jnp.int32)
            else:
                st0 = tile_state_chain_codes(
                    jax, jnp, final_q, valid_from < 0
                )
            packed = select_words_tiles_q(
                jax, jnp, vp_q, vm_q, cw_q, meta_q,
                valid_from, valid_to, islast_at, pos_base,
                k, st0, all_minima, cap, bcap,
                text_end=text_end if n_prev else None,
                alpha=alpha, n_prev=n_prev,
            )
            if hier:
                packed = packed.at[1].set(jnp.maximum(packed[1], nflag))
            return packed

        vp_q, vm_q, cw_q = scan_win_q(
            planes_win, true_start, pmasks, is_pad, h_init, m_vec, bm_vec,
            eq_mode, backend, interpret,
        )  # (Q, NW, T')
        if all_minima:
            st0 = jnp.zeros(vp_q.shape[:1] + vp_q.shape[2:], jnp.int32)
        else:
            from .minima import tile_state_chain

            st0 = tile_state_chain(
                jax, jnp, vp_q, vm_q, valid_from, valid_to, valid_from < 0
            )

        # overhang path: per-pattern position-level selection + device merge
        def select_one(vp_w, vm_w, cost_w, c0, s0):
            return select_candidates_tiles(
                jax, jnp, vp_w, vm_w, cost_w, c0, text_end,
                valid_from, valid_to, islast_at, pos_base, k, alpha, s0,
                all_minima, cap, bcap,
            )

        packed = jax.vmap(select_one)(vp_q, vm_q, cw_q, cost0, st0)
        counts = packed[:, 0]
        naux = jnp.max(packed[:, 1])
        maxq = jnp.max(counts)
        posb = packed[:, 2 : 2 + cap]
        costb = packed[:, 2 + cap : 2 + 2 * cap]
        mask = (posb >= 0).reshape(-1)
        # qid<<16 | cost in one word (same packing as the fast path)
        qcb = jnp.broadcast_to(
            jnp.arange(Q, dtype=jnp.int32)[:, None] << 16, (Q, cap)
        ) | (costb & 0xFFFF)
        pk = compact_packed(
            jax, jnp, mask, posb.reshape(-1), qcb.reshape(-1), cap, bcap
        )
        total = pk[0]
        # surface the merge compaction's own block count into the retry
        # signal: with cap-sized per-pattern rows, > bcap patterns each
        # holding hits would otherwise drop whole blocks silently
        # (nblk <= total <= cap, so no overflow would trigger)
        naux = jnp.maximum(naux, pk[1])
        return jnp.concatenate(
            [
                total.reshape(1),
                naux.reshape(1),
                maxq.reshape(1),
                pk[2 : 2 + cap],            # pos
                pk[2 + cap : 2 + 2 * cap],  # qid<<16 | cost
            ]
        )

    _BATCH_JIT[key] = run
    return run


def _batch_fn_map(n_chunks: int, *args):
    """All dispatch chunks in ONE jit (lax.map over the chunk offsets):
    one host->device send + one fetch for the whole workload instead of
    n_chunks sends."""
    key = ("map", n_chunks) + args
    got = _BATCH_JIT.get(key)
    if got is not None:
        return got

    import jax

    base = _batch_fn(*args)

    @jax.jit
    def run_all(planes_all, tv_all, t0s, patblob, k, alpha):
        return jax.lax.map(
            lambda t0: base(planes_all, tv_all, t0, patblob, k, alpha), t0s
        )

    _BATCH_JIT[key] = run_all
    return run_all


def _default_cell_budget() -> int:
    """Cells (pattern x text position pairs) per dispatch chunk.

    Word-level selection keeps a chunk's intermediates near a byte per
    cell, so a device that reports its memory limit gets an eighth of it
    in cells. A device that reports no limit (the CPU) gets small chunks."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return max(1 << 22, stats.get("bytes_limit", 0) // 8)


class BatchEngine:
    """Cartesian-product candidate engine: Q patterns x N texts, batched.

    ``candidates_many`` returns ``out[q][t] = [(end_pos, cost), ...]`` with
    results identical to the single-(pattern, text) engines.
    """

    def __init__(
        self,
        cell_budget: int | None = None,
        initial_cap: int = 1 << 10,
        w_max_words: int = 1 << 13,
        backend: str | None = None,
        interpret: bool = False,
    ):
        # initial_cap 1024: match-dense workloads grow once and the grown
        # cap is memoized per workload signature.
        if backend is None:
            backend, interpret = choose_scan(interpret)
        self.backend = backend
        self.interpret = interpret
        if cell_budget is None:
            cell_budget = _default_cell_budget()
        self.cell_budget = cell_budget
        self.initial_cap = initial_cap
        self.w_max_words = w_max_words
        # sticky caps per workload signature: a match-dense workload pays
        # the grow-retry once, repeats start at the grown size (keyed so a
        # one-off huge job does not inflate unrelated small searches)
        self._cap_hints: dict = {}
        # pattern-input memo: repeated searches with the same patterns skip
        # the host-side mask packing (~12 ms for 32x24bp per call)
        self._pat_memo: dict = {}

    def _pattern_inputs(self, profile, codes, alpha, max_overhang):
        key = (profile.name, getattr(profile, "case_sensitive", None),
               codes.tobytes(), alpha, max_overhang)
        got = self._pat_memo.get(key)
        if got is None:
            got = pattern_inputs_np(profile, codes, alpha, max_overhang)
            if len(self._pat_memo) > 4096:
                self._pat_memo.clear()
            self._pat_memo[key] = got
        return got

    def plan(self, ts: TextSet, profile: Profile, M: int, steps: int,
             halo: int, n_q: int) -> tuple[int, int, int, int]:
        """Dispatch plan ``(w_chars, pad_mult, t_chunk, q_chunk)`` for
        ``n_q`` patterns of M bucketed rows over ``ts``.

        Memoized on the TextSet: the width pick walks all text lengths,
        which at 33k-read scale costs milliseconds PER CALL — the
        per-pattern eval loop and the CLI's per-record-batch loop repeat
        it verbatim (same M/k/alpha against the same TextSet)."""
        key = ("eng_plan", M, steps, halo, n_q, self.backend,
               self.cell_budget, self.w_max_words, profile.eq_mode)
        got = ts._packs.get(key)
        if got is not None:
            return got
        lens = ts.lens
        # piece width: small enough that even one big text yields many
        # tiles (the scan's parallel axis), large enough to amortize the
        # per-piece halo re-scan
        total_chars = sum(lens) + steps * len(lens)
        target = max(4 * halo, _cdiv(total_chars, 4096), 4 * WORD_BITS)
        w_cap = min(
            _bucket_words(max(_cdiv(max(lens) + steps, WORD_BITS), 1)),
            _bucket_words(_cdiv(target, WORD_BITS)),
            self.w_max_words,
        )
        pad_mult = lane_multiple(self.backend)
        w_chars = _pick_w_words(lens, steps, halo, w_cap, pad_mult) * WORD_BITS
        if w_chars <= halo + WORD_BITS:
            w_chars = _bucket_words(
                _cdiv(halo + 4 * WORD_BITS, WORD_BITS)
            ) * WORD_BITS
        n_pieces = len(ts._plan_tv(steps, halo, w_chars, pad_mult)[0])

        # dispatch chunking under the cell budget, in pad_mult units.
        # q_chunk is hard-capped at QID_PACK_MAX: the packed fetch encodes
        # qid<<16|cost in one int32, so a dispatch may never carry more
        # than 2^15 patterns (qid >= 32768 would wrap the sign bit and
        # negative-index the decode silently). A chunk's encoded positions
        # (tile * (w_chars + 1) + pos) must also stay inside int32.
        t_chunk = max(1, self.cell_budget // max(1, n_q * w_chars))
        q_chunk = min(n_q, QID_PACK_MAX)
        while q_chunk > 1 and t_chunk < 8 and n_pieces > t_chunk:
            q_chunk = _cdiv(q_chunk, 2)
            t_chunk = max(1, self.cell_budget // max(1, q_chunk * w_chars))
        t_chunk = min(t_chunk, ((1 << 31) - 1) // (w_chars + 1))
        t_chunk = max(pad_mult, (t_chunk // pad_mult) * pad_mult)
        t_chunk = min(t_chunk, n_pieces)
        got = (w_chars, pad_mult, t_chunk, q_chunk)
        ts._packs[key] = got
        return got

    def candidates_many(
        self,
        profile: Profile,
        pattern_codes: list[np.ndarray],
        texts: list[np.ndarray],
        k: int,
        alpha: float | None = None,
        max_overhang: int | None = None,
        all_minima: bool = False,
        reverse: bool = False,
    ) -> list[list]:  # out[q][t]: Sequence[(end_pos, cost)] ((), if empty)
        # ``reverse``: scan the character-reversed texts (RC strand).
        # Positions come back in reversed-text coordinates. Passing the
        # FORWARD TextSet with reverse=True lets large texts share one
        # upload across both strands (TextSet._flat_dev).
        return self.candidates_many_async(
            profile, pattern_codes, texts, k, alpha, max_overhang,
            all_minima, reverse,
        )()

    def candidates_many_flat(self, *args, **kw):
        """Like ``candidates_many`` but returns flat sorted numpy columns
        ``(q, text_idx, pos, cost)`` instead of the dense ``out[q][t]``
        nesting — the shape the reference's v2 engine itself returns (a
        flat Vec<Match> with pattern/text indices, general.rs:335-350).
        At read-set scale the dense (Q, NT) assembly alone costs ~100 ms
        (96 x 33k cells); match-count/stream consumers should use this."""
        return self.candidates_many_async(*args, **kw, _flat=True)()

    def candidates_many_flat_async(self, *args, **kw):
        return self.candidates_many_async(*args, **kw, _flat=True)

    def candidates_many_async(
        self,
        profile: Profile,
        pattern_codes: list[np.ndarray],
        texts: list[np.ndarray],
        k: int,
        alpha: float | None = None,
        max_overhang: int | None = None,
        all_minima: bool = False,
        reverse: bool = False,
        _flat: bool = False,
    ):
        """Dispatch the whole workload and return a ``finish()`` callable
        that fetches + decodes (including cap-overflow retries). A caller
        that dispatches batch N+1 before finishing batch N overlaps the
        fetch round trip and host decode with the next batch's device
        scan (the CLI's record-batch loop does exactly this)."""
        import jax.numpy as jnp

        ts = texts if isinstance(texts, TextSet) else TextSet(texts)
        Q = len(pattern_codes)
        NT = len(ts.texts)
        if Q == 0 or NT == 0:
            z = np.zeros(0, np.int64)
            if _flat:
                return lambda: (z, z, z, z)
            return lambda: [[[] for _ in range(NT)] for _ in range(Q)]
        # sparse accumulation: the decode appends (q, text, pos, cost)
        # numpy column blocks; ONE lexsort + group-split in finish()
        # replaces per-candidate Python dict work (which dominated
        # match-dense read sets: ~300 ms at 67k matches x 33k reads)
        sink: list = []
        jobs: list = []  # dispatched q-chunk jobs, settled in finish()

        ms = [len(c) for c in pattern_codes]
        if alpha is not None and len(set(ms)) > 1:
            raise ValueError(
                "batched search with overhang requires equal-length patterns"
            )

        # group patterns by row bucket (M); each group shares one scan shape
        per = [
            self._pattern_inputs(profile, c, alpha, max_overhang)
            for c in pattern_codes
        ]
        groups: dict[int, list[int]] = {}
        for qi, p in enumerate(per):
            groups.setdefault(p[0].shape[0], []).append(qi)

        for M, qidx in groups.items():
            steps = semantics.overhang_steps(ms[qidx[0]], k, alpha, max_overhang)
            halo = M + k
            # overhang fast path: word-level selection with an
            # overshoot-exact state strip of n_prev preceding words
            # (ops/minima.py select_words_tiles_q); huge overshoot spans
            # (tiny alpha, long patterns) fall back to position-level
            n_prev = _cdiv(steps, WORD_BITS) + 1 if alpha is not None else 0
            fast = alpha is None or n_prev <= 4
            plan = self.plan(ts, profile, M, steps, halo, len(qidx))
            w_chars, pad_mult, t_chunk, q_chunk = plan
            n_pos = w_chars
            # plan only — the packed data (host pieces or device-assembled
            # windows) materializes per dispatch mode below
            pieces, _ = ts._plan_tv(steps, halo, w_chars, pad_mult)

            for q0 in range(0, len(qidx), q_chunk):
                qs = qidx[q0 : q0 + q_chunk]
                # pad large pattern batches to a multiple of 8: bounds
                # jit-shape proliferation without the 33% waste next_pow2
                # costs at e.g. Q=96->128
                L = len(qs)
                qe = L if L <= 8 else -(-L // 8) * 8
                qpad = [qs[0]] * (qe - len(qs))
                qall = qs + qpad
                assert len(qall) <= QID_PACK_MAX, (
                    f"dispatch q-chunk {len(qall)} exceeds the qid<<16 "
                    f"packing range ({QID_PACK_MAX})"
                )
                # one combined upload per q-chunk; the device blob is
                # memoized so repeat searches skip concat + upload entirely
                blob_key = (
                    tuple(pattern_codes[q].tobytes() for q in qall),
                    profile.name, alpha, max_overhang,
                )
                patblob = self._pat_memo.get(blob_key)
                if patblob is None:
                    Qe_n = len(qall)
                    pm_np = np.stack([per[q][0] for q in qall])  # (Q, M, P)
                    blob = np.concatenate(
                        [
                            pm_np.reshape(Qe_n, -1),
                            np.stack([per[q][1] for q in qall]),
                            np.stack([per[q][2] for q in qall]),
                            np.array([[ms[q]] for q in qall], np.uint32),
                            np.array([[per[q][3]] for q in qall], np.uint32),
                        ],
                        axis=1,
                    ).astype(np.uint32)
                    patblob = jnp.asarray(blob)
                    self._pat_memo[blob_key] = patblob

                hier_s = (
                    _suffix_rows(min(ms[q] for q in qall), k)
                    if alpha is None and t_chunk >= 256
                    else 0
                )
                _, disp_planes, tv_all = ts.packed(
                    profile, steps, halo, w_chars, pad_mult, reverse
                )
                # launch all chunks async, then fetch once as a stacked
                # buffer
                hint_key = (M, k, t_chunk, len(qall), fast, n_prev)
                cap, bcap, hw_t, hw_x = self._cap_hints.get(
                    hint_key,
                    (self.initial_cap, max(64, self.initial_cap // 4), 0, 0),
                )
                pt_idx, pt_start = ts._plan_arrays(
                    steps, halo, w_chars, pad_mult
                )
                work = []
                for t0 in range(0, len(pieces), t_chunk):
                    # clamp the final chunk; tiles before `skip` were
                    # already reported by the previous chunk
                    t0c = min(t0, len(pieces) - t_chunk)
                    work.append((np.int32(t0c), t0 - t0c))

                def dispatch(work, cap, bcap, *, _dp=disp_planes,
                             _tv=tv_all, _pb=patblob, _tc=t_chunk,
                             _np_=n_prev, _fast=fast, _hs=hier_s):
                    fargs = (
                        profile.eq_mode, all_minima, cap, bcap,
                        _fast, _hs, self.backend,
                        self.interpret, _tc, _np_,
                    )
                    a_val = float(alpha if alpha is not None else 0.0)
                    alpha_d = _dev_scalar(a_val, jnp.float32)
                    k_d = _dev_scalar(int(k), jnp.int32)
                    if self.backend == "pallas" and len(work) > 1:
                        # one jit maps over all chunk offsets: one send,
                        # one fetch for the whole workload
                        fnm = _batch_fn_map(len(work), *fargs)
                        t0s = _dev_scalar(
                            tuple(int(t0c) for t0c, _ in work), jnp.int32
                        )
                        return fnm(_dp, _tv, t0s, _pb, k_d, alpha_d)
                    fn = _batch_fn(*fargs)
                    return [
                        fn(_dp, _tv, _dev_scalar(int(t0c), jnp.int32),
                           _pb, k_d, alpha_d)
                        for t0c, _ in work
                    ]

                got_dev = dispatch(work, cap, bcap)
                # enqueue the device->host copy NOW: the DMA lines up right
                # behind the compute, so when many dispatches are in flight
                # (the per-pattern eval loop, the CLI record-batch loop)
                # their fetch round trips overlap instead of serializing
                # one round trip per finish()
                try:
                    if isinstance(got_dev, list):
                        for g in got_dev:
                            g.copy_to_host_async()
                    else:
                        got_dev.copy_to_host_async()
                except AttributeError:
                    pass
                jobs.append((
                    got_dev, work, dispatch,
                    cap, bcap, hw_t, hw_x, hint_key,
                    np.asarray(qall[: len(qs)], np.int32), n_pos,
                    pt_idx, pt_start,
                ))

        def finish() -> list[list]:
            for got_dev, work, dispatch, cap, bcap, hw_t, hw_x, hint_key, \
                    q_ids, n_pos, pt_idx, pt_start in jobs:
                seen_t = seen_x = 0  # max per-chunk total / naux observed
                while work:
                    if not isinstance(got_dev, list):
                        got = np.asarray(got_dev)
                    elif len(got_dev) == 1:
                        # keep the single buffer intact: jnp.stack would
                        # build a NEW device array and re-fetch it, wasting
                        # the copy_to_host_async issued at dispatch time
                        got = np.asarray(got_dev[0])[None]
                    else:
                        got = np.stack([np.asarray(g) for g in got_dev])
                    retry = []
                    for row, (t0c, skip) in zip(got, work):
                        total, naux = int(row[0]), int(row[1])
                        maxq = int(row[2])
                        seen_t = max(seen_t, total, maxq)
                        seen_x = max(seen_x, naux)
                        if total > cap or maxq > cap or naux > bcap:
                            retry.append((t0c, skip))
                            continue
                        self._decode(
                            row, cap, int(t0c), skip, q_ids, n_pos,
                            pt_idx, pt_start, sink,
                        )
                    if retry:
                        caps = max(cap + 1, *(
                            max(int(r[0]), int(r[2])) for r in got
                        ))
                        cap = _bucket_cap(caps)
                        bcap = _bucket_cap(
                            max(bcap + 1, *(int(r[1]) for r in got))
                        )
                        got_dev = dispatch(retry, cap, bcap)
                    work = retry
                # sticky caps, adaptive in BOTH directions: a sparse
                # workload fetching a cap-sized buffer per chunk pays for
                # the empty slots, so shrink the hint when
                # the observed peak leaves >= 4x headroom over an 8x safety
                # margin. The shrink compares against the SESSION high-water
                # mark, not just this call: per-call demand varies wildly
                # across patterns sharing a hint key, and a low-match call
                # shrinking below a high-match call's demand makes the next
                # call overflow into a fresh (cap, bcap) program whose
                # first execution costs tens of seconds (the eval's
                # recurring first-rep outlier).
                hw_t = max(hw_t, seen_t)
                hw_x = max(hw_x, seen_x)
                s_cap, s_bcap = cap, bcap
                if cap > 256 and 8 * hw_t <= cap // 4:
                    s_cap = _bucket_cap(max(64, 8 * hw_t))
                if bcap > 256 and 8 * hw_x <= bcap // 4:
                    s_bcap = _bucket_cap(max(64, 8 * hw_x))
                self._cap_hints[hint_key] = (s_cap, s_bcap, hw_t, hw_x)
            if sink:
                qs = np.concatenate([s[0] for s in sink])
                ti = np.concatenate([s[1] for s in sink])
                ps = np.concatenate([s[2] for s in sink])
                cs = np.concatenate([s[3] for s in sink])
                order = np.lexsort((cs, ps, ti, qs))
                qs, ti = qs[order], ti[order]
                ps, cs = ps[order], cs[order]
            else:
                qs = ti = np.zeros(0, np.int32)
                ps = cs = np.zeros(0, np.int64)
            if _flat:
                return qs, ti, ps, cs
            # dense (Q, NT) assembly from the sorted columns: group-splits
            # only, no per-candidate Python work (fill only nonempty cells;
            # materializing 96 x 33k populated lists would dominate)
            empty: tuple = ()
            dense: list[list] = [[empty] * NT for _ in range(Q)]
            if len(qs):
                cell_key = qs.astype(np.int64) * NT + ti
                cuts = np.nonzero(np.diff(cell_key))[0] + 1
                starts = np.concatenate(([0], cuts))
                ends = np.concatenate((cuts, [len(cell_key)]))
                pl = ps.tolist()
                cl = cs.tolist()
                for s, e in zip(starts.tolist(), ends.tolist()):
                    dense[qs[s]][ti[s]] = list(zip(pl[s:e], cl[s:e]))
            return dense

        return finish

    def _decode(self, row, cap, t0c, skip, q_ids, n_pos, pt_idx, pt_start,
                sink):
        """Decode one fetched [total, naux, maxq, pos, qid<<16|cost] buffer
        into (q, text_idx, pos, cost) numpy column blocks (appended to
        ``sink``; grouped once in finish())."""
        total = int(row[0])
        if total == 0:
            return
        stride = n_pos + 1
        enc = row[3 : 3 + total]
        qc = row[3 + cap : 3 + cap + total]
        qid = qc >> 16
        tiles = enc // stride
        gtiles = tiles.astype(np.int64) + t0c
        ti = pt_idx[gtiles]
        keep = (
            (qid < len(q_ids))  # padded duplicate pattern slots
            & (tiles >= skip)  # reported by the previous (unclamped) chunk
            & (ti >= 0)  # padded dummy pieces
        )
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return
        gi = gtiles[idx]
        sink.append((
            q_ids[qid[idx]],
            ti[idx],
            pt_start[gi] + (enc[idx] % stride),
            qc[idx] & 0xFFFF,
        ))

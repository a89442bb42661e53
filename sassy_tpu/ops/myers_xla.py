"""Bit-parallel search engine: the XLA scan (pure jnp, the CPU path and the
plain reference) and the pipeline every engine shares.

This is a device-native re-design of the reference's Myers'99 bit-parallel DP
(/root/reference/src/bitpacking.rs:63-85, transposed formulation of
search.rs:1074-1199): the 32 bits of a u32 word span 32 consecutive *text*
positions; the DP iterates over pattern rows per word and over words
sequentially, carrying the per-row horizontal deltas (hp/hm) between words.

Parallelism is the direct generalization of sassy's chunking
(search.rs:1018-1070): the text is split into T tiles of W words; each tile
re-runs the DP from ``halo = ceil((m+k)/32)`` words before its owned range,
so every owned end position has full left context (an alignment spans at
most m+k text chars). Tile 0 carries the true text-start boundary (overhang
alpha-init); other tiles use the plain cost-j boundary, which never
underestimates. Ownership intervals make dedup trivial (the reference's
prune_lane_overlaps, search.rs:1202-1240, becomes a static gather).

The full pipeline is device-resident: pack text bit-planes -> windowed tile
scan -> per-position cost expansion -> minima/compaction (ops/minima.py).
Only the compacted (positions, costs, count) buffer is downloaded. The scan
is ``scan_core`` below (two nested ``lax.scan``) or, on the GPU, the Pallas
kernel in ops/myers_pallas.py (ops/backend.choose_scan decides).
"""

from __future__ import annotations

import weakref
from functools import partial

import numpy as np

from .. import semantics
from ..profiles import Profile
from .backend import pad_lanes_for
from .bitpack import WORD_BITS, pattern_plane_masks_np
from .minima import select_candidates

__all__ = ["XlaEngine", "PreparedText", "end_costs_xla"]

#: Reserved packed words past the text end, for overhang 'N' padding.
#: Bounds supported overhang steps (pattern length) to 64*32 = 2048 chars.
_TAIL_RESERVE_WORDS = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _bucket_words(x: int) -> int:
    """Round up to {4,5,6,7} * 2^k — waste <= 12.5%, few distinct shapes."""
    if x <= 16:
        return 16
    p = _next_pow2(x)
    for frac in (8, 10, 12, 14):
        cand = (p // 16) * frac
        if cand >= x:
            return cand
    return p


def suffix_rows(m_min: int, k: int) -> int:
    """Hierarchical-prefilter suffix length.

    The reference picks the suffix by limb width (general.rs:294-313); our
    verify granularity is a ~4k-char tile, so the suffix must be selective
    enough that few tiles flag on random text: require s >= 8 + 6k
    (measured: a 16bp suffix at k=3 flags essentially every tile and makes
    the prefilter a slowdown, while 32bp at k=4 flags almost none). The
    verify gather only pays off when the suffix saves at least half the
    full-scan rows (m >= 2s)."""
    s = next((c for c in (8, 16, 32) if c >= 8 + 6 * k), 0)
    if s == 0 or m_min < 2 * s:
        return 0
    return s


def _bucket_rows(m: int) -> int:
    """Bucketed pattern-row count: multiples of 8 up to 128, then 64 (the
    scan cost is linear in rows; pad rows are pure overhead)."""
    if m <= 128:
        return max(8, _cdiv(m, 8) * 8)
    return _cdiv(m, 64) * 64


def _plan(total_words: int, halo: int, target_tiles: int = 1024):
    """Pick (T, W): W large enough to amortize the halo re-scan (<=25%
    overhead), T capped so tiny texts stay single-tile."""
    min_w = max(4 * halo, 16)
    W = max(min_w, _cdiv(total_words, target_tiles))
    T = max(1, _cdiv(total_words, W))
    if T == 1:
        return 1, total_words, 0
    return T, W, halo


# ---------------------------------------------------------------------------
# jitted pipeline (built lazily so importing never initializes JAX)

_JIT: dict = {}


def _kernels():
    if _JIT:
        return _JIT

    from . import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    def scan_core(planes_win, pmasks, is_pad, hp0, hm0, cost0, eq_mode):
        """The bit-parallel word scan, generic over initial boundary state.

        planes_win: (NW, P, T) uint32 — word w of plane p for tile t.
        pmasks: (M, P) uint32; is_pad: (M,) uint32; hp0/hm0: (M, T) uint32;
        cost0: (T,) int32. Returns (vp_w, vm_w, cost_w), each (NW, T):
        vertical delta words and the last-row cost at the start of each word.
        """
        n_planes = planes_win.shape[1]
        full = jnp.uint32(0xFFFFFFFF)

        def word_step(carry, planes_w):
            hp, hm, cost = carry  # (M,T),(M,T),(T,)

            def row_step(v, row):
                vp, vm = v
                hp_j, hm_j, pmask, pad_j = row
                # pad rows (pad_j all-ones) match unconditionally — even at
                # code-0 ('X') positions — so they copy the row above.
                if eq_mode == "iupac":
                    eq = pad_j
                    for p in range(n_planes):
                        eq = eq | (planes_w[p] & pmask[p])
                else:  # ascii: byte equality, gated by the validity plane
                    acc = jnp.uint32(0)
                    for p in range(n_planes - 1):
                        acc = acc | (planes_w[p] ^ pmask[p])
                    eq = ((~acc) & planes_w[n_planes - 1]) | pad_j
                # Myers step (bitpacking.rs:63-85 semantics, 32-bit words)
                vx = eq | vm
                eqh = eq | hm_j
                hx = (((eqh & vp) + vp) ^ vp) | eqh
                hp_out = vm | (~(hx | vp) & full)
                hm_out = vp & hx
                hp_carry = hp_out >> 31
                hm_carry = hm_out >> 31
                hp_sh = (hp_out << 1) | hp_j
                hm_sh = (hm_out << 1) | hm_j
                vp_new = hm_sh | (~(vx | hp_sh) & full)
                vm_new = hp_sh & vx
                return (vp_new, vm_new), (hp_carry, hm_carry)

            zero = jnp.zeros((hp.shape[1],), dtype=jnp.uint32)
            (vp, vm), (hp_new, hm_new) = jax.lax.scan(
                row_step, (zero, zero), (hp, hm, pmasks, is_pad)
            )
            pc = jax.lax.population_count
            new_cost = cost + pc(vp).astype(jnp.int32) - pc(vm).astype(jnp.int32)
            return (hp_new, hm_new, new_cost), (vp, vm, cost)

        _, out = jax.lax.scan(word_step, (hp0, hm0, cost0), planes_win)
        return out

    @partial(
        jax.jit,
        static_argnames=("planes", "with_valid", "mode", "shift", "mask",
                         "pmasks", "fold"),
    )
    def pack(text_u8, nw, nb, planes, with_valid, mode, shift, mask, pmasks,
             fold):
        """text_u8: (GW*32,) uint8 raw text (zero tail) -> (P[+1], GW) uint32
        bit-planes of the engine codes. Gather-free: each code bit is a
        <=32-entry truth table evaluated with a vectorized variable shift
        (profiles.Profile pack descriptor) instead of a per-character table
        gather. The optional validity plane marks positions
        < n = nw*32 + nb (split so absolute char positions never
        materialize in int32 — a >2.1 Gbp genome overflows them)."""
        gw = text_u8.shape[0] // WORD_BITS
        weights = jnp.uint32(1) << jnp.arange(WORD_BITS, dtype=jnp.uint32)
        # chunked: the per-bit expansion is 32x the text size in u32; packing
        # in slices keeps peak memory ~text-sized at genome scale
        nchunks = max(1, gw >> 22)
        while gw % nchunks:
            nchunks -= 1
        cw = gw // nchunks

        def pack_chunk(t):
            t = t.astype(jnp.uint32)
            if mode == "byte":
                if fold:
                    t = jnp.where((t >= 65) & (t <= 90), t + 32, t)
                bit_of = lambda p: (t >> p) & 1  # noqa: E731
            else:
                idx = (t >> shift) & mask
                bit_of = (
                    lambda p: (jnp.uint32(pmasks[p]) >> idx) & 1  # noqa: E731
                )
            rows = []
            for p in range(planes):
                bits = bit_of(p).reshape(-1, WORD_BITS)
                rows.append(jnp.sum(bits * weights, axis=1, dtype=jnp.uint32))
            return jnp.stack(rows)

        chunks = text_u8.reshape(nchunks, cw * WORD_BITS)
        out = jax.lax.map(pack_chunk, chunks)  # (nchunks, planes, cw)
        out = out.transpose(1, 0, 2).reshape(planes, gw)
        # zero positions >= n: the tail bytes are padding, and the code
        # tables map byte 0 to a real (matching) code — leaving them set
        # would diverge from the host packers' zero codes past the text.
        # Word/bit split: word < nw -> all 32 valid; word nw -> low nb.
        w = jnp.arange(gw, dtype=jnp.int32)
        lo = jnp.where(w < nw, WORD_BITS, jnp.where(w > nw, 0, nb))
        full = jnp.uint32(0xFFFFFFFF)
        nmask = jnp.where(
            lo >= 32, full, (jnp.uint32(1) << lo.astype(jnp.uint32)) - 1
        )
        out = out & nmask[None, :]
        outs = [out[p] for p in range(planes)]
        if with_valid:
            # the validity plane (bit i of word w set iff position < n)
            # IS the n-mask
            outs.append(nmask)
        return jnp.stack(outs)

    def reverse_planes(planes_g, nw, nb):
        """Flat planes of the REVERSED text: out char i = in char n-1-i
        (n = nw*32 + nb), zeros at positions >= n. Pure vector ops
        (bitrev32 butterfly + word reversal + a cross-word funnel shift),
        so the reversed strand of an uploaded text is derived on device
        instead of re-encoding, re-packing, and re-uploading it from the
        host — the host->device link is the bottleneck for fresh
        genome-scale texts (the reference instead materializes a reversed
        copy per text, search.rs CachedRev). n arrives split in words+bits
        so nothing overflows int32 at >2.1 Gbp."""
        gw = planes_g.shape[1]
        x = planes_g
        for sh, m in (
            (1, jnp.uint32(0x55555555)),
            (2, jnp.uint32(0x33333333)),
            (4, jnp.uint32(0x0F0F0F0F)),
            (8, jnp.uint32(0x00FF00FF)),
        ):
            x = ((x >> sh) & m) | ((x & m) << sh)
        x = (x >> 16) | (x << 16)
        x = x[:, ::-1]  # now char i = input char gw*32-1-i
        # shift down by D = gw*32 - n chars: out[i] = x[i + D];
        # D = (gw - nw)*32 - nb, i.e. dw = gw - nw - (nb > 0 ? 1 : 0),
        # db = (32 - nb) % 32 — word/bit arithmetic only
        dw = gw - nw - jnp.where(nb > 0, 1, 0).astype(jnp.int32)
        db = ((WORD_BITS - nb) % WORD_BITS).astype(jnp.uint32)
        pad = jnp.zeros((planes_g.shape[0], gw + 1), x.dtype)
        xp = jnp.concatenate([x, pad], axis=1)
        lo = jax.lax.dynamic_slice(xp, (0, dw), (planes_g.shape[0], gw))
        hi = jax.lax.dynamic_slice(xp, (0, dw + 1), (planes_g.shape[0], gw))
        carry = jnp.where(db == 0, jnp.uint32(0), hi << ((32 - db) & 31))
        return (lo >> db) | carry

    @jax.jit
    def overlay_n_tail(planes_g, nw, nb, ew, eb):
        """Set bits [n, e) in every plane ('N' = matches everything), for
        overhang padding past the text end (search.rs:203). Boundaries
        arrive split in (word, bit) pairs so absolute char positions never
        materialize in int32 (>2.1 Gbp texts overflow them)."""
        gw = planes_g.shape[1]
        w = jnp.arange(gw, dtype=jnp.int32)
        lo = jnp.where(w < nw, WORD_BITS, jnp.where(w > nw, 0, nb))
        hi = jnp.where(w < ew, WORD_BITS, jnp.where(w > ew, 0, eb))
        full = jnp.uint32(0xFFFFFFFF)
        mask_lo = jnp.where(lo >= 32, full, (jnp.uint32(1) << lo.astype(jnp.uint32)) - 1)
        mask_hi = jnp.where(hi >= 32, full, (jnp.uint32(1) << hi.astype(jnp.uint32)) - 1)
        mask = mask_hi ^ mask_lo
        return planes_g | mask[None, :]

    def _windows(planes_g, T, W, halo):
        """Halo-tiled windows (NW, P, T), NW = W + halo + 1: tile t's
        window is words [t*W - halo, t*W + W] — halo left context, W owned
        words, plus ONE right-context word so the rightmost-minima
        lookahead at the tile's last owned position reads the true next
        delta instead of an artificial +1 (a cost run that keeps
        decreasing into the next tile must suppress the boundary
        position). Built from shifted reshapes of the flat planes, no
        gathers; tile 0 (window [0, NW), owned prefix) is patched with a
        small update."""
        NW = W + halo + 1
        n_planes = planes_g.shape[0]
        TW = T * W
        gw = planes_g.shape[1]
        pad_to = max(TW, NW)
        if pad_to > gw:
            planes_g = jnp.pad(planes_g, ((0, 0), (0, pad_to - gw)))
        owned_w = planes_g[:, :TW].reshape(n_planes, T, W)
        # right-context word: tile t's word halo+W is flat word (t+1)*W
        # (zeros past the last tile — cost only rises there)
        rsh = jnp.concatenate(
            [planes_g[:, W:TW], jnp.zeros((n_planes, W), planes_g.dtype)],
            axis=1,
        )
        right = rsh.reshape(n_planes, T, W)[:, :, :1]
        strips = []
        # tile t's halo words [t*W - halo, t*W) come from shifted
        # reshapes: shifted_s[:, i] = planes_g[:, i - s], so strip c0
        # (shift s = halo - c0) supplies columns c0..c0+W of the halo. One
        # strip only yields W columns, so halo > W takes ceil(halo/W).
        for c0 in range(0, halo, W):
            s = halo - c0
            width = max(TW - s, 0)
            shifted = jnp.concatenate(
                [
                    jnp.zeros((n_planes, TW - width), planes_g.dtype),
                    planes_g[:, :width],
                ],
                axis=1,
            )
            strips.append(shifted.reshape(n_planes, T, W)[:, :, : min(W, s)])
        win_pt = jnp.concatenate([*strips, owned_w, right], axis=2)
        win_pt = win_pt.at[:, 0, :].set(planes_g[:, :NW])  # tile 0's window
        return win_pt.transpose(2, 0, 1)  # (NW, P, T)

    def _scan_words(
        planes_g, pmasks, is_pad, h_init, m_real, boundary_m, eq_mode,
        T, W, halo, backend, interpret,
    ):
        """Run the halo-tiled bit-parallel DP; return the window-local
        word-level outputs (vp_w, vm_w, cost_w), each (NW, T). Traced (not
        jitted) so the pipeline below fuses it with candidate selection in
        one dispatch."""
        tile0 = jnp.arange(T, dtype=jnp.int32) == 0
        return _scan_win(
            _windows(planes_g, T, W, halo), tile0, pmasks, is_pad, h_init,
            m_real, boundary_m, eq_mode, backend, interpret,
        )

    def _scan_win(
        planes_win, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
        eq_mode, backend, interpret,
    ):
        """Scan prebuilt windows (NW, P, T). ``tile0`` (T,) bool marks tiles
        whose boundary is the true text start (h_init/boundary_m); others
        restart with the plain cost-j boundary."""
        if backend == "pallas":
            out = _scan_win_q(
                planes_win, tile0, pmasks[None], is_pad[None], h_init[None],
                jnp.reshape(m_real, (1,)), jnp.reshape(boundary_m, (1,)),
                eq_mode, backend, interpret,
            )
            return tuple(x[0] for x in out)

        # h-init: plain delta-1 everywhere; true-start tiles carry the
        # (possibly overhang-alpha) deltas. Pad rows carry delta 0.
        M = pmasks.shape[0]
        T = planes_win.shape[2]
        hp0 = jnp.where(
            is_pad[:, None] != 0,
            jnp.uint32(0),
            jnp.where(tile0[None, :], h_init[:, None], jnp.uint32(1)),
        )
        hm0 = jnp.zeros((M, T), dtype=jnp.uint32)
        cost0 = jnp.where(tile0, boundary_m, m_real).astype(jnp.int32)

        return scan_core(planes_win, pmasks, is_pad, hp0, hm0, cost0, eq_mode)

    def _scan_win_q(
        planes_win, tile0, pmasks_q, ispad_q, hinit_q, m_q, bm_q,
        eq_mode, backend, interpret,
    ):
        """Pattern-batched window scan: pmasks_q (Q, M, P), ispad_q/hinit_q
        (Q, M), m_q/bm_q (Q,). Returns (vp, vm, cost) each (Q, NW, T)."""
        if backend == "pallas":
            from .myers_pallas import scan_q

            return scan_q(
                planes_win, tile0, pmasks_q, ispad_q, hinit_q,
                m_q.astype(jnp.int32), bm_q.astype(jnp.int32),
                eq_mode=eq_mode, interpret=interpret,
            )

        def one(pm, ip, hi, m, bm):
            return _scan_win(
                planes_win, tile0, pm, ip, hi, m, bm, eq_mode, "xla", interpret
            )

        return jax.vmap(one)(pmasks_q, ispad_q, hinit_q, m_q, bm_q)

    def _scan_win_meta(
        planes_win, tile0, vfrom, vto, pmasks, is_pad, h_init, m_real,
        boundary_m, k, eq_mode, backend, interpret,
    ):
        """Single-pattern window scan WITH selection metadata (the Q=1 case
        of _scan_win_q_meta). Returns (vp, vm, cost, meta) each (NW, T)
        plus ``final`` (T,)."""
        out = _scan_win_q_meta(
            planes_win, tile0, vfrom, vto, pmasks[None], is_pad[None],
            h_init[None], jnp.reshape(m_real, (1,)),
            jnp.reshape(boundary_m, (1,)), k, eq_mode, backend, interpret,
        )
        return tuple(x[0] for x in out)

    def _scan_win_q_meta(
        planes_win, tile0, vfrom, vto, pmasks_q, ispad_q, hinit_q, m_q, bm_q,
        k, eq_mode, backend, interpret,
    ):
        """Pattern-batched window scan WITH selection metadata.

        Returns (vp, vm, cost, meta) each (Q, NW, T) plus ``final`` (Q, T):
        per-word screen/state codes and the per-tile outgoing state code
        (see ops/minima.meta_from_words). The GPU kernel computes the
        metadata in-kernel; the XLA path derives it from the scan outputs
        (identical bits by construction)."""
        from .minima import meta_from_words

        if backend == "pallas":
            from .myers_pallas import scan_q

            return scan_q(
                planes_win, tile0, pmasks_q, ispad_q, hinit_q,
                m_q.astype(jnp.int32), bm_q.astype(jnp.int32),
                eq_mode=eq_mode, interpret=interpret, vf=vfrom, vt=vto, k=k,
            )
        vp_w, vm_w, cost_w = _scan_win_q(
            planes_win, tile0, pmasks_q, ispad_q, hinit_q, m_q, bm_q,
            eq_mode, backend, interpret,
        )
        meta, final = meta_from_words(
            jax, jnp, vp_w, vm_w, cost_w, vfrom, vto, k
        )
        return vp_w, vm_w, cost_w, meta, final

    def _scan_flat(
        planes_g, pmasks, is_pad, h_init, m_real, boundary_m,
        eq_mode, T, W, halo, backend, interpret,
    ):
        """Word scan + per-position expansion (legacy/overhang path)."""
        vp_w, vm_w, cost_w = _scan_words(
            planes_g, pmasks, is_pad, h_init, m_real, boundary_m,
            eq_mode, T, W, halo, backend, interpret,
        )
        return _assemble(jnp, vp_w, vm_w, cost_w, None, halo, W)

    def _assemble(jnp, vp_w, vm_w, cost_w, tile, halo, W):
        """Keep owned words only; expand delta bits to per-position costs and
        deltas (flat, positions 1..T*W*32). Slice-based — no gathers: owned
        words are window words [halo, halo+W) for tiles >= 1, the prefix
        [0, W) for tile 0 (the window's final word is right context)."""
        del tile
        vp = vp_w[halo : halo + W, :].at[:, 0].set(vp_w[:W, 0])
        vm = vm_w[halo : halo + W, :].at[:, 0].set(vm_w[:W, 0])
        cw = cost_w[halo : halo + W, :].at[:, 0].set(cost_w[:W, 0])
        bit = jnp.arange(WORD_BITS, dtype=jnp.uint32)
        vp_b = ((vp[..., None] >> bit) & 1).astype(jnp.int32)
        vm_b = ((vm[..., None] >> bit) & 1).astype(jnp.int32)
        delta = vp_b - vm_b  # (W,T,32)
        csum = jnp.cumsum(delta, axis=-1)
        posc = cw[..., None] + csum  # (W,T,32)
        return (
            posc.transpose(1, 0, 2).reshape(-1),
            delta.transpose(1, 0, 2).reshape(-1),
        )

    def pipeline(
        planes_g,
        pmasks,
        is_pad,
        h_init,
        m_real,
        boundary_m,
        n_text,
        max_pos,
        k,
        alpha,
        eq_mode,
        T,
        W,
        halo,
        backend,
        interpret,
        all_minima,
        cap,
        bcap,
        fast=False,
        hier_s=0,
        n_prev=0,
        win=None,
    ):
        """One-dispatch search: scan + candidate selection, returning the
        packed [count, naux, pos[cap], cost[cap]] buffer (ops/minima.py).

        ``win`` (optional array): prebuilt (NW, P, T) windows from
        ``windows`` (cached on PreparedText) — skips the per-call window
        construction on repeat searches over the same text.

        ``n_prev`` (static; > 0 with overhang alpha) enables the word-level
        fast path for overhang searches: body tiles own positions <= n only
        (their delta codes stay raw-exact), and ONE dedicated tail tile —
        tile T-1, its window dynamic-sliced over the last m+k+steps chars —
        owns the overshoot span, with selection recomputing the
        decreasing-state over an n_prev-word strip of overshoot-adjusted
        deltas (ops/minima.py select_words_tiles).

        ``fast`` (static; set when overhang is off) selects the word-level
        selection: only words whose cost lower bound reaches <= k are
        expanded to positions, making selection O(matches) instead of
        O(text). ``hier_s`` (static; 0 = off) enables the hierarchical
        suffix prefilter: a hier_s-row suffix scan flags tiles, and the
        full scan runs only on flagged tiles (gathered into a fixed-size
        batch tied to bcap). naux reports screened words/tiles — retry
        with a larger bcap on overflow; output is unsorted.
        """
        if fast:
            from .minima import (
                compact_packed,
                select_words_tiles,
                tile_state_chain_codes,
            )

            WB = WORD_BITS
            tile = jnp.arange(T, dtype=jnp.int32)
            offset = jnp.where(tile == 0, 0, tile * W * WB - halo * WB)
            valid_from = jnp.where(tile == 0, -1, halo * WB)
            vto_raw = jnp.where(tile == 0, W * WB, (halo + W) * WB)
            rel_last = max_pos - offset
            valid_to = jnp.minimum(vto_raw, rel_last)
            islast = jnp.where(
                (rel_last > valid_from) & (rel_last <= vto_raw), rel_last, -1
            )

            if win is None:
                win = _windows(planes_g, T, W, halo)  # (NW, P, T)
            if hier_s and hier_s < pmasks.shape[0]:
                S = hier_s
                pm_s = pmasks[-S:]
                ip_s = jnp.zeros((S,), jnp.uint32)
                hi_s = jnp.ones((S,), jnp.uint32)
                no_t0 = jnp.zeros((T,), bool)
                _, _, _, meta_s, _ = _scan_win_meta(
                    win, no_t0, valid_from, valid_to,
                    pm_s, ip_s, hi_s, jnp.int32(S), jnp.int32(S), k,
                    eq_mode, backend, interpret,
                )
                flag = jnp.any((meta_s & 1) != 0, axis=0)  # (T,)
                tcap = pad_lanes_for(backend, bcap)
                pt = compact_packed(
                    jax, jnp, flag, tile, jnp.zeros((T,), jnp.int32),
                    tcap, max(16, tcap // 4),
                )
                nflag, nblkt = pt[0], pt[1]
                ids = pt[2 : 2 + tcap]
                live = ids >= 0
                safe = jnp.where(live, ids, 0)

                sub = jnp.take(win, safe, axis=2)  # (NW, P, tcap)
                t0_sel = live & (safe == 0)
                vf = jnp.where(live, jnp.take(valid_from, safe), 1 << 30)
                vt = jnp.where(live, jnp.take(valid_to, safe), 0)
                il = jnp.where(live, jnp.take(islast, safe), -1)
                pb = jnp.take(offset, safe)
                vp_w, vm_w, cost_w, meta_w, final_w = _scan_win_meta(
                    sub, t0_sel, vf, vt, pmasks, is_pad, h_init, m_real,
                    boundary_m, k, eq_mode, backend, interpret,
                )
                if all_minima:
                    st0 = jnp.zeros(vf.shape, jnp.int32)
                else:
                    # chain over the compacted tiles: an unflagged gap means
                    # every owned position there costs > k, so a candidate
                    # whose state reaches across a gap cannot exist (its
                    # flat <=k plateau would have flagged the gap tiles)
                    st0 = tile_state_chain_codes(
                        jax, jnp, final_w, t0_sel
                    )
                packed = select_words_tiles(
                    jax, jnp, vp_w, vm_w, cost_w, vf, vt, il, pb,
                    k, st0, all_minima, cap, bcap, meta=meta_w,
                )
                naux = jnp.maximum(
                    jnp.maximum(packed[1], nflag), 4 * nblkt
                )
                return packed.at[1].set(naux)

            planes_win = win
            tile0_vec = tile == 0
            tend_vec = None
            if n_prev:
                # overhang fast path: clamp body ownership at the text end
                # and inject the dedicated tail tile (docstring above)
                TT = T - 1
                NWp = planes_win.shape[0]
                P = planes_g.shape[0]
                valid_to = jnp.minimum(vto_raw, n_text - offset)
                islast = jnp.full((T,), -1, jnp.int32)
                gw = planes_g.shape[1]
                # the tail tile restarts with the plain cost-j boundary, so
                # its window must re-scan the full m+k chars before its
                # owned overshoot span — the plan's halo is 0 for texts
                # that fit one tile, which would leave the restart DP
                # unconverged at the first overshoot positions
                rescan = jnp.maximum(
                    jnp.int32(halo * WB), pmasks.shape[0] + k
                )
                ws0 = jnp.clip((n_text - rescan) // WB, 0, gw)
                s0 = ws0 * WB
                planes_pad = jnp.concatenate(
                    [planes_g, jnp.zeros((P, NWp), planes_g.dtype)], axis=1
                )
                tail_win = jax.lax.dynamic_slice(
                    planes_pad, (0, ws0), (P, NWp)
                )
                planes_win = planes_win.at[:, :, TT].set(tail_win.T)
                tile0_vec = tile0_vec | ((tile == TT) & (s0 == 0))
                offset = offset.at[TT].set(s0)
                valid_from = valid_from.at[TT].set(n_text - s0)
                valid_to = valid_to.at[TT].set(max_pos - s0)
                islast = islast.at[TT].set(max_pos - s0)
                tend_vec = n_text - offset
            vp_w, vm_w, cost_w, meta_w, final_w = _scan_win_meta(
                planes_win, tile0_vec, valid_from, valid_to, pmasks,
                is_pad, h_init, m_real, boundary_m, k,
                eq_mode, backend, interpret,
            )
            if all_minima:
                state0 = jnp.zeros((T,), jnp.int32)
            else:
                # chain resets at TEXT starts only — the tail tile's window
                # may be boundary-anchored (ws0 == 0) but the text did not
                # restart there, so its incoming state must flow through
                state0 = tile_state_chain_codes(
                    jax, jnp, final_w, tile == 0
                )
            return select_words_tiles(
                jax, jnp, vp_w, vm_w, cost_w,
                valid_from, valid_to, islast, offset,
                k, state0, all_minima, cap, bcap, meta=meta_w,
                text_end=tend_vec, alpha=alpha, n_prev=n_prev,
            )

        flat_costs, flat_delta = _scan_flat(
            planes_g,
            pmasks,
            is_pad,
            h_init,
            m_real,
            boundary_m,
            eq_mode,
            T,
            W,
            halo,
            backend,
            interpret,
        )
        return select_candidates(
            jax,
            jnp,
            flat_costs,
            flat_delta,
            boundary_m,
            n_text,
            max_pos,
            k,
            alpha,
            all_minima,
            cap,
            bcap,
        )

    _JIT["pack"] = pack
    _JIT["pack_jit"] = jax.jit(
        pack,
        static_argnames=(
            "planes", "with_valid", "mode", "shift", "mask", "pmasks",
            "fold",
        ),
    )
    _JIT["reverse_planes"] = jax.jit(reverse_planes)
    _JIT["overlay"] = overlay_n_tail
    _JIT["windows"] = jax.jit(_windows, static_argnames=("T", "W", "halo"))
    _JIT["pipeline_raw"] = pipeline
    _JIT["pipeline"] = jax.jit(
        pipeline,
        static_argnames=(
            "eq_mode",
            "T",
            "W",
            "halo",
            "backend",
            "interpret",
            "all_minima",
            "cap",
            "bcap",
            "fast",
            "hier_s",
            "n_prev",
        ),
    )

    def pipeline_bytes(
        buf, nw, nb, ew, eb,
        pmasks, is_pad, h_init, m_real, boundary_m, n_text, max_pos, k,
        alpha,
        prof_planes, with_valid, mode, shift, mask, pack_masks, fold,
        steps, **pipe,
    ):
        """One-shot fused search from RAW text bytes: device pack (+ the
        overhang 'N' overlay) + scan + selection in a SINGLE dispatch.

        The standard path (PreparedText) runs the pack as a chain of eager
        device ops before the pipeline dispatch — fine for texts that get
        reused (the pack amortizes), but a fresh small text pays the whole
        eager chain's dispatch overhead for one search, which dominates
        sub-Mbp one-shot latency. ``nw/nb/ew/eb`` ride as traced operands
        so one compiled program serves every text length in a gw bucket."""
        planes = pack(
            buf, nw, nb, prof_planes, with_valid, mode, shift, mask,
            pack_masks, fold,
        )
        if steps:
            planes = overlay_n_tail(planes, nw, nb, ew, eb)
        return pipeline(
            planes, pmasks, is_pad, h_init, m_real, boundary_m,
            n_text, max_pos, k, alpha, **pipe,
        )

    _JIT["pipeline_bytes"] = jax.jit(
        pipeline_bytes,
        static_argnames=(
            "prof_planes", "with_valid", "mode", "shift", "mask",
            "pack_masks", "fold", "steps",
            "eq_mode", "T", "W", "halo", "backend", "interpret",
            "all_minima", "cap", "bcap", "fast", "hier_s", "n_prev",
        ),
    )
    _JIT["windows_raw"] = _windows
    _JIT["scan_win_q"] = _scan_win_q
    _JIT["scan_win_q_meta"] = _scan_win_q_meta
    _JIT["scan_raw"] = _scan_flat
    _JIT["scan_core"] = scan_core
    return _JIT


# ---------------------------------------------------------------------------


def pattern_inputs_np(profile: Profile, pattern_codes: np.ndarray, alpha, max_overhang):
    """Host-side per-pattern DP inputs: row-bucketed plane masks, pad-row
    flags, true-start h deltas, and the left boundary cost at row m.

    Rows are padded at the TOP to the bucketed count; pad rows match
    unconditionally (they copy the row above) and carry h delta 0.
    """
    m = len(pattern_codes)
    m_bucket = _bucket_rows(m)
    pm_real = pattern_plane_masks_np(pattern_codes, profile.planes, profile.eq_mode)
    n_pad = m_bucket - m
    pmasks = np.vstack(
        [np.zeros((n_pad, profile.planes), dtype=np.uint32), pm_real]
    )
    is_pad = np.zeros(m_bucket, dtype=np.uint32)
    is_pad[:n_pad] = 0xFFFFFFFF
    h_init = np.zeros(m_bucket, dtype=np.uint32)
    h_init[n_pad:] = semantics.init_h_deltas(m, alpha, max_overhang).astype(np.uint32)
    boundary_m = int(semantics.left_boundary_costs(m, alpha, max_overhang)[-1])
    return pmasks, is_pad, h_init, boundary_m


class PreparedText:
    """Device-resident packed bit-planes of one text, reusable across
    patterns/k (the analog of the reference's per-search text profile reuse,
    plus the CLI's CachedRev caching)."""

    def __init__(self, profile: Profile, text_raw, lazy: bool = False):
        import jax.numpy as jnp

        self.profile = profile
        self.n = len(text_raw)
        self.gw = _bucket_words(_cdiv(self.n, WORD_BITS) + _TAIL_RESERVE_WORDS)
        pad = self.gw * WORD_BITS - self.n
        with_valid = profile.eq_mode == "ascii"
        self.n_planes = profile.planes + (1 if with_valid else 0)
        self._overlays: dict[int, object] = {}
        self._wins: dict = {}
        self._reused = False
        self._planes = None
        self.buf_np: np.ndarray | None = None
        if lazy and isinstance(text_raw, np.ndarray):
            # one-shot fast path: keep the raw padded bytes; the fused
            # pipeline_bytes dispatch packs on device inside the SAME
            # program as the scan (no eager pack chain). ``planes``
            # materializes on first access (a second search over the same
            # array takes the standard cached-plane/window path).
            buf = np.zeros(self.gw * WORD_BITS, dtype=np.uint8)
            buf[: self.n] = text_raw
            self.buf_np = buf
            return
        if isinstance(text_raw, np.ndarray):
            buf = np.zeros(self.gw * WORD_BITS, dtype=np.uint8)
            buf[: self.n] = text_raw
            buf = jnp.asarray(buf)
        else:
            # device-resident text: pad on device (no host round trip)
            buf = jnp.concatenate(
                [text_raw.astype(jnp.uint8), jnp.zeros(pad, jnp.uint8)]
            )
        self._planes = self._pack_planes(buf)

    def _pack_planes(self, buf):
        ker = _kernels()
        profile = self.profile
        return ker["pack"](
            buf,
            np.int32(self.n // WORD_BITS),
            np.int32(self.n % WORD_BITS),
            profile.planes,
            profile.eq_mode == "ascii",
            profile.pack_mode,
            profile.pack_shift,
            profile.pack_mask,
            tuple(profile.pack_plane_masks),
            profile.pack_fold_case,
        )

    @property
    def planes(self):
        if self._planes is None:
            import jax.numpy as jnp

            self._planes = self._pack_planes(jnp.asarray(self.buf_np))
        return self._planes

    def win_for(self, planes, steps: int, T: int, W: int, halo: int):
        """Cached (NW, P, T) scan windows for repeat searches, keyed by
        overhang steps and tile plan; at most two entries kept (a window
        array is ~(1 + (halo+1)/W) x the planes size)."""
        key = (steps, T, W, halo)
        got = self._wins.get(key)
        if got is None:
            got = _kernels()["windows"](planes, T=T, W=W, halo=halo)
            while len(self._wins) >= 2:
                self._wins.pop(next(iter(self._wins)))
            self._wins[key] = got
        return got

    def planes_for(self, steps: int):
        """Planes with an 'N' overlay for ``steps`` overhang positions."""
        if steps == 0:
            return self.planes
        got = self._overlays.get(steps)
        if got is None:
            ker = _kernels()
            e = self.n + steps
            got = ker["overlay"](
                self.planes,
                np.int32(self.n // WORD_BITS), np.int32(self.n % WORD_BITS),
                np.int32(e // WORD_BITS), np.int32(e % WORD_BITS),
            )
            self._overlays[steps] = got
        return got


class _IdCache:
    """Identity-keyed cache of PreparedText, safe against id reuse via
    weakrefs to the source array."""

    def __init__(self, max_items: int = 8):
        self._items: dict[tuple[int, int], tuple[weakref.ref, PreparedText]] = {}
        self.max_items = max_items

    def get(self, profile: Profile, codes: np.ndarray) -> PreparedText | None:
        key = (id(codes), id(profile.__class__))
        got = self._items.get(key)
        if got is None:
            return None
        ref, prep = got
        if ref() is not codes:
            del self._items[key]
            return None
        return prep

    def put(self, profile: Profile, codes: np.ndarray, prep: PreparedText) -> None:
        try:
            ref = weakref.ref(codes)
        except TypeError:
            return
        if len(self._items) >= self.max_items:
            self._items.pop(next(iter(self._items)))
        self._items[(id(codes), id(profile.__class__))] = (ref, prep)


class XlaEngine:
    """Engine adapter: device bit-parallel costs + device candidate
    selection + host candidate list."""

    name = "xla"
    backend = "xla"
    interpret = False
    #: one-shot searches over fresh host arrays up to this length take the
    #: fused bytes path (pack+scan+select in one dispatch) — bounded so the
    #: per-(gw bucket, statics) compile surface stays small
    ONE_SHOT_BYTES_MAX = 4 << 20

    def __init__(self, target_tiles: int = 1024, initial_cap: int = 1 << 11):
        self.target_tiles = target_tiles
        self.initial_cap = initial_cap
        self._prep_cache = _IdCache()

    def _plan_layout(self, words_needed: int, halo: int, m_bucket: int = 32):
        del m_bucket
        T, W, halo = _plan(_bucket_words(words_needed), halo, self.target_tiles)
        return T, W, halo

    # -- text preparation ------------------------------------------------
    def prepare(self, profile: Profile, text_raw: np.ndarray) -> PreparedText:
        prep = self._prep_cache.get(profile, text_raw)
        if prep is None:
            prep = PreparedText(profile, text_raw)
            self._prep_cache.put(profile, text_raw, prep)
        else:
            # second sighting of the same text: window caching pays off
            prep._reused = True
        return prep

    # -- pipeline input construction ---------------------------------------
    def build_inputs(
        self,
        profile: Profile,
        pattern_codes: np.ndarray,
        text,
        k: int,
        alpha=None,
        max_overhang=None,
        all_minima: bool = False,
        cap: int | None = None,
        bcap: int | None = None,
        bytes_mode: bool = False,
    ):
        """Build the (array_args, static_kwargs) pair for the fused pipeline.

        ``array_args`` matches the positional signature of the jitted
        pipeline up to the static tail; reusable by __graft_entry__ and the
        sharded multi-chip path. ``bytes_mode`` (internal, one-shot fast
        path): leave array_args[0] as None — the caller dispatches
        pipeline_bytes from the raw byte buffer instead of touching
        prep.planes (which would materialize the eager pack chain).
        """
        import jax.numpy as jnp

        prep = text if isinstance(text, PreparedText) else self.prepare(profile, text)
        m = len(pattern_codes)
        n = prep.n
        steps = semantics.overhang_steps(m, k, alpha, max_overhang)
        if steps > _TAIL_RESERVE_WORDS * WORD_BITS:
            raise ValueError(
                f"overhang of {steps} exceeds supported maximum "
                f"{_TAIL_RESERVE_WORDS * WORD_BITS}"
            )
        max_pos = n + steps
        if max_pos >= (1 << 31) - 1:
            # the fused single-dispatch pipeline encodes absolute positions
            # in int32; the batched engine (search_many / the CLI paths)
            # chunks position space and has no such limit
            raise ValueError(
                f"text of {n} positions exceeds the single-dispatch "
                "engine's int32 position space; use the batched engine "
                "(Searcher.search_many / TextSet) for >2.1 Gbp texts"
            )

        m_bucket = _bucket_rows(m)
        # halo shape-bucketing: pow2 up to 8 words, then {8,10,12,14}*2^k
        # (a straight next_pow2 turns m=1000's 33-word halo into 64 — pure
        # re-scan overhead)
        h_words = _cdiv(m_bucket + k, WORD_BITS)
        halo = _next_pow2(h_words) if h_words <= 8 else _bucket_words(h_words)
        words_needed = max(1, _cdiv(max_pos, WORD_BITS))
        # overhang fast path: word-level selection with an n_prev-word
        # overshoot-exact state strip + a dedicated tail tile; huge
        # overshoot spans fall back to the position-level path
        n_prev = _cdiv(steps, WORD_BITS) + 1 if alpha is not None else 0
        fast_alpha = 0 < n_prev <= 4
        T, W, halo = self._plan_layout(words_needed, halo, m_bucket)
        if self.backend == "xla" and (T * W > prep.gw or W + halo > prep.gw):
            # text shorter than reserve; re-plan single tile over whole buffer
            T, W, halo = 1, prep.gw, 0
        if fast_alpha:
            W = max(W, _cdiv(steps, WORD_BITS) + 1)
            T = pad_lanes_for(self.backend, T + 1)  # spare overshoot tile

        pmasks, is_pad, h_init, boundary_m = pattern_inputs_np(
            profile, pattern_codes, alpha, max_overhang
        )

        if cap is None:
            cap = self.initial_cap
        if bcap is None:
            bcap = self.initial_cap // 4
        array_args = (
            None if bytes_mode else prep.planes_for(steps),
            jnp.asarray(pmasks),
            jnp.asarray(is_pad),
            jnp.asarray(h_init),
            np.int32(m),
            np.int32(boundary_m),
            np.int32(n),
            np.int32(max_pos),
            np.int32(k),
            np.float32(alpha if alpha is not None else 0.0),
        )
        statics = dict(
            eq_mode=profile.eq_mode,
            T=T,
            W=W,
            halo=halo,
            backend=self.backend,
            interpret=self.interpret,
            all_minima=all_minima,
            cap=cap,
            bcap=bcap,
            fast=alpha is None or fast_alpha,
            hier_s=(
                suffix_rows(m, k)
                if alpha is None and T >= 4096 and profile.eq_mode == "iupac"
                else 0
            ),
            n_prev=n_prev if fast_alpha else 0,
        )
        return array_args, statics

    # -- main entry -------------------------------------------------------
    def candidates(
        self,
        profile: Profile,
        pattern_codes: np.ndarray,
        text,
        k: int,
        alpha,
        max_overhang,
        all_minima: bool,
    ):
        return self.candidates_async(
            profile, pattern_codes, text, k, alpha, max_overhang, all_minima
        )()

    def candidates_async(
        self,
        profile: Profile,
        pattern_codes: np.ndarray,
        text,
        k: int,
        alpha,
        max_overhang,
        all_minima: bool,
    ):
        """Dispatch the fused pipeline and return a ``finish()`` callable
        that fetches + decodes. Dispatching the next search before
        finishing the previous one overlaps the host round trip with
        device compute (double buffering)."""
        ker = _kernels()
        if isinstance(text, PreparedText):
            prep = text
        else:
            cached = self._prep_cache.get(profile, text)
            if (
                cached is None
                and isinstance(text, np.ndarray)
                and len(text) <= self.ONE_SHOT_BYTES_MAX
                and self.backend in ("xla", "pallas")
            ):
                # first sighting of a small host text: one-shot fused
                # bytes path (pack + scan + select in ONE dispatch); a
                # repeat search finds this prep cached and takes the
                # standard path (planes materialize then)
                prep = PreparedText(profile, text, lazy=True)
                self._prep_cache.put(profile, text, prep)
            else:
                prep = self.prepare(profile, text)
        use_bytes = (
            prep.buf_np is not None
            and prep._planes is None
            and not prep._reused
        )
        array_args, statics = self.build_inputs(
            profile, pattern_codes, prep, k, alpha, max_overhang, all_minima,
            bytes_mode=use_bytes,
        )
        # reused texts (explicit PreparedText, or a second search over the
        # same array) take the cached window path; one-shot searches keep
        # the single fused dispatch
        win = None
        reused = isinstance(text, PreparedText) or prep._reused
        if statics["fast"] and reused:
            steps = semantics.overhang_steps(
                len(pattern_codes), k, alpha, max_overhang
            )
            win = prep.win_for(
                array_args[0], steps, statics["T"], statics["W"],
                statics["halo"],
            )
        cap = statics.pop("cap")
        bcap = statics.pop("bcap")
        # async dispatch: the device starts scanning immediately; the
        # returned finish() fetches + decodes (and grow-retries on cap
        # overflow). Callers that dispatch call N+1 before finishing call
        # N overlap the fetch round trip with the next scan.
        if use_bytes:
            steps = semantics.overhang_steps(
                len(pattern_codes), k, alpha, max_overhang
            )
            n, e = prep.n, prep.n + steps
            pk = dict(
                prof_planes=profile.planes,
                with_valid=profile.eq_mode == "ascii",
                mode=profile.pack_mode,
                shift=profile.pack_shift,
                mask=profile.pack_mask,
                pack_masks=tuple(profile.pack_plane_masks),
                fold=profile.pack_fold_case,
                steps=steps,
            )
            byte_args = (
                prep.buf_np,
                np.int32(n // WORD_BITS), np.int32(n % WORD_BITS),
                np.int32(e // WORD_BITS), np.int32(e % WORD_BITS),
            ) + array_args[1:]

            def dispatch(cap, bcap):
                return ker["pipeline_bytes"](
                    *byte_args, **pk, **statics, cap=cap, bcap=bcap,
                )
        else:
            def dispatch(cap, bcap):
                return ker["pipeline"](
                    *array_args, **statics, cap=cap, bcap=bcap, win=win,
                )

        packed = dispatch(cap, bcap)

        def finish():
            nonlocal packed, cap, bcap
            while True:
                # single device->host transfer: [count, nblocks, pos, cost]
                arr = np.asarray(packed)
                count = int(arr[0])
                nblk = int(arr[1])
                if count <= cap and nblk <= bcap:
                    break
                cap = max(cap, _next_pow2(count))
                bcap = max(bcap, _next_pow2(nblk))
                packed = dispatch(cap, bcap)
            pos = arr[2 : 2 + count]
            cost = arr[2 + cap : 2 + cap + count]
            out = list(zip(pos.tolist(), cost.tolist()))
            if statics.get("fast"):
                out.sort()  # word-level selection emits unsorted
            return out

        return finish


def end_costs_xla(
    profile: Profile,
    pattern_codes: np.ndarray,
    text_raw: np.ndarray,
    alpha,
    max_overhang,
    k: int,
) -> np.ndarray:
    """Costs 0..len(text_raw) — comparable to oracle.end_costs (test hook).

    Computed through the same device pipeline, then truncated.
    """
    eng = XlaEngine()
    # run with all_minima + huge k to recover the raw cost row
    prep = eng.prepare(profile, text_raw)
    cands = eng.candidates(
        profile, pattern_codes, prep, 10**6, alpha, max_overhang, True
    )
    n = len(text_raw)
    out = np.zeros(n + 1, dtype=np.int64)
    for p, c in cands:
        if p <= n:
            out[p] = c
    return out


def _register():
    from ..search import register_engine

    register_engine("xla", XlaEngine)


_register()

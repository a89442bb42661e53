"""Device-side candidate end-position extraction.

jnp port of :func:`sassy_tpu.semantics.find_candidates` (the reference's
sequential minima scan, search.rs:1286-1369), engineered for the device:

- **No gathers/scatters over positions.** The decreasing-state d(p) ("last
  cost change at or before p was a decrease, or none yet") is computed with a
  single cummax over an encoding ``2*p + (delta>0)`` of nonzero deltas.
- **Hierarchical compaction.** Candidates are compacted block-wise: a small
  scatter over n/BS block ids, a row-gather of only the nonzero blocks, and a
  tiny scatter into the output buffer. Only ``[count, nblocks, pos[cap],
  cost[cap]]`` leaves the device, in one transfer.

``select_candidates`` is a plain traced function fused into the engine's
single-dispatch pipeline (ops/myers_xla.py).
"""

from __future__ import annotations

#: positions per compaction block
BLOCK = 1024


def select_candidates(
    jax,
    jnp,
    flat_costs,  # (N,) int32 DP costs at positions 1..N
    flat_delta,  # (N,) int32 cost deltas c(p) - c(p-1) at positions 1..N
    boundary_m,  # () int32 cost at position 0
    n_text,  # () int32 true text length
    max_pos,  # () int32 last valid end position
    k,  # () int32
    alpha,  # () float32 (0.0 when no overhang)
    all_minima: bool,
    cap: int,
    bcap: int,
    min_pos=None,  # () int32: first owned position (shard ownership), or None
    owned_end=None,  # () int32: last owned position, or None
    state0=None,  # () int32 {0,1}: state seed at min_pos (cross-shard chain)
):
    """Returns packed (2 + cap + cap,) int32: [count, nblocks, pos, cost].

    ``min_pos``/``owned_end`` implement the owner-computes rule for sharded
    search (the generalization of the reference's prune_lane_overlaps,
    search.rs:1202-1240): candidates outside [min_pos, owned_end] are
    suppressed. When ``state0`` is given, deltas below ``min_pos`` (restart
    artifacts in the halo) are excluded from the decreasing-state and the
    cross-shard seed is used instead — see tile_state_chain.
    """
    c = jnp.concatenate([jnp.asarray(boundary_m, jnp.int32).reshape(1), flat_costs])
    delta = jnp.concatenate([jnp.zeros(1, jnp.int32), flat_delta])
    P1 = c.shape[0]
    pos = jnp.arange(P1, dtype=jnp.int32)

    # total cost incl. overshoot (f32 floor, matching the reference
    # search.rs:1274-1282) — also adjust deltas in the overshoot region so
    # the plateau logic sees total costs.
    ov = jnp.floor(alpha * jnp.maximum(pos - n_text, 0).astype(jnp.float32)).astype(
        jnp.int32
    )
    ov_prev = jnp.floor(
        alpha * jnp.maximum(pos - 1 - n_text, 0).astype(jnp.float32)
    ).astype(jnp.int32)
    c = c + ov
    delta = delta + (ov - ov_prev)

    in_range = pos <= max_pos
    if min_pos is not None:
        in_range = in_range & (pos >= min_pos)
    if owned_end is not None:
        in_range = in_range & (pos <= owned_end)
    if all_minima:
        mask = in_range & (c <= k)
    else:
        # decreasing-state after p: encode each nonzero delta as
        # 2*p (decrease) / 2*p+1 (increase); cummax finds the latest one.
        enc = jnp.where(delta > 0, 2 * pos + 1, jnp.where(delta < 0, 2 * pos, -1))
        if state0 is not None:
            lo = min_pos if min_pos is not None else 0
            enc = jnp.where(pos >= lo, enc, -1)
            enc = enc.at[0].set(jnp.where(state0 > 0, 1, -1))
        m2 = jax.lax.cummax(enc)
        d = (m2 < 0) | ((m2 & 1) == 0)
        delta_next = jnp.concatenate([delta[1:], jnp.ones(1, jnp.int32)])
        next_gt = (delta_next >= 1) | (pos == max_pos)
        mask = in_range & (c <= k) & next_gt & d

    return compact_packed(jax, jnp, mask, pos, c, cap, bcap)


def compact_packed(jax, jnp, mask, posvals, costvals, cap, bcap):
    """Block-hierarchical compaction of a sparse candidate mask.

    mask/posvals/costvals: flat (N,) arrays. Returns packed (2 + 2*cap,)
    int32 [count, nblocks, pos[cap], cost[cap]] — pos entries are the
    posvals at mask positions, in increasing index order; unused slots -1.
    Gathers touch only the (few) nonzero blocks, so the compaction cost
    scales with matches, not text length.
    """
    N = mask.shape[0]
    NB = -(-N // BLOCK)
    bcap = min(bcap, NB)  # never gather/scatter more blocks than exist
    pad = NB * BLOCK - N
    maskb = jnp.concatenate([mask, jnp.zeros(pad, bool)]).reshape(NB, BLOCK)
    cb = jnp.concatenate([costvals, jnp.zeros(pad, jnp.int32)]).reshape(NB, BLOCK)
    pb = jnp.concatenate([posvals, jnp.zeros(pad, jnp.int32)]).reshape(NB, BLOCK)

    blk_cnt = jnp.sum(maskb, axis=1, dtype=jnp.int32)  # (NB,)
    blk_nz = blk_cnt > 0
    nblk = jnp.sum(blk_nz.astype(jnp.int32))
    count = jnp.sum(blk_cnt)

    blk_slot = jnp.where(blk_nz, jnp.cumsum(blk_nz.astype(jnp.int32)) - 1, bcap)
    blk_ids = jnp.full((bcap,), NB, jnp.int32)
    blk_ids = blk_ids.at[blk_slot].set(jnp.arange(NB, dtype=jnp.int32), mode="drop")
    blk_base = jnp.cumsum(blk_cnt) - blk_cnt  # output offset per block

    safe = jnp.minimum(blk_ids, NB - 1)
    g_valid = blk_ids < NB
    g_mask = jnp.take(maskb, safe, axis=0) & g_valid[:, None]  # (bcap, BLOCK)
    g_c = jnp.take(cb, safe, axis=0)
    g_p = jnp.take(pb, safe, axis=0)
    g_base = jnp.take(blk_base, safe)

    local = jnp.cumsum(g_mask.astype(jnp.int32), axis=1) - 1
    slot = jnp.where(g_mask, g_base[:, None] + local, cap)

    out_pos = jnp.full((cap,), -1, dtype=jnp.int32)
    out_cost = jnp.zeros((cap,), dtype=jnp.int32)
    out_pos = out_pos.at[slot].set(g_p, mode="drop")
    out_cost = out_cost.at[slot].set(g_c, mode="drop")
    return jnp.concatenate([count.reshape(1), nblk.reshape(1), out_pos, out_cost])


def _swar_min_u8(jnp, a, b):
    """Per-byte min of two uint32s holding 4 byte fields each <= 127."""
    H = jnp.uint32(0x80808080)
    L = jnp.uint32(0x7F7F7F7F)  # ~H, spelled out: the kernel lowering
    ones = jnp.uint32(0x01010101)  # cannot invert a constant
    d = (a | H) - (b & L)  # byte MSB set iff a_field >= b_field
    ge = ((d >> 7) & ones) * jnp.uint32(0xFF)
    return (b & ge) | (a & ~ge)


def word_min_prefix(jax, jnp, vp, vm):
    """Exact min over i=1..32 of the prefix sums of per-bit deltas
    (vp bit i = +1, vm bit i = -1), as int32 <= 0, fully vectorized.

    This is the vector equivalent of the reference's BMI2 ``prefix_min``
    (/root/reference/src/minima.rs:62-77): instead of pext + byte tables, a
    SWAR reduction — 8 packed-byte accumulation steps produce per-byte
    (sum, min-prefix), then 4 bytes combine sequentially.
    """
    del jax
    vp = vp.astype(jnp.uint32)
    vm = vm.astype(jnp.uint32)
    ones = jnp.uint32(0x01010101)
    s = jnp.full(vp.shape, 0x08080808, jnp.uint32)  # bias 8 per byte
    mn = None
    for j in range(8):
        s = s + ((vp >> j) & ones) - ((vm >> j) & ones)
        mn = s if mn is None else _swar_min_u8(jnp, mn, s)
    acc_min = ((mn >> 0) & 0xFF).astype(jnp.int32) - 8
    acc_sum = ((s >> 0) & 0xFF).astype(jnp.int32) - 8
    for b in (1, 2, 3):
        mb = ((mn >> (8 * b)) & 0xFF).astype(jnp.int32) - 8
        sb = ((s >> (8 * b)) & 0xFF).astype(jnp.int32) - 8
        acc_min = jnp.minimum(acc_min, acc_sum + mb)
        acc_sum = acc_sum + sb
    return acc_min


def _owned_delta_masks(jnp, widx, valid_from, valid_to):
    """(broadcast) uint32 masks keeping delta bit j of word w iff its
    position ``w*32 + j + 1`` lies in the owned range (valid_from, valid_to].

    Used for the rightmost-minima *state* computation only: delta bits in a
    tile's halo are restart artifacts (the re-scanned DP has not converged
    to the global costs yet), and bits past valid_to belong to the next
    tile's owned range — both must be excluded from the last-delta-sign
    chain or they corrupt the decreasing-state at flat-cost plateaus.
    """
    WB = 32
    lo = jnp.clip(valid_from - widx * WB, 0, WB)
    hi = jnp.clip(valid_to - widx * WB, 0, WB)
    full = jnp.uint32(0xFFFFFFFF)
    # shift counts stay < 32 (a 32-bit shift by 32 is undefined in the
    # GPU kernel's lowering); the >= 32 cases are selected away
    sh_lo = jnp.minimum(lo, WB - 1).astype(jnp.uint32)
    sh_hi = jnp.minimum(hi, WB - 1).astype(jnp.uint32)
    m_lo = jnp.where(lo >= WB, jnp.uint32(0), full << sh_lo)
    m_hi = jnp.where(hi >= WB, full, ~(full << sh_hi))
    return m_lo & m_hi


def word_screen_code(jnp, vp, vm, cost, widx, vf, vt, k):
    """Per-word selection facts, elementwise over broadcastable operands.

    ``screen`` (int32 0/1): the word holds an owned position whose cost
    can reach <= k (exact lower bound ``cost + min prefix``; word 0 of a
    position-0-owning tile also covers the tile boundary candidate at
    position 0, cost ``cost``). ``code`` (int32): 0 when the word has no
    owned nonzero delta, else ``2 | sign`` of its last owned delta (1 =
    +1). vp and vm are disjoint, so the last delta is +1 exactly when
    ``vp_o > vm_o`` as unsigned words.

    The scan kernel (ops/myers_pallas.py) evaluates this per word inside
    its loop; meta_from_words evaluates it over whole (NW, T) grids.
    """
    WB = 32
    wlo = widx * WB + 1
    whi = wlo + WB - 1
    mp = word_min_prefix(None, jnp, vp, vm)
    # word 0 of a position-0-owning tile also carries the tile BOUNDARY
    # candidate (position 0, cost = cost): reachable when the overhang
    # boundary cost floor(alpha*m) <= k (or degenerate k >= m)
    first = (widx == 0) & (vf < 0)
    mp = jnp.where(first, jnp.minimum(mp, 0), mp)
    wvalid = (whi > vf) & ((wlo <= vt) | first)
    screen = (wvalid & (cost + mp <= k)).astype(jnp.int32)
    omask = _owned_delta_masks(jnp, widx, vf, vt)
    vp_o = vp & omask
    vm_o = vm & omask
    has = (vp_o | vm_o) != 0
    code = jnp.where(has, 2 | (vp_o > vm_o).astype(jnp.int32), 0)
    return screen, code


def meta_from_words(jax, jnp, vp_w, vm_w, cost_w, valid_from, valid_to, k):
    """XLA computation of the per-word selection metadata, bit-identical
    to the scan kernel's in-kernel outputs (ops/myers_pallas.py): per
    word ``meta`` int32 (bit 0 = screen, bits 1-2 = decreasing-state code
    at word start from OWNED deltas earlier in the tile: 0 none, 2 last
    -1, 3 last +1) and per tile ``final`` (the code after the last word).
    Used on the XLA path so selection has ONE meta-based code path."""
    lead = vp_w.ndim - 2
    NW, T = vp_w.shape[-2], vp_w.shape[-1]
    widx = jnp.arange(NW, dtype=jnp.int32).reshape((1,) * lead + (NW, 1))
    vf = valid_from.reshape((1,) * lead + (1, T))
    vt = valid_to.reshape((1,) * lead + (1, T))
    screen, code = word_screen_code(jnp, vp_w, vm_w, cost_w, widx, vf, vt, k)
    # code at word START = last present code among earlier words (carry 0
    # forward): encode presence in high bits for cummax, then strip
    enc = jnp.where(code > 0, ((widx + 1) << 2) | code, 0)
    cm = jax.lax.cummax(enc, axis=lead)
    zeros = jnp.zeros(cm.shape[:lead] + (1, T), cm.dtype)
    prior = jnp.concatenate([zeros, cm[..., :-1, :]], axis=lead)
    final = cm[..., -1, :] & 3  # (.., T)
    meta = screen | ((prior & 3) << 1)
    return meta, final


def tile_state_chain_codes(jax, jnp, tl, is_start, seed_code=None,
                           with_out=False):
    """Cross-tile decreasing-state chain from per-tile last-owned-delta
    codes (``tl``: 0 = none, 2|sign otherwise — the Pallas kernel's
    ``final`` output or meta_from_words' second result). See
    tile_state_chain for semantics."""
    T = tl.shape[-1]
    t_ids = jnp.arange(T, dtype=jnp.int32)
    tcode = jnp.where(tl > 0, 2 * (t_ids + 2) + (tl & 1), 0)
    cm = jax.lax.cummax(tcode, axis=tcode.ndim - 1)
    zeros = jnp.zeros(cm.shape[:-1] + (1,), cm.dtype)
    ld = jnp.concatenate([zeros, cm[..., :-1]], axis=-1)  # exclusive
    if seed_code is not None:
        ld = jnp.maximum(ld, seed_code[..., None])
    scode = jnp.where(is_start, t_ids + 2, 0)
    ls = jax.lax.cummax(scode)
    state0 = jnp.where((ld > 0) & ((ld >> 1) >= ls), ld & 1, 0)
    if with_out:
        return state0, jnp.max(tcode, axis=-1)
    return state0


def tile_state_chain(
    jax, jnp, vp_w, vm_w, valid_from, valid_to, is_start,
    seed_code=None, with_out=False,
):
    """Decreasing-state seeds across a tile sequence (exact minima rule).

    The rightmost-local-minima rule needs the sign of the last nonzero cost
    delta before each position — unbounded left context. Within a tile the
    word-level cummax provides it; ACROSS tiles this chain provides the
    boundary state: per tile, the sign of its last owned delta, combined by
    an exclusive cummax in tile order, reset at tiles that own a text start
    (the reference instead re-initializes ``decreasing = true`` at every
    internal lane start, search.rs:1040-1056, making its output depend on
    its private lane layout at flat-cost plateaus; we match the global
    semantics of the oracle instead).

    vp_w/vm_w: (..., NW, T) delta words; valid_from/valid_to: (T,) owned
    range per tile; is_start: (T,) bool, tile owns its text's position 0.
    Returns state0 (..., T) int32 in {0, 1}: 1 = the last delta before this
    tile's owned range was +1 (suppresses flat-plateau candidates).

    ``seed_code`` (optional, (...,) int32): incoming state from BEFORE tile
    0, encoded ``2 + sign`` (0 = none) — used by the sharded path to chain
    state across devices. ``with_out=True`` additionally returns the
    outgoing last-delta code ``max(tcode)`` ((...,) int32; sign in bit 0,
    0 = this tile sequence has no owned deltas), for the same chaining.
    """
    WB = 32
    nw = vp_w.shape[-2]
    T = vp_w.shape[-1]
    lead = (1,) * (vp_w.ndim - 2)
    widx = jnp.arange(nw, dtype=jnp.int32).reshape(lead + (nw, 1))
    mask = _owned_delta_masks(jnp, widx, valid_from, valid_to)
    vp_o = vp_w & mask
    vm_o = vm_w & mask
    clz = jax.lax.clz
    has = (vp_o | vm_o) != 0
    hb_p = jnp.int32(31) - clz(vp_o).astype(jnp.int32)
    hb_m = jnp.int32(31) - clz(vm_o).astype(jnp.int32)
    s_w = (hb_p > hb_m).astype(jnp.int32)
    enc_w = jnp.where(has, 2 * (widx + 1) + s_w, 0)
    tl = jnp.max(enc_w, axis=-2)  # (..., T) last owned delta code per tile

    t_ids = jnp.arange(T, dtype=jnp.int32)
    tcode = jnp.where(tl > 0, 2 * (t_ids + 2) + (tl & 1), 0)
    cm = jax.lax.cummax(tcode, axis=tcode.ndim - 1)
    zeros = jnp.zeros(cm.shape[:-1] + (1,), cm.dtype)
    ld = jnp.concatenate([zeros, cm[..., :-1]], axis=-1)  # exclusive
    if seed_code is not None:
        # incoming state sits at pseudo tile index -1 (code 2+sign, i.e.
        # (ld >> 1) == 1): beaten by any real delta or text start
        ld = jnp.maximum(ld, seed_code[..., None])
    scode = jnp.where(is_start, t_ids + 2, 0)
    ls = jax.lax.cummax(scode)  # inclusive: a start in tile t resets t itself
    state0 = jnp.where((ld > 0) & ((ld >> 1) >= ls), ld & 1, 0)
    if with_out:
        return state0, jnp.max(tcode, axis=-1)
    return state0


def select_words_tiles(
    jax,
    jnp,
    vp_w,  # (NW, T) uint32 vertical +1 delta words
    vm_w,  # (NW, T) uint32 vertical -1 delta words
    cost_w,  # (NW, T) int32 last-row cost at each word start
    valid_from,  # (T,) int32 window-local (-1 = tile owns position 0)
    valid_to,  # (T,) int32 window-local last owned position
    islast_at,  # (T,) int32 trailing-minimum position (-1 = none)
    pos_base,  # (T,) int32 encoded output = pos_base + local position
    k,  # () int32
    state0,  # (T,) int32 {0,1} cross-tile state seed (tile_state_chain)
    all_minima: bool,
    cap: int,
    wcap: int,
    meta,  # (NW, T) int32 selection metadata (kernel or meta_from_words)
    text_end=None,  # (T,) int32 per-tile text end (overshoot ref), or None
    alpha=None,  # () f32 overhang cost/char (with text_end)
    n_prev: int = 0,  # static: strip length for overshoot-exact state
):
    """Word-level candidate selection (no-overhang fast path).

    Positions-space work is O(candidate words), not O(text): ``meta`` bit 0
    screens each 32-position word by its exact cost lower bound, and only
    screened words are expanded to per-position costs. The minima
    decreasing-state at a word start comes from ``meta``'s state code (the
    sign of the last OWNED nonzero delta earlier in the tile; halo deltas
    are restart artifacts), falling back to ``state0`` from the cross-tile
    chain.

    Returns packed (2 + 2*cap,) int32 [count, nwords, enc[cap], cost[cap]];
    callers must retry with larger caps when count > cap or nwords > wcap.
    Output order is NOT sorted (tile-position order within words, with
    position-0 candidates appended) — callers sort.
    """
    WB = 32
    NW, T = vp_w.shape
    wstep = T  # flat stride between consecutive words of a tile
    screen = (meta & 1) != 0

    # ---- hierarchical compaction of screened words: only nonzero 1024-word
    # blocks are gathered (row gathers), never a full-size scatter.
    wbcap = max(16, wcap // 4)
    F = NW * T
    NB = -(-F // BLOCK)
    pad = NB * BLOCK - F

    def blk(x, fill=0):
        f = x.reshape(-1)
        if pad:
            f = jnp.concatenate([f, jnp.full((pad,), fill, f.dtype)])
        return f.reshape(NB, BLOCK)

    maskb = blk(screen, False)
    blk_cnt = jnp.sum(maskb, axis=1, dtype=jnp.int32)
    blk_nz = blk_cnt > 0
    # one fused two-row cumsum pass (see select_words_tiles_q)
    cs2 = jnp.cumsum(
        jnp.stack([blk_cnt, blk_nz.astype(jnp.int32)]), axis=1
    )
    nblk = cs2[1, -1]
    nwords = cs2[0, -1]
    blk_slot = jnp.where(blk_nz, cs2[1] - 1, wbcap)
    blk_ids = jnp.full((wbcap,), NB, jnp.int32)
    blk_ids = blk_ids.at[blk_slot].set(jnp.arange(NB, dtype=jnp.int32), mode="drop")
    safe = jnp.minimum(blk_ids, NB - 1)
    bvalid = blk_ids < NB
    blk_base = cs2[0] - blk_cnt

    g_mask = jnp.take(maskb, safe, axis=0) & bvalid[:, None]  # (wbcap, BLOCK)
    g_base = jnp.take(blk_base, safe)
    local = jnp.cumsum(g_mask.astype(jnp.int32), axis=1) - 1
    wslot = jnp.where(g_mask, g_base[:, None] + local, jnp.int32(1 << 30))
    g_fidx = safe[:, None] * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)[None, :]

    # compacted word indices via SORT by output slot (slots are unique, so
    # sort order == scatter order) instead of cap-sized scatters
    _, fidx = jax.lax.sort(
        (wslot.reshape(-1), g_fidx.reshape(-1)), num_keys=1
    )
    fidx = fidx[:wcap]
    gvalid = jnp.arange(wcap, dtype=jnp.int32) < jnp.minimum(nwords, wcap)
    fidx = jnp.minimum(jnp.where(gvalid, fidx, 0), NW * T - 1)

    def gather_words(x):  # element gather of wcap values — O(caps)
        return jnp.take(x.reshape(-1), fidx)

    g_vp, g_vm = gather_words(vp_w), gather_words(vm_w)
    g_cost = gather_words(cost_w)
    # flat index f = w * T + t  (natural (NW, T) order)
    g_tile = fidx % T
    g_w = fidx // T
    if all_minima:
        g_din = jnp.ones((wcap,), bool)
        g_next = jnp.zeros((wcap,), jnp.int32)
    else:
        if n_prev:
            fidx0 = fidx - jnp.minimum(g_w, n_prev) * wstep
        else:
            fidx0 = fidx
        code = (jnp.take(meta.reshape(-1), fidx0) >> 1) & 3
        g_s0 = jnp.take(state0, g_tile)
        g_din = jnp.where(code > 0, (code & 1) == 0, g_s0 == 0)
        fidx2 = jnp.minimum(fidx + wstep, NW * T - 1)
        nf = (jnp.take(vp_w.reshape(-1), fidx2).astype(jnp.int32) & 1) - (
            jnp.take(vm_w.reshape(-1), fidx2).astype(jnp.int32) & 1
        )
        g_next = jnp.where(g_w + 1 < NW, nf, 1)
    gt = lambda v: jnp.take(v, g_tile)  # noqa: E731
    g_vfrom, g_vto = gt(valid_from), gt(valid_to)
    g_ilast, g_pbase = gt(islast_at), gt(pos_base)

    # ---- expand (wcap, 33): column 0 is the word's start position, which
    # for word 0 of a tile is the tile's position 0 (boundary candidate).
    bit = jnp.arange(WB, dtype=jnp.uint32)[None, :]

    def bits_delta(vpv, vmv):
        bp = ((vpv[:, None] >> bit) & 1).astype(jnp.int32)
        bm = ((vmv[:, None] >> bit) & 1).astype(jnp.int32)
        return bp - bm

    if text_end is not None:
        g_tend = gt(text_end)
        af = jnp.asarray(alpha, jnp.float32)

        def ovf(p):  # floor(alpha * overshoot), f32 (search.rs:1274-1282)
            ovs = jnp.maximum(p - g_tend[:, None], 0)
            return jnp.floor(af * ovs.astype(jnp.float32)).astype(jnp.int32)

        def ov_adjust(d32, lp):
            return d32 + ovf(lp) - ovf(lp - 1)
    else:

        def ov_adjust(d32, lp):
            return d32

    delta32 = bits_delta(g_vp, g_vm)
    lpos = g_w[:, None] * WB + jnp.arange(WB + 1, dtype=jnp.int32)[None, :]
    delta32 = ov_adjust(delta32, lpos[:, 1:])
    zcol = jnp.zeros((wcap, 1), jnp.int32)
    delta = jnp.concatenate([zcol, delta32], axis=1)  # (wcap, 33)
    c = g_cost[:, None] + jnp.cumsum(delta, axis=1)
    if text_end is not None:
        c = c + ovf(lpos[:, :1])
    valid = gvalid[:, None] & (lpos > g_vfrom[:, None]) & (lpos <= g_vto[:, None])
    # column 0 only stands for the tile boundary position
    valid = valid.at[:, 0].set(
        gvalid & (g_w == 0) & (g_vfrom < 0)
    )

    if all_minima:
        mask = valid & (c <= k)
    else:
        if text_end is not None:
            nref = (g_w + 1) * WB + 1
            novd = ovf(nref[:, None]) - ovf(nref[:, None] - 1)
            g_next = jnp.where(g_w + 1 < NW, g_next + novd[:, 0], g_next)
        enc = jnp.where(
            delta > 0, 2 * lpos + 1, jnp.where(delta < 0, 2 * lpos, 0)
        )
        # halo positions inside a straddling word are restart artifacts:
        # they must not feed the decreasing-state
        enc = jnp.where(lpos > g_vfrom[:, None], enc, 0)
        seed = jnp.where(g_din, 0, 1)[:, None]
        # column 0 (word start) is "decreasing" per the carried-in state;
        # for w == 0 the state is fresh (True), which d_in already is.
        if n_prev:
            strips = []
            for jp in range(n_prev, 0, -1):
                has_w = g_w >= jp
                fj = jnp.maximum(fidx - jp * wstep, 0)
                vpj = jnp.where(
                    has_w, jnp.take(vp_w.reshape(-1), fj), 0
                )
                vmj = jnp.where(
                    has_w, jnp.take(vm_w.reshape(-1), fj), 0
                )
                dj = bits_delta(vpj, vmj)
                lpj = (g_w - jp)[:, None] * WB + jnp.arange(
                    1, WB + 1, dtype=jnp.int32
                )[None, :]
                dj = ov_adjust(dj, lpj)
                encj = jnp.where(
                    dj > 0, 2 * lpj + 1, jnp.where(dj < 0, 2 * lpj, 0)
                )
                encj = jnp.where(
                    (lpj > g_vfrom[:, None]) & has_w[:, None], encj, 0
                )
                strips.append(encj)
            st_all = jax.lax.cummax(
                jnp.concatenate([seed] + strips + [enc], axis=1), axis=1
            )
            st = st_all[:, 1 + n_prev * WB :]
        else:
            st = jax.lax.cummax(
                jnp.concatenate([seed, enc], axis=1), axis=1
            )[:, 1:]
        d = (st == 0) | ((st & 1) == 0)
        delta_next = jnp.concatenate([delta[:, 1:], g_next[:, None]], axis=1)
        next_gt = (delta_next >= 1) | (lpos == g_ilast[:, None])
        mask = valid & (c <= k) & next_gt & d

    enc_out = g_pbase[:, None] + lpos
    # final position-level compaction via SORT over the (wcap, 33)
    # expansion (key = flat index -> increasing-index order, pads last);
    # replaces compact_packed's two cap-sized scatters. The sort cannot
    # drop entries, so the block-count retry term disappears from naux.
    fmask = mask.reshape(-1)
    Npts = fmask.shape[0]
    keyc = jnp.where(
        fmask, jnp.arange(Npts, dtype=jnp.int32), jnp.int32(Npts)
    )
    _, s_enc, s_cost = jax.lax.sort(
        (keyc, enc_out.reshape(-1), c.reshape(-1)), num_keys=1
    )
    if Npts < cap:  # tiny grids: fewer expansion points than the cap
        padn = cap - Npts
        s_enc = jnp.concatenate([s_enc, jnp.zeros((padn,), s_enc.dtype)])
        s_cost = jnp.concatenate([s_cost, jnp.zeros((padn,), s_cost.dtype)])
    total = jnp.sum(fmask.astype(jnp.int32))
    live = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(total, cap)
    pos_out = jnp.where(live, s_enc[:cap], -1)
    cost_out = jnp.where(live, s_cost[:cap], 0)
    naux = jnp.maximum(nwords, 4 * nblk)
    return jnp.concatenate(
        [total.reshape(1), naux.reshape(1), pos_out, cost_out]
    )


def select_words_tiles_q(
    jax,
    jnp,
    vp_w,  # (Q, NW, T) uint32
    vm_w,  # (Q, NW, T) uint32
    cost_w,  # (Q, NW, T) int32
    meta,  # (Q, NW, T) int32 selection metadata (kernel or meta_from_words)
    valid_from,  # (T,) int32 (shared across patterns)
    valid_to,  # (T,) int32
    islast_at,  # (T,) int32
    pos_base,  # (T,) int32
    k,
    state0,  # (Q, T) int32 {0,1} cross-tile state seeds (tile_state_chain)
    all_minima: bool,
    cap: int,
    wcap: int,
    text_end=None,  # (T,) int32 per-tile text end (overshoot ref), or None
    alpha=None,  # () f32 overhang cost/char (with text_end)
    n_prev: int = 0,  # static: strip length for overshoot-exact state
):
    """Pattern-batched word selection: ONE hierarchical compaction across
    the whole (Q, NW, T) grid — per-pattern fixed-size scatters made the
    batched path O(Q x caps) instead of O(matches).

    The word screen and decreasing-state come precomputed in ``meta``
    (bit 0 = screen, bits 1-2 = state code at word start) — the GPU scan
    kernel emits it with vp/vm already in registers; the XLA path computes
    it with meta_from_words. This keeps the per-word XLA work to one
    compaction pass instead of the full SWAR/cummax pipeline.

    Returns packed (3 + 2*cap,) int32
    [total, naux, maxq(unused=0), pos[cap], qc[cap]] with
    qc = qid << 16 | cost.
    """
    WB = 32
    Q, NW, T = vp_w.shape
    wstep = T  # flat stride between consecutive words of a tile
    screen = (meta & 1) != 0

    # ---- 3-level word compaction over the flat (Q*NW*T) grid:
    # 1024-word slabs -> 64-word sub-blocks -> words. Screened words can
    # be fully scattered (one per slab, e.g. planted matches every few
    # kb), so slab capacity must equal the word cap; a 2-level scheme
    # then pays a (wcap, 1024) cumsum+scatter, while coupling the slab cap
    # tighter (wcap//64) inflates the retry demand 64x. With the
    # sub-block level, full-grid work is
    # ONE popcount pass and everything after touches O(wcap) slabs /
    # sub-blocks / words.
    F = Q * NW * T
    NB = -(-F // BLOCK)
    pad = NB * BLOCK - F
    SUB = 64
    NSUB = BLOCK // SUB
    wbcap = min(max(8, wcap), NB)

    def blk(x, fill=0):
        f = x.reshape(-1)
        if pad:
            f = jnp.concatenate([f, jnp.full((pad,), fill, f.dtype)])
        return f.reshape(NB, BLOCK)

    maskb = blk(screen, False)
    subcnt = jnp.sum(
        maskb.reshape(NB, NSUB, SUB), axis=2, dtype=jnp.int32
    )  # (NB, NSUB) — the one full-grid pass
    blk_cnt = jnp.sum(subcnt, axis=1)
    blk_nz = blk_cnt > 0
    # ONE two-row cumsum pass over NB yields slab slots, word offsets,
    # nblk and nwords together (separate cumsum+cumsum+sum+sum passes
    # cost 4 reduce-window/reduce sweeps of the NB-sized table)
    cs2 = jnp.cumsum(
        jnp.stack([blk_cnt, blk_nz.astype(jnp.int32)]), axis=1
    )
    nblk = cs2[1, -1]
    nwords = cs2[0, -1]
    blk_slot = jnp.where(blk_nz, cs2[1] - 1, wbcap)
    blk_ids = jnp.full((wbcap,), NB, jnp.int32)
    blk_ids = blk_ids.at[blk_slot].set(jnp.arange(NB, dtype=jnp.int32), mode="drop")
    safe_b = jnp.minimum(blk_ids, NB - 1)
    bvalid = blk_ids < NB
    blk_base = cs2[0] - blk_cnt  # global word offset per slab

    # sub-block level: counts + within-slab offsets for gathered slabs
    g_sub = jnp.take(subcnt, safe_b, axis=0) * bvalid[:, None]  # (wbcap, NSUB)
    g_obase = jnp.take(blk_base, safe_b)  # (wbcap,)
    sub_off = jnp.cumsum(g_sub, axis=1) - g_sub
    sub_nz = (g_sub > 0).reshape(-1)  # (wbcap*NSUB,)
    # nonzero sub-blocks <= nwords (<= wcap when not overflowing), but on
    # tiny grids NB < wcap caps the slab table while sub-blocks can still
    # number up to NB*NSUB
    sbcap = min(max(8, wcap), NB * NSUB)
    s_slot = jnp.where(
        sub_nz, jnp.cumsum(sub_nz.astype(jnp.int32)) - 1, sbcap
    )
    s_ids = jnp.full((sbcap,), wbcap * NSUB, jnp.int32)
    s_ids = s_ids.at[s_slot].set(
        jnp.arange(wbcap * NSUB, dtype=jnp.int32), mode="drop"
    )
    s_safe = jnp.minimum(s_ids, wbcap * NSUB - 1)
    s_valid = s_ids < wbcap * NSUB
    s_row = s_safe // NSUB  # row in the gathered slab list
    s_sub = s_safe % NSUB
    # flat (padded) word index of each selected sub-block's first word,
    # and its global output offset
    s_fbase = jnp.take(safe_b, s_row) * BLOCK + s_sub * SUB
    s_obase = jnp.take(g_obase, s_row) + jnp.take(
        sub_off.reshape(-1), s_safe
    )

    sidx = s_fbase[:, None] + jnp.arange(SUB, dtype=jnp.int32)[None, :]
    # ROW gather of whole 64-bit sub-blocks (sub-block r = row r of the
    # (NB*NSUB, SUB) view) rather than an elementwise take of the same
    # sbcap*SUB flat indices
    s_mask = (
        jnp.take(maskb.reshape(NB * NSUB, SUB), s_fbase // SUB, axis=0)
        & s_valid[:, None]
    )  # (sbcap, SUB)
    local = jnp.cumsum(s_mask.astype(jnp.int32), axis=1) - 1
    wslot = jnp.where(s_mask, s_obase[:, None] + local, jnp.int32(1 << 30))

    # compacted word indices via SORT (key = output slot) instead of the
    # equivalent (sbcap*SUB -> wcap) scatter; slots are unique so sort
    # order == scatter order
    _, fidx = jax.lax.sort(
        (wslot.reshape(-1), sidx.reshape(-1)), num_keys=1
    )
    fidx = fidx[:wcap]
    gvalid = jnp.arange(wcap, dtype=jnp.int32) < jnp.minimum(nwords, wcap)
    fidx = jnp.minimum(jnp.where(gvalid, fidx, 0), F - 1)

    def g(x):  # element gather of wcap values — O(caps), not O(grid)
        return jnp.take(x.reshape(-1), fidx)

    g_vp, g_vm = g(vp_w), g(vm_w)
    g_cost = g(cost_w)
    g_q = fidx // (NW * T)
    g_w = (fidx // T) % NW
    g_tile = fidx % T

    if not all_minima:
        # decreasing-state seed: in-tile prior code from meta, falling back
        # to the cross-tile seed when no owned delta yet. With an overshoot
        # strip (n_prev > 0) the seed comes from the word at the strip
        # START — by construction either pre-overshoot (meta exact) or the
        # tile's word 0 (cross-tile state applies).
        if n_prev:
            fidx0 = fidx - jnp.minimum(g_w, n_prev) * wstep
        else:
            fidx0 = fidx
        code = (jnp.take(meta.reshape(-1), fidx0) >> 1) & 3
        g_s0 = jnp.take(state0.reshape(-1), g_q * T + g_tile)
        g_din = jnp.where(code > 0, (code & 1) == 0, g_s0 == 0)
        # first total delta of the NEXT word (artificial +1 past the end):
        # gathered from the next word's vp/vm instead of a full-grid shift
        fidx2 = jnp.minimum(fidx + wstep, F - 1)
        nf = (jnp.take(vp_w.reshape(-1), fidx2).astype(jnp.int32) & 1) - (
            jnp.take(vm_w.reshape(-1), fidx2).astype(jnp.int32) & 1
        )
        g_next = jnp.where(g_w + 1 < NW, nf, 1)
    else:
        g_din = jnp.ones((wcap,), bool)
        g_next = jnp.zeros((wcap,), jnp.int32)

    gt = lambda v: jnp.take(v, g_tile)  # noqa: E731
    g_vfrom, g_vto = gt(valid_from), gt(valid_to)
    g_ilast, g_pbase = gt(islast_at), gt(pos_base)

    # ---- expand (wcap, 33); column 0 = tile position 0 (boundary)
    bit = jnp.arange(WB, dtype=jnp.uint32)[None, :]

    def bits_delta(vpv, vmv):
        bp = ((vpv[:, None] >> bit) & 1).astype(jnp.int32)
        bm = ((vmv[:, None] >> bit) & 1).astype(jnp.int32)
        return bp - bm

    if text_end is not None:
        g_tend = gt(text_end)
        af = jnp.asarray(alpha, jnp.float32)

        def ovf(p):  # floor(alpha * overshoot), f32 (search.rs:1274-1282)
            ovs = jnp.maximum(p - g_tend[:, None], 0)
            return jnp.floor(af * ovs.astype(jnp.float32)).astype(jnp.int32)

        def ov_adjust(d32, lp):  # per-position total deltas incl. overshoot
            return d32 + ovf(lp) - ovf(lp - 1)
    else:

        def ov_adjust(d32, lp):
            return d32

    delta32 = bits_delta(g_vp, g_vm)
    lpos = g_w[:, None] * WB + jnp.arange(WB + 1, dtype=jnp.int32)[None, :]
    delta32 = ov_adjust(delta32, lpos[:, 1:])
    zcol = jnp.zeros((wcap, 1), jnp.int32)
    delta = jnp.concatenate([zcol, delta32], axis=1)
    c = g_cost[:, None] + jnp.cumsum(delta, axis=1)
    if text_end is not None:
        c = c + ovf(lpos[:, :1])  # overshoot base at the word start
    valid = gvalid[:, None] & (lpos > g_vfrom[:, None]) & (lpos <= g_vto[:, None])
    valid = valid.at[:, 0].set(gvalid & (g_w == 0) & (g_vfrom < 0))

    if all_minima:
        mask = valid & (c <= k)
    else:
        if text_end is not None:
            # the next word's first total delta also carries its ov step
            nref = (g_w + 1) * WB + 1
            novd = ovf(nref[:, None]) - ovf(nref[:, None] - 1)
            g_next = jnp.where(
                g_w + 1 < NW, g_next + novd[:, 0], g_next
            )
        enc = jnp.where(delta > 0, 2 * lpos + 1, jnp.where(delta < 0, 2 * lpos, 0))
        # halo positions inside a straddling word must not feed the state
        enc = jnp.where(lpos > g_vfrom[:, None], enc, 0)
        seed = jnp.where(g_din, 0, 1)[:, None]
        if n_prev:
            # overshoot-exact state: recompute the in-tile state over the
            # n_prev preceding words with ov-adjusted deltas (the meta
            # codes are raw-delta only). Words before the tile clamp to
            # zero deltas; halo positions are masked as usual.
            strips = []
            for jp in range(n_prev, 0, -1):
                has_w = g_w >= jp
                fj = jnp.maximum(fidx - jp * wstep, 0)
                vpj = jnp.where(
                    has_w, jnp.take(vp_w.reshape(-1), fj), 0
                )
                vmj = jnp.where(
                    has_w, jnp.take(vm_w.reshape(-1), fj), 0
                )
                dj = bits_delta(vpj, vmj)
                lpj = (g_w - jp)[:, None] * WB + jnp.arange(
                    1, WB + 1, dtype=jnp.int32
                )[None, :]
                dj = ov_adjust(dj, lpj)
                encj = jnp.where(
                    dj > 0, 2 * lpj + 1, jnp.where(dj < 0, 2 * lpj, 0)
                )
                encj = jnp.where(
                    (lpj > g_vfrom[:, None]) & has_w[:, None], encj, 0
                )
                strips.append(encj)
            st_all = jax.lax.cummax(
                jnp.concatenate([seed] + strips + [enc], axis=1), axis=1
            )
            st = st_all[:, 1 + n_prev * WB :]
        else:
            st = jax.lax.cummax(
                jnp.concatenate([seed, enc], axis=1), axis=1
            )[:, 1:]
        d = (st == 0) | ((st & 1) == 0)
        delta_next = jnp.concatenate([delta[:, 1:], g_next[:, None]], axis=1)
        next_gt = (delta_next >= 1) | (lpos == g_ilast[:, None])
        mask = valid & (c <= k) & next_gt & d

    enc_out = g_pbase[:, None] + lpos
    # (qid, cost) share one int32: qid<<16 | cost. qid per dispatch is
    # bounded by the cell budget (<= ~2048 padded patterns) and recorded
    # costs are <= k <= m (patterns are vastly shorter than 65535), so
    # both fields fit. Halves the per-candidate fetch (pos + qc instead
    # of pos + cost + qid).
    qc_out = jnp.broadcast_to(
        g_q[:, None] << 16, (wcap, WB + 1)
    ) | (c & 0xFFFF)

    # final position-level compaction via SORT: the expansion is only
    # (wcap, WB+1) elements, so one 3-operand sort replaces the block
    # compaction's two cap-sized scatters; key = flat index keeps
    # increasing-index output order, pads (key = Npts) sort last
    fmask = mask.reshape(-1)
    Npts = fmask.shape[0]
    keyc = jnp.where(
        fmask, jnp.arange(Npts, dtype=jnp.int32), jnp.int32(Npts)
    )
    _, s_enc, s_qc = jax.lax.sort(
        (keyc, enc_out.reshape(-1), qc_out.reshape(-1)), num_keys=1
    )
    if Npts < cap:  # tiny grids: fewer expansion points than the cap
        padn = cap - Npts
        s_enc = jnp.concatenate([s_enc, jnp.zeros((padn,), s_enc.dtype)])
        s_qc = jnp.concatenate([s_qc, jnp.zeros((padn,), s_qc.dtype)])
    total = jnp.sum(fmask.astype(jnp.int32))
    live = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(total, cap)
    pos_out = jnp.where(live, s_enc[:cap], -1)
    qc_fin = jnp.where(live, s_qc[:cap], 0)
    naux = jnp.maximum(nwords, nblk)  # nblk <= nwords; wbcap == wcap
    return jnp.concatenate(
        [
            total.reshape(1),
            naux.reshape(1),
            jnp.zeros((1,), jnp.int32),
            pos_out,
            qc_fin,
        ]
    )


def select_candidates_tiles(
    jax,
    jnp,
    vp_w,  # (W, T) uint32 vertical +1 delta words
    vm_w,  # (W, T) uint32 vertical -1 delta words
    cost_w,  # (W, T) int32 last-row cost at each word start
    boundary0,  # (T,) int32 cost at each tile's position 0
    text_end,  # (T,) int32 per-tile text end (overshoot reference point)
    valid_from,  # (T,) int32: positions > valid_from are owned (-1 = from 0)
    valid_to,  # (T,) int32: positions <= valid_to are owned
    islast_at,  # (T,) int32: trailing-minimum position (-1 = none)
    pos_base,  # (T,) int32: encoded output = pos_base + local position
    k,  # () int32
    alpha,  # () float32 (0.0 = no overhang)
    state0,  # (T,) int32 {0,1} cross-tile state seed (tile_state_chain)
    all_minima: bool,
    cap: int,
    bcap: int,
):
    """Per-tile candidate selection for the batched engine.

    Each tile is an independent text (or text segment) with its own boundary
    cost, ownership interval, and trailing-minimum position — the device-side
    generalization of :func:`sassy_tpu.semantics.find_candidates` to a
    (tiles, positions) grid. The tile width may exceed the owned range (the
    final word is right context so the minima lookahead past ``valid_to``
    is exact). Returns packed [count, nblocks, enc[cap], cost[cap]] where
    ``enc = pos_base[tile] + pos``.
    """
    W, T = vp_w.shape
    WB = 32
    N = W * WB
    bit = jnp.arange(WB, dtype=jnp.uint32)
    vp_b = ((vp_w[..., None] >> bit) & 1).astype(jnp.int32)  # (W,T,32)
    vm_b = ((vm_w[..., None] >> bit) & 1).astype(jnp.int32)
    delta = (vp_b - vm_b).transpose(1, 0, 2).reshape(T, N)
    csum = jnp.cumsum((vp_b - vm_b), axis=-1)
    posc = (cost_w[..., None] + csum).transpose(1, 0, 2).reshape(T, N)

    c = jnp.concatenate([boundary0[:, None], posc], axis=1)  # (T, N+1)
    delta = jnp.concatenate([jnp.zeros((T, 1), jnp.int32), delta], axis=1)
    pos = jnp.arange(N + 1, dtype=jnp.int32)[None, :]

    # overshoot cost, f32 floor as in the reference (search.rs:1274-1282)
    ov = jnp.floor(
        alpha * jnp.maximum(pos - text_end[:, None], 0).astype(jnp.float32)
    ).astype(jnp.int32)
    ov_prev = jnp.floor(
        alpha * jnp.maximum(pos - 1 - text_end[:, None], 0).astype(jnp.float32)
    ).astype(jnp.int32)
    c = c + ov
    delta = delta + (ov - ov_prev)

    valid = (pos > valid_from[:, None]) & (pos <= valid_to[:, None])
    if all_minima:
        mask = valid & (c <= k)
    else:
        enc = jnp.where(delta > 0, 2 * pos + 1, jnp.where(delta < 0, 2 * pos, -1))
        # halo deltas are restart artifacts — exclude them from the state
        # and seed column 0 with the cross-tile chain instead
        enc = jnp.where(pos > valid_from[:, None], enc, -1)
        enc = enc.at[:, 0].set(jnp.where(state0 > 0, 1, -1))
        m2 = jax.lax.cummax(enc, axis=1)
        d = (m2 < 0) | ((m2 & 1) == 0)
        delta_next = jnp.concatenate(
            [delta[:, 1:], jnp.ones((T, 1), jnp.int32)], axis=1
        )
        next_gt = (delta_next >= 1) | (pos == islast_at[:, None])
        mask = valid & (c <= k) & next_gt & d

    posenc = pos_base[:, None] + pos
    return compact_packed(
        jax, jnp, mask.reshape(-1), posenc.reshape(-1), c.reshape(-1), cap, bcap
    )

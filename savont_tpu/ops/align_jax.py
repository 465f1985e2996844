"""Banded affine Smith-Waterman in plain JAX, batched over pairs.

Same recurrence as ops/align.py banded_sw (prefix-max E formulation), as a
lax.scan over query rows with the band along the minor axis.  This is the
device reference: on a GPU the same forwards run as one CUDA kernel
(ops/align_cuda.py, exactly equal outputs), chosen by
align_cuda.dp_kernel; everywhere else XLA compiles these scans.  Instead of
materializing traceback matrices, the forward propagates METADATA along
the winning path:

    nm  — edit count (mismatches + gap bases) of the optimal path,
    qs/ts — start coordinates of the optimal path,

so a full Mapping (score, NM, query/target spans) comes back as 6 scalars
per pair.  Tie-breaking matches the host traceback exactly:
    H: prefer G over E;  G: prefer zero, then F, then diagonal;
    E: nearest origin j' (largest);  F: prefer H-origin over extension.

CIGAR-needing call sites (pileups, adjusted errors, chimera scans) run on
sw_traceback_full below: direction planes + a batched traceback walk +
on-device run-length encoding, so only packed CIGAR runs leave the device.

Both kernels handle RAW planner bands exactly (barrel-shifted planes on
band jumps, the device analog of native/swalign.cpp's pre-shift), so all
results are bit-identical to the host kernels on any job set — no
smooth_lo caveat.  The opt-in smooth=True path of sw_forward_meta (one
static shift per plane; requires pre-smoothed lo) remains for the mesh
callers, with the documented large-indel caveat.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH
from .jax_init import ensure_jax_cache

ensure_jax_cache()

NEG = -20000


def _dyn_shl(a, dl, fill):
    """Barrel left-shift along lanes: out[:, j] = a[:, j + dl[b]], filled
    past the end.  dl is (B,) int32 >= 0, already clamped to < 2**stages.
    Implemented as bit_length(band) static lane shifts + selects (a
    per-pair dynamic shift without a per-element gather).  This is the
    device analog of the native kernel's plane pre-shift on band jumps
    (native/swalign.cpp), and is what makes the device kernels EXACT on raw
    planner bands (no smooth_lo result caveat)."""
    B, band = a.shape
    out = a
    k = 1
    while k <= band:
        shifted = jnp.concatenate(
            [out[:, k:], jnp.full((B, k), fill, out.dtype)], axis=1
        )
        out = jnp.where((dl[:, None] & k) != 0, shifted, out)
        k <<= 1
    return out


def _dl_clamp(dl, band):
    """Clamp raw band advances so every set bit is covered by _dyn_shl's
    stages (any dl >= band shifts the whole row to fill either way)."""
    lim = 1
    while lim <= band:
        lim <<= 1
    return jnp.minimum(dl, lim - 1)


@partial(jax.jit, static_argnames=("band", "smooth"))
def sw_forward_meta(q, t, lo, tlens, band: int = 128, smooth: bool = True):
    """Batched forward banded SW with path metadata.

    q: (B, Lq) int32 codes 0..3 (4 ambiguous, >=5 padding)
    t: (B, Lt) int32 codes
    lo: (B, Lq+1) int32 band lower bound per row, non-decreasing.
        smooth=True (the shard_map/mesh fast path) requires per-row
        increments of AT MOST 1 (see smooth_lo): every previous-row access
        is ONE static lane shift.  smooth=False handles RAW planner bands
        exactly (matching native/swalign.cpp bit-for-bit on any input) via
        barrel shifts — ~bit_length(band) static shifts per plane.
    tlens: (B,) int32
    Returns dict of (B,) arrays: score, q_start, q_end, t_start, t_end, nm.
    """
    B, Lq = q.shape
    je = jnp.arange(band, dtype=jnp.int32)

    # pre-gather the per-row target windows OUTSIDE the scan (one big gather)
    cols_all = lo[:, 1:, None] + je[None, None, :]  # (B, Lq, band)
    valid_all = cols_all < tlens[:, None, None]
    gather_cols = jnp.minimum(cols_all, tlens[:, None, None] - 1).reshape(B, Lq * band)
    tc_all = jnp.take_along_axis(t.astype(jnp.int32), gather_cols, axis=1).reshape(B, Lq, band)

    def shl1(a, fill):  # out[:, j] = a[:, j+1]
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), fill, a.dtype)], axis=1)

    def shr1(a, fill):  # out[:, j] = a[:, j-1]
        return jnp.concatenate([jnp.full((B, 1), fill, a.dtype), a[:, :-1]], axis=1)

    def step(carry, xs):
        H, F, nmh, qsh, tsh, nmf, qsf, tsf, best = carry
        qc, l, dl, r, tc, valid = xs  # (B,), (B,), (B,), scalar, (B,band), (B,band)

        cols = l[:, None] + je[None, :]
        is_match = (tc == qc[:, None]) & (qc[:, None] < 4) & (tc < 4)
        s = jnp.where(is_match, MATCH, MISMATCH)

        if smooth:
            d1 = (dl == 1)[:, None]  # band advanced one column this row

            def up(a, fill):  # same COLUMN in the previous row: j + dl
                return jnp.where(d1, shl1(a, fill), a)

            def diag(a, fill):  # column j-1 of the previous row: j + dl - 1
                return jnp.where(d1, a, shr1(a, fill))

            Hup, Fup = up(H, NEG), up(F, NEG)
            nmh_up, qsh_up, tsh_up = up(nmh, 0), up(qsh, 0), up(tsh, 0)
            nmf_up, qsf_up, tsf_up = up(nmf, 0), up(qsf, 0), up(tsf, 0)

            Hdiag = diag(H, NEG)
            nmd, qsd, tsd = diag(nmh, 0), diag(qsh, 0), diag(tsh, 0)
        else:
            # raw planner bands: per-pair barrel shifts.  diag planes shift
            # by dl-1; up planes = diag result shifted one more lane (shared
            # barrels), except dl==0 rows where up is identity / diag is the
            # static right-shift.
            dlc = _dl_clamp(dl, band)
            dm1 = jnp.maximum(dlc - 1, 0)
            d0 = (dl == 0)[:, None]

            def updiag(a, fill):
                pos = _dyn_shl(a, dm1, fill)  # shift by dl-1 (dl >= 1 rows)
                a_up = jnp.where(d0, a, shl1(pos, fill))
                a_diag = jnp.where(d0, shr1(a, fill), pos)
                return a_up, a_diag

            Hup, Hdiag = updiag(H, NEG)
            nmh_up, nmd = updiag(nmh, 0)
            qsh_up, qsd = updiag(qsh, 0)
            tsh_up, tsd = updiag(tsh, 0)
            Fup = _dyn_shl(F, dlc, NEG)
            nmf_up = _dyn_shl(nmf, dlc, 0)
            qsf_up = _dyn_shl(qsf, dlc, 0)
            tsf_up = _dyn_shl(tsf, dlc, 0)
        # left of the band is the free zero boundary only at column 0
        # (cols==0 forces l==0 and, lo being non-decreasing from lo[0]>=0,
        # dl==0 — so no dl term is needed in the predicate)
        left_edge = (je[None, :] == 0) & (cols == 0)
        Hdiag = jnp.where(left_edge, 0, Hdiag)
        nmd = jnp.where(left_edge, 0, nmd)
        qsd = jnp.where(left_edge, r - 1, qsd)
        tsd = jnp.where(left_edge, cols, tsd)

        # F (vertical, consumes query base): prefer H-origin on ties
        from_h = (Hup - GAP_OPEN) >= Fup
        Fr = jnp.maximum(jnp.maximum(Hup - GAP_OPEN, Fup) - GAP_EXT, NEG)
        nmf_n = jnp.where(from_h, nmh_up, nmf_up) + 1
        qsf_n = jnp.where(from_h, qsh_up, qsf_up)
        tsf_n = jnp.where(from_h, tsh_up, tsf_up)

        # G = max(0, diag + s, F): priority zero > F > diag (traceback order)
        Gr = jnp.maximum(jnp.maximum(0, Hdiag + s), Fr)
        g_zero = Gr == 0
        g_f = (~g_zero) & (Gr == Fr)
        nmg = jnp.where(g_zero, 0, jnp.where(g_f, nmf_n, nmd + (~is_match).astype(jnp.int32)))
        qsg = jnp.where(g_zero, r, jnp.where(g_f, qsf_n, qsd))
        tsg = jnp.where(g_zero, cols + 1, jnp.where(g_f, tsf_n, tsd))

        # E via an inclusive prefix max of (G + e*j) with metadata riding
        # along the argmax (ties -> largest j', i.e. right operand)
        def combine(a, b):
            take_b = b[0] >= a[0]
            return tuple(jnp.where(take_b, y, x) for x, y in zip(a, b))

        scanned = lax.associative_scan(
            combine,
            (Gr + GAP_EXT * je[None, :], nmg - je[None, :], qsg, tsg),
            axis=1,
        )
        run_v = shr1(scanned[0], NEG)
        run_nm = shr1(scanned[1], 0)
        run_qs = shr1(scanned[2], 0)
        run_ts = shr1(scanned[3], 0)
        Er = run_v - GAP_OPEN - GAP_EXT * je[None, :]
        Er = jnp.maximum(jnp.where(je[None, :] == 0, NEG, Er), NEG)
        nme = run_nm + je[None, :]
        qse = run_qs
        tse = run_ts

        # H = max(G, E): prefer G on ties
        use_g = Gr >= Er
        Hr = jnp.where(use_g, Gr, Er)
        nmh_n = jnp.where(use_g, nmg, nme)
        qsh_n = jnp.where(use_g, qsg, qse)
        tsh_n = jnp.where(use_g, tsg, tse)
        Hr = jnp.where(valid, Hr, NEG)

        # per-lane running best (strictly greater -> keeps the earliest row)
        bv, bqs, bts, bqe, bte, bnm = best
        better = Hr > bv
        best_n = (
            jnp.where(better, Hr, bv),
            jnp.where(better, qsh_n, bqs),
            jnp.where(better, tsh_n, bts),
            jnp.where(better, r, bqe),
            jnp.where(better, cols + 1, bte),
            jnp.where(better, nmh_n, bnm),
        )
        return (Hr, Fr, nmh_n, qsh_n, tsh_n, nmf_n, qsf_n, tsf_n, best_n), None

    # derive the init carry from q AND t so its sharding "varying" type
    # matches the scan outputs inside shard_map regardless of which input is
    # the sharded one (zero-cost: x & 0)
    vary2 = (
        (q[:, :1].astype(jnp.int32) & 0)
        + (t[:, :1].astype(jnp.int32) & 0)
        + (tlens[:, None].astype(jnp.int32) & 0)
        + jnp.zeros((B, band), jnp.int32)
    )
    init = (
        vary2,  # H row 0 = 0 (local alignment)
        vary2 + NEG,
        vary2, vary2, vary2, vary2, vary2, vary2,
        (vary2, vary2, vary2, vary2, vary2, vary2),  # per-lane best planes
    )
    rows = jnp.arange(1, Lq + 1, dtype=jnp.int32)
    xs = (
        q.T.astype(jnp.int32),            # (Lq, B)
        lo[:, 1:].T.astype(jnp.int32),    # l per row
        (lo[:, 1:] - lo[:, :-1]).T.astype(jnp.int32),  # dl per row
        rows,
        jnp.swapaxes(tc_all, 0, 1),       # (Lq, B, band)
        jnp.swapaxes(valid_all, 0, 1),
    )
    (_, _, _, _, _, _, _, _, best), _ = lax.scan(step, init, xs)
    bv, bqs, bts, bqe, bte, bnm = best

    # reduce lanes: max value; ties -> earliest row (bqe), then lowest lane
    # (equivalent to the row-major flat argmax of the full DP matrix)
    vmax = bv.max(axis=1, keepdims=True)
    is_best = bv == vmax
    tb = jnp.where(is_best, (Lq + 1 - bqe) * (band + 1) + (band - je[None, :]), -1)
    chosen = is_best & (tb == tb.max(axis=1, keepdims=True))

    def pick(x):
        return jnp.sum(jnp.where(chosen, x, 0), axis=1)

    return {
        "score": pick(bv),
        "q_start": pick(bqs),
        "t_start": pick(bts),
        "q_end": pick(bqe),
        "t_end": pick(bte),
        "nm": pick(bnm),
    }


# ── device traceback: direction planes + batched walk + on-device CIGAR RLE ──
#
# The reference pipeline is CIGAR-driven end to end (pileups walk CIGARs,
# alignment.rs:520-564; adjusted-error merging classifies CIGAR runs,
# alignment.rs:101-188; chimera detection walks CIGARs from both ends,
# chimera.rs:274-398).  This kernel produces full CIGARs ON DEVICE,
# bit-identical to the host traceback (ops/align.py _traceback and
# native/swalign.cpp sw_tb_batch) given the same (smoothed) bands:
#
#   forward scan  — same recurrence as sw_forward_meta, but instead of path
#                   metadata it stores FIVE decision bits per cell (one u8
#                   plane per row, band lanes wide):
#                     bit0 use_g   H == G        (H-state: go G, else E)
#                     bit1 g_zero  G == 0        (G-state: stop)
#                     bit2 g_f     G == F        (G-state: go F, else diag)
#                     bit3 exitE   E[j] == G[j-1] - o - e   (E-state: exit to G)
#                     bit4 from_h  F[j] == H_up - o - e     (F-state: exit to H)
#   walk          — a batched lax.while_loop replaying the host state machine
#                   (H>G>E priority, zero>F>diag, nearest-origin gap exits);
#                   every iteration emits exactly one CIGAR base-op, so the
#                   iteration count equals the longest path in the batch.
#   RLE           — reverse + run-length encode on device; only packed u32
#                   (len<<4 | op) runs leave the device, not per-base ops
#                   or traceback matrices.
ST_H, ST_G, ST_E, ST_F = 0, 1, 2, 3


def _forward_payload(q, t, lo, tlens, band: int):
    """Forward scan emitting ONE packed uint8 payload byte per cell:

        bit0  use_g    bit1 g_zero    bit2 g_f    bit3 exitE    bit4 from_h
        bit5  mm       (mismatch-or-both-ambiguous at this cell)

    (the per-row band advance dl travels in a separate (B, Lq) u8 table —
    see _walk_ops).  One byte per cell keeps the payload, and the window
    the walk gathers from, small.  Returns (payload (B, Lq*band) u8, score, ri, bj) with the start cell
    equal to the host's row-major flat argmax of H[1:].
    """
    B, Lq = q.shape
    je = jnp.arange(band, dtype=jnp.int32)
    ooe = GAP_OPEN + GAP_EXT

    cols_all = lo[:, 1:, None] + je[None, None, :]
    valid_all = cols_all < tlens[:, None, None]
    gather_cols = jnp.minimum(cols_all, tlens[:, None, None] - 1).reshape(B, Lq * band)
    tc_all = jnp.take_along_axis(t.astype(jnp.int32), gather_cols, axis=1).reshape(B, Lq, band)

    def shl1(a, fill):
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), fill, a.dtype)], axis=1)

    def shr1(a, fill):
        return jnp.concatenate([jnp.full((B, 1), fill, a.dtype), a[:, :-1]], axis=1)

    def step(carry, xs):
        H, F, bv, brow = carry
        qc, l, dl, r, tc, valid = xs

        cols = l[:, None] + je[None, :]
        is_match = (tc == qc[:, None]) & (qc[:, None] < 4) & (tc < 4)
        s = jnp.where(is_match, MATCH, MISMATCH)

        # RAW planner bands (exact vs native/swalign.cpp on any lo): barrel
        # shifts by dl-1 for the diagonal plane, +1 static lane for "up"
        dlc = _dl_clamp(dl, band)
        d0 = (dl == 0)[:, None]
        Hd_pos = _dyn_shl(H, jnp.maximum(dlc - 1, 0), NEG)
        Hup = jnp.where(d0, H, shl1(Hd_pos, NEG))
        Hdiag = jnp.where(d0, shr1(H, NEG), Hd_pos)
        Fup = _dyn_shl(F, dlc, NEG)
        left_edge = (je[None, :] == 0) & (cols == 0)
        Hdiag = jnp.where(left_edge, 0, Hdiag)

        from_h = (Hup - GAP_OPEN) >= Fup
        Fr = jnp.maximum(jnp.maximum(Hup - GAP_OPEN, Fup) - GAP_EXT, NEG)
        Gr = jnp.maximum(jnp.maximum(0, Hdiag + s), Fr)

        run_v = shr1(lax.associative_scan(jnp.maximum, Gr + GAP_EXT * je[None, :], axis=1), NEG)
        Er = run_v - GAP_OPEN - GAP_EXT * je[None, :]
        Er = jnp.maximum(jnp.where(je[None, :] == 0, NEG, Er), NEG)

        g_zero = Gr == 0
        g_f = (~g_zero) & (Gr == Fr)
        use_g = Gr >= Er
        exitE = Er == (shr1(Gr, NEG) - ooe)

        pay = (
            use_g.astype(jnp.uint8)
            | (g_zero.astype(jnp.uint8) << 1)
            | (g_f.astype(jnp.uint8) << 2)
            | (exitE.astype(jnp.uint8) << 3)
            | (from_h.astype(jnp.uint8) << 4)
            | ((~is_match).astype(jnp.uint8) << 5)
        )

        Hr = jnp.where(use_g, Gr, Er)
        Hr = jnp.where(valid, Hr, NEG)

        better = Hr > bv  # strictly greater -> per-lane earliest row
        bv_n = jnp.where(better, Hr, bv)
        brow_n = jnp.where(better, r, brow)
        return (Hr, Fr, bv_n, brow_n), pay

    vary2 = (
        (q[:, :1].astype(jnp.int32) & 0)
        + (t[:, :1].astype(jnp.int32) & 0)
        + (tlens[:, None].astype(jnp.int32) & 0)
        + jnp.zeros((B, band), jnp.int32)
    )
    init = (vary2, vary2 + NEG, vary2 + NEG, vary2)
    rows = jnp.arange(1, Lq + 1, dtype=jnp.int32)
    xs = (
        q.T.astype(jnp.int32),
        lo[:, 1:].T.astype(jnp.int32),
        (lo[:, 1:] - lo[:, :-1]).T.astype(jnp.int32),
        rows,
        jnp.swapaxes(tc_all, 0, 1),
        jnp.swapaxes(valid_all, 0, 1),
    )
    (_, _, bv, brow), pay_rows = lax.scan(step, init, xs)
    payload = jnp.swapaxes(pay_rows, 0, 1).reshape(B, Lq * band)

    # start cell = row-major flat argmax of H[1:]: earliest row, lowest lane
    vmax = bv.max(axis=1, keepdims=True)
    is_best = bv == vmax
    tb = jnp.where(is_best, (Lq + 1 - brow) * (band + 1) + (band - je[None, :]), -1)
    chosen = is_best & (tb == tb.max(axis=1, keepdims=True))

    def pick(x):
        return jnp.sum(jnp.where(chosen, x, 0), axis=1)

    score = pick(bv)
    ri = pick(brow)
    bj = pick(jnp.broadcast_to(je[None, :], bv.shape))
    return payload, score, ri, bj


def _walk_ops(payload, dl_tab, score, ri, bj, band: int, ops_max: int,
              K: int = 128, S: int = 96):
    """Batched traceback walk (host _traceback state machine).

    The walk gathers from a K-row WINDOW of the payload instead of the
    whole (Lq, band) plane, so each step's data-dependent gather touches
    K*band bytes per pair whatever the query length: an outer while_loop
    slices rows [w0, w0+K) at the current maximum active row (a shared
    dynamic_slice — cheap), an inner scan runs S steps inside the window,
    and pairs whose row has dropped below the window PARK until the window
    descends.  The row index only decreases, and the maximum active pair is
    always inside the window, so every inner step emits at least one op and
    the loop terminates.

    Emission goes to per-pair positions (cnt) via a masked scatter into the
    (B, ops_max) buffer — positions 0..cnt-1 hold the pair's backward op
    stream, 255 past it.

    Returns (ops (B, ops_max) u8 backward order, cnt, nm, nins, ndel).
    """
    B = payload.shape[0]
    Lq = dl_tab.shape[1]
    K = min(K, Lq)
    W = ops_max
    payload3 = payload.reshape(B, Lq, band)
    bidx = jnp.arange(B)

    def stepw(c, _):
        r, j, st, cnt, nm, nins, ndel, done, w0, win, dlw, ops = c
        act = (~done) & (r - 1 >= w0)  # park below-window pairs
        cell = jnp.clip((r - 1 - w0) * band + j, 0, K * band - 1)
        p = jnp.take_along_axis(win, cell[:, None], axis=1)[:, 0]
        use_g = (p & 1) != 0
        g_zero = (p & 2) != 0
        g_f = (p & 4) != 0
        exitE = (p & 8) != 0
        from_h = (p & 16) != 0
        mm = ((p >> 5) & 1).astype(jnp.int32)
        dl = jnp.take_along_axis(
            dlw, jnp.clip(r - 1 - w0, 0, K - 1)[:, None], axis=1
        )[:, 0].astype(jnp.int32)

        st1 = jnp.where(st == ST_H, jnp.where(use_g, ST_G, ST_E), st)
        is_stop = (st1 == ST_G) & g_zero
        st2 = jnp.where((st1 == ST_G) & g_f, ST_F, st1)
        is_diag = (st2 == ST_G) & ~is_stop
        is_f = (st2 == ST_F) & ~is_stop
        is_e = (st2 == ST_E) & ~is_stop

        emit = act & ~is_stop
        op = jnp.where(is_diag, 0, jnp.where(is_f, 1, 2)).astype(jnp.uint8)
        ops = ops.at[bidx, jnp.where(emit, cnt, W)].set(op, mode="drop")
        nm = nm + jnp.where(emit, jnp.where(is_diag, mm, 1), 0)
        nins = nins + (emit & is_f).astype(jnp.int32)
        ndel = ndel + (emit & is_e).astype(jnp.int32)
        cnt = cnt + emit.astype(jnp.int32)

        # moves (host order: emit, move, then boundary breaks)
        up = j + dl
        exit_f = from_h & (up < band)
        exit_e = exitE & (j - 1 >= 0)
        r_n = jnp.where(is_diag | is_f, r - 1, r)
        j_n = jnp.where(is_diag, up - 1, jnp.where(is_f, up, jnp.where(is_e, j - 1, j)))
        st_n = jnp.where(
            is_diag,
            ST_H,
            jnp.where(
                is_f,
                jnp.where(exit_f, ST_H, ST_F),
                jnp.where(is_e, jnp.where(exit_e, ST_G, ST_E), st2),
            ),
        )
        term = is_stop | (r_n <= 0) | (j_n < 0) | (j_n >= band) | (cnt >= ops_max)
        done_n = done | (act & term)
        r = jnp.where(act, r_n, r)
        j = jnp.where(act, j_n, j)
        st = jnp.where(act, st_n, st)
        return (r, j, st, cnt, nm, nins, ndel, done_n, w0, win, dlw, ops), None

    def cond(s):
        walk = s
        return jnp.any(~walk[7])

    def body(s):
        r, j, st, cnt, nm, nins, ndel, done, _w0, _win, _dlw, ops = s
        w_hi = jnp.max(jnp.where(done, 1, r))  # max active row (>= 1)
        w0 = jnp.maximum(w_hi - K, 0)
        win = lax.dynamic_slice(payload3, (0, w0, 0), (B, K, band)).reshape(B, K * band)
        dlw = lax.dynamic_slice(dl_tab, (0, w0), (B, K))
        carry = (r, j, st, cnt, nm, nins, ndel, done, w0, win, dlw, ops)
        carry, _ = lax.scan(stepw, carry, None, length=S)
        return carry

    # zero-carries derived from a varying input so the loop state's sharding
    # "varying" type matches the body outputs under shard_map
    z = score & 0
    zu8 = (z & 0).astype(jnp.uint8)
    ops0 = jnp.broadcast_to(zu8[:, None], (B, W)) + jnp.uint8(255)
    win0 = jnp.broadcast_to(
        zu8.astype(payload.dtype)[:, None], (B, K * band)
    ) + payload.dtype.type(0)
    dlw0 = jnp.broadcast_to(zu8[:, None], (B, K)) + jnp.uint8(0)
    walk0 = (ri, bj, z + ST_H, z, z, z, z, score <= 0, jnp.max(z), win0, dlw0, ops0)
    out = lax.while_loop(cond, body, walk0)
    (_, _, _, cnt, nm, nins, ndel, _, _, _, _, ops) = out
    return ops, cnt, nm, nins, ndel


def sw_traceback_from_payload(payload, lo, score, ri, bj, band: int, ops_max: int, maxrun: int):
    """Walk + RLE half of the device traceback (sw_traceback_full)."""
    B = payload.shape[0]
    Lq = lo.shape[1] - 1
    dl_tab = jnp.minimum(lo[:, 1:] - lo[:, :-1], band + 1).astype(jnp.uint8)
    ops, cnt, nm, nins, ndel = _walk_ops(payload, dl_tab, score, ri, bj, band, ops_max)
    W = ops.shape[1]

    q_end = ri
    t_end = jnp.take_along_axis(lo, jnp.clip(ri, 0, Lq)[:, None], axis=1)[:, 0] + bj + 1
    q_start = q_end - (cnt - ndel)
    t_start = t_end - (cnt - nins)

    # reverse (ops were emitted end->start) and run-length encode
    ii = jnp.arange(W)
    rev_idx = cnt[:, None] - 1 - ii[None, :]
    valid = rev_idx >= 0
    ops_f = jnp.take_along_axis(ops, jnp.clip(rev_idx, 0, W - 1), axis=1)
    prev = jnp.concatenate([jnp.full((B, 1), 255, jnp.uint8), ops_f[:, :-1]], axis=1)
    bnd = valid & (ops_f != prev)
    rid = jnp.cumsum(bnd.astype(jnp.int32), axis=1) - 1
    n_runs = bnd.sum(axis=1).astype(jnp.int32)
    rid_c = jnp.clip(rid, 0, maxrun - 1)
    b2 = jnp.arange(B)[:, None]
    run_len = jnp.zeros((B, maxrun), jnp.int32).at[
        b2, jnp.where(valid, rid_c, maxrun)
    ].add(1, mode="drop")
    run_op = jnp.zeros((B, maxrun), jnp.uint32).at[
        b2, jnp.where(bnd, rid_c, maxrun)
    ].set(ops_f.astype(jnp.uint32), mode="drop")
    cigar = (run_len.astype(jnp.uint32) << 4) | run_op
    cigar = jnp.where(ii[None, :maxrun] < jnp.minimum(n_runs, maxrun)[:, None], cigar, 0)

    return {
        "score": score,
        "q_start": q_start,
        "q_end": q_end,
        "t_start": t_start,
        "t_end": t_end,
        "nm": nm,
        "cigar": cigar,
        "n_runs": n_runs,
    }


def forward_meta(q, t, lo, tlens, band: int, kernel: str, smooth: bool = False):
    """sw_forward_meta through the chosen device kernel (align_cuda.dp_kernel):
    "cuda" runs the CUDA kernel, which is exact on any band; "xla" runs the
    scan above (smooth=True asks for its one-shift form on pre-smoothed lo)."""
    if kernel == "cuda":
        from . import align_cuda

        return align_cuda.sw_forward_meta(q, t, lo, tlens, band)
    return sw_forward_meta(q, t, lo, tlens, band=band, smooth=smooth)


def forward_payload(q, t, lo, tlens, band: int, kernel: str):
    """_forward_payload through the chosen device kernel (see forward_meta)."""
    if kernel == "cuda":
        from . import align_cuda

        return align_cuda.forward_payload(q, t, lo, tlens, band)
    return _forward_payload(q, t, lo, tlens, band)


@partial(jax.jit, static_argnames=("band", "ops_max", "maxrun", "kernel"))
def sw_traceback_full(q, t, lo, tlens, band: int, ops_max: int, maxrun: int,
                      kernel: str = "xla"):
    """Batched banded SW with full on-device traceback.

    Inputs as sw_forward_meta; lo is the RAW planner band (arbitrary
    non-decreasing advances — handled exactly).  kernel picks the forward
    (forward_payload); the walk is the XLA loop either way.
    Returns dict with per-pair score/q_start/q_end/t_start/t_end/nm plus
    cigar (B, maxrun) packed u32 and n_runs (n_runs > maxrun = overflow,
    caller re-runs that pair on the host kernel).
    """
    payload, score, ri, bj = forward_payload(q, t, lo, tlens, band, kernel)
    return sw_traceback_from_payload(payload, lo, score, ri, bj, band, ops_max, maxrun)


def sw_pileup_counts(
    q, t, lo, tlens, lvl, hp, off, total_L: int, nq: int,
    band: int, ops_max: int, slots: int = 1, use_hp: bool = False,
    kernel: str = "xla",
):
    """Banded SW + traceback + DIRECT pileup count-matrix scatter, all on
    device — the stage-4 pileup construction (alignment.rs:409-652) with
    only the count matrices leaving the device.

    q/t/lo/tlens as sw_traceback_full, with B = n_pairs * slots rows: each
    group of `slots` consecutive rows are the candidate jobs of one
    (read, consensus) pair (both strands); the winner is the strictly-max
    score with the earliest slot (align_pairs' rule) and only the winner's
    path is scattered.  lvl (B, Lq) int32 = per-ORIENTED-query-base quality
    level; hp (B, Lq) int32 = clamped HP run lengths (use_hp only); off (B,)
    int32 = flat base offset of the pair's consensus (roff[owner]).

    Returns dict of flat count arrays:
        bq   (total_L*nq*2,)  base counts by (pos, qlevel, is_ref)
        dels (total_L,)
        ins  (total_L*nq,)    one event per insertion run @ first-base qlevel
        hph  (total_L*64,)    HP run-length histogram (use_hp)
    exactly matching pipeline/pileup.read_pileup_indices semantics: the
    backward op stream's positions are reconstructed with cumsums, so the
    walk itself is untouched.  kernel picks the forward (forward_payload).
    """
    payload, score, ri, bj = forward_payload(q, t, lo, tlens, band, kernel)
    return _pileup_counts_from_payload(
        payload, lo, score, ri, bj, q, t, lvl, hp, off, tlens,
        total_L, nq, band, ops_max, slots, use_hp,
    )


def _pileup_counts_from_payload(
    payload, lo_pad, score, ri, bj, q, t, lvl, hp, off, tlens,
    total_L: int, nq: int, band: int, ops_max: int, slots: int, use_hp: bool,
):
    """Walk + winner + count-matrix scatter half of sw_pileup_counts."""
    B, Lq = q.shape
    if slots > 1:
        # per-pair winner: max score, earliest slot on ties (the AlignJob
        # path's strictly-greater replacement rule)
        s2 = score.reshape(-1, slots)
        win_col = jnp.argmax(s2, axis=1)  # argmax returns FIRST max
        is_win = (
            jnp.arange(slots)[None, :] == win_col[:, None]
        ).reshape(-1)
        walk_score = jnp.where(is_win, score, 0)
    else:
        walk_score = score

    Lq_pay = lo_pad.shape[1] - 1
    dl_tab = jnp.minimum(lo_pad[:, 1:] - lo_pad[:, :-1], band + 1).astype(jnp.uint8)
    ops, cnt, nm, nins, ndel = _walk_ops(payload, dl_tab, walk_score, ri, bj, band, ops_max)
    W = ops.shape[1]

    q_end = ri
    t_end = jnp.take_along_axis(lo_pad, jnp.clip(ri, 0, Lq_pay)[:, None], axis=1)[:, 0] + bj + 1

    # backward stream -> positions: the i-th backward op consumes
    # t[t_end-1 - #(target-consuming ops before it)] / q[q_end-1 - ...]
    ii = jnp.arange(W)
    valid = ii[None, :] < cnt[:, None]
    adv_t = ((ops != 1) & valid).astype(jnp.int32)
    adv_q = ((ops != 2) & valid).astype(jnp.int32)
    ct = jnp.cumsum(adv_t, axis=1) - adv_t  # exclusive
    cq = jnp.cumsum(adv_q, axis=1) - adv_q
    tpos = t_end[:, None] - 1 - ct
    qpos = q_end[:, None] - 1 - cq
    qi = jnp.clip(qpos, 0, Lq - 1)
    qc = jnp.take_along_axis(q, qi, axis=1)
    tc = jnp.take_along_axis(t, jnp.clip(tpos, 0, t.shape[1] - 1), axis=1)
    lv = jnp.take_along_axis(lvl, qi, axis=1)
    off_b = off[:, None] + tpos  # flat consensus position

    in_t = (tpos >= 0) & (tpos < tlens[:, None])
    is_m = valid & (ops == 0) & in_t & (qpos >= 0)
    is_ref = (qc == tc).astype(jnp.int32)
    bq_idx = jnp.where(is_m, (off_b * nq + lv) * 2 + is_ref, total_L * nq * 2)
    bq = jnp.zeros((total_L * nq * 2,), jnp.int32).at[bq_idx.reshape(-1)].add(
        1, mode="drop"
    )

    is_d = valid & (ops == 2) & in_t
    del_idx = jnp.where(is_d, off_b, total_L)
    dels = jnp.zeros((total_L,), jnp.int32).at[del_idx.reshape(-1)].add(1, mode="drop")

    # insertion events: one per run at the FORWARD-first base = the LAST
    # backward op of each consecutive-1 stretch; attach at tpos (== the
    # host's tp-1), quality of that base (alignment.rs:585-600 semantics
    # via pileup.read_pileup_indices:137-145)
    nxt = jnp.concatenate([ops[:, 1:], jnp.full((B, 1), 255, jnp.uint8)], axis=1)
    i_first = valid & (ops == 1) & ((ii[None, :] + 1 >= cnt[:, None]) | (nxt != 1))
    ins_ok = i_first & in_t & (qpos >= 0)
    ins_idx = jnp.where(ins_ok, off_b * nq + lv, total_L * nq)
    ins = jnp.zeros((total_L * nq,), jnp.int32).at[ins_idx.reshape(-1)].add(
        1, mode="drop"
    )

    out = {"bq": bq, "dels": dels, "ins": ins, "score": score, "nm": nm}
    if use_hp:
        hpv = jnp.take_along_axis(hp, qi, axis=1)
        hp_idx = jnp.where(is_m, off_b * 64 + hpv, total_L * 64)
        out["hph"] = jnp.zeros((total_L * 64,), jnp.int32).at[
            hp_idx.reshape(-1)
        ].add(1, mode="drop")
    return out


def _pack_jobs(jobs, pairs: int):
    """Shared padding for the device wrappers (codes 5/6 never match; lo
    extended flat past the real rows).  Raw planner lo — the kernels handle
    arbitrary band advances exactly (no smoothing).  Rows are padded to a
    multiple of 64, target columns to a multiple of 256 and the batch to
    `pairs` inert pairs, which bounds the number of distinct compiled
    shapes; the padding never changes a result."""
    B = len(jobs)
    Lq = -(-max(len(j.qcodes) for j in jobs) // 64) * 64
    Lt = -(-max(len(j.tcodes) for j in jobs) // 256) * 256
    q = np.full((pairs, Lq), 5, dtype=np.int32)
    t = np.full((pairs, Lt), 6, dtype=np.int32)
    lo = np.zeros((pairs, Lq + 1), dtype=np.int32)
    tlens = np.full(pairs, Lt, dtype=np.int32)
    for i, j in enumerate(jobs):
        q[i, : len(j.qcodes)] = j.qcodes
        t[i, : len(j.tcodes)] = j.tcodes
        lo[i, 1 : len(j.lo) + 1] = j.lo
        lo[i, 0] = j.lo[0]
        if len(j.lo) < Lq:
            lo[i, len(j.lo) + 1 :] = j.lo[-1]
        tlens[i] = len(j.tcodes)
    return q, t, lo, tlens


def _batch_pairs(n_jobs: int, bucket: int) -> int:
    """Pairs a dispatch of n_jobs is padded to: the next power of two, at
    most `bucket` (so a run compiles a handful of batch shapes)."""
    return min(bucket, 1 << max(n_jobs - 1, 0).bit_length())


def sw_traceback_numpy_jobs(jobs, band: int = 128, maxrun: int = 512):
    """Run AlignJobs through the device traceback kernel; returns per-job
    (score, q0, q1, t0, t1, cigar_u32, nm) tuples or None — the run_jobs
    contract.  Pairs whose CIGAR overflows maxrun runs (pathological, >2x
    any observed amplicon alignment) are re-run on the host kernel."""
    if not jobs:
        return []
    results: list[tuple | None] = [None] * len(jobs)
    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    # buckets of 256 length-sorted jobs: chunk boundaries only change
    # padding, so results are identical at any bucket size
    from .align_cuda import dp_kernel

    bucket = 256
    kernel = dp_kernel(band)
    overflow: list[int] = []
    # dispatch every bucket before blocking on any result, then ONE batched
    # device_get for all of them
    chunks: list[list[int]] = []
    outs: list[dict] = []
    for start in range(0, len(order), bucket):
        chunk = order[start : start + bucket]
        cjobs = [jobs[i] for i in chunk]
        q, t, lo, tlens = _pack_jobs(cjobs, _batch_pairs(len(cjobs), bucket))
        chunks.append(chunk)
        outs.append(sw_traceback_full(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(lo), jnp.asarray(tlens),
            band=band, ops_max=q.shape[1] + t.shape[1], maxrun=maxrun, kernel=kernel,
        ))
    hosts = jax.device_get(outs)
    for chunk, host in zip(chunks, hosts):
        for x, i in enumerate(chunk):
            if host["score"][x] <= 0:
                results[i] = None
            elif host["n_runs"][x] > maxrun:
                overflow.append(i)
            else:
                results[i] = (
                    int(host["score"][x]),
                    int(host["q_start"][x]),
                    int(host["q_end"][x]),
                    int(host["t_start"][x]),
                    int(host["t_end"][x]),
                    host["cigar"][x, : host["n_runs"][x]].astype(np.uint32),
                    int(host["nm"][x]),
                )
    if overflow:
        # host redo (the native kernel computes the same raw-band DP, so the
        # result is bit-identical to what the device chose)
        import os

        from .align_batch import run_jobs

        env = os.environ.pop("SAVONT_ALIGN_BACKEND", None)
        try:
            host_res = run_jobs([jobs[i] for i in overflow], band=band)
        finally:
            if env is not None:
                os.environ["SAVONT_ALIGN_BACKEND"] = env
        for i, r in zip(overflow, host_res):
            results[i] = r
    return results


from functools import lru_cache


@lru_cache(maxsize=8)
def _sharded_forward(band: int, kernel: str):
    """jitted shard_map of the forward kernel over the pair ("dp") axis —
    the multi-device path for NM-only scoring batches."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()), ("dp",))

    def fn(q, t, lo, tlens):
        return forward_meta(q, t, lo, tlens, band, kernel)

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp", None), P("dp")),
        out_specs=P("dp"),
    )
    return jax.jit(sharded)


def sw_scores_dispatch(jobs, band: int = 128):
    """Dispatch AlignJobs to the device forward kernel WITHOUT fetching:
    returns the on-device output dict (callers batch several dispatches
    into one jax.device_get)."""
    from .align_cuda import dp_kernel

    n_dev = jax.device_count()
    kernel = dp_kernel(band)
    # the batch is a power of two, and a multiple of the device count
    pairs = _batch_pairs(len(jobs), max(256, len(jobs)))
    q, t, lo, tlens = _pack_jobs(jobs, -(-pairs // n_dev) * n_dev)
    if n_dev > 1:
        # shard the pair axis over the mesh: each device scores its slice
        # of the batch (stage-7 EM / classify scale-out across devices)
        out = _sharded_forward(band, kernel)(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(lo), jnp.asarray(tlens)
        )
    else:
        out = _forward_meta_jit(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(lo), jnp.asarray(tlens),
            band=band, kernel=kernel,
        )
    return out


_forward_meta_jit = jax.jit(forward_meta, static_argnames=("band", "kernel", "smooth"))


def _scores_host_to_dicts(host, B: int) -> list[dict | None]:
    res: list[dict | None] = []
    for i in range(B):
        if host["score"][i] <= 0:
            res.append(None)
        else:
            res.append(
                {
                    "score": int(host["score"][i]),
                    "q_start": int(host["q_start"][i]),
                    "q_end": int(host["q_end"][i]),
                    "t_start": int(host["t_start"][i]),
                    "t_end": int(host["t_end"][i]),
                    "nm": int(host["nm"][i]),
                }
            )
    return res


def sw_scores_numpy_jobs(jobs, band: int = 128):
    """Run AlignJobs through the device kernel; returns per-job dicts
    (score<=0 -> None).  Used by NM-only call sites.  Raw planner bands —
    results are bit-identical to the host kernels on ANY job set (the
    barrel-shift forward handles arbitrary band advances)."""
    if not jobs:
        return []
    out = sw_scores_dispatch(jobs, band)
    return _scores_host_to_dicts(jax.device_get(out), len(jobs))

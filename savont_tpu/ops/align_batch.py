"""Batched banded alignment: many (query, target) jobs filled in one
vectorized DP sweep.

The per-row recurrence is identical to ops/align.py banded_sw, but all
arrays carry a leading batch dimension (B, band), so the Python row loop is
amortized over the whole batch.  Jobs are bucketed by query length.  This
is the host twin of the device kernels in align_jax.py (same math; rows become
lax.scan steps there).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .align import (
    GAP_EXT,
    GAP_OPEN,
    MATCH,
    MISMATCH,
    Mapping,
    TargetIndex,
    _band_centers,
    _chain_anchors,
    _traceback,
    _window_minimizers,
    ascii_to_align_codes,
    evict_half,
)
from .encode import revcomp_bytes

NEG = -20000  # int16-safe sentinel

_QCODE_CACHE: dict[tuple[bytes, int], np.ndarray] = {}
_QCODE_CACHE_MAX = 262144

# bytes-IDENTITY keyed code cache for the big-batch planner path: entry is
# [bytes, fwd_codes, rc_codes|None]; holding the bytes object pins its id.
_IDCODE_CACHE: dict[int, list] = {}
_IDCODE_CACHE_MAX = 400_000


def _qcodes_cached(qb: bytes, strand: int) -> np.ndarray:
    """Oriented query codes, memoized across planning calls: the same read
    is planned against several candidate targets (one group per target), so
    a per-call cache re-encoded every read once per group."""
    key = (qb, strand)
    hit = _QCODE_CACHE.get(key)
    if hit is None:
        if len(_QCODE_CACHE) >= _QCODE_CACHE_MAX:
            evict_half(_QCODE_CACHE)
        if strand == 1:
            from .encode import registered_planner_codes

            hit = registered_planner_codes(qb)
        if hit is None:
            hit = ascii_to_align_codes(qb if strand == 1 else revcomp_bytes(qb))
        _QCODE_CACHE[key] = hit
    return hit


def _qcodes_cached_batch(items: list[tuple[bytes, int]]) -> list[np.ndarray]:
    """Batched _qcodes_cached: all cache misses are encoded through ONE
    concatenated LUT gather (the per-call numpy overhead dominated at tens
    of thousands of small sequences).  Same values, same cache.

    Large one-shot batches (whole-readset planner sweeps like the stage-7
    tie-break) bypass the cache entirely: the per-item bytes-key hashing +
    dict churn costs more than re-encoding, and inserting would clear the
    cache out from under the small repeated batches it serves."""
    from .align import _ASCII_CODE

    out: list[np.ndarray | None] = [None] * len(items)
    if len(items) >= 4096:
        # encode each + strand once; - strands derive from the + codes
        # (reverse + 3-complement, code 4 fixed).  Verified byte-exhaustively
        # equal to ascii_to_align_codes(revcomp_bytes(qb)) for every byte
        # EXCEPT U/u (revcomp_bytes leaves U unchanged while the LUT folds
        # it into T) — sequences containing U take the bytes path.  Skips
        # the second 100+ MB bytes join + LUT pass at scale.
        #
        # Cross-call cache keyed by BYTES IDENTITY: TwinRead.seq_bytes()
        # memoizes one bytes object per read, and every planner stage
        # (stage-4 votes, pileups, stage-5, stage-7) re-encodes the same
        # reads once per slab — 4.7 s of the 100k wall before this cache.
        # Keying by id() is safe because the entry holds the bytes object
        # (pins it: its id can't be reused while the entry lives).
        fwd_ids: dict[bytes, int] = {}
        fwd_of = [fwd_ids.setdefault(qb, len(fwd_ids)) for qb, _st in items]
        bufs = list(fwd_ids.keys())
        n_u = len(bufs)
        fwd: list[np.ndarray | None] = [None] * n_u
        if len(_IDCODE_CACHE) > _IDCODE_CACHE_MAX:
            evict_half(_IDCODE_CACHE)
        ents = [_IDCODE_CACHE.get(id(b)) for b in bufs]
        miss = [i for i, e in enumerate(ents) if e is None or e[0] is not bufs[i]]
        for i, e in enumerate(ents):
            if e is not None and e[0] is bufs[i]:
                fwd[i] = e[1]
        if miss:
            # TwinRead-backed bytes reuse their registered 0..3 codes (the
            # LUT is its exact inverse); only the rest take the join+LUT
            from .align import _encode_queries_registry

            mcodes = _encode_queries_registry([bufs[i] for i in miss])
            for c, i in zip(mcodes, miss):
                fwd[i] = c
                _IDCODE_CACHE[id(bufs[i])] = [bufs[i], c, None]

        # reverse complements: cache hits first, the rest in ONE
        # reversed-span gather + one vectorized complement
        rc: dict[int, np.ndarray] = {}
        rc_miss: list[int] = []
        for (_qb, st), fi in zip(items, fwd_of):
            if st == -1 and fi not in rc:
                e = _IDCODE_CACHE.get(id(bufs[fi]))
                if e is not None and e[0] is bufs[fi] and e[2] is not None:
                    rc[fi] = e[2]
                else:
                    rc[fi] = True  # mark; filled below
                    rc_miss.append(fi)
        if rc_miss:
            rl = np.fromiter((len(bufs[fi]) for fi in rc_miss), np.int64, len(rc_miss))
            roff = np.zeros(len(rc_miss) + 1, dtype=np.int64)
            np.cumsum(rl, out=roff[1:])
            total = int(roff[-1])
            fcat = np.concatenate([fwd[fi] for fi in rc_miss]) if total else np.zeros(0, np.uint8)
            from .kmers_native import revcomp_codes_ranges_native

            rc_cat = revcomp_codes_ranges_native(fcat, roff, threads=4)
            if rc_cat is None:
                # NumPy fallback: reversed span within the concat (start at
                # end of each seq); three full-size temporaries, so the
                # native sweep is preferred at scale
                starts = roff[1:] - 1
                idx = np.repeat(starts + roff[:-1], rl) - np.arange(total, dtype=np.int64)
                rc_cat = fcat[idx]
                np.subtract(3, rc_cat, out=rc_cat, where=rc_cat < 4)
            for i, fi in enumerate(rc_miss):
                qb = bufs[fi]
                if b"U" in qb or b"u" in qb:
                    # revcomp_bytes folds U/u differently than the LUT path
                    r = _ASCII_CODE[np.frombuffer(revcomp_bytes(qb), dtype=np.uint8)]
                else:
                    r = rc_cat[roff[i] : roff[i + 1]]
                rc[fi] = r
                e = _IDCODE_CACHE.get(id(qb))
                if e is not None and e[0] is qb:
                    e[2] = r

        return [
            fwd[fi] if st == 1 else rc[fi]
            for (qb, st), fi in zip(items, fwd_of)
        ]
    miss: list[int] = []
    for x, key in enumerate(items):
        hit = _QCODE_CACHE.get(key)
        if hit is None:
            miss.append(x)
        else:
            out[x] = hit
    if miss:
        bufs = [
            items[x][0] if items[x][1] == 1 else revcomp_bytes(items[x][0])
            for x in miss
        ]
        off = np.zeros(len(bufs) + 1, dtype=np.int64)
        np.cumsum(np.fromiter((len(b) for b in bufs), np.int64, len(bufs)), out=off[1:])
        codes_cat = _ASCII_CODE[np.frombuffer(b"".join(bufs), dtype=np.uint8)]
        for i, x in enumerate(miss):
            if len(_QCODE_CACHE) >= _QCODE_CACHE_MAX:
                evict_half(_QCODE_CACHE)
            # views, not copies: every byte of the concat buffer IS a cache
            # entry (all misses are inserted), so pinning it wastes nothing
            # — and the per-miss .copy() was ~3 us x 100k reads
            c = codes_cat[off[i] : off[i + 1]]
            _QCODE_CACHE[items[x]] = c
            out[x] = c
    return out


@dataclass(slots=True)
class AlignJob:
    """One planned banded alignment (post seeding/chaining)."""

    qcodes: np.ndarray  # oriented query codes (0..4)
    tcodes: np.ndarray  # target codes
    lo: np.ndarray  # per-row band lower bound (int32, len == len(qcodes))
    # metadata to build the Mapping afterwards
    target_id: int
    strand: int
    fwd_qlen: int


def plan_jobs(
    index: TargetIndex,
    query_ascii: bytes | np.ndarray,
    band: int | None = None,
    min_anchors: int = 3,
    no_diag_id: int | None = None,
) -> list[AlignJob]:
    """Seeding + chaining for a query against an index; one job per
    (target, strand) that has a viable chain."""
    from .align import resolve_band

    band = resolve_band(band)
    if isinstance(query_ascii, (bytes, bytearray)):
        qbytes = bytes(query_ascii)
    else:
        qbytes = np.asarray(query_ascii, dtype=np.uint8).tobytes()
    qf = ascii_to_align_codes(qbytes)
    from .align import _group_anchors, window_minimizers_cached

    hq, pq, fq = window_minimizers_cached(qbytes, index.w, index.k)
    qlen = len(qf)

    per_ts = _group_anchors(index, hq, pq, fq, qlen, no_diag_id)

    qr = None
    jobs: list[AlignJob] = []
    for (tid, strand), (qa, ta) in per_ts.items():
        if len(qa) < min_anchors:
            continue
        chain = _chain_anchors(qa, ta)
        if len(chain) < min_anchors:
            continue
        if strand == -1 and qr is None:
            qr = ascii_to_align_codes(revcomp_bytes(qbytes))
        qcodes = qf if strand == 1 else qr
        centers = _band_centers(len(qcodes), qa[chain], ta[chain])
        tcodes = index.targets[tid]
        n = len(tcodes)
        b = min(band, max(8, n))
        lo = np.maximum.accumulate(
            np.clip(centers - b // 2, 0, max(n - b, 0))
        ).astype(np.int32)
        jobs.append(AlignJob(qcodes, tcodes, lo, tid, strand, qlen))
    return jobs


def plan_jobs_batch(
    index: TargetIndex,
    queries: list[bytes],
    band: int | None = None,
    min_anchors: int = 3,
    no_diag: bool = False,
) -> tuple[list[AlignJob], list[int]]:
    """Seeding + chaining for MANY queries against one index in a single
    vectorized lookup pass.  Returns (jobs, owner_query_index)."""
    from .align import resolve_band, window_minimizers_flat_batch

    band = resolve_band(band)

    # gather all query minimizers with query ids (flat pools; large batches
    # bypass the tuple cache — see window_minimizers_flat_batch)
    all_h, all_p, all_f, moff = window_minimizers_flat_batch(
        [bytes(q) for q in queries], index.w, index.k
    )
    if len(all_h) == 0 or len(index.h_sorted) == 0:
        return [], []
    all_p = all_p.astype(np.int32)
    qid = np.repeat(np.arange(len(queries)), np.diff(moff)).astype(np.int32)
    qlens = np.array([len(q) for q in queries], dtype=np.int64)

    # one flat lookup (native binary search when available)
    from .kmers_native import anchor_search_native

    searched = anchor_search_native(index.h_sorted, all_h)
    if searched is not None:
        left, counts, total = searched
    else:
        left = np.searchsorted(index.h_sorted, all_h, side="left")
        right = np.searchsorted(index.h_sorted, all_h, side="right")
        counts = right - left
        total = int(counts.sum())
    if total == 0:
        return [], []

    # dims for the packed u64 sort key (20+14+1+14+14 bits)
    dims_fit = (
        len(queries) < (1 << 20)
        and len(index.targets) < (1 << 14)
        and int(qlens.max(initial=0)) - index.k < (1 << 14)
        and (int(index.h_tpos.max()) if len(index.h_tpos) else 0) < (1 << 14)
    )
    keys = None
    if dims_fit:
        from .kmers_native import anchor_sorted_keys_native

        keys = anchor_sorted_keys_native(
            left, counts, all_p, all_f, qid, qlens,
            index.h_tid, index.h_tpos, index.h_isf,
            index.k, no_diag, threads=4,
        )
    if keys is not None:
        # native path: expansion + no_diag filter + radix sort done in C.
        # Group bounds come straight from the high key bits (qid|tid|strand),
        # so only the anchor coordinates are decoded full-size; the per-group
        # fields decode from the first key of each group.
        if len(keys) == 0:
            return [], []
        hi_bits = keys >> np.uint64(28)
        bounds = np.flatnonzero(np.concatenate(([True], hi_bits[1:] != hi_bits[:-1])))
        grp_off = np.append(bounds, len(keys))
        kb = keys[bounds]
        g_qi = (kb >> np.uint64(43)).astype(np.int64)
        g_tid = ((kb >> np.uint64(29)) & np.uint64(0x3FFF)).astype(np.int64)
        g_st = np.where((kb >> np.uint64(28)) & np.uint64(1), 1, -1).astype(np.int8)
        qp_o = ((keys >> np.uint64(14)) & np.uint64(0x3FFF)).astype(np.int64)
        tpos = (keys & np.uint64(0x3FFF)).astype(np.int64)
    else:
        mi = np.repeat(np.arange(len(all_h)), counts)
        starts = np.repeat(left, counts)
        within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        hidx = starts + within

        h_qid = qid[mi]
        h_tid = index.h_tid[hidx]
        if no_diag:
            keep = h_tid != h_qid
            mi, hidx, h_qid, h_tid = mi[keep], hidx[keep], h_qid[keep], h_tid[keep]
            if len(mi) == 0:
                return [], []
        same = index.h_isf[hidx] == all_f[mi]
        strand = np.where(same, 1, -1).astype(np.int8)
        qp_o = np.where(same, all_p[mi], (qlens[h_qid] - index.k - all_p[mi])).astype(np.int64)
        tpos = index.h_tpos[hidx].astype(np.int64)
        if (
            dims_fit
            and int(qp_o.max(initial=0)) < (1 << 14)
            and int(qp_o.min(initial=0)) >= 0
        ):
            key = (
                (h_qid.astype(np.uint64) << np.uint64(43))
                | (h_tid.astype(np.uint64) << np.uint64(29))
                | ((strand == 1).astype(np.uint64) << np.uint64(28))
                | (qp_o.astype(np.uint64) << np.uint64(14))
                | tpos.astype(np.uint64)
            )
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((tpos, qp_o, strand, h_tid, h_qid))
        h_qid, h_tid, strand, qp_o, tpos = (
            h_qid[order], h_tid[order], strand[order], qp_o[order], tpos[order],
        )
        bounds = np.flatnonzero(
            np.concatenate(
                ([True],
                 (h_qid[1:] != h_qid[:-1]) | (h_tid[1:] != h_tid[:-1]) | (strand[1:] != strand[:-1]))
            )
        )
        grp_off = np.append(bounds, len(h_qid))
        g_qi, g_tid, g_st = h_qid[bounds], h_tid[bounds], strand[bounds]
    t_lens = np.array([len(tc) for tc in index.targets], dtype=np.int64)

    from .kmers_native import chain_band_native, get_scan_lib

    jobs: list[AlignJob] = []
    owners: list[int] = []

    if get_scan_lib() is not None:
        lo_flat, lo_off, nchain = chain_band_native(
            qp_o, tpos, grp_off, qlens[g_qi], t_lens[g_tid], band, min_anchors
        )
        kept = np.flatnonzero(nchain >= min_anchors)
        qcodes_all = _qcodes_cached_batch(
            [(bytes(queries[int(g_qi[g])]), int(g_st[g])) for g in kept]
        )
        for g, qcodes in zip(kept, qcodes_all):
            qi, tid, st = int(g_qi[g]), int(g_tid[g]), int(g_st[g])
            lo = lo_flat[lo_off[g] : lo_off[g] + len(qcodes)]
            jobs.append(AlignJob(qcodes, index.targets[tid], lo, tid, st, int(qlens[qi])))
            owners.append(qi)
        return jobs, owners

    for g in range(len(bounds)):
        s, e = int(grp_off[g]), int(grp_off[g + 1])
        if e - s < min_anchors:
            continue
        qi, tid, st = int(g_qi[g]), int(g_tid[g]), int(g_st[g])
        qa, ta = qp_o[s:e], tpos[s:e]
        chain = _chain_anchors(qa, ta)
        if len(chain) < min_anchors:
            continue
        qcodes = _qcodes_cached(bytes(queries[qi]), st)
        centers = _band_centers(len(qcodes), qa[chain], ta[chain])
        tcodes = index.targets[tid]
        n = len(tcodes)
        b = min(band, max(8, n))
        lo = np.maximum.accumulate(
            np.clip(centers - b // 2, 0, max(n - b, 0))
        ).astype(np.int32)
        jobs.append(AlignJob(qcodes, tcodes, lo, tid, st, int(qlens[qi])))
        owners.append(qi)
    return jobs, owners


def _run_bucket(jobs: list[AlignJob], band: int) -> list[tuple | None]:
    """Vectorized DP over a bucket of jobs with equal padded dims."""
    B = len(jobs)
    Lq = max(len(j.qcodes) for j in jobs)
    q = np.full((B, Lq), 5, dtype=np.uint8)  # 5 = padding, never matches
    tmaxlen = max(len(j.tcodes) for j in jobs)
    t = np.full((B, tmaxlen), 6, dtype=np.uint8)
    lo = np.zeros((B, Lq + 1), dtype=np.int64)
    tlens = np.zeros(B, dtype=np.int64)
    for i, j in enumerate(jobs):
        q[i, : len(j.qcodes)] = j.qcodes
        t[i, : len(j.tcodes)] = j.tcodes
        lo[i, 1 : len(j.lo) + 1] = j.lo
        lo[i, 0] = j.lo[0]
        if len(j.lo) < Lq:
            lo[i, len(j.lo) + 1 :] = j.lo[-1]
        tlens[i] = len(j.tcodes)

    H = np.zeros((B, Lq + 1, band), dtype=np.int16)
    E = np.full((B, Lq + 1, band), NEG, dtype=np.int16)
    F = np.full((B, Lq + 1, band), NEG, dtype=np.int16)
    G = np.zeros((B, Lq + 1, band), dtype=np.int16)

    je = np.arange(band, dtype=np.int64)
    bi = np.arange(B)[:, None]
    ooe = GAP_OPEN + GAP_EXT

    for r in range(1, Lq + 1):
        l = lo[:, r]
        dl = l - lo[:, r - 1]
        cols = l[:, None] + je[None, :]
        valid = cols < tlens[:, None]
        tc = t[bi, np.minimum(cols, tlens[:, None] - 1)]
        qc = q[:, r - 1][:, None]
        s = np.where((tc == qc) & (qc < 4) & (tc < 4), MATCH, MISMATCH).astype(np.int16)

        src = je[None, :] + dl[:, None]
        in_rng = src < band
        src_cl = np.minimum(src, band - 1)
        Hup = np.where(in_rng, H[bi, r - 1, src_cl], NEG)
        Fup = np.where(in_rng, F[bi, r - 1, src_cl], NEG)
        srcd = src - 1
        d_in = (srcd >= 0) & (srcd < band)
        srcd_cl = np.clip(srcd, 0, band - 1)
        Hdiag = np.where(d_in, H[bi, r - 1, srcd_cl], NEG).astype(np.int32)
        # left-of-band diagonal is the free zero boundary only at column 0
        left_edge = (srcd < 0) & (cols == 0)
        Hdiag = np.where(left_edge, 0, Hdiag)

        Fr = np.maximum(Hup.astype(np.int32) - GAP_OPEN, Fup.astype(np.int32)) - GAP_EXT
        Fr = np.maximum(Fr, NEG)
        Gr = np.maximum(np.maximum(0, Hdiag + s), Fr)
        run = np.maximum.accumulate(Gr + GAP_EXT * je[None, :], axis=1)
        Er = np.full((B, band), NEG, dtype=np.int32)
        Er[:, 1:] = run[:, :-1] - ooe - GAP_EXT * je[None, 1:] + GAP_EXT
        Er = np.maximum(Er, NEG)
        Hr = np.maximum(Gr, Er)
        Hr = np.where(valid, Hr, NEG)
        Gr = np.where(valid, Gr, NEG)
        H[:, r] = Hr.astype(np.int16)
        E[:, r] = Er.astype(np.int16)
        F[:, r] = Fr.astype(np.int16)
        G[:, r] = Gr.astype(np.int16)

    out = []
    for i, job in enumerate(jobs):
        m = len(job.qcodes)
        Hi = H[i, 1 : m + 1]
        flat = int(np.argmax(Hi))
        ri, bj = divmod(flat, band)
        ri += 1
        score = int(Hi[ri - 1, bj])
        if score <= 0:
            out.append(None)
            continue
        lo_full = lo[i, : m + 1]
        out.append(
            _traceback(
                H[i, : m + 1].astype(np.int32),
                E[i, : m + 1].astype(np.int32),
                F[i, : m + 1].astype(np.int32),
                G[i, : m + 1].astype(np.int32),
                lo_full,
                job.qcodes,
                job.tcodes,
                ri,
                bj,
                score,
            )
        )
    return out


_JAX_BACKEND = None


def use_jax_backend(enable: bool = True) -> None:
    """Route bucket DP through the device kernel (align_jax)."""
    global _JAX_BACKEND
    if enable:
        from . import align_jax

        _JAX_BACKEND = align_jax
    else:
        _JAX_BACKEND = None


def _pack_seqs(arrs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate code arrays with object-identity dedup: jobs share qcodes
    (per-(query, strand) cache) and tcodes (index.targets), so e.g. stage-7
    packs 8 unique ASV targets once instead of one 1.5kb copy per job.
    Returns (cat, off (B,) i64, lens (B,) i32)."""
    B = len(arrs)
    off = np.empty(B, dtype=np.int64)
    lens = np.empty(B, dtype=np.int32)
    seen: dict[int, tuple[int, int]] = {}
    parts: list[np.ndarray] = []
    total = 0
    for i, arr in enumerate(arrs):
        got = seen.get(id(arr))
        if got is None:
            a = np.asarray(arr, dtype=np.uint8)
            parts.append(a)
            got = (total, len(a))
            seen[id(arr)] = got
            total += len(a)
        off[i], lens[i] = got
    cat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return cat, off, lens


def _run_native(jobs: list[AlignJob], band: int, lib, n_threads: int = 0,
                simd: bool = True) -> list[tuple | None]:
    """Route jobs through the C++ kernel (native/swalign.cpp): the
    inter-pair SIMD traceback batch (sw_tb_batch) when int16 coordinates
    fit, else the per-pair kernel — identical results either way."""
    import ctypes

    B = len(jobs)
    use_simd = simd and not any(
        len(j.qcodes) > 32000 or len(j.tcodes) > 32000 for j in jobs
    )
    if use_simd:
        # length-sort so PBLK lane blocks have similar padded heights
        order = sorted(range(B), key=lambda i: len(jobs[i].qcodes))
        sjobs = [jobs[i] for i in order]
    else:
        order = list(range(B))
        sjobs = jobs
    q_cat, q_off, q_lens = _pack_seqs([j.qcodes for j in sjobs])
    t_cat, t_off, t_lens = _pack_seqs([j.tcodes for j in sjobs])

    max_cigar = 512
    out_meta = np.zeros((B, 8), dtype=np.int32)
    out_cigar = np.zeros((B, max_cigar), dtype=np.uint32)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    if use_simd:
        # raw planner lo, len q_len per pair; per-JOB offsets (q_off may
        # point shared/deduped queries, but every job has its own lo)
        lo_cat = np.ascontiguousarray(np.concatenate([j.lo for j in sjobs]), dtype=np.int32)
        lo_off = np.concatenate(([0], np.cumsum(q_lens[:-1], dtype=np.int64)))
        lib.sw_tb_batch(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
            ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ptr(out_cigar, ctypes.c_uint32),
            ctypes.c_int32(max_cigar), ctypes.c_int32(n_threads),
        )
    else:
        lo_parts, lo_lens = [], []
        for j in sjobs:
            lo_full = np.concatenate(([j.lo[0]], j.lo)).astype(np.int32)
            lo_parts.append(lo_full)
            lo_lens.append(len(lo_full))
        lo_cat = np.concatenate(lo_parts)
        lo_off = np.concatenate(([0], np.cumsum(lo_lens[:-1]))).astype(np.int64)
        lib.sw_banded_batch(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
            ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ptr(out_cigar, ctypes.c_uint32),
            ctypes.c_int32(max_cigar), ctypes.c_int32(n_threads),
        )

    results: list[tuple | None] = [None] * B
    for si, i in enumerate(order):
        score, q0, q1, t0, t1, nm, clen, overflow = (int(x) for x in out_meta[si])
        if score <= 0:
            continue
        if overflow:
            # extremely fragmented alignment: redo on the NumPy path
            results[i] = _run_bucket([jobs[i]], band)[0]
            continue
        results[i] = (score, q0, q1, t0, t1, out_cigar[si, :clen].copy(), nm)
    return results


def _run_native_nm(jobs: list[AlignJob], band: int, lib) -> list[tuple | None]:
    """NM-only jobs through the inter-pair SIMD forward kernel (sw_nm_batch):
    no matrices, no traceback, metadata carried along winning paths — the C++
    twin of align_jax.sw_forward_meta (same tie rules, same results)."""
    import ctypes

    B = len(jobs)
    # int16 metadata planes: fall back to the traceback kernel on huge seqs
    if any(len(j.qcodes) > 32000 or len(j.tcodes) > 32000 for j in jobs):
        return _run_native(jobs, band, lib)
    # sort by query length so PBLK blocks have similar padded heights
    order = sorted(range(B), key=lambda i: len(jobs[i].qcodes))
    sjobs = [jobs[i] for i in order]
    q_cat, q_off, q_lens = _pack_seqs([j.qcodes for j in sjobs])
    t_cat, t_off, t_lens = _pack_seqs([j.tcodes for j in sjobs])
    # raw planner lo (len q_len per pair); per-JOB offsets (q_off may point
    # shared/deduped queries, but every job has its own lo)
    lo_cat = np.ascontiguousarray(
        np.concatenate([j.lo for j in sjobs]), dtype=np.int32
    )
    lo_off = np.concatenate(([0], np.cumsum(q_lens[:-1], dtype=np.int64)))
    out_meta = np.zeros((B, 6), dtype=np.int32)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    lib.sw_nm_batch(
        ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
        ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
        ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
        ctypes.c_int32(B), ctypes.c_int32(band),
        ptr(out_meta, ctypes.c_int32), ctypes.c_int32(0),
    )
    results: list[tuple | None] = [None] * B
    for si, i in enumerate(order):
        score, q0, q1, t0, t1, nm = (int(x) for x in out_meta[si])
        if score > 0:
            results[i] = (score, q0, q1, t0, t1, [], nm)
    return results


def run_jobs(jobs: list[AlignJob], band: int | None = None, bucket: int = 64) -> list[tuple | None]:
    """Run all jobs, bucketed by query length for padding efficiency.

    Backend priority: C++ native kernel > JAX device kernel (if enabled via
    use_jax_backend) > vectorized NumPy.  All three produce identical
    results (tests/test_native.py, tests/test_multichip.py).

    Returns per job: (score, q0, q1, t0, t1, cigar, nm) or None.
    """
    import os

    from .align import resolve_band

    band = resolve_band(band)
    if not jobs:
        return []
    if (
        os.environ.get("SAVONT_ALIGN_BACKEND") == "jax"
        and os.environ.get("SAVONT_DEVICE_TB", "1") != "0"
    ):
        # device traceback: full CIGARs computed on the device (decision
        # bytes + batched walk + on-device RLE), bit-identical to the host
        # kernels INCLUDING raw-band jumps — serves the CIGAR consumers
        # (stage-4 votes, pileups, stage-5 adjusted errors, stage-6 chimera
        # walks).  The forward is the CUDA kernel on a GPU, the XLA scan
        # elsewhere (align_cuda.dp_kernel).  SAVONT_DEVICE_TB=0 keeps CIGAR
        # sites on the host kernel.
        from . import align_jax

        return align_jax.sw_traceback_numpy_jobs(jobs, band)
    from .native_build import get_lib

    lib = get_lib()
    if lib is not None:
        if len(jobs) <= 8192:
            return _run_native(jobs, band, lib)
        # slab after a global length sort: packed transients (lo tables,
        # code pools) stay bounded and SIMD lane blocks stay homogeneous
        order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
        results = [None] * len(jobs)
        for start in range(0, len(order), 8192):
            chunk = order[start : start + 8192]
            for i, r in zip(chunk, _run_native([jobs[i] for i in chunk], band, lib)):
                results[i] = r
        return results

    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    results = [None] * len(jobs)
    for start in range(0, len(order), bucket):
        chunk = order[start : start + bucket]
        res = _run_bucket([jobs[i] for i in chunk], band)
        for i, r in zip(chunk, res):
            results[i] = r
    return results


def run_jobs_nm(jobs: list[AlignJob], band: int | None = None) -> list[tuple | None]:
    """NM-only job execution: routes to the device forward kernel when
    SAVONT_ALIGN_BACKEND=jax (no CIGARs; cigar field is empty)."""
    import os

    from .align import resolve_band

    band = resolve_band(band)
    if not jobs:
        return []
    backend = os.environ.get("SAVONT_ALIGN_BACKEND")
    if backend == "jax" or _JAX_BACKEND is not None:
        import jax as _jax

        from . import align_jax

        bucket = 256  # length-sorted jobs per dispatch (see sw_traceback_numpy_jobs)
        order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
        results: list[tuple | None] = [None] * len(jobs)
        # dispatch every bucket async, then ONE batched device_get
        chunks = [order[s : s + bucket] for s in range(0, len(order), bucket)]
        outs = [
            align_jax.sw_scores_dispatch([jobs[i] for i in chunk], band)
            for chunk in chunks
        ]
        hosts = _jax.device_get(outs)
        for chunk, host in zip(chunks, hosts):
            res = align_jax._scores_host_to_dicts(host, len(chunk))
            for i, r in zip(chunk, res):
                if r is None:
                    results[i] = None
                else:
                    results[i] = (r["score"], r["q_start"], r["q_end"], r["t_start"], r["t_end"], [], r["nm"])
        return results
    from .native_build import get_lib

    lib = get_lib()
    if lib is not None:
        return _run_native_nm(jobs, band, lib)
    return run_jobs(jobs, band)


def align_pairs_nm(
    pairs: list[tuple[bytes, bytes]], band: int | None = None, coords: bool = True
) -> list[Mapping | None]:
    """Batched pair alignment for NM-only consumers (stage-7 tie-break,
    classification): uses the device kernel when enabled.

    coords=False routes the native path through the lighter no-coords DP
    variant: score/nm (and the tie-break winner) are bit-identical, but
    query_start/target_start read 0 — only for callers that ignore spans."""
    import os

    if os.environ.get("SAVONT_ALIGN_BACKEND") in (None, "") and _JAX_BACKEND is None:
        out = _run_soa_slabs(pairs, band, traceback=False, coords=coords)
        if out is not None:
            return out
    all_jobs, owner = _plan_pairs(pairs, band)
    raw = run_jobs_nm(all_jobs, band=band)
    best: list[Mapping | None] = [None] * len(pairs)
    for o, job, r in zip(owner, all_jobs, raw):
        if r is None:
            continue
        (m,) = _jobs_to_mappings([job], [r])
        if best[o] is None or m.score > best[o].score:
            best[o] = m
    return best


def _run_soa_slabs(
    pairs: list[tuple[bytes, bytes]], band: int | None,
    traceback: bool, coords: bool = True,
) -> list[Mapping | None] | None:
    """Slabbed SoA alignment with a 2-stage plan/DP pipeline.

    Slabs bound the planning/DP transients (band tables, code pools) to
    ~100 MB at any input scale; owners never span slabs, so winner
    selection stays slab-local.  The main thread plans slab i+1 while ONE
    worker runs slab i's DP — the DP batch is OMP-parallel internally and
    releases the GIL, so fused per-slab workers only oversubscribed cores.
    Returns None when the SoA path is unavailable (caller falls back to the
    AlignJob path)."""
    import os

    slab = int(os.environ.get("SAVONT_SLAB_SIZE", "8192"))
    if len(pairs) <= slab:
        return _align_pairs_nm_soa(pairs, band, traceback=traceback, coords=coords)
    spans = [(s, min(s + slab, len(pairs))) for s in range(0, len(pairs), slab)]
    pipelined = os.environ.get("SAVONT_SLAB_WORKERS", "2") != "1"
    if not pipelined:
        out_seq: list[Mapping | None] = []
        for s, e in spans:
            part = _align_pairs_nm_soa(pairs[s:e], band, traceback=traceback, coords=coords)
            if part is None:
                return None
            out_seq.extend(part)
        return out_seq
    from concurrent.futures import ThreadPoolExecutor

    parts: list[list[Mapping | None] | None] = []
    failed = False
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        for s, e in spans:
            ctx = _plan_pairs_soa(pairs[s:e], band)
            if fut is not None:
                part = fut.result()
                if part is None:
                    failed = True
                parts.append(part)
                fut = None
            if failed or ctx[4] is None:
                failed = True
                break
            fut = pool.submit(_soa_core_dp, ctx, traceback, coords, False)
        if fut is not None:
            part = fut.result()
            if part is None:
                failed = True
            parts.append(part)
    if failed:
        return None
    return [m for p in parts for m in p]


def align_pairs_nm_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray,
    band: int | None = None, coords: bool = True,
) -> list[Mapping | None]:
    """NM-only alignment of (queries[qi[k]], targets[ti[k]]) per job k —
    the indexed twin of align_pairs_nm for callers that already hold
    unique sequence pools plus index arrays (stage-7 tie-break, classify).
    Skips the per-pair tuple materialization and bytes-keyed dedup of the
    tuple path; results (incl. tie-breaks) are identical."""
    import os

    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    if os.environ.get("SAVONT_ALIGN_BACKEND") in (None, "") and _JAX_BACKEND is None:
        out = _run_indexed_slabs(queries, targets, qi, ti, band, coords)
        if out is not None:
            return out
    # fallback (device backend selected, or an SoA prerequisite missing):
    # materialize tuples and take the standard path
    pairs = [(queries[a], targets[b]) for a, b in zip(qi.tolist(), ti.tolist())]
    return align_pairs_nm(pairs, band=band, coords=coords)


def align_pairs_nm_values_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None = None,
) -> np.ndarray:
    """NM of the best alignment per indexed job as a flat int64 array
    (-1 = no alignment).  Same winners/tie-breaks as align_pairs_nm_indexed
    but with zero per-job Python: no Mapping objects, vectorized winner
    scatter.  For NM-only consumers (stage-7 tie-break)."""
    import os

    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    if os.environ.get("SAVONT_ALIGN_BACKEND") in (None, "") and _JAX_BACKEND is None:
        out = _run_indexed_slabs(queries, targets, qi, ti, band, False, nm_values=True)
        if out is not None:
            return out
    # fallback (device backend, or an SoA prerequisite missing): materialize
    # tuples straight into align_pairs_nm — going through the indexed
    # wrapper would re-run the same gated slab machinery a second time
    pairs = [(queries[a], targets[b]) for a, b in zip(qi.tolist(), ti.tolist())]
    maps = align_pairs_nm(pairs, band=band, coords=False)
    return np.fromiter(
        (m.nm if m is not None else -1 for m in maps), np.int64, len(maps)
    )


def _run_indexed_slabs(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None, coords: bool,
    nm_values: bool = False, traceback: bool = False,
) -> list[Mapping | None] | np.ndarray | None:
    """Slabbed indexed SoA alignment with a 2-stage plan/DP pipeline.

    Each slab's pools are restricted to the sequences it references, so the
    per-slab minimizer scans stay proportional to slab size.  The main
    thread plans slab i+1 while ONE worker runs slab i's DP: the DP batch
    is OMP-parallel internally, so fused per-slab workers (the old scheme)
    only oversubscribed cores — measured at 100k-read stage 7, plan ~4.5 s
    and DP ~2 s run mostly disjoint, and overlapping them takes the call
    from ~6.6 s to ~max(plan, dp)."""
    import os

    def plan_slab(s: int, e: int):
        uq, qi2 = np.unique(qi[s:e], return_inverse=True)
        ut, ti2 = np.unique(ti[s:e], return_inverse=True)
        q_sub = [queries[i] for i in uq.tolist()]
        t_sub = [targets[i] for i in ut.tolist()]
        return _soa_core_plan(q_sub, t_sub, qi2.astype(np.int64),
                              ti2.astype(np.int64), band)

    def dp_slab(ctx):
        return _soa_core_dp(ctx, traceback, coords, nm_values)

    def join(parts):
        return np.concatenate(parts) if nm_values else [m for p in parts for m in p]

    slab = int(os.environ.get("SAVONT_SLAB_SIZE", "8192"))
    n = len(qi)
    if n <= slab:
        return dp_slab(plan_slab(0, n))
    spans = [(s, min(s + slab, n)) for s in range(0, n, slab)]
    # default "2": plan(i+1) on the main thread || DP(i) on one worker.
    # "3" (2 plan workers + 1 DP worker) was measured WORSE on this 4-core
    # VM (100k interleaved A/B: 24.2/24.8 s -> 27.1/34.1 s wall, cpu
    # 52-54 -> 65-80 s): two concurrent OMP-parallel native planner calls
    # thrash the small core count.  Left as an opt-in for larger hosts.
    workers = os.environ.get("SAVONT_SLAB_WORKERS", "2")
    if workers == "1":
        parts = []
        for s, e in spans:
            part = dp_slab(plan_slab(s, e))
            if part is None:
                return None
            parts.append(part)
        return join(parts)
    from concurrent.futures import ThreadPoolExecutor

    if workers == "2":
        # legacy scheme: main thread plans slab i+1 while ONE worker runs
        # slab i's DP
        parts = []
        failed = False
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for s, e in spans:
                ctx = plan_slab(s, e)
                if fut is not None:
                    part = fut.result()
                    if part is None:
                        failed = True
                    parts.append(part)
                    fut = None
                if failed or ctx[4] is None:
                    # planner prerequisite missing: whole call falls back
                    failed = True
                    break
                fut = pool.submit(dp_slab, ctx)
            if fut is not None:
                part = fut.result()
                if part is None:
                    failed = True
                parts.append(part)
        if failed:
            return None
        return join(parts)

    # default: TWO plan workers + ONE DP worker.  Slab plans are fully
    # independent (thread-local native scratch, race-tolerant memo dicts),
    # and a plan is ~1/3 GIL-held numpy/dict glue and ~2/3 GIL-released
    # OMP native calls — so two plans in flight interleave one slab's glue
    # with the other's native sections while the DP worker (OMP-internal)
    # drains contexts.  AHEAD bounds in-flight plan contexts (~tens of MB
    # each).  Slab-local winner selection keeps results order-exact.
    n_slabs = len(spans)
    AHEAD = 3
    parts = [None] * n_slabs
    plan_futs: list = [None] * n_slabs
    dp_futs: list = [None] * n_slabs
    failed = False
    with ThreadPoolExecutor(max_workers=2) as plan_pool, \
            ThreadPoolExecutor(max_workers=1) as dp_pool:
        next_plan = 0

        def pump(limit):
            nonlocal next_plan
            while next_plan < n_slabs and next_plan < limit:
                s, e = spans[next_plan]
                plan_futs[next_plan] = plan_pool.submit(plan_slab, s, e)
                next_plan += 1

        pump(AHEAD)
        for i in range(n_slabs):
            ctx = plan_futs[i].result()
            plan_futs[i] = None
            if ctx[4] is None:
                failed = True
                break
            dp_futs[i] = dp_pool.submit(dp_slab, ctx)
            pump(i + 1 + AHEAD)
            if i >= 1:
                parts[i - 1] = dp_futs[i - 1].result()
                dp_futs[i - 1] = None
                if parts[i - 1] is None:
                    failed = True
                    break
        if not failed:
            parts[n_slabs - 1] = dp_futs[n_slabs - 1].result()
            dp_futs[n_slabs - 1] = None
            if parts[n_slabs - 1] is None:
                failed = True
        else:
            # drain stragglers so the pools can shut down cleanly
            for f in plan_futs + dp_futs:
                if f is not None:
                    f.result()
    if failed:
        return None
    return join(parts)


def _align_pairs_nm_soa(
    pairs: list[tuple[bytes, bytes]], band: int, traceback: bool = False,
    coords: bool = True,
) -> list[Mapping | None] | None:
    """Struct-of-arrays pair alignment: planning, DP dispatch and winner
    selection run on flat arrays with no per-job Python objects.  Returns
    None when a prerequisite is missing (native libs, packed-key dims), so
    the caller can fall back to the AlignJob path.  Results are identical
    to the legacy path including tie-breaks (tests/test_native.py).

    traceback=True routes through sw_tb_batch and fills Mapping.cigar
    (packed u32), serving the align_pairs consumers (stage-4 vote, pileups,
    stage-5 merge); pairs whose winning job overflows the fixed CIGAR
    buffer are re-done on the legacy per-pair path (identical results)."""
    if not pairs:
        return []
    return _soa_core_dp(_plan_pairs_soa(pairs, band), traceback, coords, False)


def _plan_pairs_soa(pairs: list[tuple[bytes, bytes]], band: int | None):
    """Dedup + planning half of _align_pairs_nm_soa (ctx for _soa_core_dp)."""
    # unique targets and unique queries, both keyed by bytes; one flat
    # "job" per input pair (job id = pair index)
    tgt_ids: dict[bytes, int] = {}
    qry_ids: dict[bytes, int] = {}
    job_uq_list: list[int] = []  # per pair: unique-query id
    job_ti_list: list[int] = []  # per pair: unique-target id
    for qa, ta in pairs:
        tb = bytes(ta) if isinstance(ta, (bytes, bytearray)) else np.asarray(ta, dtype=np.uint8).tobytes()
        qb = bytes(qa) if isinstance(qa, (bytes, bytearray)) else np.asarray(qa, dtype=np.uint8).tobytes()
        job_ti_list.append(tgt_ids.setdefault(tb, len(tgt_ids)))
        job_uq_list.append(qry_ids.setdefault(qb, len(qry_ids)))
    return _soa_core_plan(
        list(qry_ids.keys()), list(tgt_ids.keys()),
        np.asarray(job_uq_list, dtype=np.int64),
        np.asarray(job_ti_list, dtype=np.int64),
        band,
    )


def _soa_core_plan(
    qry_bytes: list[bytes], tgt_bytes: list[bytes],
    job_uq_arr: np.ndarray, job_ti_arr: np.ndarray, band: int | None,
):
    """Planning half of _align_soa_core: returns an opaque ctx for
    _soa_core_dp.  Split out so slab runners can overlap one slab's
    planning with the previous slab's DP (the DP batch releases the GIL
    and is OMP-parallel internally)."""
    plan = _plan_soa_indexed(qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, band)
    return (qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, plan)


def _soa_core_dp(
    ctx, traceback: bool, coords: bool, nm_values: bool,
) -> list[Mapping | None] | np.ndarray | None:
    """DP + winner-selection half of _align_soa_core over a _soa_core_plan
    ctx.  Returns None when the planner prerequisite was missing (caller
    falls back to the per-pair path)."""
    qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, plan = ctx
    n_pairs = len(job_uq_arr)
    _miss = np.full(n_pairs, -1, dtype=np.int64) if nm_values else None
    if nm_values:
        assert not traceback
    if plan is None:
        if nm_values:
            return None if n_pairs else _miss
        return None if n_pairs else []
    if plan == "empty":
        return _miss if nm_values else [None] * n_pairs
    (owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
     t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, band) = plan
    from .native_build import get_lib

    lib = get_lib()
    return _soa_dp_and_winners(
        lib, qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, n_pairs, band,
        traceback, coords, nm_values, _miss,
        owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
        t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all,
    )


def _align_soa_core(
    qry_bytes: list[bytes], tgt_bytes: list[bytes],
    job_uq_arr: np.ndarray, job_ti_arr: np.ndarray,
    band: int, traceback: bool = False, coords: bool = True,
    nm_values: bool = False,
) -> list[Mapping | None] | np.ndarray | None:
    """SoA planning + DP + winner selection over indexed jobs: job k aligns
    qry_bytes[job_uq_arr[k]] against tgt_bytes[job_ti_arr[k]].  Every entry
    of qry_bytes is minimizer-scanned, so callers should pass only used
    sequences.  Returns one Mapping|None per job (or, with nm_values=True,
    one flat int64 NM array with -1 = unaligned — no Mapping objects), or
    None when a prerequisite is missing (caller falls back)."""
    ctx = _soa_core_plan(qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, band)
    return _soa_core_dp(ctx, traceback, coords, nm_values)


def _plan_soa_indexed(
    qry_bytes: list[bytes], tgt_bytes: list[bytes],
    job_uq_arr: np.ndarray, job_ti_arr: np.ndarray,
    band: int | None, min_anchors: int = 2,
):
    """SoA planning (minimizers -> anchors -> chains -> band corridors) for
    indexed jobs, shared by the host DP dispatcher and the mesh/device
    packers.  Returns None when a prerequisite is missing (caller falls
    back to the per-pair path), the string "empty" when no job yields a
    chain, else the flat plan tuple
      (owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
       t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, band)
    where job k of the plan aligns oriented query codes
    q_cat[q_off_j[k] : q_off_j[k]+q_lens_j[k]] against target codes
    t_cat[t_off_j[k] : ...] inside the corridor lo_flat[lo_off_j[k] : ...],
    and owner_j[k] is the input job index it belongs to.  Plan order is the
    legacy per-pair order (pair asc, strand - then +) so earliest-job
    tie-breaks match align_pairs_nm exactly."""
    from .align import resolve_band, window_minimizers_flat_batch

    band = resolve_band(band)
    from .kmers_native import (
        chain_band_native,
        get_scan_lib,
        get_sort_lib,
    )
    from .native_build import get_lib

    lib = get_lib()
    n_pairs = len(job_uq_arr)
    if lib is None or get_scan_lib() is None or get_sort_lib() is None or not n_pairs:
        return None

    if n_pairs >= (1 << 21):
        return None  # job id field: key bits 43..63
    # ONE length pass per pool (the any()/max() genexpr quartet re-walked
    # every bytes object four times per slab)
    qlens_all = np.fromiter((len(q) for q in qry_bytes), np.int64, len(qry_bytes))
    tlens_all = np.fromiter((len(t) for t in tgt_bytes), np.int64, len(tgt_bytes))
    max_qlen = int(qlens_all.max()) if len(qlens_all) else 0
    max_tlen = int(tlens_all.max()) if len(tlens_all) else 0
    if max_qlen > 32000 or max_tlen > 32000:
        return None  # int16 metadata planes in sw_nm_batch
    if max_qlen >= (1 << 14) + 15 or max_tlen >= (1 << 14):
        return None  # packed anchor key field widths

    # one minimizer pass over unique queries, straight into flat pools
    # (large batches bypass the tuple cache, see window_minimizers_flat_batch);
    # one single-target index each (all target scans batched in one native call)
    pool_h, pool_p, pool_f, q_moff = window_minimizers_flat_batch(qry_bytes, 10, 15)
    indexes = TargetIndex.build_singletons(tgt_bytes)
    from .kmers_native import anchor_search_multi_native

    # concatenated per-target tables (singleton tables carry tid = 0, so the
    # packed keys' tid field stays 0 and group identity lives in the job id)
    tab_off = np.zeros(len(indexes) + 1, dtype=np.int64)
    np.cumsum([len(ix.h_sorted) for ix in indexes], out=tab_off[1:])
    h_cat = np.concatenate([ix.h_sorted for ix in indexes]) if indexes else np.zeros(0, U64)
    tpos_cat = np.concatenate([ix.h_tpos for ix in indexes]) if indexes else np.zeros(0, np.int32)
    isf_cat = np.concatenate([ix.h_isf for ix in indexes]) if indexes else np.zeros(0, bool)
    tid_cat = np.zeros(len(h_cat), dtype=np.int32)

    # flat query-minimizer stream over all jobs (pairs), tagged with the
    # job's target table; lookups + key packing + ONE global radix sort.
    # Sorted keys have the job id in the top bits, so key runs appear in
    # ascending pair order (within a pair: strand - then +), matching the
    # legacy plan order for tie-breaks.
    if int(q_moff[-1]) == 0:
        return "empty"
    # fused indexed anchor planning: job j probes its unique query's POOLED
    # minimizers against its target table and emits packed sorted keys
    # directly (strand- reverse-mini then strand+ forward per job, jobs
    # ascending — identical key stream to the expanded path below, which
    # the parity test pins).  The host-side per-job expansion (np.repeat +
    # gathers to tens of millions of elements at 100k reads) disappears.
    from .kmers_native import anchor_keys_indexed_native

    keys = anchor_keys_indexed_native(
        h_cat, tab_off, pool_h, pool_p, pool_f, q_moff,
        job_uq_arr, job_ti_arr, qlens_all, tpos_cat, isf_cat,
        indexes[0].k if indexes else 15, threads=4,
    )
    if keys is None:
        # expansion fallback (older .so without the fused entry points)
        q_mcnt = np.diff(q_moff)
        mini_counts = q_mcnt[job_uq_arr]
        total_minis = int(mini_counts.sum())
        if total_minis == 0:
            return "empty"
        job_moff = np.zeros(n_pairs + 1, dtype=np.int64)  # per-job mini ranges
        np.cumsum(mini_counts, out=job_moff[1:])
        job_off = job_moff[:-1]  # exclusive scan
        flat = np.repeat(q_moff[job_uq_arr] - job_off, mini_counts)
        flat += np.arange(total_minis, dtype=np.int64)
        all_h = pool_h[flat]
        all_p = pool_p[flat].astype(np.int32)
        all_f = pool_f[flat]
        gid = np.repeat(job_ti_arr, mini_counts).astype(np.int32)
        found = anchor_search_multi_native(h_cat, tab_off, gid, all_h)
        if found is None:
            return None
        left, counts, total = found
        if total == 0:
            return "empty"
        # singleton tables: tid bits are constant 0, so keys collapse to
        # (jid << 29 | strand | qp | tpos) emitted directly in sorted order.
        from .kmers_native import anchor_sorted_keys_singleton_native

        keys = anchor_sorted_keys_singleton_native(
            left, counts, job_moff, all_p, all_f, qlens_all[job_uq_arr],
            tpos_cat, isf_cat, indexes[0].k if indexes else 15, threads=4,
        )
        if keys is None:
            return None
    if len(keys) == 0:
        return "empty"
    hi_bits = keys >> np.uint64(28)
    bounds = np.flatnonzero(np.concatenate(([True], hi_bits[1:] != hi_bits[:-1])))
    sizes_all = np.diff(np.append(bounds, len(keys)))
    kb = keys[bounds]
    g_job = (kb >> np.uint64(29)).astype(np.int64)
    qa_all = ((keys >> np.uint64(14)) & np.uint64(0x3FFF)).astype(np.int64)
    ta_all = (keys & np.uint64(0x3FFF)).astype(np.int64)
    grp_off = np.zeros(len(sizes_all) + 1, dtype=np.int64)
    np.cumsum(sizes_all, out=grp_off[1:])
    owner_g = g_job
    uq_g = job_uq_arr[g_job]
    st_g = np.where((kb >> np.uint64(28)) & np.uint64(1), 1, -1).astype(np.int8)
    tid_g = job_ti_arr[g_job]

    # one chaining/band-planning pass over every (pair, strand) group
    lo_flat, lo_off_g, nchain = chain_band_native(
        qa_all, ta_all, grp_off, qlens_all[uq_g], tlens_all[tid_g], band, min_anchors
    )
    kept = np.flatnonzero(nchain >= min_anchors)
    if len(kept) == 0:
        return "empty"

    owner_j = owner_g[kept]
    uq_j = uq_g[kept]
    st_j = st_g[kept]
    tid_j = tid_g[kept]
    q_lens_j = qlens_all[uq_j].astype(np.int32)
    lo_off_j = lo_off_g[kept]

    # code pools: encode each used (query, strand) / target exactly once.
    # combo ids are dense (< 2 * n_queries), so a flag + rank table gives
    # unique/inverse in O(n + nq) instead of np.unique's sort
    combo = uq_j * 2 + (st_j == 1)
    flags = np.zeros(2 * len(qry_bytes), dtype=bool)
    flags[combo] = True
    ucombo = np.flatnonzero(flags)
    rank = np.cumsum(flags) - 1
    inv = rank[combo]
    combo_codes = _qcodes_cached_batch(
        [(qry_bytes[cb >> 1], 1 if cb & 1 else -1) for cb in ucombo.tolist()]
    )
    combo_lens = np.fromiter((len(c) for c in combo_codes), np.int64, len(combo_codes))
    combo_off = np.zeros(len(combo_codes) + 1, dtype=np.int64)
    np.cumsum(combo_lens, out=combo_off[1:])
    q_cat = np.concatenate(combo_codes) if combo_codes else np.zeros(0, np.uint8)
    q_off_j = combo_off[inv]

    t_codes = [idx.targets[0] for idx in indexes]
    t_lens_all = tlens_all  # codes are 1:1 with target bytes
    t_off_all = np.zeros(len(t_codes) + 1, dtype=np.int64)
    np.cumsum(t_lens_all, out=t_off_all[1:])
    t_cat = np.concatenate(t_codes) if t_codes else np.zeros(0, np.uint8)
    t_off_j = t_off_all[tid_j]
    t_lens_j = t_lens_all[tid_j].astype(np.int32)
    return (
        owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
        t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, band,
    )


def _soa_dp_and_winners(
    lib, qry_bytes, tgt_bytes, job_uq_arr, job_ti_arr, n_pairs, band,
    traceback, coords, nm_values, _miss,
    owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
    t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all,
):
    """DP dispatch + vectorized winner selection over a _plan_soa_indexed
    plan (the back half of the historical _align_soa_core)."""
    # DP dispatch, length-sorted for even SIMD lane blocks (stable order
    # keeps the legacy tie-break: first job in plan order wins ties)
    import ctypes

    B = len(owner_j)
    order = np.argsort(q_lens_j, kind="stable")
    out_meta = np.zeros((B, 6), dtype=np.int32)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    q_off_s = np.ascontiguousarray(q_off_j[order])
    q_lens_s = np.ascontiguousarray(q_lens_j[order])
    t_off_s = np.ascontiguousarray(t_off_j[order])
    t_lens_s = np.ascontiguousarray(t_lens_j[order])
    lo_off_s = np.ascontiguousarray(lo_off_j[order])
    cig = cig_row = None
    if traceback:
        max_cigar = 512
        out_meta = np.zeros((B, 8), dtype=np.int32)
        # empty, not zeros: the kernel writes exactly clen entries per row
        # and readers slice [:clen]; winners read through the inverse
        # permutation instead of scattering the whole (B, 512) matrix back
        out_cigar = np.empty((B, max_cigar), dtype=np.uint32)
        lib.sw_tb_batch(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off_s, ctypes.c_int64), ptr(q_lens_s, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off_s, ctypes.c_int64), ptr(t_lens_s, ctypes.c_int32),
            ptr(lo_flat, ctypes.c_int32), ptr(lo_off_s, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ptr(out_cigar, ctypes.c_uint32),
            ctypes.c_int32(max_cigar), ctypes.c_int32(0),
        )
        meta = np.empty_like(out_meta)
        meta[order] = out_meta
        cig = out_cigar
        cig_row = np.empty(B, dtype=np.int64)
        cig_row[order] = np.arange(B, dtype=np.int64)
    else:
        nm_fn = lib.sw_nm_batch if coords else lib.sw_nm_batch_nc
        nm_fn(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off_s, ctypes.c_int64), ptr(q_lens_s, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off_s, ctypes.c_int64), ptr(t_lens_s, ctypes.c_int32),
            ptr(lo_flat, ctypes.c_int32), ptr(lo_off_s, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ctypes.c_int32(0),
        )
        meta = np.empty_like(out_meta)
        meta[order] = out_meta

    # vectorized winner selection: per pair, max score, first job on ties
    score = meta[:, 0]
    ok = np.flatnonzero(score > 0)
    best: list[Mapping | None] = [None] * n_pairs
    if len(ok) == 0:
        return _miss if nm_values else best
    sel = np.lexsort((ok, -score[ok], owner_j[ok]))
    ow = owner_j[ok][sel]
    first = sel[np.flatnonzero(np.concatenate(([True], ow[1:] != ow[:-1])))]
    redo: set[int] = set()
    if traceback:
        # a pair with ANY CIGAR-overflowing job gets redone on the legacy
        # per-pair path (same results; extremely fragmented alignments)
        for j in np.flatnonzero(meta[:, 7] > 0):
            redo.add(int(owner_j[j]))
    jj = ok[first]
    if nm_values:
        # flat NM winners, fully vectorized (no Mapping objects; the nm
        # path never sets redo — CIGAR overflow is traceback-only)
        _miss[owner_j[jj]] = meta[jj, 5].astype(np.int64)
        return _miss
    rows = meta[jj].tolist()  # python ints in one pass (no per-scalar int())
    owners_w = owner_j[jj].tolist()
    sts_w = st_j[jj].tolist()
    fqls_w = qlens_all[uq_j[jj]].tolist()
    for x, j in enumerate(jj):
        o = owners_w[x]
        if o in redo:
            continue
        s, q0, q1, t0, t1, nm = rows[x][:6]
        st = sts_w[x]
        fql = fqls_w[x]
        fq0, fq1 = (q0, q1) if st == 1 else (fql - q1, fql - q0)
        cigar = cig[cig_row[j], : rows[x][6]].copy() if traceback else []
        best[o] = Mapping(
            target_id=0, strand=st, query_start=fq0, query_end=fq1,
            target_start=t0, target_end=t1, nm=nm, cigar=cigar, score=s,
        )
    for o in sorted(redo):
        pair_o = (qry_bytes[job_uq_arr[o]], tgt_bytes[job_ti_arr[o]])
        jobs_o, owner_o = _plan_pairs([pair_o], band)
        raw_o = run_jobs(jobs_o, band=band)
        best_o: Mapping | None = None
        for job, r in zip(jobs_o, raw_o):
            if r is None:
                continue
            (m,) = _jobs_to_mappings([job], [r])
            if best_o is None or m.score > best_o.score:
                best_o = m
        best[o] = best_o
    return best


def _jobs_to_mappings(jobs: list[AlignJob], raw: list[tuple | None]) -> list[Mapping]:
    out = []
    for job, r in zip(jobs, raw):
        if r is None:
            continue
        score, q0, q1, t0, t1, cigar, nm = r
        if job.strand == 1:
            fq0, fq1 = q0, q1
        else:
            fq0, fq1 = job.fwd_qlen - q1, job.fwd_qlen - q0
        out.append(
            Mapping(
                target_id=job.target_id, strand=job.strand, query_start=fq0,
                query_end=fq1, target_start=t0, target_end=t1, nm=nm,
                cigar=cigar, score=score,
            )
        )
    return out


def map_batch(
    index: TargetIndex,
    queries: list[bytes | np.ndarray],
    band: int | None = None,
    min_anchors: int = 3,
    max_hits: int | None = None,
    no_diag: bool = False,
) -> list[list[Mapping]]:
    """Map many queries against one index with batched DP.

    Returns per query a hit list sorted like align.map_query (best first,
    one per target, mapq>0 iff unique best)."""
    all_jobs, job_owner = plan_jobs_batch(
        index, [bytes(q) if isinstance(q, (bytes, bytearray)) else np.asarray(q, dtype=np.uint8).tobytes() for q in queries],
        band=band, min_anchors=min_anchors, no_diag=no_diag,
    )
    raw = run_jobs(all_jobs, band=band)

    per_query: dict[int, list[tuple[AlignJob, tuple]]] = {}
    for owner, job, r in zip(job_owner, all_jobs, raw):
        if r is not None:
            per_query.setdefault(owner, []).append((job, r))

    results: list[list[Mapping]] = []
    for qi in range(len(queries)):
        pairs = per_query.get(qi, [])
        best_by_target: dict[int, Mapping] = {}
        for job, r in pairs:
            (m,) = _jobs_to_mappings([job], [r]) or (None,)
            if m is None:
                continue
            prev = best_by_target.get(m.target_id)
            if prev is None or m.score > prev.score:
                best_by_target[m.target_id] = m
        hits = sorted(best_by_target.values(), key=lambda m: (-m.score, m.target_id))
        for i, m in enumerate(hits):
            m.is_primary = i == 0
            m.mapq = 60 if (i == 0 and (len(hits) < 2 or hits[1].score < m.score)) else 0
        if max_hits is not None:
            hits = hits[:max_hits]
        results.append(hits)
    return results


def _plan_pairs(pairs: list[tuple[bytes, bytes]], band: int) -> tuple[list[AlignJob], list[int]]:
    """Plan independent pairs: group queries by unique target so each target
    is indexed once and its queries planned in one batch."""
    groups: dict[bytes, tuple[TargetIndex, list[int]]] = {}
    for i, (qa, ta) in enumerate(pairs):
        tb = bytes(ta) if isinstance(ta, (bytes, bytearray)) else np.asarray(ta, dtype=np.uint8).tobytes()
        g = groups.get(tb)
        if g is None:
            g = (TargetIndex([tb]), [])
            groups[tb] = g
        g[1].append(i)
    all_jobs: list[AlignJob] = []
    owner: list[int] = []
    for idx, pair_ids in groups.values():
        qbytes = [
            bytes(pairs[i][0]) if isinstance(pairs[i][0], (bytes, bytearray)) else np.asarray(pairs[i][0], dtype=np.uint8).tobytes()
            for i in pair_ids
        ]
        jobs, owners_local = plan_jobs_batch(idx, qbytes, band=band, min_anchors=2)
        all_jobs.extend(jobs)
        owner.extend(pair_ids[o] for o in owners_local)
    return all_jobs, owner


def nm_score_for_plan_jobs(plan, sel: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Host-native (score, nm) for SELECTED jobs of a _plan_soa_indexed
    plan, on the RAW planner corridors (the host oracle).  Used by device
    dispatchers to realign pairs whose smoothed corridor lags too far
    behind the raw band (smooth_lo_max_lag gate) — returns None when the
    native kernel is unavailable (callers keep the ungated device result)."""
    import ctypes

    from .native_build import get_lib

    lib = get_lib()
    if lib is None or len(sel) == 0:
        return None
    (_owner_j, _uq_j, _st_j, _tid_j, q_cat, q_off_j, q_lens_j,
     t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, _qlens_all, band) = plan

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    B = len(sel)
    q_off_s = np.ascontiguousarray(q_off_j[sel])
    q_lens_s = np.ascontiguousarray(q_lens_j[sel])
    t_off_s = np.ascontiguousarray(t_off_j[sel])
    t_lens_s = np.ascontiguousarray(t_lens_j[sel])
    lo_off_s = np.ascontiguousarray(lo_off_j[sel])
    out_meta = np.zeros((B, 6), dtype=np.int32)
    lib.sw_nm_batch_nc(
        ptr(q_cat, ctypes.c_uint8), ptr(q_off_s, ctypes.c_int64), ptr(q_lens_s, ctypes.c_int32),
        ptr(t_cat, ctypes.c_uint8), ptr(t_off_s, ctypes.c_int64), ptr(t_lens_s, ctypes.c_int32),
        ptr(lo_flat, ctypes.c_int32), ptr(lo_off_s, ctypes.c_int64),
        ctypes.c_int32(B), ctypes.c_int32(band),
        ptr(out_meta, ctypes.c_int32), ctypes.c_int32(0),
    )
    return out_meta[:, 0].astype(np.int64), out_meta[:, 5].astype(np.int64)


def align_pairs_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None = None,
) -> list[Mapping | None]:
    """Traceback alignment of (queries[qi[k]], targets[ti[k]]) per job k —
    the indexed twin of align_pairs for callers that already hold unique
    sequence pools plus index arrays (stage-4 vote rounds, pileups).  Skips
    the per-pair tuple materialization and bytes-keyed dedup of the tuple
    path; results (incl. CIGARs and tie-breaks) are identical."""
    import os

    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    if os.environ.get("SAVONT_ALIGN_BACKEND") in (None, "") and _JAX_BACKEND is None:
        out = _run_indexed_slabs(queries, targets, qi, ti, band, True,
                                 traceback=True)
        if out is not None:
            return out
    pairs = [(queries[a], targets[b]) for a, b in zip(qi.tolist(), ti.tolist())]
    return align_pairs(pairs, band=band)


def align_pairs(pairs: list[tuple[bytes, bytes]], band: int | None = None) -> list[Mapping | None]:
    """Batched independent pair alignments.  Targets are deduplicated so a
    seed/consensus aligned against many reads is indexed once.

    Prefers the struct-of-arrays planner+DP path (no per-job Python
    objects) with the inter-pair SIMD traceback kernel; falls back to the
    AlignJob path when native libs or packed-key dims are missing.  Both
    produce identical Mappings including CIGARs (tests/test_native.py).
    SAVONT_ALIGN_BACKEND=jax routes through the device traceback kernel
    (align_jax.sw_traceback_numpy_jobs) via run_jobs."""
    import os

    if os.environ.get("SAVONT_ALIGN_BACKEND") in (None, "") and _JAX_BACKEND is None:
        out = _run_soa_slabs(pairs, band, traceback=True)
        if out is not None:
            return out
    all_jobs, owner = _plan_pairs(pairs, band)
    raw = run_jobs(all_jobs, band=band)
    best: list[Mapping | None] = [None] * len(pairs)
    for o, job, r in zip(owner, all_jobs, raw):
        if r is None:
            continue
        (m,) = _jobs_to_mappings([job], [r])
        if best[o] is None or m.score > best[o].score:
            best[o] = m
    return best

"""Vectorized pileup representation for stage 4.

Instead of per-position Python lists of base entries, each consensus keeps
count MATRICES over (position, quality level, is_ref) — the exact sufficient
statistics for the reference's quality calibration (alignment.rs:656-779)
and Bayesian posterior (alignment.rs:936-1021).  CIGARs are expanded to
per-base op arrays and scattered with bincount, so pileup construction is
a handful of vector ops per read.  This is also the representation the device
path scatters into.

Quality levels: the expanded binned qualities take exactly the 16 values
33 + 3*level (QualCompact3), so level = (q - 33) / 3.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

import numpy as np

from ..config import ClusterArgs
from ..constants import DEFAULT_ERR_RATE, MAX_SEQS_CONSENSUS
from ..core import ConsensusSequence, TwinRead
from ..ops.encode import (
    homopolymer_compress,
    homopolymer_compress_with_quality,
    revcomp_bytes,
)

log = logging.getLogger("savont")

NQ = 21  # quality levels 0..20 cover ASCII 33..93 (levels beyond 15 from FASTA q=60 etc.)


def qlevel(q: np.ndarray | int):
    return np.clip((np.asarray(q).astype(np.int32) - 33) // 3, 0, NQ - 1)


def qvalue(level: int) -> int:
    return 33 + 3 * level


@dataclass
class PileupMatrix:
    """Per-consensus pileup counts."""

    ref: np.ndarray  # (L,) ASCII ref bases
    bq: np.ndarray  # (L, NQ, 2) base counts by quality level x [nonref, ref]
    dels: np.ndarray  # (L,)
    ins_q: np.ndarray  # (L, NQ) insertion events by FIRST-base quality level
    hp_hist: np.ndarray | None = None  # (L, 64) run-length histogram (use_hpc)
    start: int = 0  # trim window [start, end) set by analyze
    end: int = 0

    def depth(self) -> np.ndarray:
        return self.bq.sum(axis=(1, 2)) + self.dels + self.ins_q.sum(axis=1)


def _expand_cigar(cigar) -> np.ndarray:
    from ..ops.align import cigar_lens_ops

    lens, ops = cigar_lens_ops(cigar)
    return np.repeat(ops, lens)


def batched_cigar_walk(cigars: list[np.ndarray], t_starts, q_starts):
    """Expand MANY packed CIGARs into per-base op/position streams in one
    numpy pass (segmented cumsums over the concatenated runs).

    Returns (ops, tpos, qpos, base_read, run_read, run_lens, run_ops,
    run_start): per-base arrays indexed by global base position, plus
    per-run metadata for run-level consumers (insertion events)."""
    from ..ops.align import cigar_lens_ops

    n = len(cigars)
    n_runs = np.fromiter((len(c) for c in cigars), np.int64, n)
    cg = np.concatenate(cigars) if n else np.zeros(0, np.uint32)
    run_read = np.repeat(np.arange(n), n_runs)
    run_lens, run_ops = cigar_lens_ops(cg)
    ops = np.repeat(run_ops, run_lens)
    base_read = np.repeat(run_read, run_lens)
    t_adv = (ops != 1).astype(np.int64)
    q_adv = (ops != 2).astype(np.int64)
    Et = np.cumsum(t_adv) - t_adv  # exclusive scans
    Eq = np.cumsum(q_adv) - q_adv
    base_cnt = np.bincount(base_read, minlength=n) if len(base_read) else np.zeros(n, np.int64)
    start_idx = np.cumsum(base_cnt) - base_cnt
    safe = np.minimum(start_idx, max(len(ops) - 1, 0)).astype(np.int64)
    Et_base = Et[safe] if len(ops) else np.zeros(n, np.int64)
    Eq_base = Eq[safe] if len(ops) else np.zeros(n, np.int64)
    ts = np.asarray(t_starts, dtype=np.int64)
    qs = np.asarray(q_starts, dtype=np.int64)
    tpos = ts[base_read] + Et - Et_base[base_read]
    qpos = qs[base_read] + Eq - Eq_base[base_read]
    run_start = np.cumsum(run_lens) - run_lens
    return ops, tpos, qpos, base_read, run_read, run_lens, run_ops, run_start


def read_pileup_indices(
    ref: np.ndarray,
    oseq: bytes,
    oqual: np.ndarray,
    ohp: np.ndarray | None,
    cigar: list[tuple[int, int]],
    t_start: int,
    q_start: int,
):
    """CIGAR walk as vector ops (semantics of alignment.rs:520-564).

    Returns flat scatter indices (bq_flat, del_pos, ins_flat, hp_flat) for
    one read; the caller accumulates indices per consensus and bincounts
    ONCE per matrix — a per-read bincount over the full (L, NQ, 2) matrix
    was the stage-4 hotspot at 20k reads."""
    ops = _expand_cigar(cigar)
    t_adv = (ops != 1).astype(np.int64)
    q_adv = (ops != 2).astype(np.int64)
    tpos = t_start + np.cumsum(t_adv) - t_adv
    qpos = q_start + np.cumsum(q_adv) - q_adv
    L = len(ref)
    sarr = np.frombuffer(oseq, dtype=np.uint8)

    is_m = ops == 0
    tm = tpos[is_m]
    qm = qpos[is_m]
    ok = (tm < L) & (qm < len(sarr))
    tm, qm = tm[ok], qm[ok]
    bases = sarr[qm]
    levels = qlevel(oqual[qm])
    is_ref = (bases == ref[tm]).astype(np.int64)
    bq_flat = (tm * NQ + levels) * 2 + is_ref

    is_d = ops == 2
    td = tpos[is_d]
    td = td[td < L]

    # insertions: one event per run, attached to tpos-1, first-base quality
    bounds = np.flatnonzero(np.concatenate(([True], ops[1:] != ops[:-1])))
    ends = np.append(bounds[1:], len(ops))
    ins = ops[bounds] == 1
    rs, re = bounds[ins], ends[ins]
    tp = tpos[rs]
    qp = qpos[rs]
    keep = (tp > 0) & (tp - 1 < L) & (qp + (re - rs) <= len(sarr))
    ins_flat = (tp[keep] - 1) * NQ + qlevel(oqual[qp[keep]])

    hp_flat = None
    if ohp is not None:
        hp = np.minimum(ohp[qm], 63).astype(np.int64)
        hp_flat = tm * 64 + hp
    return bq_flat, td, ins_flat, hp_flat


def add_read_to_pileup(
    pm: PileupMatrix,
    oseq: bytes,
    oqual: np.ndarray,
    ohp: np.ndarray | None,
    cigar: list[tuple[int, int]],
    t_start: int,
    q_start: int,
    max_ins_store: int = 2,
) -> None:
    """Single-read scatter (kept for API parity; the batch path in
    generate_consensus_pileups accumulates indices instead)."""
    L = len(pm.ref)
    bq_flat, td, ins_flat, hp_flat = read_pileup_indices(
        pm.ref, oseq, oqual, ohp if pm.hp_hist is not None else None,
        cigar, t_start, q_start,
    )
    pm.bq.reshape(-1)[:] += np.bincount(bq_flat, minlength=L * NQ * 2)
    pm.dels += np.bincount(td, minlength=L)
    pm.ins_q.reshape(-1)[:] += np.bincount(ins_flat, minlength=L * NQ)
    if pm.hp_hist is not None and hp_flat is not None:
        pm.hp_hist.reshape(-1)[:] += np.bincount(hp_flat, minlength=L * 64)


_PILEUP_LIB = None
_PILEUP_TRIED = False


def _get_pileup_lib():
    """native/pileup.cpp: direct CIGAR-walk scatter into count matrices (no
    per-base intermediate streams).  None -> NumPy chunk path."""
    global _PILEUP_LIB, _PILEUP_TRIED
    if _PILEUP_TRIED:
        return _PILEUP_LIB
    _PILEUP_TRIED = True
    import ctypes

    from ..ops.native_build import build_extra

    so = build_extra("pileup", extra_link=["-fopenmp"])
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.pileup_accum_batch.restype = None
    lib.pileup_accum_batch.argtypes = [
        u8p, i64p, u8p, u8p, u32p, i64p, i64p, i64p, i64p,
        ctypes.c_int64, u8p, i64p, ctypes.c_int32,
        i64p, i64p, i64p, i64p, ctypes.c_int32,
    ]
    if hasattr(lib, "adjusted_errors_batch"):  # older cached .so may lack it
        lib.adjusted_errors_batch.restype = None
        lib.adjusted_errors_batch.argtypes = [
            u32p, i64p, u8p, i64p, i64p, u8p, i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int32,
        ]
    _PILEUP_LIB = lib
    return lib


def _accumulate_native(
    lib, pms, ref_cat, ref_off, cons_first_job, seqs, quals, hps, cigars,
    t0s, q0s, bq_flat, del_flat, ins_flat, hp_flat, threads,
) -> bool:
    """One native scatter pass over ALL jobs; returns False if any input
    can't be marshalled (caller falls back to the NumPy chunk path)."""
    import ctypes

    if any(np.asarray(c).ndim != 1 for c in cigars):
        return False
    slen = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    s_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(slen, out=s_off[1:])
    seq_cat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    qual_cat = np.ascontiguousarray(np.concatenate(quals), dtype=np.uint8)
    if len(qual_cat) != len(seq_cat):
        return False
    hp_cat = None
    if hps is not None:
        hp_cat = np.minimum(np.concatenate(hps), 63).astype(np.uint8)
        if len(hp_cat) != len(seq_cat):
            return False
    n_runs = np.fromiter((len(c) for c in cigars), np.int64, len(cigars))
    cig_off = np.zeros(len(cigars) + 1, dtype=np.int64)
    np.cumsum(n_runs, out=cig_off[1:])
    cig_cat = (
        np.ascontiguousarray(np.concatenate(cigars), dtype=np.uint32)
        if len(cigars)
        else np.zeros(0, np.uint32)
    )
    t0 = np.asarray(t0s, dtype=np.int64)
    q0 = np.asarray(q0s, dtype=np.int64)
    job_off = np.ascontiguousarray(cons_first_job, dtype=np.int64)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    lib.pileup_accum_batch(
        ptr(seq_cat, ctypes.c_uint8), ptr(s_off, ctypes.c_int64),
        ptr(qual_cat, ctypes.c_uint8),
        ptr(hp_cat, ctypes.c_uint8) if hp_cat is not None else None,
        ptr(cig_cat, ctypes.c_uint32), ptr(cig_off, ctypes.c_int64),
        ptr(t0, ctypes.c_int64), ptr(q0, ctypes.c_int64),
        ptr(job_off, ctypes.c_int64), ctypes.c_int64(len(pms)),
        ptr(ref_cat, ctypes.c_uint8), ptr(ref_off, ctypes.c_int64),
        ctypes.c_int32(NQ),
        ptr(bq_flat, ctypes.c_int64), ptr(del_flat, ctypes.c_int64),
        ptr(ins_flat, ctypes.c_int64),
        ptr(hp_flat, ctypes.c_int64) if hp_flat is not None else None,
        ctypes.c_int32(threads),
    )
    return True


def _median_from_hist(hist: np.ndarray) -> np.ndarray:
    """Per-row median with the reference's even-count averaging
    (alignment.rs:603-612); rows with no observations -> 1."""
    L = hist.shape[0]
    n = hist.sum(axis=1)
    out = np.ones(L, dtype=np.uint8)
    csum = np.cumsum(hist, axis=1)
    for i in np.flatnonzero(n):
        ni = n[i]
        mid = ni // 2
        lo_idx = int(np.searchsorted(csum[i], mid, side="right"))
        if ni % 2 == 1:
            out[i] = lo_idx
        else:
            lo2 = int(np.searchsorted(csum[i], mid - 1, side="right"))
            out[i] = (lo2 + lo_idx) // 2
    return out


def _accumulate_pileup_chunk(
    pms, c_lo, c_hi, ref_off, L_arr, own, seqs, quals, hps, cigars, t0s, q0s
):
    """Batched CIGAR walk + local bincounts for consensuses [c_lo, c_hi)."""
    base = int(ref_off[c_lo])
    loc_l = int(ref_off[c_hi]) - base
    own = np.asarray(own, dtype=np.int64)
    slen = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    s_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(slen, out=s_off[1:])
    seq_cat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    qual_cat = np.concatenate(quals)
    hp_cat = np.concatenate(hps) if hps else None
    ref_cat = np.concatenate([pms[c].ref for c in range(c_lo, c_hi)])
    ops, tpos, qpos, base_read, run_read, run_lens, run_ops, run_start = (
        batched_cigar_walk(cigars, t0s, q0s)
    )

    is_m = ops == 0
    tm, qm, rd = tpos[is_m], qpos[is_m], base_read[is_m]
    ok = (tm < L_arr[own[rd]]) & (qm < slen[rd])
    tm, qm, rd = tm[ok], qm[ok], rd[ok]
    gpos = (ref_off[own[rd]] - base) + tm
    qcat_i = s_off[rd] + qm
    bases = seq_cat[qcat_i]
    levels = qlevel(qual_cat[qcat_i])
    is_ref = (bases == ref_cat[gpos]).astype(np.int64)
    bq_loc = np.bincount((gpos * NQ + levels) * 2 + is_ref, minlength=loc_l * NQ * 2)

    is_d = ops == 2
    td, rdd = tpos[is_d], base_read[is_d]
    okd = td < L_arr[own[rdd]]
    del_loc = np.bincount((ref_off[own[rdd[okd]]] - base) + td[okd], minlength=loc_l)

    ins_r = run_ops == 1
    rs, rr, rl = run_start[ins_r], run_read[ins_r], run_lens[ins_r]
    tp, qp = tpos[rs], qpos[rs]
    keepi = (tp > 0) & (tp - 1 < L_arr[own[rr]]) & (qp + rl <= slen[rr])
    rrk = rr[keepi]
    ins_loc = np.bincount(
        ((ref_off[own[rrk]] - base) + tp[keepi] - 1) * NQ
        + qlevel(qual_cat[s_off[rrk] + qp[keepi]]),
        minlength=loc_l * NQ,
    )

    hp_loc = None
    if hp_cat is not None:
        hpv = np.minimum(hp_cat[qcat_i], 63).astype(np.int64)
        hp_loc = np.bincount(gpos * 64 + hpv, minlength=loc_l * 64)

    for ci in range(c_lo, c_hi):
        pm = pms[ci]
        L = len(pm.ref)
        o = int(ref_off[ci]) - base
        pm.bq.reshape(-1)[:] += bq_loc[o * NQ * 2 : (o + L) * NQ * 2]
        pm.dels += del_loc[o : o + L]
        pm.ins_q.reshape(-1)[:] += ins_loc[o * NQ : (o + L) * NQ]
        if pm.hp_hist is not None and hp_loc is not None:
            pm.hp_hist.reshape(-1)[:] += hp_loc[o * 64 : (o + L) * 64]


def _pileup_payload(
    twin_reads: list[TwinRead], consensuses: list[ConsensusSequence], args: ClusterArgs
) -> tuple[list[int], list[tuple]]:
    """Per-(read, consensus) pileup inputs shared by the host and mesh
    paths: (owners, [(seq, qual, hp), ...]) with per-read quality-aware HPC
    applied under --use-hpc (alignment.rs:455-475)."""
    from ..core import TwinRead

    used = [
        twin_reads[cons.cluster[i]]
        for cons in consensuses
        for i in range(min(len(cons.cluster), MAX_SEQS_CONSENSUS))
    ]
    TwinRead.warm_seq_bytes(used)
    TwinRead.warm_qual_ascii(used)
    owners, payload = [], []
    for ci, cons in enumerate(consensuses):
        for i in range(min(len(cons.cluster), MAX_SEQS_CONSENSUS)):
            tr = twin_reads[cons.cluster[i]]
            seq = tr.seq_bytes()
            qual = tr.expanded_qual_ascii()
            if args.use_hpc:
                # per-read HPC with min-run quality (utils.rs:135-184, used
                # at alignment.rs:473 before pileup population)
                hpc_seq, hq, hp_lens = homopolymer_compress_with_quality(
                    np.frombuffer(seq, dtype=np.uint8), qual
                )
                seq, qual, hp = hpc_seq.tobytes(), hq, hp_lens
            else:
                hp = None
            owners.append(ci)
            payload.append((seq, qual, hp))
    return owners, payload


def generate_consensus_pileups(
    twin_reads: list[TwinRead], consensuses: list[ConsensusSequence], args: ClusterArgs
) -> list[PileupMatrix]:
    """alignment.rs:409-652 on the matrix representation.

    SAVONT_STAGE4_BACKEND=mesh routes the whole construction — orient +
    banded align + traceback + count-matrix scatter — through the sharded
    device step (parallel/mesh.mesh_stage4_pileups), bit-identical."""
    import os

    if os.environ.get("SAVONT_STAGE4_BACKEND") == "mesh":
        from ..parallel.mesh import mesh_stage4_pileups

        return mesh_stage4_pileups(twin_reads, consensuses, args)

    owners, payload = _pileup_payload(twin_reads, consensuses, args)
    pairs = [p[0] for p in payload]
    # indexed form: consensuses are the target pool (deduped by id), reads
    # their own queries — no per-pair tuples; identical results
    from ..ops.align_batch import align_pairs_indexed

    tgt_pool = [cons.sequence.tobytes() for cons in consensuses]
    results = align_pairs_indexed(
        pairs, tgt_pool, np.arange(len(pairs)), np.asarray(owners, np.int64)
    )

    # count matrices are contiguous views into flat per-type buffers, so the
    # native scatter kernel can write all consensuses through one pointer
    L_flat = np.fromiter((len(c.sequence) for c in consensuses), np.int64, len(consensuses))
    roff = np.zeros(len(consensuses) + 1, dtype=np.int64)
    np.cumsum(L_flat, out=roff[1:])
    total_L = int(roff[-1])
    bq_flat = np.zeros(total_L * NQ * 2, dtype=np.int64)
    del_flat = np.zeros(total_L, dtype=np.int64)
    ins_flat = np.zeros(total_L * NQ, dtype=np.int64)
    hp_flat = np.zeros(total_L * 64, dtype=np.int64) if args.use_hpc else None
    pms = []
    for ci, cons in enumerate(consensuses):
        L = len(cons.sequence)
        o = int(roff[ci])
        pms.append(
            PileupMatrix(
                ref=cons.sequence.copy(),
                bq=bq_flat[o * NQ * 2 : (o + L) * NQ * 2].reshape(L, NQ, 2),
                dels=del_flat[o : o + L],
                ins_q=ins_flat[o * NQ : (o + L) * NQ].reshape(L, NQ),
                hp_hist=hp_flat[o * 64 : (o + L) * 64].reshape(L, 64) if args.use_hpc else None,
            )
        )
    # one batched CIGAR walk over every (read, consensus) mapping, then one
    # global bincount per matrix type, sliced back per consensus
    j_own: list[int] = []
    j_seq: list[bytes] = []
    j_qual: list[np.ndarray] = []
    j_hp: list[np.ndarray] = []
    j_cigar: list[np.ndarray] = []
    j_t0: list[int] = []
    j_q0: list[int] = []
    for ci, (seq, qual, hp), m in zip(owners, payload, results):
        if m is None:
            continue
        if m.strand == -1:
            j_seq.append(revcomp_bytes(seq))
            j_qual.append(qual[::-1])
            if hp is not None:
                j_hp.append(hp[::-1])
            j_q0.append(len(seq) - m.query_end)
        else:
            j_seq.append(seq)
            j_qual.append(qual)
            if hp is not None:
                j_hp.append(hp)
            j_q0.append(m.query_start)
        j_own.append(ci)
        j_cigar.append(m.cigar)
        j_t0.append(m.target_start)

    use_hp = args.use_hpc
    L_arr = np.fromiter((len(pm.ref) for pm in pms), np.int64, len(pms))
    ref_off = np.zeros(len(pms) + 1, dtype=np.int64)
    np.cumsum(L_arr, out=ref_off[1:])
    if j_own:
        # jobs are appended in consensus order, so chunks of whole
        # consensuses keep walk intermediates bounded (~8M bases each) at
        # any read scale AND give contiguous local bincount windows
        own_all = np.asarray(j_own, dtype=np.int64)
        cons_first_job = np.searchsorted(own_all, np.arange(len(pms) + 1))
        lib = _get_pileup_lib()
        done = False
        if lib is not None:
            ref_cat = np.concatenate([pm.ref for pm in pms]) if pms else np.zeros(0, np.uint8)
            done = _accumulate_native(
                lib, pms, np.ascontiguousarray(ref_cat, dtype=np.uint8), roff,
                cons_first_job, j_seq, j_qual,
                j_hp if use_hp and j_hp else None, j_cigar, j_t0, j_q0,
                bq_flat, del_flat, ins_flat, hp_flat, args.threads,
            )
        slen_all = np.fromiter((len(s) for s in j_seq), np.int64, len(j_seq))
        cap = 8 << 20
        c_lo = 0 if not done else len(pms)
        while c_lo < len(pms):
            c_hi, bases_sum = c_lo, 0
            while c_hi < len(pms):
                nb = int(slen_all[cons_first_job[c_hi] : cons_first_job[c_hi + 1]].sum())
                if c_hi > c_lo and bases_sum + nb > cap:
                    break
                bases_sum += nb
                c_hi += 1
            j0, j1 = int(cons_first_job[c_lo]), int(cons_first_job[c_hi])
            if j1 > j0:
                _accumulate_pileup_chunk(
                    pms, c_lo, c_hi, ref_off, L_arr,
                    j_own[j0:j1], j_seq[j0:j1], j_qual[j0:j1],
                    j_hp[j0:j1] if use_hp and j_hp else None,
                    j_cigar[j0:j1], j_t0[j0:j1], j_q0[j0:j1],
                )
            c_lo = c_hi

    # modal (median) HP length per position -> consensus hp_lengths
    for cons, pm in zip(consensuses, pms):
        if pm.hp_hist is not None:
            cons.hp_lengths = _median_from_hist(pm.hp_hist)
        else:
            cons.hp_lengths = np.ones(len(cons.sequence), dtype=np.uint8)
    return pms


def estimate_quality_error_rates(
    pms: list[PileupMatrix], consensuses: list[ConsensusSequence], top_frac: float = 0.1
) -> dict[int, float]:
    """alignment.rs:656-779 on count matrices: positions with <5% error from
    the top-depth clusters feed per-quality error rates (+1/+1 prior)."""
    depths = sorted(((c.depth, i) for i, c in enumerate(consensuses)), key=lambda x: -x[0])
    n_top = round(top_frac * len(depths))
    errors = np.zeros(NQ, dtype=np.int64)
    totals = np.zeros(NQ, dtype=np.int64)
    seen = np.zeros(NQ, dtype=bool)
    for _, ci in depths[:n_top]:
        if ci >= len(pms):
            continue
        pm = pms[ci]
        total = pm.depth()
        err = pm.bq[:, :, 0].sum(axis=1) + pm.dels + pm.ins_q.sum(axis=1)
        gate = (total > 0) & (err < 0.05 * total)
        sel = pm.bq[gate]  # (n, NQ, 2)
        errors += sel[:, :, 0].sum(axis=0)
        totals += sel.sum(axis=(0, 2))
        seen |= sel.sum(axis=(0, 2)) > 0
    out = {}
    for lvl in range(NQ):
        if seen[lvl]:
            # +1/+1 prior per observed quality key (alignment.rs:721)
            out[qvalue(lvl)] = (errors[lvl] + 1) / (totals[lvl] + 1)

    # debug ASCII histogram (alignment.rs:749-773)
    if log.isEnabledFor(logging.DEBUG):
        n_total = int(totals.sum())
        n_err = int(errors.sum())
        overall = n_err / n_total if n_total else 0.0
        log.debug("=" * 65)
        log.debug("Quality Error Rate Histogram (from %d high-confidence positions)", n_total)
        log.debug("Overall error rate: %.4f%% (%d/%d)", overall * 100.0, n_err, n_total)
        log.debug("=" * 65)
        for lvl in range(NQ):
            if not seen[lvl]:
                continue
            rate = errors[lvl] / totals[lvl] if totals[lvl] else 0.0
            bar_len = min(int(round(rate * 100.0)), 50)
            log.debug(
                "Q%3d: [%s%s] %6.3f%% (%7d/%7d errors)",
                qvalue(lvl), "#" * bar_len, " " * (50 - bar_len),
                rate * 100.0, int(errors[lvl]), int(totals[lvl]),
            )
        log.debug("=" * 65)
    return out


def analyze_pileup_consensuses(
    pms: list[PileupMatrix],
    consensuses: list[ConsensusSequence],
    quality_error_map: dict[int, float],
    args: ClusterArgs,
) -> list[ConsensusSequence]:
    """alignment.rs:857-1153, vectorized over positions."""
    bad_length_threshold = 100
    min_cov_abs = max(args.min_cluster_size * 3 // 4, 2)
    indel_rate = quality_error_map.get(48, DEFAULT_ERR_RATE)

    er = np.array([quality_error_map.get(qvalue(l), DEFAULT_ERR_RATE) for l in range(NQ)])
    ln_er = np.log(er)
    ln_acc = np.log(1.0 - er)

    flagged_by_cons: list[np.ndarray] = []
    windows: list[tuple[int, int] | None] = []
    post_threshold = min(args.posterior_threshold_ln, args.min_cluster_size * 3)

    for ci, pm in enumerate(pms):
        L = len(pm.ref)
        if L == 0:
            flagged_by_cons.append(np.zeros(0, dtype=np.int64))
            windows.append(None)
            continue
        depth = pm.depth()
        min_cov = max(int(depth.max()) // 3, min_cov_abs)
        covered = np.flatnonzero(depth >= min_cov)
        if len(covered) == 0:
            log.warning("consensus %d has no sufficiently covered positions", ci)
            flagged_by_cons.append(np.zeros(0, dtype=np.int64))
            windows.append(None)
            continue
        start, end = int(covered[0]), int(covered[-1]) + 1
        pm.start, pm.end = start, end
        sl = slice(start, end)

        ref_cnt = pm.bq[sl, :, 1]  # (n, NQ)
        alt_cnt = pm.bq[sl, :, 0]
        ins_cnt = pm.ins_q[sl]
        dels = pm.dels[sl]
        lp_ref = ref_cnt @ ln_acc + alt_cnt @ ln_er + dels * math.log(indel_rate) + ins_cnt @ ln_er
        lp_alt = ref_cnt @ ln_er + alt_cnt @ ln_acc + dels * math.log(1.0 - indel_rate) + ins_cnt @ ln_acc
        mx = np.maximum(lp_ref, lp_alt)
        alt_post = lp_alt - (mx + np.log(np.exp(lp_ref - mx) + np.exp(lp_alt - mx)))
        flagged = np.flatnonzero(alt_post > -post_threshold) + start
        flagged_by_cons.append(flagged)
        # TRACE: per-consensus pileup dump (posterior-flagged positions)
        log.log(5, "pileup cluster %d: window [%d,%d] max depth %d, flagged positions %s",
                ci, start, end, int(depth.max()), flagged.tolist())
        windows.append((start, end))

    for ci, cons in enumerate(consensuses):
        win = windows[ci]
        if win is None:
            continue
        left_start, right_end = win
        flagged = flagged_by_cons[ci]
        start_polish = bad_length_threshold + left_start
        end_polish = right_end - bad_length_threshold
        head = flagged[flagged < start_polish]
        tail = flagged[flagged >= end_polish]
        lc_left = int(head.max()) if len(head) else left_start
        lc_right = int(tail.min()) if len(tail) else right_end
        if lc_left > 0:
            cons.sequence[:lc_left] = ord("N")
        if lc_right < len(cons.sequence):
            cons.sequence[lc_right:] = ord("N")
        for p in flagged:
            if args.mask_low_quality:
                cons.sequence[p] = ord("N")
            if lc_left < p < lc_right:
                cons.low_quality_positions.append(int(p))

    def lq(c: ConsensusSequence) -> bool:
        n = len(c.low_quality_positions)
        return n > 0 and c.depth // (n * n) < args.n_depth_cutoff

    low_quality = [c for c in consensuses if lq(c)]
    consensuses[:] = [c for c in consensuses if not lq(c)]
    log.info("Stage 4: %d low-quality consensuses split off, %d kept", len(low_quality), len(consensuses))
    return low_quality

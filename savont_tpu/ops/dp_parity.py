"""Parity and timing of the device DP kernels against their references.

Used by chip_smoke.py (phase 2) and by the GPU-marked parity test: the
CUDA kernel (align_cuda) must give exactly what the plain-JAX scan
(align_jax) gives on every pair, in both variants, and both must agree with
the NumPy DP of align_batch on a sample.  The DP is integer arithmetic, so
every comparison is exact.
"""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import align_cuda, align_jax
from .align_batch import AlignJob, _run_bucket


def random_pairs(B: int, Lq: int, band: int, seed: int):
    """B read-vs-template pairs with raw planner-like bands: the query is a
    copy of a target window with ~2 % substitutions, ambiguous bases and
    1-3 bp indels; the band follows the true diagonal, and a quarter of the
    pairs get band jumps of up to band + 2 columns (structural indels).
    Returns int32 numpy arrays q (B, Lq) pad 5, t (B, Lt) pad 6,
    lo (B, Lq + 1), tlens (B,)."""
    rng = np.random.default_rng(seed)
    Lt = Lq + Lq // 16
    q = np.full((B, Lq), 5, np.int32)
    t = np.full((B, Lt), 6, np.int32)
    lo = np.zeros((B, Lq + 1), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        tlen = int(rng.integers(Lt * 7 // 8, Lt + 1))
        tseq = rng.integers(0, 4, tlen).astype(np.int32)
        t[b, :tlen] = tseq
        tlens[b] = tlen
        keep = rng.random(tlen) >= 0.01  # deletions
        src = np.flatnonzero(keep)
        ins = rng.random(len(src)) < 0.01  # insertions before these bases
        qpos = np.arange(len(src)) + np.cumsum(ins)
        qseq = np.full(len(src) + int(ins.sum()), 0, np.int32)
        qseq[qpos] = tseq[src]
        ins_at = np.setdiff1d(np.arange(len(qseq)), qpos)
        qseq[ins_at] = rng.integers(0, 4, len(ins_at))
        sub = rng.random(len(qseq)) < 0.02
        qseq[sub] = rng.integers(0, 5, int(sub.sum()))  # code 4 = ambiguous
        n = min(len(qseq), Lq - int(rng.integers(0, Lq // 8)))
        q[b, :n] = qseq[:n]
        # band: true target column of each query row, centred, clamped
        diag = np.interp(np.arange(Lq + 1), np.append(qpos, len(qseq)), np.append(src, tlen))
        centre = np.round(diag).astype(np.int64) - band // 2
        if b % 4 == 0:
            for p in rng.integers(1, Lq, 2):
                centre[p:] += int(rng.integers(0, band + 3))
        lo[b] = np.maximum.accumulate(np.clip(centre, 0, max(tlen - band, 0)))
        lo[b, 0] = lo[b, 1]  # row 1 starts without an advance, as in packed jobs
    return q, t, lo, tlens


_xla_meta = jax.jit(partial(align_jax.sw_forward_meta, smooth=False), static_argnames="band")
_xla_payload = jax.jit(align_jax._forward_payload, static_argnames="band")
_cuda_meta = jax.jit(align_cuda.sw_forward_meta, static_argnames="band")
_cuda_payload = jax.jit(align_cuda.forward_payload, static_argnames="band")


def _timed(fn, args, band: int, reps: int = 3):
    """(result on the host, best wall time of `reps` runs after a warm-up
    run that also compiles; each run ends in block_until_ready)."""
    out = jax.block_until_ready(fn(*args, band=band))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, band=band))
        best = min(best, time.perf_counter() - t0)
    return jax.device_get(out), best


#: Fields compared with the NumPy DP.  The metadata kernels (XLA, C++ NM,
#: CUDA) start every path's t_start at 0 when the path begins in query row
#: 1 at a column > 0, where the traceback reads the column; the NM
#: consumers never read t_start, so it is left out here.
NUMPY_KEYS = ("score", "q_start", "q_end", "t_end", "nm")


def numpy_reference(q, t, lo, tlens, band: int) -> np.ndarray:
    """(B, 5) NUMPY_KEYS from the NumPy banded DP with traceback (zeros
    where the score is not positive)."""
    jobs = []
    for b in range(q.shape[0]):
        qlen = int(np.count_nonzero(q[b] != 5))
        jobs.append(AlignJob(
            qcodes=q[b, :qlen].astype(np.uint8), tcodes=t[b, : tlens[b]].astype(np.uint8),
            lo=lo[b, 1 : qlen + 1].astype(np.int32), target_id=0, strand=1, fwd_qlen=qlen,
        ))
    out = np.zeros((len(jobs), len(NUMPY_KEYS)), np.int64)
    for b, r in enumerate(_run_bucket(jobs, band)):
        if r is not None:
            score, q0, q1, _t0, t1, _cigar, nm = r
            out[b] = (score, q0, q1, t1, nm)
    return out


def compare(q, t, lo, tlens, band: int, n_numpy: int = 32) -> dict:
    """Run both variants through the CUDA kernel and the XLA scan and count
    mismatching pairs; check the first n_numpy pairs against the NumPy DP.
    Returns counts (all must be 0) and the best times in seconds, with the
    full device traceback (CUDA payload + walk) timed beside them."""
    args = tuple(jnp.asarray(a) for a in (q, t, lo, tlens))
    cm, t_cm = _timed(_cuda_meta, args, band)
    xm, t_xm = _timed(_xla_meta, args, band)
    (cp, cs, cri, cbj), t_cp = _timed(_cuda_payload, args, band)
    (xp, xs, xri, xbj), t_xp = _timed(_xla_payload, args, band)
    # the whole device traceback on the CUDA forward: payload + the XLA
    # walk + RLE, so the walk's share is (traceback - payload) / traceback
    ops_max = q.shape[1] + t.shape[1]
    traceback = partial(align_jax.sw_traceback_full, ops_max=ops_max,
                        maxrun=min(512, ops_max), kernel="cuda")
    _, t_tb = _timed(traceback, args, band)
    meta_bad = np.zeros(q.shape[0], bool)
    for k in align_cuda.META_KEYS:
        meta_bad |= np.asarray(cm[k]) != np.asarray(xm[k])
    pay_bad = (np.asarray(cp) != np.asarray(xp)).any(axis=1)
    for a, b in ((cs, xs), (cri, xri), (cbj, xbj)):
        pay_bad |= np.asarray(a) != np.asarray(b)
    n = min(n_numpy, q.shape[0])
    ref = numpy_reference(q[:n], t[:n], lo[:n], tlens[:n], band)
    got = np.stack([np.asarray(cm[k])[:n] for k in NUMPY_KEYS], axis=1)
    got = np.where(got[:, :1] > 0, got, 0)
    numpy_bad = (ref != got).any(axis=1)
    return {
        "pairs": int(q.shape[0]), "Lq": int(q.shape[1]), "band": band,
        "meta_mismatch": int(meta_bad.sum()), "payload_mismatch": int(pay_bad.sum()),
        "numpy_checked": n, "numpy_mismatch": int(numpy_bad.sum()),
        "positive_scores": int((np.asarray(cm["score"]) > 0).sum()),
        "cuda_meta_s": t_cm, "xla_meta_s": t_xm,
        "cuda_payload_s": t_cp, "xla_payload_s": t_xp, "cuda_traceback_s": t_tb,
    }

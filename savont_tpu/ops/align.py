"""Seed-chain-extend aligner (the reference's minimap2 role).

Design (device-first):
- minimizer anchors + host chaining pick strand and a diagonal corridor;
- a BANDED affine Smith-Waterman fills the corridor.  The row recurrence is
  expressed with a prefix-max scan (no within-row sequential dependency):

      F[i,j] = max(H[i-1,j] - o, F[i-1,j]) - e            (vertical)
      G[i,j] = max(0, H[i-1,j-1] + s(i,j), F[i,j])
      E[i,j] = max_{j'<j} (G[i,j'] - o - e*(j-j'))        (prefix-max scan)
      H[i,j] = max(G[i,j], E[i,j])

  The usual E-from-H circularity is removed: an E path passing through
  another E cell is always dominated by extending the originating G cell,
  so E depends only on G of the same row.  Every row is then a handful of
  elementwise/scan vector ops of width = band; this exact formulation runs
  vectorized in NumPy here and batched on the device in align_jax.py
  (rows = lax.scan steps, band = the minor axis).

Replaces reference call sites: alignment.rs:284,432,1232,1545,1841 and
chimera.rs:88,416 and classify.rs:131-145 (minimap2 map_ont / lrhq).

CIGAR ops: 0=M (match/mismatch), 1=I (insertion in query), 2=D (deletion).
NM = mismatches + inserted + deleted bases over the aligned region,
matching minimap2's NM tag.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from .encode import U64, mm_hash64, revcomp_bytes
from .kmers import rolling_kmers

# scoring (map_ont-like single affine)
MATCH = 2
MISMATCH = -4
GAP_OPEN = 4  # first gap base costs GAP_OPEN + GAP_EXT
GAP_EXT = 2
NEG = -(10**8)

# DP corridor width.  128 is the conservative default; the asv driver
# lowers it to 64 for short-amplicon presets (output-identical on the
# Zymo + 20k/100k synthetic oracles, ~2x less DP work) via
# set_default_band.  SAVONT_DP_BAND pins a value for experiments.
import os as _os

_BAND_ENV = _os.environ.get("SAVONT_DP_BAND")
DEFAULT_BAND = int(_BAND_ENV) if _BAND_ENV else 128


def set_default_band(band: int) -> None:
    """Adjust the runtime band (no-op when SAVONT_DP_BAND pins it)."""
    global DEFAULT_BAND
    if not _BAND_ENV:
        DEFAULT_BAND = band


def resolve_band(band: int | None) -> int:
    return DEFAULT_BAND if band is None else band

_ASCII_CODE = np.full(256, 4, dtype=np.uint8)  # 4 = ambiguous, mismatches everything
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for _ch in _b:
        _ASCII_CODE[_ch] = _c


def ascii_to_align_codes(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII -> 0..3 codes with 4 for N/ambiguous (never matches)."""
    if isinstance(seq, (bytes, bytearray)):
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _ASCII_CODE[arr]


def cigar_lens_ops(cigar) -> tuple[np.ndarray, np.ndarray]:
    """Unpack a packed-u32 CIGAR into (lengths i64, ops i8)."""
    c = np.asarray(cigar, dtype=np.uint32)
    return (c >> np.uint32(4)).astype(np.int64), (c & np.uint32(0xF)).astype(np.int8)


@dataclass(slots=True)
class Mapping:
    """One alignment hit (the fields the reference consumes from minimap2)."""

    target_id: int
    strand: int  # +1 forward, -1 reverse
    query_start: int  # on the FORWARD query
    query_end: int
    target_start: int
    target_end: int
    nm: int
    cigar: np.ndarray  # packed u32 (length << 4 | op) on the ORIENTED query
    score: int
    is_primary: bool = True
    mapq: int = 60

    @property
    def query_span(self) -> int:
        return self.query_end - self.query_start


# ── seeding / anchors ────────────────────────────────────────────────────────


_MINI_CACHE: dict[tuple[bytes, int, int], tuple] = {}
_MINI_CACHE_MAX = 131072


def evict_half(cache: dict) -> None:
    """Drop the OLDEST half of a bounded memo dict (insertion order =
    iteration order).  A wholesale clear at capacity caused a re-encode /
    re-scan storm right at the working-set boundary.

    Thread-tolerant: list(cache) snapshots atomically under the GIL and
    pop() ignores keys another planner thread already evicted (the slab
    pipeline plans two slabs concurrently; double-compute of a cache
    entry is benign, a del KeyError is not)."""
    keys = list(cache)
    for k in keys[: len(keys) // 2]:
        cache.pop(k, None)


def window_minimizers_cached(qbytes: bytes, w: int, k: int):
    """Memoized _window_minimizers over raw ASCII bytes (reads are re-seeded
    by several pipeline stages)."""
    key = (qbytes, w, k)
    hit = _MINI_CACHE.get(key)
    if hit is None:
        hit = _window_minimizers(ascii_to_align_codes(qbytes), w, k)
        if len(_MINI_CACHE) >= _MINI_CACHE_MAX:
            evict_half(_MINI_CACHE)
        _MINI_CACHE[key] = hit
    return hit


def _encode_queries_registry(bufs: list[bytes]) -> list[np.ndarray]:
    """Planner 0..4 codes for a list of ASCII buffers: registered
    TwinRead-backed bytes reuse their stored 2-bit codes (bit-identical to
    the LUT by construction); the rest go through ONE concatenated LUT
    gather."""
    from .encode import registered_planner_codes

    out: list[np.ndarray | None] = [None] * len(bufs)
    lut_idx: list[int] = []
    for j, b in enumerate(bufs):
        c = registered_planner_codes(b)
        if c is not None:
            out[j] = c
        else:
            lut_idx.append(j)
    if lut_idx:
        lbufs = [bufs[j] for j in lut_idx]
        off = np.zeros(len(lbufs) + 1, dtype=np.int64)
        np.cumsum(np.fromiter((len(b) for b in lbufs), np.int64, len(lbufs)), out=off[1:])
        cat = (
            _ASCII_CODE[np.frombuffer(b"".join(lbufs), dtype=np.uint8)]
            if int(off[-1]) else np.zeros(0, np.uint8)
        )
        for x, j in enumerate(lut_idx):
            out[j] = cat[off[x] : off[x + 1]]
    return out  # type: ignore[return-value]


def window_minimizers_cached_batch(queries: list[bytes], w: int, k: int) -> list[tuple]:
    """Cache-backed minimizers for many queries; cache misses are computed in
    ONE native batch call (threads across sequences, one ctypes round-trip)."""
    out: list[tuple | None] = [None] * len(queries)
    miss_idx: list[int] = []
    for i, qb in enumerate(queries):
        hit = _MINI_CACHE.get((qb, w, k))
        if hit is not None:
            out[i] = hit
        else:
            miss_idx.append(i)
    if miss_idx:
        from .kmers_native import get_scan_lib, window_minimizers_native

        # one LUT gather for every miss (the per-query encode loop was
        # ~10 us x 100k reads); views share one parent, so the native
        # batch's concat takes its zero-copy parent-span fast path.
        # TwinRead-backed bytes skip the LUT: their 0..3 codes are
        # registered at decode time and re-encoding is the exact inverse.
        codes = _encode_queries_registry([bytes(queries[i]) for i in miss_idx])
        if get_scan_lib() is not None:
            computed = window_minimizers_native(codes, k, w)
        else:
            computed = [_window_minimizers_numpy(c, w, k) for c in codes]
        if len(_MINI_CACHE) + len(miss_idx) >= _MINI_CACHE_MAX:
            evict_half(_MINI_CACHE)
        for i, res in zip(miss_idx, computed):
            _MINI_CACHE[(queries[i], w, k)] = res
            out[i] = res
    return out  # type: ignore[return-value]


_IDMINI_CACHE: dict[int, list] = {}  # id(qb) -> entry, see _mini_entries; (w,k)=(10,15) only
_IDMINI_CACHE_MAX = 400_000


def _mini_entries(queries, idx, h_par, p_par, f_par, off):
    """Id-cache entries for the x-th span off[x]:off[x+1] of each listed
    query: [qb, h_parent, p_parent, f_parent, ptr_h, ptr_p, ptr_f, count,
    start].  Entries pin the PARENT pool arrays (no per-read slices) and
    the pointer/length columns are computed vectorized — the per-read
    slice+.ctypes.data construction cost ~3-4 us x 100k reads."""
    off = np.asarray(off, dtype=np.int64)
    starts = off[:-1]
    ph = (h_par.ctypes.data + starts * h_par.dtype.itemsize).tolist()
    pp = (p_par.ctypes.data + starts * p_par.dtype.itemsize).tolist()
    pf = (f_par.ctypes.data + starts * f_par.dtype.itemsize).tolist()
    cl = np.diff(off).tolist()
    sl = starts.tolist()
    return [
        [queries[i], h_par, p_par, f_par, ph[x], pp[x], pf[x], cl[x], sl[x]]
        for x, i in enumerate(idx)
    ]


def window_minimizers_flat_batch(
    queries: list[bytes], w: int, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Minimizers for a batch as FLAT pools: (hash, pos, is_fwd, off[n+1]).

    Large batches (>= 2048 queries — one-shot planner sweeps like the
    stage-7 tie-break slabs or whole-readset pileups) bypass _MINI_CACHE's
    bytes-keyed tuples and instead use a bytes-IDENTITY cache (the entry
    holds the bytes object, so its id can't be recycled): every planner
    stage rescans the same memoized seq_bytes() objects, and the id probe
    is ~30x cheaper than the native rescan.  Small batches go through the
    cached tuple path and are pooled; values are bit-identical either way."""
    n = len(queries)
    from .kmers_native import get_scan_lib, window_minimizers_flat_native

    if n >= 2048 and get_scan_lib() is not None:
        if w == 10 and k == 15:  # the planner signature (cache is unkeyed on w/k)
            if len(_IDMINI_CACHE) > _IDMINI_CACHE_MAX:
                evict_half(_IDMINI_CACHE)
            ents = [_IDMINI_CACHE.get(id(q)) for q in queries]
            miss = [i for i, e in enumerate(ents) if e is None or e[0] is not queries[i]]
            if len(miss) < n:
                # ANY hit: scan only the misses and assemble pools from the
                # cache — the native rescan is ~30x the id-probe cost, so a
                # partial-hit batch never benefits from the full-scan path
                # below (which rescans hits too)
                # assemble flat pools from cache + one native scan of misses
                if miss:
                    mcodes = _encode_queries_registry([queries[i] for i in miss])
                    mh, mp, mf, mo = window_minimizers_flat_native(mcodes, k, w)
                    # entries carry PARENT arrays + precomputed data
                    # pointers (parents pinned by the entry) so pool
                    # assembly is one native scatter-gather memcpy; the
                    # pointer/length columns are built vectorized — the
                    # per-read slice construction cost ~3-4 us x 100k
                    for i, e in zip(miss, _mini_entries(queries, miss, mh, mp, mf, mo)):
                        _IDMINI_CACHE[id(queries[i])] = e
                        ents[i] = e
                cnt = np.fromiter((e[7] for e in ents), np.int64, n)
                off = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(cnt, out=off[1:])
                total = int(off[-1])
                h = np.empty(total, U64)
                pos = np.empty(total, np.int64)
                isf = np.empty(total, bool)
                from .kmers_native import gather_ptr_ranges_native

                # one fromiter per pointer column (~60 ns/elem); the old
                # per-entry ptrs[i, j] scalar stores cost ~2-3 us each,
                # ~0.6 s at 100k reads
                p_h = np.fromiter((e[4] for e in ents), np.uint64, n)
                p_p = np.fromiter((e[5] for e in ents), np.uint64, n)
                p_f = np.fromiter((e[6] for e in ents), np.uint64, n)
                if not (
                    gather_ptr_ranges_native(p_h, cnt, off, h, threads=4)
                    and gather_ptr_ranges_native(p_p, cnt, off, pos, threads=4)
                    and gather_ptr_ranges_native(p_f, cnt, off, isf, threads=4)
                ):
                    for i, e in enumerate(ents):
                        s, t = off[i], off[i + 1]
                        src = e[8]
                        h[s:t] = e[1][src : src + e[7]]
                        pos[s:t] = e[2][src : src + e[7]]
                        isf[s:t] = e[3][src : src + e[7]]
                return h, pos, isf, off
        codes = _encode_queries_registry(list(queries))
        out = window_minimizers_flat_native(codes, k, w)
        if w == 10 and k == 15:
            oh, op, of_, oo = out
            for q, e in zip(queries, _mini_entries(queries, range(n), oh, op, of_, oo)):
                _IDMINI_CACHE[id(q)] = e
        return out
    qmini = window_minimizers_cached_batch(queries, w, k)
    cnt = np.fromiter((len(m[0]) for m in qmini), np.int64, n)
    moff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=moff[1:])
    if n == 0 or int(moff[-1]) == 0:
        return (
            np.zeros(0, U64), np.zeros(0, np.int64),
            np.zeros(0, bool), moff,
        )
    return (
        np.concatenate([m[0] for m in qmini]),
        np.concatenate([m[1] for m in qmini]),
        np.concatenate([m[2] for m in qmini]),
        moff,
    )


def prime_idmini_cache(queries: list[bytes], threads: int = 2,
                       stop=None, chunk: int = 8192) -> int:
    """Background prefill of the (w=10, k=15) planner id-cache.

    The stage-7 tie-break planner's first touch of each read's seq_bytes
    is a native minimizer scan (~1.6 s of cpu at 100k reads) that lands
    on the critical path.  The driver calls this from a helper thread
    while stages 4-6 run — the scan itself is a GIL-releasing ctypes
    call, so it rides the cores those stages leave idle and stage-7's
    id-probe then hits.  Values are IDENTICAL to the in-line scan (same
    kernel, same entry construction as window_minimizers_flat_batch's
    miss path); the cache is an identity-keyed memo, so a partial fill
    (stop event set, or races with stage-4's own inserts) only changes
    WHO computes an entry, never its value.  Returns #entries added;
    best-effort — any exception abandons the remaining chunks."""
    from .kmers_native import get_scan_lib, window_minimizers_flat_native

    if get_scan_lib() is None:
        return 0
    added = 0
    try:
        for s in range(0, len(queries), chunk):
            if stop is not None and stop.is_set():
                break
            qs = [q for q in queries[s : s + chunk]
                  if (e := _IDMINI_CACHE.get(id(q))) is None or e[0] is not q]
            if not qs:
                continue
            codes = _encode_queries_registry(qs)
            oh, op, of_, oo = window_minimizers_flat_native(codes, 15, 10, threads)
            for q, e in zip(qs, _mini_entries(qs, range(len(qs)), oh, op, of_, oo)):
                _IDMINI_CACHE[id(q)] = e
            added += len(qs)
    except Exception:  # pragma: no cover - optimization only, never fatal
        import logging

        logging.getLogger("savont").debug("idmini prefetch aborted", exc_info=True)
    return added


def _window_minimizers(codes4: np.ndarray, w: int, k: int):
    """Canonical window minimizers -> (hash u64, pos, is_fwd_canonical).

    Windows containing ambiguous bases (code 4) are excluded.  Uses the native
    batched kernel when available (bit-identical; tests/test_native.py)."""
    n = len(codes4) - k + 1
    if n <= 0:
        return np.zeros(0, U64), np.zeros(0, np.int64), np.zeros(0, bool)
    from .kmers_native import get_scan_lib, window_minimizers_native

    if get_scan_lib() is not None:
        return window_minimizers_native([codes4], k, w, threads=1)[0]
    return _window_minimizers_numpy(codes4, w, k)


def _window_minimizers_numpy(codes4: np.ndarray, w: int, k: int):
    """Pure-NumPy reference implementation (correctness oracle)."""
    n = len(codes4) - k + 1
    if n <= 0:
        return np.zeros(0, U64), np.zeros(0, np.int64), np.zeros(0, bool)
    clean = np.minimum(codes4, 3)
    fwd, rev = rolling_kmers(clean, k)
    bad = np.convolve((codes4 > 3).astype(np.int32), np.ones(k, np.int32), "valid") > 0
    canon_is_fwd = fwd <= rev
    canon = np.where(canon_is_fwd, fwd, rev)
    h = mm_hash64(canon)
    h[bad] = np.iinfo(np.uint64).max
    if n < w:
        pos = np.array([int(np.argmin(h))])
    else:
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        pos = np.unique(win.argmin(axis=1) + np.arange(len(win)))
    keep = h[pos] != np.iinfo(np.uint64).max
    pos = pos[keep]
    return h[pos], pos.astype(np.int64), canon_is_fwd[pos]


class TargetIndex:
    """Minimizer index over target sequences: flat sorted-hash arrays, so
    query lookups are searchsorted range scans (no Python dict hot path)."""

    def __init__(self, targets: list[np.ndarray | bytes], w: int = 10, k: int = 15):
        self.w, self.k = w, k
        self.raw = [
            np.frombuffer(bytes(t), dtype=np.uint8) if isinstance(t, (bytes, bytearray)) else np.asarray(t, dtype=np.uint8)
            for t in targets
        ]
        self.targets = [ascii_to_align_codes(t) for t in self.raw]
        self.n_minis = np.zeros(len(targets), dtype=np.int64)
        from .kmers_native import get_scan_lib, window_minimizers_native

        if self.targets and get_scan_lib() is not None:
            per_target = window_minimizers_native(self.targets, k, w)
        else:
            per_target = [_window_minimizers_numpy(tc, w, k) for tc in self.targets]
        hs, tids, tposs, isfs = [], [], [], []
        for tid, (h, pos, isf) in enumerate(per_target):
            self.n_minis[tid] = len(h)
            hs.append(h)
            tids.append(np.full(len(h), tid, dtype=np.int32))
            tposs.append(pos.astype(np.int32))
            isfs.append(isf)
        if hs:
            allh = np.concatenate(hs)
            order = np.argsort(allh, kind="stable")
            self.h_sorted = allh[order]
            self.h_tid = np.concatenate(tids)[order]
            self.h_tpos = np.concatenate(tposs)[order]
            self.h_isf = np.concatenate(isfs)[order]
        else:
            self.h_sorted = np.zeros(0, dtype=U64)
            self.h_tid = np.zeros(0, dtype=np.int32)
            self.h_tpos = np.zeros(0, dtype=np.int32)
            self.h_isf = np.zeros(0, dtype=bool)

    @classmethod
    def build_singletons(
        cls, targets: list[bytes], w: int = 10, k: int = 15
    ) -> list["TargetIndex"]:
        """One single-target index per target, with ALL minimizer scans done
        in one native batch call (the SoA pair planner's per-target layout;
        field-identical to TargetIndex([t]) per target)."""
        from .kmers_native import get_scan_lib, window_minimizers_native

        raws = [
            np.frombuffer(bytes(t), dtype=np.uint8)
            if isinstance(t, (bytes, bytearray))
            else np.asarray(t, dtype=np.uint8)
            for t in targets
        ]
        codes = [ascii_to_align_codes(r) for r in raws]
        if codes and get_scan_lib() is not None:
            per_target = window_minimizers_native(codes, k, w)
        else:
            per_target = [_window_minimizers_numpy(tc, w, k) for tc in codes]
        out = []
        for raw, tc, (h, pos, isf) in zip(raws, codes, per_target):
            idx = cls.__new__(cls)
            idx.w, idx.k = w, k
            idx.raw = [raw]
            idx.targets = [tc]
            idx.n_minis = np.array([len(h)], dtype=np.int64)
            order = np.argsort(h, kind="stable")
            idx.h_sorted = h[order]
            idx.h_tid = np.zeros(len(h), dtype=np.int32)
            idx.h_tpos = pos.astype(np.int32)[order]
            idx.h_isf = isf[order]
            out.append(idx)
        return out

    def lookup(self, hq: np.ndarray, pq: np.ndarray, fq: np.ndarray):
        """For query minimizers (hashes, positions, strand flags) return
        flat hit arrays (q_pos, t_id, t_pos, same_strand)."""
        if len(hq) == 0 or len(self.h_sorted) == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, z, np.zeros(0, dtype=bool)
        left = np.searchsorted(self.h_sorted, hq, side="left")
        right = np.searchsorted(self.h_sorted, hq, side="right")
        counts = right - left
        total = int(counts.sum())
        if total == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, z, np.zeros(0, dtype=bool)
        # expand ranges: index array of all hits
        qi = np.repeat(np.arange(len(hq)), counts)
        # offsets within each range
        starts = np.repeat(left, counts)
        within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        hidx = starts + within
        same = self.h_isf[hidx] == fq[qi]
        return pq[qi].astype(np.int32), self.h_tid[hidx], self.h_tpos[hidx], same



def smooth_lo(lo):
    """Clamp per-row band advances to <= 1 column: lo'[i] = i + cummin(lo - i).

    The device kernels and the native NM kernel use static {0,1} shifts
    instead of dynamic gathers; a 128-wide band tolerates the resulting
    <=64-column lag on diagonal jumps (larger structural indels are filtered
    downstream)."""
    ar = np.arange(lo.shape[-1])
    return (ar + np.minimum.accumulate(lo - ar, axis=-1)).astype(lo.dtype)


def smooth_lo_max_lag(lo) -> np.ndarray:
    """Per-row worst-case corridor lag of smooth_lo vs the raw planner
    band: max_i (lo[i] - smooth_lo(lo)[i]), vectorized over leading axes.

    The smoothed corridor misses the TOP `lag` columns of the raw window at
    the lagging rows; when lag >= band/2 the device result can diverge from
    the host oracle on large structural indels, so device dispatchers gate
    on this and realign flagged pairs on the host path (bit-identity for
    every input, not just smooth ones)."""
    ar = np.arange(lo.shape[-1])
    d = lo - ar
    return (d - np.minimum.accumulate(d, axis=-1)).max(axis=-1)


def _chain_anchors(qpos: np.ndarray, tpos: np.ndarray) -> np.ndarray:
    """Longest co-linear chain: LIS on tpos after sorting by (qpos, tpos)."""
    order = np.lexsort((tpos, qpos))
    t = tpos[order]
    n = len(t)
    if n == 0:
        return order[:0]
    # fast path: anchors already strictly increasing (near-identical pairs)
    if n > 1 and bool((t[1:] > t[:-1]).all()):
        return order
    tails: list[int] = []
    tails_vals: list[int] = []
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        v = int(t[i])
        pos = bisect.bisect_left(tails_vals, v)
        if pos > 0:
            parent[i] = tails[pos - 1]
        if pos == len(tails):
            tails.append(i)
            tails_vals.append(v)
        else:
            tails[pos] = i
            tails_vals[pos] = v
    chain = []
    cur = tails[-1]
    while cur != -1:
        chain.append(cur)
        cur = parent[cur]
    chain.reverse()
    return order[np.array(chain, dtype=np.int64)]


def _band_centers(m: int, qa: np.ndarray, ta: np.ndarray) -> np.ndarray:
    """Per-query-row target center from chained anchors (piecewise linear,
    diagonal extrapolation at the ends, forced non-decreasing)."""
    if len(qa) == 0:
        return np.arange(m, dtype=np.int64)
    centers = np.interp(np.arange(m, dtype=np.float64), qa.astype(np.float64), ta.astype(np.float64))
    head = np.arange(int(qa[0]))
    centers[: int(qa[0])] = ta[0] - (qa[0] - head)
    if int(qa[-1]) < m - 1:
        tail = np.arange(int(qa[-1]) + 1, m)
        centers[int(qa[-1]) + 1 :] = ta[-1] + (tail - qa[-1])
    return np.maximum.accumulate(np.round(centers).astype(np.int64))


# ── banded affine Smith-Waterman (NumPy reference backend) ───────────────────


def banded_sw(q: np.ndarray, t: np.ndarray, centers: np.ndarray, band: int | None = None):
    """Local banded affine alignment.

    q, t: alignment codes (0..3, 4=ambiguous); centers: per-row band center.
    Returns (score, q_start, q_end, t_start, t_end, cigar, nm) or None.
    """
    band = resolve_band(band)
    m, n = len(q), len(t)
    if m == 0 or n == 0:
        return None
    band = min(band, max(8, n))
    lo = np.clip(centers - band // 2, 0, max(n - band, 0))
    lo = np.maximum.accumulate(lo)
    lo_full = np.concatenate(([lo[0]], lo))  # row r (1-based) uses lo_full[r]

    H = np.zeros((m + 1, band), dtype=np.int32)
    E = np.full((m + 1, band), NEG, dtype=np.int32)
    F = np.full((m + 1, band), NEG, dtype=np.int32)
    G = np.zeros((m + 1, band), dtype=np.int32)

    ooe = GAP_OPEN + GAP_EXT
    je = np.arange(band, dtype=np.int32)

    def shift(arr: np.ndarray, d: int, fill: int) -> np.ndarray:
        """out[bj] = arr[bj + d] (d >= 0), fill beyond the end."""
        if d == 0:
            return arr
        out = np.full(band, fill, dtype=np.int32)
        if d < band:
            out[: band - d] = arr[d:]
        return out

    for r in range(1, m + 1):
        qc = int(q[r - 1])
        l = int(lo_full[r])
        dl = l - int(lo_full[r - 1])
        cols = l + je
        valid = cols < n
        tc = t[np.minimum(cols, n - 1)]
        s = np.where((tc == qc) & (qc < 4) & (tc < 4), MATCH, MISMATCH).astype(np.int32)

        Hup = shift(H[r - 1], dl, NEG)
        Fup = shift(F[r - 1], dl, NEG)
        if dl >= 1:
            Hdiag = shift(H[r - 1], dl - 1, NEG)
        else:
            Hdiag = np.empty(band, dtype=np.int32)
            Hdiag[1:] = H[r - 1][:-1]
            Hdiag[0] = 0 if l == 0 else NEG  # left of band: free only at col -1
        Fr = np.maximum(Hup - GAP_OPEN, Fup) - GAP_EXT
        Gr = np.maximum(np.maximum(np.zeros(band, np.int32), Hdiag + s), Fr)
        run = np.maximum.accumulate(Gr + GAP_EXT * je)
        Er = np.full(band, NEG, dtype=np.int32)
        Er[1:] = run[:-1] - ooe - GAP_EXT * je[1:] + GAP_EXT
        Hr = np.maximum(Gr, Er)
        Hr = np.where(valid, Hr, NEG)
        Gr = np.where(valid, Gr, NEG)
        H[r], E[r], F[r], G[r] = Hr, Er, Fr, Gr

    flat = int(np.argmax(H[1:]))
    ri, bj = divmod(flat, band)
    ri += 1
    score = int(H[ri, bj])
    if score <= 0:
        return None
    return _traceback(H, E, F, G, lo_full, q, t, ri, bj, score)


def _traceback(H, E, F, G, lo_full, q, t, ri, bj, score):
    band = H.shape[1]
    n = len(t)
    ops: list[int] = []  # per-base ops from END to START
    r, j = ri, bj
    state = "H"
    while r > 0 and 0 <= j < band:
        l = int(lo_full[r])
        dl = l - int(lo_full[r - 1])
        if state == "H":
            state = "G" if H[r, j] == G[r, j] else "E"
            continue
        if state == "G":
            g = int(G[r, j])
            if g == 0:
                break
            if g == F[r, j]:
                state = "F"
                continue
            ops.append(0)  # diagonal (match/mismatch)
            r -= 1
            j = j + dl - 1
            state = "H"
            if j < 0:
                break  # entered via the free zero boundary at column -1
            continue
        if state == "E":
            # horizontal: consumes a target base (deletion, op 2)
            ops.append(2)
            if j - 1 >= 0 and E[r, j] == G[r, j - 1] - GAP_OPEN - GAP_EXT:
                state = "G"
            j -= 1
            continue
        if state == "F":
            # vertical: consumes a query base (insertion, op 1)
            ops.append(1)
            up = j + dl
            if up < band and F[r, j] == H[r - 1, up] - GAP_OPEN - GAP_EXT:
                state = "H"
            r -= 1
            j = up
            if j >= band:
                break
            continue

    q_end = ri
    t_end = int(lo_full[ri]) + bj + 1
    q_len = sum(1 for o in ops if o != 2)
    t_len = sum(1 for o in ops if o != 1)
    q_start = q_end - q_len
    t_start = t_end - t_len

    ops.reverse()
    # run-length encode into the packed u32 representation shared with the
    # native kernel: (length << 4) | op
    oarr = np.asarray(ops, dtype=np.uint32)
    if len(oarr):
        starts = np.flatnonzero(np.concatenate(([True], oarr[1:] != oarr[:-1])))
        lens = np.diff(np.append(starts, len(oarr))).astype(np.uint32)
        cigar = (lens << np.uint32(4)) | oarr[starts]
    else:
        cigar = np.zeros(0, dtype=np.uint32)

    nm = 0
    qp, tp = q_start, t_start
    for v in cigar:
        length, op = int(v) >> 4, int(v) & 0xF
        if op == 0:
            qs = q[qp : qp + length]
            ts = t[tp : tp + length]
            nm += int((qs != ts).sum()) + int(((qs == 4) & (ts == 4)).sum())
            qp += length
            tp += length
        elif op == 1:
            nm += length
            qp += length
        else:
            nm += length
            tp += length
    return score, q_start, q_end, t_start, t_end, cigar, nm


# ── top-level mapping ────────────────────────────────────────────────────────


def _group_anchors(
    index: "TargetIndex",
    hq: np.ndarray,
    pq: np.ndarray,
    fq: np.ndarray,
    qlen: int,
    no_diag_id: int | None,
) -> dict[tuple[int, int], tuple[np.ndarray, np.ndarray]]:
    """Vectorized anchor collection: (tid, strand) -> (q_pos, t_pos) arrays.
    Reverse-strand query positions are flipped to the oriented query."""
    qpos, tid, tpos, same = index.lookup(hq, pq.astype(np.int32), fq)
    if len(qpos) == 0:
        return {}
    if no_diag_id is not None:
        keep = tid != no_diag_id
        qpos, tid, tpos, same = qpos[keep], tid[keep], tpos[keep], same[keep]
    strand = np.where(same, 1, -1).astype(np.int8)
    qp_o = np.where(same, qpos, qlen - index.k - qpos).astype(np.int64)
    order = np.lexsort((tpos, qp_o, strand, tid))
    tid_s, strand_s, qp_s, tp_s = tid[order], strand[order], qp_o[order], tpos[order].astype(np.int64)
    out: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    if len(tid_s) == 0:
        return out
    bounds = np.flatnonzero(
        np.concatenate(([True], (tid_s[1:] != tid_s[:-1]) | (strand_s[1:] != strand_s[:-1])))
    )
    ends = np.append(bounds[1:], len(tid_s))
    for s, e in zip(bounds, ends):
        out[(int(tid_s[s]), int(strand_s[s]))] = (qp_s[s:e], tp_s[s:e])
    return out


def map_query(
    index: TargetIndex,
    query_ascii: np.ndarray | bytes,
    band: int | None = None,
    min_anchors: int = 3,
    max_hits: int | None = None,
    no_diag_id: int | None = None,
) -> list[Mapping]:
    """Map a query against all indexed targets.

    Returns hits sorted by score desc (primary first), at most one hit per
    (target, best strand).  mapq>0 only when the best hit's score strictly
    beats the runner-up (the only mapq use in the reference is `mapq > 0` at
    alignment.rs:1574)."""
    if isinstance(query_ascii, (bytes, bytearray)):
        qbytes = bytes(query_ascii)
    else:
        qbytes = np.asarray(query_ascii, dtype=np.uint8).tobytes()
    qf = ascii_to_align_codes(qbytes)
    hq, pq, fq = _window_minimizers(qf, index.w, index.k)
    qlen = len(qf)

    per_ts = _group_anchors(index, hq, pq, fq, qlen, no_diag_id)

    qr = ascii_to_align_codes(revcomp_bytes(qbytes))
    best_by_target: dict[int, Mapping] = {}
    for (tid, strand), (qa, ta) in per_ts.items():
        if len(qa) < min_anchors:
            continue
        chain = _chain_anchors(qa, ta)
        if len(chain) < min_anchors:
            continue
        qa_c, ta_c = qa[chain], ta[chain]
        qcodes = qf if strand == 1 else qr
        centers = _band_centers(len(qcodes), qa_c, ta_c)
        res = banded_sw(qcodes, index.targets[tid], centers, band=band)
        if res is None:
            continue
        score, q0, q1, t0, t1, cigar, nm = res
        if strand == 1:
            fq0, fq1 = q0, q1
        else:
            fq0, fq1 = qlen - q1, qlen - q0
        m = Mapping(
            target_id=tid, strand=strand, query_start=fq0, query_end=fq1,
            target_start=t0, target_end=t1, nm=nm, cigar=cigar, score=score,
        )
        prev = best_by_target.get(tid)
        if prev is None or m.score > prev.score:
            best_by_target[tid] = m

    results = sorted(best_by_target.values(), key=lambda m: (-m.score, m.target_id))
    for i, m in enumerate(results):
        m.is_primary = i == 0
        m.mapq = 60 if (i == 0 and (len(results) < 2 or results[1].score < m.score)) else 0
    if max_hits is not None:
        results = results[:max_hits]
    return results


def align_pair(query_ascii, target_ascii, band: int | None = None) -> Mapping | None:
    """Single-pair alignment (one-target index)."""
    idx = TargetIndex([target_ascii])
    hits = map_query(idx, query_ascii, band=band, min_anchors=2)
    return hits[0] if hits else None

"""Vectorized k-mer kernels (host NumPy backend).

These are exact functional equivalents of the reference's rolling-hash scalar
loops (seeding.rs), re-expressed as vector ops over whole reads so the same
code path can run on the device via JAX on padded batches (see ops/kmers_jax.py).

Conventions (all match the reference):
- k odd, <= 31.  2-bit packing, most-significant bits = first base.
- "split"/"masked" k-mer: middle base zeroed, mask = ~(3 << (k-1))
  (bit position k-1 holds the low bit of the middle base for odd k).
- canonicalization for split k-mers compares the MASKED forward/reverse
  k-mers (seeding.rs:1039-1062); the strand flag is packed into bit 63.
"""
from __future__ import annotations

import numpy as np

from .encode import U64, mm_hash64

_BIT63 = U64(1) << U64(63)


def rolling_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement packed k-mers at every position.

    Returns (fwd, rev) arrays of length len(codes)-k+1 (empty if too short).
    fwd[i] packs codes[i..i+k] with first base most-significant;
    rev[i] is the reverse complement of the same window.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=U64)
    c = codes.astype(U64)
    # recursive doubling: build 2^i-mer packs, then combine k's binary digits
    # (log2(k) array passes instead of k).
    fpack, rpack = c, U64(3) - c  # span-1 packs
    spans = [(1, fpack, rpack)]
    s = 1
    while s * 2 <= k:
        fpack = (fpack[: len(fpack) - s] << U64(2 * s)) | fpack[s:]
        rpack = (rpack[s:] << U64(2 * s)) | rpack[: len(rpack) - s]
        s *= 2
        spans.append((s, fpack, rpack))
    fwd = rev = None
    off = 0
    for s, fp, rp in reversed(spans):
        if not (k & s):
            continue
        fw = fp[off : off + n]
        rw = rp[off : off + n]
        if fwd is None:
            fwd, rev = fw.copy(), rw.copy()
        else:
            fwd = (fwd << U64(2 * s)) | fw
            rev = rev | (rw << U64(2 * off))
        off += s
    return fwd, rev


def split_kmer_mid(
    codes: np.ndarray,
    phred: np.ndarray | None,
    k: int,
    minimum_bq: int,
) -> np.ndarray:
    """Canonical split k-mers with strand flag in bit 63 (seeding.rs:975-1068).

    Skips palindromic masked k-mers and positions whose MIDDLE base quality
    is < minimum_bq (unless all qualities are equal - old PacBio convention).
    """
    if k % 2 != 1 or k > 31:
        raise ValueError("k must be odd and <= 31")
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=U64)

    fwd, rev = rolling_kmers(codes, k)
    split_mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    split_f = fwd & split_mask
    split_r = rev & split_mask

    keep = split_f != split_r  # drop palindromic masked k-mers
    if phred is not None and len(phred) and not (phred == phred[0]).all():
        mid_q = phred[k // 2 : k // 2 + n]
        keep &= mid_q >= minimum_bq  # reference skips q < minimum_bq

    canonical = split_f < split_r
    kmer = np.where(canonical, fwd, rev)
    flagged = kmer | np.where(canonical, _BIT63, U64(0))
    return flagged[keep]


def count_flagged_kmers(
    per_read_flagged: list[np.ndarray], threads: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Global strand-split k-mer counting (seq_parse.rs second_iteration).

    Input: list of bit63-flagged canonical split k-mer arrays (one per read).
    Output: (kmers sorted ascending, counts[n,2]) where counts[:,canon_flag]
    are per-strand occurrence counts.  This is the sort/segment-reduce
    formulation of the reference's sharded hash-map counting; the native
    parallel radix sort (native/sortcount.cpp) is used when available,
    bit-identical to the np.unique path below.
    """
    if not per_read_flagged:
        return np.zeros(0, dtype=U64), np.zeros((0, 2), dtype=np.uint32)
    allk = np.concatenate(per_read_flagged)
    return _count_flagged_stream(allk, threads)


def _count_flagged_stream(allk: np.ndarray, threads: int) -> tuple[np.ndarray, np.ndarray]:
    if len(allk) == 0:
        return np.zeros(0, dtype=U64), np.zeros((0, 2), dtype=np.uint32)
    from .kmers_native import count_flagged_native

    native = count_flagged_native(allk, threads)
    if native is not None:
        return native
    uniq, cnt = np.unique(allk, return_counts=True)  # sort + segmented reduce
    bare = uniq & ~_BIT63
    flag = (uniq >> U64(63)).astype(np.int64)
    kmers, inv = np.unique(bare, return_inverse=True)
    counts = np.zeros((len(kmers), 2), dtype=np.uint32)
    np.add.at(counts, (inv, flag), cnt.astype(np.uint32))
    return kmers, counts


def merge_counted(
    k1: np.ndarray, c1: np.ndarray, k2: np.ndarray, c2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Merge two (sorted-unique kmers, counts[n,2]) tables, summing counts
    of shared keys."""
    if len(k1) == 0:
        return k2, c2
    if len(k2) == 0:
        return k1, c1
    cat = np.concatenate([k1, k2])
    catc = np.concatenate([c1, c2])
    order = np.argsort(cat, kind="stable")
    cat, catc = cat[order], catc[order]
    starts = np.flatnonzero(np.concatenate(([True], cat[1:] != cat[:-1])))
    return cat[starts], np.add.reduceat(catc, starts, axis=0)


def count_flagged_kmers_streaming(
    per_read_flagged: list[np.ndarray], chunk_reads: int = 256
) -> tuple[np.ndarray, np.ndarray]:
    """Memory-bounded strand-split counting: the exact equivalent of the
    reference's Bloom-prefiltered two-pass mode (seq_parse.rs:80-314).

    The Bloom pass only bounds pass-2 memory — a k-mer survives iff both
    strands observed it, which the exact retain filter re-checks anyway, so
    outputs are identical to count_flagged_kmers.  Here the same memory bound
    comes from chunked unique+merge: peak is O(distinct k-mers) instead of
    O(total k-mer stream).
    """
    kmers = np.zeros(0, dtype=U64)
    counts = np.zeros((0, 2), dtype=np.uint32)
    for start in range(0, len(per_read_flagged), chunk_reads):
        chunk = per_read_flagged[start : start + chunk_reads]
        ck, cc = count_flagged_kmers(chunk)
        if len(ck) == 0:
            continue
        merged, inv = np.unique(np.concatenate([kmers, ck]), return_inverse=True)
        mc = np.zeros((len(merged), 2), dtype=np.uint32)
        np.add.at(mc, inv[: len(kmers)], counts)
        np.add.at(mc, inv[len(kmers) :], cc)
        kmers, counts = merged, mc
    return kmers, counts


def aggressive_bloom_admitted(per_read_flagged: list[np.ndarray]) -> np.ndarray:
    """K-mers admitted by the reference's --aggressive-bloom pass
    (seq_parse.rs:225-258), with EXACT (false-positive-free) Bloom
    semantics: a k-mer is admitted iff SOME occurrence, in stream order,
    has >= 1 prior same-strand occurrence AND >= 1 prior opposite-strand
    occurrence (insert() returns already-present; contains() checks the
    other filter).  This is stricter than the normal pass and
    order-dependent: strand counts (2,1) seen fwd,fwd,rc are NOT admitted
    while fwd,rc,fwd are.  Returns sorted bare (low-63-bit) k-mer values."""
    if not per_read_flagged:
        return np.zeros(0, dtype=U64)
    allk = np.concatenate(per_read_flagged)
    if len(allk) == 0:
        return np.zeros(0, dtype=U64)
    bare = allk & np.uint64(0x7FFFFFFFFFFFFFFF)
    strand = (allk >> np.uint64(63)).astype(np.int64)
    order = np.argsort(bare, kind="stable")  # stable: stream order per k-mer
    b = bare[order]
    s = strand[order]
    starts = np.flatnonzero(np.concatenate(([True], b[1:] != b[:-1])))
    seg_len = np.diff(np.append(starts, len(b)))
    pos = np.arange(len(b)) - np.repeat(starts, seg_len)  # index within segment
    cf = np.cumsum(s) - s  # exclusive fwd-strand count (global)
    cf_seg = cf - np.repeat(cf[starts], seg_len)  # ... within segment
    fwd_before = cf_seg
    rc_before = pos - cf_seg
    same_before = np.where(s == 1, fwd_before, rc_before)
    other_before = pos - same_before
    admitted_occ = (same_before >= 1) & (other_before >= 1)
    admitted_seg = np.logical_or.reduceat(admitted_occ, starts) if len(starts) else np.zeros(0, bool)
    return b[starts][admitted_seg]


def filter_counted_kmers(
    kmers: np.ndarray, counts: np.ndarray, single_strand: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Strand-support filter (seq_parse.rs:32-63): both strands > 0 and
    total > 2 (single-strand mode: counts[0] > 2)."""
    if single_strand:
        keep = counts[:, 0] > 2
    else:
        keep = (counts[:, 0] > 0) & (counts[:, 1] > 0) & (counts.sum(axis=1) > 2)
    return kmers[keep], counts[keep]


def masked_kmer(kmers: np.ndarray | int, k: int) -> np.ndarray | int:
    """Zero the middle base (kmer_comp.rs:261-264)."""
    mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    return np.asarray(kmers, dtype=U64) & mask if not np.isscalar(kmers) else int(kmers) & int(mask)


def mid_base(kmers: np.ndarray, k: int) -> np.ndarray:
    """Extract the middle base (kmer_comp.rs:267-272)."""
    return ((np.asarray(kmers, dtype=U64) >> U64(k - 1)) & U64(3)).astype(np.uint8)


def syncmer_and_snpmer_scan(
    codes: np.ndarray,
    phred: np.ndarray | None,
    k: int,
    c: int,
    snpmer_sorted: np.ndarray,
    minimum_bq: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Single pass over a read: open-syncmer minimizers + SNPmer hits.

    Mirrors seeding.rs get_twin_read_syncmer (317-568):
    - s = k - c + 1; a k-mer at position p is a minimizer iff the hash of its
      MIDDLE s-mer (index (k-s)/2 of the k-s+1 s-mers in the window) is a
      strict minimum of the window (others must be strictly greater).
    - canonical k-mer = fwd if masked_fwd < masked_rev else rev.
    - SNPmer hit: canonical k-mer in snpmer_sorted AND middle base quality
      STRICTLY > minimum_bq (or all-equal qualities).
    - per-read dedup (DEDUP_SNPMERS): drop SNPmer hits whose masked k-mer
      occurs more than once among ALL set hits (pre-quality-gate).

    Returns (mini_pos u32, mini_kmers u64, snp_pos u32, snp_kmers u64).
    """
    s = k - c + 1
    n = len(codes) - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, U64), np.zeros(0, np.uint32), np.zeros(0, U64))

    fwd, rev = rolling_kmers(codes, k)
    split_mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    canonical = (fwd & split_mask) < (rev & split_mask)
    canon_kmer = np.where(canonical, fwd, rev)

    # --- syncmer minimizers ---
    sf, sr = rolling_kmers(codes, s)
    shash = mm_hash64(np.minimum(sf, sr))
    # window of k-s+1 s-mer hashes for k-mer at p: shash[p .. p+k-s]
    m = k - s + 1
    mid = (k - s) // 2
    if len(shash) >= m:
        win = np.lib.stride_tricks.sliding_window_view(shash, m)[:n]
        center = win[:, mid]
        others_gt = np.ones(len(win), dtype=bool)
        for j in range(m):
            if j != mid:
                others_gt &= win[:, j] > center
        is_sync = others_gt
    else:
        is_sync = np.zeros(n, dtype=bool)
    mini_pos = np.flatnonzero(is_sync).astype(np.uint32)
    mini_kmers = canon_kmer[mini_pos]

    # --- SNPmer hits ---
    if len(snpmer_sorted):
        idx = np.searchsorted(snpmer_sorted, canon_kmer)
        idx = np.minimum(idx, len(snpmer_sorted) - 1)
        in_set = snpmer_sorted[idx] == canon_kmer
    else:
        in_set = np.zeros(n, dtype=bool)

    all_equal_q = phred is not None and len(phred) > 0 and bool((phred == phred[0]).all())
    if phred is not None and not all_equal_q:
        mid_q = phred[k // 2 : k // 2 + n]
        qual_ok = mid_q > minimum_bq
    else:
        qual_ok = np.ones(n, dtype=bool)

    hit = in_set & qual_ok
    snp_pos = np.flatnonzero(hit).astype(np.uint32)
    snp_kmers = canon_kmer[snp_pos]

    # per-read dedup on masked k-mer, counted over ALL set hits (pre qual gate)
    if len(snp_pos):
        all_hit_masked = canon_kmer[in_set] & split_mask
        uniq, cnt = np.unique(all_hit_masked, return_counts=True)
        once = uniq[cnt == 1]
        my_masked = snp_kmers & split_mask
        j = np.searchsorted(once, my_masked)
        j = np.minimum(j, max(len(once) - 1, 0))
        keep = (once[j] == my_masked) if len(once) else np.zeros(len(snp_pos), dtype=bool)
        snp_pos = snp_pos[keep]
        snp_kmers = snp_kmers[keep]

    return mini_pos, mini_kmers, snp_pos, snp_kmers


def kmer_at_position_oriented(codes: np.ndarray, pos: np.ndarray, k: int, forward: np.ndarray) -> np.ndarray:
    """Packed k-mers at positions with explicit orientation
    (types.rs:573-619 kmer_from_position_canonical): forward=True -> the
    plain window k-mer, else its reverse complement."""
    fwd, rev = rolling_kmers(codes, k)
    p = np.asarray(pos, dtype=np.int64)
    return np.where(np.asarray(forward, dtype=bool), fwd[p], rev[p])


def kmer_at_position(codes: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """Recompute canonical k-mers at positions, forward-preferred tie-break.

    Mirrors TwinRead::kmer_from_position (types.rs:622-663): canonical by
    MASKED comparison, but on equality the FORWARD k-mer is returned
    (note: construction-time canonicalization prefers reverse on ties).
    """
    fwd, rev = rolling_kmers(codes, k)
    split_mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    p = np.asarray(pos, dtype=np.int64)
    f, r = fwd[p], rev[p]
    use_rev = (r & split_mask) < (f & split_mask)
    return np.where(use_rev, r, f)


def kmer_at_position_batch(
    codes_list: list[np.ndarray], pos_lists: list[np.ndarray], k: int,
    chunk: int = 4096,
) -> list[np.ndarray]:
    """kmer_at_position over many reads with ONE rolling pass per chunk of
    concatenated codes (valid because rolling_kmers windows are local: a
    position p <= len-k never reads past its own read).  Per-read calls
    cost ~80us each in rolling overhead; this amortizes them away."""
    split_mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    out: list[np.ndarray] = []
    for s in range(0, len(codes_list), chunk):
        cl = codes_list[s : s + chunk]
        pl = pos_lists[s : s + chunk]
        lens = np.fromiter((len(c) for c in cl), np.int64, len(cl))
        off = np.concatenate(([0], np.cumsum(lens)))[:-1]
        cat = np.concatenate(cl) if cl else np.zeros(0, np.uint8)
        fwd, rev = rolling_kmers(cat, k)
        counts = [len(p) for p in pl]
        flat = (
            np.concatenate([np.asarray(p, np.int64) + o for p, o in zip(pl, off)])
            if pl
            else np.zeros(0, np.int64)
        )
        f, r = fwd[flat], rev[flat]
        use_rev = (r & split_mask) < (f & split_mask)
        km = np.where(use_rev, r, f)
        ends = np.cumsum(np.asarray(counts, dtype=np.int64))
        out.extend(km[e - c : e] for c, e in zip(counts, ends))
    return out


def minimizer_sketch(codes: np.ndarray, w: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-minimizer sketch replicating seeding.rs:99-187 exactly.

    Quirk parity (all three observable in the Rust source):
    - Input bytes decode through BYTE_TO_SEQ (types.rs:92-101), so ASCII and
      raw 2-bit codes hash identically (seeding.rs:124).
    - During the k+w-1-base warm-up loop, rolling_kmer_f is NEVER masked
      (seeding.rs:123-141: no `& max_mask`), so warm-up window hashes are
      computed on an accumulator holding ALL bases so far (mod 2^64) — NOT
      the clean k-mer.  The main loop masks (seeding.rs:154).
    - The first emitted value is the warm-up's final CANONICAL accumulator
      (not the minimum's hash, seeding.rs:145); every subsequent emission
      is the mm_hash64 of the window minimum.
    Downstream consumers (stage-5 dedup at alignment.rs:1167, export
    fuzzy-merge at merge.rs:220) only use these values for set containment
    computed the same way on both sides, so the mixture is harmless but
    must match.

    Returns (values u64, positions u64).
    """
    from .encode import _BYTE_TO_CODE
    from .kmers_native import minimizer_sketch_batch_native

    native = minimizer_sketch_batch_native([np.ascontiguousarray(codes)], w, k)
    if native is not None:
        return native[0]

    n = len(codes)
    if n < k + w - 1:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=U64)
    seq = _BYTE_TO_CODE[codes]
    fwd, rev = rolling_kmers(seq, k)
    canon = np.minimum(fwd, rev)
    hashes = mm_hash64(canon)

    # warm-up: UNMASKED forward accumulator (reference quirk, see above);
    # the reverse accumulator equals rev[p] at every step, so only f needs
    # scalar tracking.  w scalar hash calls total.
    vals: list[int] = []
    poss: list[int] = []
    window = np.empty(w, dtype=U64)
    mask64 = (1 << 64) - 1
    f = 0
    canonical_last = 0
    seq_list = seq[: k + w - 1].tolist()
    for i in range(k + w - 1):
        f = ((f << 2) | seq_list[i]) & mask64
        if i >= k - 1:
            r = int(rev[i - k + 1])
            canonical_last = f if f < r else r
            window[i - k + 1] = mm_hash64(canonical_last)

    # position_min: ties -> LAST index among minima (Rust max_by semantics)
    mn = window.min()
    min_pos = int(np.flatnonzero(window == mn)[-1])
    min_val = window[min_pos]
    vals.append(canonical_last)  # quirk: warm-up's final canonical value
    poss.append(min_pos)

    for gp in range(w, len(hashes)):  # gp = global k-mer position = i - k + 1
        h = hashes[gp]
        slot = gp % w
        window[slot] = h
        if h < min_val:
            min_val = h
            min_pos = slot
            vals.append(int(h))
            poss.append(gp)
        elif min_pos == slot:
            mn = window.min()
            min_pos = int(np.flatnonzero(window == mn)[-1])
            min_val = window[min_pos]
            offset = (slot - min_pos) % w
            poss.append(gp - offset)
            vals.append(int(min_val))
    return np.array(vals, dtype=U64), np.array(poss, dtype=U64)


def minimizer_sketch_batch(
    seqs: list[np.ndarray], w: int, k: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Batched minimizer_sketch: one native call for all sequences (falls
    back to the per-sequence Python loop, bit-identical)."""
    from .kmers_native import minimizer_sketch_batch_native

    native = minimizer_sketch_batch_native(
        [np.ascontiguousarray(s) for s in seqs], w, k
    )
    if native is not None:
        return native
    return [minimizer_sketch(s, w, k) for s in seqs]


def fmh_seeds(codes: np.ndarray, c: int, k: int, positions: bool = False):
    """FracMinHash seeds (seeding.rs:190-314): hash < u64::MAX/c.

    positions=False -> array of hashes (fmh_seeds);
    positions=True -> (canonical kmers, positions) (fmh_seeds_positions).
    """
    fwd, rev = rolling_kmers(codes, k)
    canon = np.minimum(fwd, rev)
    h = mm_hash64(canon)
    thresh = U64(np.uint64(0xFFFFFFFFFFFFFFFF) // np.uint64(c))
    keep = h < thresh
    if positions:
        return canon[keep], np.flatnonzero(keep).astype(U64)
    return h[keep]


def blockmer_hits_scan(
    codes: np.ndarray,
    phred: np.ndarray | None,
    k: int,
    l: int,
    blockmer_sorted: np.ndarray,
    minimum_bq: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Blockmer set hits over a read (seeding.rs:461-504).

    A window of k+l bases hits if its forward OR reverse-complement packed
    form is in blockmer_sorted; the suffix (last l window bases) must have
    quality > minimum_bq (unless all qualities equal).  Returns
    (positions u32, is_forward bool)."""
    bk = k + l
    n = len(codes) - bk + 1
    if n <= 0 or len(blockmer_sorted) == 0:
        return np.zeros(0, np.uint32), np.zeros(0, bool)
    fwd, rev = rolling_kmers(codes, bk)

    def member(v):
        idx = np.clip(np.searchsorted(blockmer_sorted, v), 0, len(blockmer_sorted) - 1)
        return blockmer_sorted[idx] == v

    hit_f = member(fwd)
    hit_r = member(rev)
    hit = hit_f | hit_r
    if phred is not None and len(phred) and not (phred == phred[0]).all():
        ok = np.ones(n, dtype=bool)
        for j in range(l):
            qpos = np.arange(n) + k + j
            valid = qpos < len(phred)
            ok &= ~valid | (phred[np.minimum(qpos, len(phred) - 1)] > minimum_bq)
        hit &= ok
    pos = np.flatnonzero(hit).astype(np.uint32)
    return pos, hit_f[pos]


def count_blockmers(
    per_read: list[tuple[np.ndarray, np.ndarray]], threads: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Count (blockmer, is_forward) observations (seq_parse.rs blockmer
    counting): returns (blockmers sorted, counts[n,2]) with counts[:,1] =
    forward-orientation count."""
    if not per_read:
        return np.zeros(0, U64), np.zeros((0, 2), dtype=np.uint32)
    flagged = []
    for kms, is_fwd in per_read:
        flagged.append(kms | (is_fwd.astype(U64) << U64(63)))
    return _count_flagged_stream(np.concatenate(flagged), threads)


def blockmer_scan(
    codes: np.ndarray,
    phred: np.ndarray | None,
    k: int,
    l: int,
    minimum_bq: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Blockmer extraction (seeding.rs:840-973).

    A blockmer is [anchor k-mer][l-base suffix]; orientation chosen by the
    anchor's FULL-kmer canonical comparison; palindromic anchors skipped;
    suffix bases must have quality >= minimum_bq (reference skips q-33 <
    minimum_bq).  Returns (blockmers u64, is_forward bool).
    """
    n_anchor = len(codes) - k + 1
    if n_anchor <= 0 or len(codes) < k + l:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=bool)
    fwd, rev = rolling_kmers(codes, k)
    c64 = codes.astype(U64)
    have_qual = phred is not None and len(phred) > 0

    out_k: list[int] = []
    out_f: list[bool] = []
    # vectorized suffix packing for both orientations
    n = len(codes)
    for p in range(n_anchor):
        f, r = fwd[p], rev[p]
        if f == r:
            continue
        if f < r:
            # forward: suffix to the right of anchor end (positions p+k .. p+k+l-1)
            if p + k + l > n:
                continue
            if have_qual:
                qs = phred[p + k : p + k + l]
                if (qs < minimum_bq).any():
                    continue
            suf = 0
            for j in range(l):
                suf = (suf << 2) | int(c64[p + k + j])
            out_k.append((int(f) << (2 * l)) | suf)
            out_f.append(True)
        else:
            # reverse: l bases to the LEFT, reverse-complemented
            if p < l:
                continue
            if have_qual:
                qs = phred[p - l : p]
                if (qs < minimum_bq).any():
                    continue
            suf = 0
            for j in range(1, l + 1):
                suf = (suf << 2) | (3 - int(c64[p - j]))
            out_k.append((int(r) << (2 * l)) | suf)
            out_f.append(False)
    return np.array(out_k, dtype=U64), np.array(out_f, dtype=bool)

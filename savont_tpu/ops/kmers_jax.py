"""Device k-mer kernels: batched split-kmer extraction and syncmer/SNPmer scans
over fixed-shape padded read batches.

64-bit k-mers are carried as (hi, lo) uint32 planes so the kernels need
no 64-bit mode; the rolling update is two shifts and a carry.  Per-base
work is pure element-wise math over a (N_reads, L) batch, so it shards
trivially over a device mesh on the batch axis (reads are data-parallel).

Counting is completed by jnp.unique/segment-reduce on host or device; the
extraction (the reference's 3-pass hot loop, seq_parse.rs/seeding.rs) is
the per-base cost and lives here.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .jax_init import ensure_jax_cache

ensure_jax_cache()

U32 = jnp.uint32


def _rolling_kmers_2d(codes, k: int):
    """codes (N, L) int32 in 0..3 -> fwd/rev packed k-mers as (hi, lo) uint32
    planes of shape (N, L-k+1).  First base most significant (2k bits)."""
    N, L = codes.shape
    n = L - k + 1
    c = codes.astype(U32)
    fhi = jnp.zeros((N, n), U32)
    flo = jnp.zeros((N, n), U32)
    rhi = jnp.zeros((N, n), U32)
    rlo = jnp.zeros((N, n), U32)
    for j in range(k):
        w = jax.lax.dynamic_slice_in_dim(c, j, n, axis=1)
        shift = 2 * (k - 1 - j)
        if shift >= 32:
            fhi = fhi | (w << U32(shift - 32))
        else:
            flo = flo | (w << U32(shift))  # 2-bit aligned: never straddles
        rs = 2 * j
        wr = U32(3) - w
        if rs >= 32:
            rhi = rhi | (wr << U32(rs - 32))
        else:
            rlo = rlo | (wr << U32(rs))
    return fhi, flo, rhi, rlo


def _combine64(hi, lo):
    """(hi, lo) uint32 -> uint64 on host (after download)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def _lt64(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


@partial(jax.jit, static_argnames=("k", "min_bq", "has_qual"))
def split_kmers_batch(codes, phred, lens, k: int, min_bq: int, has_qual: bool):
    """Batched split_kmer_mid (seeding.rs:975-1068).

    codes: (N, L) int32 2-bit codes (padding arbitrary)
    phred: (N, L) int32 (ignored when has_qual=False)
    lens:  (N,) int32 read lengths
    Returns (hi, lo, canon_flag, valid) each (N, L-k+1):
      canonical split k-mer planes, strand flag, and validity mask
      (in-read, non-palindromic-masked, mid-quality pass).
    """
    N, L = codes.shape
    n = L - k + 1
    fhi, flo, rhi, rlo = _rolling_kmers_2d(codes, k)

    # masked middle base: bit position k-1 (within the low 2k bits)
    if (k - 1) >= 32:
        m_hi = U32(3) << U32(k - 1 - 32)
        m_lo = U32(0)
    else:
        m_hi = U32(0)
        m_lo = U32(3) << U32(k - 1)
    sf_hi, sf_lo = fhi & ~m_hi, flo & ~m_lo
    sr_hi, sr_lo = rhi & ~m_hi, rlo & ~m_lo

    palindrome = (sf_hi == sr_hi) & (sf_lo == sr_lo)
    canonical = _lt64(sf_hi, sf_lo, sr_hi, sr_lo)
    khi = jnp.where(canonical, fhi, rhi)
    klo = jnp.where(canonical, flo, rlo)

    pos = jnp.arange(n)[None, :]
    valid = (pos < lens[:, None] - k + 1) & ~palindrome
    if has_qual:
        midq = jax.lax.dynamic_slice_in_dim(phred, k // 2, n, axis=1)
        in_read = jnp.arange(L)[None, :] < lens[:, None]
        all_eq = ((phred == phred[:, :1]) | ~in_read).all(axis=1)
        valid = valid & ((midq >= min_bq) | all_eq[:, None])
    return khi, klo, canonical, valid


@partial(jax.jit, static_argnames=("k", "c"))
def syncmer_batch(codes, lens, k: int, c: int):
    """Batched open-syncmer minimizer detection (seeding.rs:527-543).

    Returns (is_syncmer (N, L-k+1) bool, canon_hi, canon_lo) where canonical
    uses the MASKED comparison (reverse preferred on ties, as in the
    reference's construction path)."""
    s = k - c + 1
    N, L = codes.shape
    n = L - k + 1
    ns = L - s + 1

    # s-mer hashes: s <= 16 so an s-mer fits in 32 bits -> mm_hash64 of the
    # 64-bit canonical s-mer; compute in (hi=0, lo) planes then hash.
    shi, slo, rshi, rslo = _rolling_kmers_2d(codes, s)
    canon_s = jnp.where(_lt64(shi, slo, rshi, rslo), slo, rslo)
    canon_s_hi = jnp.where(_lt64(shi, slo, rshi, rslo), shi, rshi)
    h_hi, h_lo = _mm_hash64_planes(canon_s_hi, canon_s)

    m = k - s + 1
    mid = (k - s) // 2
    # windows of m s-mer hashes per k-mer position
    center_hi = jax.lax.dynamic_slice_in_dim(h_hi, mid, n, axis=1)
    center_lo = jax.lax.dynamic_slice_in_dim(h_lo, mid, n, axis=1)
    ok = jnp.ones((N, n), bool)
    for j in range(m):
        if j == mid:
            continue
        o_hi = jax.lax.dynamic_slice_in_dim(h_hi, j, n, axis=1)
        o_lo = jax.lax.dynamic_slice_in_dim(h_lo, j, n, axis=1)
        ok = ok & _lt64(center_hi, center_lo, o_hi, o_lo)

    fhi, flo, rhi, rlo = _rolling_kmers_2d(codes, k)
    if (k - 1) >= 32:
        m_hi, m_lo = U32(3) << U32(k - 1 - 32), U32(0)
    else:
        m_hi, m_lo = U32(0), U32(3) << U32(k - 1)
    canonical = _lt64(fhi & ~m_hi, flo & ~m_lo, rhi & ~m_hi, rlo & ~m_lo)
    khi = jnp.where(canonical, fhi, rhi)
    klo = jnp.where(canonical, flo, rlo)
    pos = jnp.arange(n)[None, :]
    in_read = pos < lens[:, None] - k + 1
    return ok & in_read, khi, klo


def _mm_hash64_planes(hi, lo):
    """mm_hash64 (seeding.rs:18-28) on (hi, lo) uint32 planes."""

    def add64(ahi, alo, bhi, blo):
        slo = alo + blo
        carry = (slo < alo).astype(U32)
        return ahi + bhi + carry, slo

    def shl(ahi, alo, n):
        if n == 0:
            return ahi, alo
        if n >= 32:
            return alo << U32(n - 32), jnp.zeros_like(alo)
        return (ahi << U32(n)) | (alo >> U32(32 - n)), alo << U32(n)

    def shr(ahi, alo, n):
        if n == 0:
            return ahi, alo
        if n >= 32:
            return jnp.zeros_like(ahi), ahi >> U32(n - 32)
        return ahi >> U32(n), (alo >> U32(n)) | (ahi << U32(32 - n))

    def xor(ahi, alo, bhi, blo):
        return ahi ^ bhi, alo ^ blo

    khi, klo = hi, lo
    # key = (~key) + (key << 21)
    thi, tlo = shl(khi, klo, 21)
    khi, klo = add64(~khi, ~klo, thi, tlo)
    # key ^= key >> 24
    khi, klo = xor(khi, klo, *shr(khi, klo, 24))
    # key = key + (key<<3) + (key<<8)
    a = add64(khi, klo, *shl(khi, klo, 3))
    khi, klo = add64(*a, *shl(khi, klo, 8))
    khi, klo = xor(khi, klo, *shr(khi, klo, 14))
    a = add64(khi, klo, *shl(khi, klo, 2))
    khi, klo = add64(*a, *shl(khi, klo, 4))
    khi, klo = xor(khi, klo, *shr(khi, klo, 28))
    khi, klo = add64(khi, klo, *shl(khi, klo, 31))
    return khi, klo


# ── host-facing wrappers ─────────────────────────────────────────────────────


def pad_reads(code_list: list[np.ndarray], phred_list=None, pad_to: int | None = None):
    """Pack variable-length reads into a fixed-shape batch (codes, phred,
    lens); pads to the bucket size (multiple of 256)."""
    N = len(code_list)
    L = max((len(c) for c in code_list), default=0)
    if pad_to:
        L = ((L + pad_to - 1) // pad_to) * pad_to
    codes = np.zeros((N, L), dtype=np.int32)
    phred = np.zeros((N, L), dtype=np.int32)
    lens = np.zeros(N, dtype=np.int32)
    for i, c in enumerate(code_list):
        codes[i, : len(c)] = c
        lens[i] = len(c)
        if phred_list is not None and phred_list[i] is not None:
            phred[i, : len(phred_list[i])] = phred_list[i]
    return codes, phred, lens


def device_split_kmers(code_list, phred_list, k: int, min_bq: int) -> list[np.ndarray]:
    """Device path for stage-1 extraction: returns per-read flagged canonical
    split k-mers (bit63 strand flag) matching ops.kmers.split_kmer_mid."""
    codes, phred, lens = pad_reads(code_list, phred_list, pad_to=256)
    has_qual = phred_list is not None and any(p is not None for p in phred_list)
    khi, klo, canon, valid = split_kmers_batch(
        jnp.asarray(codes), jnp.asarray(phred), jnp.asarray(lens), k, min_bq, has_qual
    )
    khi_h = np.asarray(khi)
    klo_h = np.asarray(klo)
    canon_h = np.asarray(canon)
    valid_h = np.asarray(valid)
    kmers = _combine64(khi_h, klo_h) | (canon_h.astype(np.uint64) << np.uint64(63))
    out = []
    for i in range(len(code_list)):
        out.append(kmers[i][valid_h[i]])
    return out

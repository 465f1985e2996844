"""Device k-mer kernels == host NumPy kernels (on the CPU backend)."""
import numpy as np
import pytest

from savont_tpu.ops.encode import encode_seq, mm_hash64
from savont_tpu.ops.kmers import rolling_kmers, split_kmer_mid, syncmer_and_snpmer_scan
from savont_tpu.ops.kmers_jax import (
    _combine64,
    device_split_kmers,
    pad_reads,
    syncmer_batch,
)

RNG = np.random.default_rng(17)


def rand_read(n):
    return RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n).astype(np.uint8).tobytes()


def test_device_split_kmers_matches_host():
    import jax.numpy as jnp

    reads = [encode_seq(rand_read(RNG.integers(300, 900))) for _ in range(8)]
    phreds = [np.full(len(r), 40) for r in reads]
    phreds[2][100] = 5  # low-quality mid base
    phreds[3][:] = 12  # all-equal qualities: gate disabled
    got = device_split_kmers(reads, phreds, 17, 25)
    for codes, phred, g in zip(reads, phreds, got):
        want = split_kmer_mid(codes, phred, 17, 25)
        assert g.tolist() == want.tolist()


def test_device_syncmers_match_host():
    import jax.numpy as jnp

    reads = [encode_seq(rand_read(RNG.integers(400, 800))) for _ in range(6)]
    codes, phred, lens = pad_reads(reads, None, pad_to=128)
    is_sync, khi, klo = syncmer_batch(jnp.asarray(codes), jnp.asarray(lens), 17, 11)
    is_sync = np.asarray(is_sync)
    kmers = _combine64(np.asarray(khi), np.asarray(klo))
    for i, r in enumerate(reads):
        mini_pos, mini_kmers, _, _ = syncmer_and_snpmer_scan(r, None, 17, 11, np.zeros(0, np.uint64), 25)
        got_pos = np.flatnonzero(is_sync[i])
        assert got_pos.tolist() == mini_pos.tolist()
        assert kmers[i][got_pos].tolist() == mini_kmers.tolist()


def test_mm_hash64_planes():
    from savont_tpu.ops.kmers_jax import _mm_hash64_planes
    import jax.numpy as jnp

    vals = RNG.integers(0, 2**63, 64, dtype=np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ghi, glo = _mm_hash64_planes(jnp.asarray(hi), jnp.asarray(lo))
    got = _combine64(np.asarray(ghi), np.asarray(glo))
    want = mm_hash64(vals)
    assert got.tolist() == want.tolist()


def test_device_kmer_pipeline_flag(tmp_path, monkeypatch, community):
    """SAVONT_DEVICE_KMERS=1 routes stage-1 extraction through the device
    batch kernel with identical counted output."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline import stage1_kmers

    args = ClusterArgs(
        input_files=[str(community.reads)], output_dir=str(tmp_path), threads=2,
    )
    host_k, host_c = stage1_kmers.read_to_split_kmers(args)
    monkeypatch.setenv("SAVONT_DEVICE_KMERS", "1")
    dev_k, dev_c = stage1_kmers.read_to_split_kmers(args)
    assert np.array_equal(host_k, dev_k)
    assert np.array_equal(host_c, dev_c)

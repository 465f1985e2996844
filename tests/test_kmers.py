"""Unit tests for the k-mer kernels against slow scalar reference
implementations transcribed from the reference semantics (seeding.rs)."""
import numpy as np
import pytest

from savont_tpu.ops.encode import (
    U64,
    bin_qualities,
    encode_kmer,
    encode_seq,
    decode_kmer,
    expand_binned_qualities,
    fxhash64_seeded,
    homopolymer_compress,
    homopolymer_decompress,
    mm_hash64,
    quantize_qual_bin,
    revcomp_bytes,
    revcomp_kmer,
)
from savont_tpu.ops.kmers import (
    count_flagged_kmers,
    masked_kmer,
    mid_base,
    minimizer_sketch,
    rolling_kmers,
    split_kmer_mid,
    syncmer_and_snpmer_scan,
)

RNG = np.random.default_rng(7)


def rand_seq(n):
    return RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n).astype(np.uint8).tobytes()


def slow_split_kmers(seq: bytes, k: int):
    """Direct transcription of seeding.rs:975-1068 (no quality gate)."""
    out = []
    split_mask = (~(3 << (k - 1))) & ((1 << 64) - 1)
    for i in range(len(seq) - k + 1):
        sub = seq[i : i + k]
        f = encode_kmer(sub.decode())
        r = encode_kmer(revcomp_bytes(sub).decode())
        sf, sr = f & split_mask, r & split_mask
        if sf == sr:
            continue
        if sf < sr:
            out.append(f | (1 << 63))
        else:
            out.append(r)
    return out


def test_rolling_kmers_basic():
    seq = b"ACGTACGTT"
    codes = encode_seq(seq)
    fwd, rev = rolling_kmers(codes, 5)
    assert decode_kmer(int(fwd[0]), 5) == "ACGTA"
    assert decode_kmer(int(rev[0]), 5) == "TACGT"
    assert int(fwd[4]) == encode_kmer("ACGTT")


def test_revcomp_kmer():
    km = encode_kmer("ACGTG")
    assert decode_kmer(revcomp_kmer(km, 5), 5) == "CACGT"


def test_split_kmer_mid_matches_slow():
    seq = rand_seq(300)
    codes = encode_seq(seq)
    got = split_kmer_mid(codes, None, 17, 25)
    want = slow_split_kmers(seq, 17)
    assert [int(x) for x in got] == want


def test_split_kmer_mid_quality_gate():
    seq = rand_seq(100)
    codes = encode_seq(seq)
    phred = np.full(100, 40)
    phred[50] = 5  # low-quality base
    got = split_kmer_mid(codes, phred, 17, 25)
    # positions whose MIDDLE base (p + 8) == 50 are skipped: p == 42
    all_pos = split_kmer_mid(codes, None, 17, 25)
    assert len(got) <= len(all_pos)
    # all-equal qualities: no gate
    got_eq = split_kmer_mid(codes, np.full(100, 5), 17, 25)
    assert len(got_eq) == len(all_pos)


def test_counting_strand_split():
    seq = rand_seq(200)
    rc = revcomp_bytes(seq)
    a = split_kmer_mid(encode_seq(seq), None, 17, 25)
    b = split_kmer_mid(encode_seq(rc), None, 17, 25)
    kmers, counts = count_flagged_kmers([a, b])
    # every kmer seen once on each strand orientation
    assert (counts.sum(axis=1) == 2).all()
    assert (counts[:, 0] == 1).all() and (counts[:, 1] == 1).all()


def test_masked_and_mid():
    km = encode_kmer("ACGTACGTACGTACGTA")  # k=17
    m = masked_kmer(np.array([km], dtype=U64), 17)[0]
    b = mid_base(np.array([km], dtype=U64), 17)[0]
    # middle base is at index 8: 'A' = 0
    assert b == 0
    assert int(m) | (int(b) << 16) == km


def test_syncmer_scan_consistency():
    """Syncmer definition: middle s-mer hash strictly less than all others."""
    seq = rand_seq(500)
    codes = encode_seq(seq)
    k, c = 17, 11
    s = k - c + 1
    mini_pos, mini_kmers, _, _ = syncmer_and_snpmer_scan(codes, None, k, c, np.zeros(0, U64), 25)
    fwd, rev = rolling_kmers(codes, s)
    shash = mm_hash64(np.minimum(fwd, rev))
    mid = (k - s) // 2
    for p in mini_pos:
        win = shash[p : p + k - s + 1]
        assert all(win[j] > win[mid] for j in range(len(win)) if j != mid)
    # strand invariance of the k-mer multiset
    rc_codes = encode_seq(revcomp_bytes(seq))
    _, rc_kmers, _, _ = syncmer_and_snpmer_scan(rc_codes, None, k, c, np.zeros(0, U64), 25)
    assert sorted(map(int, mini_kmers)) == sorted(map(int, rc_kmers))


def test_snpmer_hits_and_dedup():
    seq = rand_seq(300)
    codes = encode_seq(seq)
    k, c = 17, 11
    # make every canonical kmer a "snpmer": all positions hit, dedup drops repeats
    fwd, rev = rolling_kmers(codes, k)
    split_mask = U64((1 << 64) - 1) ^ U64(3 << (k - 1))
    canon = np.where((fwd & split_mask) < (rev & split_mask), fwd, rev)
    snp_sorted = np.unique(canon)
    _, _, snp_pos, snp_kmers = syncmer_and_snpmer_scan(codes, None, k, c, snp_sorted, 25)
    masked = snp_kmers & split_mask
    assert len(np.unique(masked)) == len(masked)  # per-read dedup


def test_lsh_signature_deterministic():
    h1 = fxhash64_seeded(3, np.array([123456789, 987654321], dtype=U64))
    h2 = fxhash64_seeded(3, np.array([123456789, 987654321], dtype=U64))
    assert (h1 == h2).all()
    h3 = fxhash64_seeded(4, np.array([123456789], dtype=U64))
    assert h3[0] != h1[0]


def test_qual_codec_roundtrip():
    q = np.array([33, 40, 53, 70, 90], dtype=np.uint8)
    lv = quantize_qual_bin(q)
    assert lv.tolist() == [0, 2, 7, 12, 15]
    exp = expand_binned_qualities(lv, 20)
    assert len(exp) == 20
    assert exp[0] == 33 and exp[4] == 2 * 3 + 33


def test_hpc_roundtrip():
    seq = np.frombuffer(b"AAACGGGT", dtype=np.uint8)
    hpc, lens = homopolymer_compress(seq, True)
    assert hpc.tobytes() == b"ACGT"
    assert lens.tolist() == [3, 1, 3, 1]
    assert homopolymer_decompress(hpc, lens).tobytes() == b"AAACGGGT"
    # no-op mode
    hpc2, lens2 = homopolymer_compress(seq, False)
    assert hpc2.tobytes() == b"AAACGGGT" and (lens2 == 1).all()


def test_minimizer_sketch_shared_region():
    a = rand_seq(800)
    b = a[100:700]
    va, _ = minimizer_sketch(np.frombuffer(a, dtype=np.uint8), 10, 21)
    vb, _ = minimizer_sketch(np.frombuffer(b, dtype=np.uint8), 10, 21)
    # most of b's sketch values are contained in a's (quirk: first element
    # is a raw kmer, interior are hashes)
    shared = np.isin(vb[1:], va).mean()
    assert shared > 0.8


def test_rev_hash64_inverse():
    v = RNG.integers(0, 2**63, 500, dtype=np.uint64)
    from savont_tpu.ops.encode import rev_hash64

    assert (rev_hash64(mm_hash64(v)) == v).all()


def test_streaming_count_identical():
    """-b (Bloom-prefilter equivalent) chunked counting matches the one-shot
    counter exactly (seq_parse.rs:80-314 admits a superset that the retain
    filter reduces to the same set)."""
    from savont_tpu.ops.kmers import count_flagged_kmers, count_flagged_kmers_streaming

    rng = np.random.default_rng(5)
    per_read = [
        (rng.integers(0, 1 << 62, rng.integers(0, 200)).astype(np.uint64)
         | (rng.integers(0, 2, 1).astype(np.uint64) << np.uint64(63)))
        for _ in range(700)
    ]
    k1, c1 = count_flagged_kmers(per_read)
    k2, c2 = count_flagged_kmers_streaming(per_read, chunk_reads=64)
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)


def test_kmer_at_position_batch_matches_scalar():
    from savont_tpu.ops.kmers import kmer_at_position, kmer_at_position_batch

    rng = np.random.default_rng(3)
    k = 17
    codes_list, pos_lists = [], []
    for i in range(40):
        n = int(rng.integers(5, 300))  # includes reads shorter than k
        codes_list.append(rng.integers(0, 4, n).astype(np.uint8))
        npos = 0 if n < k else int(rng.integers(0, n - k + 1))
        pos_lists.append(
            np.sort(rng.choice(n - k + 1, npos, replace=False)).astype(np.uint32)
            if npos
            else np.zeros(0, np.uint32)
        )
    got = kmer_at_position_batch(codes_list, pos_lists, k, chunk=7)
    for c, p, g in zip(codes_list, pos_lists, got):
        assert np.array_equal(g, kmer_at_position(c, p, k))


def test_chunked_native_counting_matches_flat():
    """_count_chunked_native (chunk=3) must equal the one-shot count on the
    same reads, including strand-split columns."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.ops.kmers import count_flagged_kmers, split_kmer_mid
    from savont_tpu.pipeline.stage1_kmers import (
        _count_chunked_native,
        _sortcount_available,
    )

    if not _sortcount_available():
        return
    rng = np.random.default_rng(9)
    codes = [rng.integers(0, 4, int(rng.integers(20, 200))).astype(np.uint8) for _ in range(25)]
    phreds = [np.full(len(c), 40, np.int32) for c in codes]
    args = ClusterArgs(input_files=[], output_dir="", threads=2)
    gk, gc = _count_chunked_native(codes, phreds, args, chunk=3)
    per_read = [split_kmer_mid(c, p, args.kmer_size, args.minimum_base_quality) for c, p in zip(codes, phreds)]
    wk, wc = count_flagged_kmers(per_read)
    assert np.array_equal(gk, wk) and np.array_equal(gc, wc)


def test_aggressive_bloom_admission_order_dependent():
    """seq_parse.rs:225-258 semantics: a k-mer is admitted iff some
    occurrence has a PRIOR same-strand and a PRIOR other-strand sighting.
    fwd,fwd,rc is NOT admitted; fwd,rc,fwd is."""
    from savont_tpu.ops.kmers import aggressive_bloom_admitted

    F = np.uint64(1 << 63)
    a, b = np.uint64(42), np.uint64(99)
    # k-mer a: fwd, fwd, rc -> never admitted
    # k-mer b: fwd, rc, fwd -> admitted at the third occurrence
    stream = [np.array([a | F, b | F]), np.array([a | F, b]), np.array([a, b | F])]
    got = aggressive_bloom_admitted(stream)
    assert got.tolist() == [99]
    # both-strand-pair only (1,1): not admitted
    got2 = aggressive_bloom_admitted([np.array([a | F]), np.array([a])])
    assert got2.tolist() == []
    # (2,1) with the rc in the middle: admitted
    got3 = aggressive_bloom_admitted([np.array([a | F, a, a | F])])
    assert got3.tolist() == [42]


def test_cached_encoded_invalidates_with_read_cache(community):
    """_cached_encoded memoizes per parse: same records list -> same encode
    objects; clearing _READ_CACHE (what bench.py does between runs) must
    invalidate the encodes too, so no stale arrays cross runs."""
    from savont_tpu.pipeline import stage1_kmers as s1

    path = str(community.reads)
    s1._READ_CACHE.clear()
    c1, p1 = s1._cached_encoded(path)
    c2, p2 = s1._cached_encoded(path)
    assert c1 is c2 and p1 is p2  # memoized for one parse
    recs = s1._cached_records(path)
    assert len(c1) == len(recs)
    # values match the per-read encoder
    from savont_tpu.ops.encode import encode_seq

    assert np.array_equal(c1[5], encode_seq(recs[5].seq))
    s1._READ_CACHE.clear()
    c3, _ = s1._cached_encoded(path)
    assert c3 is not c1  # fresh parse -> fresh encode


def test_pipeline_with_uncached_records(tmp_path, monkeypatch, community):
    """With the read cache disabled (file over the size limit), every parse
    re-streams and _cached_encoded must re-encode without storing; the
    pipeline output is unchanged."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline import stage1_kmers as s1
    from savont_tpu.pipeline.asv import run_cluster
    from savont_tpu.validate import validate_asvs

    monkeypatch.setattr(s1, "_READ_CACHE_LIMIT", 0)
    s1._READ_CACHE.clear()
    s1._ENCODE_CACHE.clear()
    out = tmp_path / "out"
    run_cluster(ClusterArgs(
        input_files=[str(community.reads)], output_dir=str(out), threads=4,
    ))
    assert not s1._ENCODE_CACHE  # nothing stored for uncached parses
    res = validate_asvs(str(out / "final_asvs.fasta"), str(community.templates))
    assert len(res) == community.n_templates and all(r.nm == 0 for r in res)


def test_streamed_count_matches_oracle_with_rc_headers(tmp_path, monkeypatch):
    """_streamed_count (the default pipelined counting path) must equal the
    single-threaded _count_chunked_native oracle bit-for-bit, INCLUDING
    cutadapt 'rc'-tagged headers and headers with trailing whitespace (the
    rc predicate is split()[-1] == 'rc' in every path)."""
    import gzip

    import numpy as np

    from savont_tpu.config import ClusterArgs
    from savont_tpu.ops.encode import revcomp_bytes
    from savont_tpu.ops.kmers_native import get_scan_lib, get_sortcount_lib
    from savont_tpu.pipeline import stage1_kmers
    from savont_tpu.pipeline.stage1_kmers import (
        _batch_encode,
        _count_chunked_native,
        _streamed_count,
    )

    if get_scan_lib() is None or get_sortcount_lib() is None:
        import pytest

        pytest.skip("native libs unavailable")

    rng = np.random.default_rng(41)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fq = tmp_path / "rc.fq.gz"
    recs = []
    with gzip.open(fq, "wt") as f:
        for i in range(60):
            seq = rng.choice(bases, int(rng.integers(80, 400))).tobytes()
            qual = ("I" * len(seq))
            # mix: plain, 'rc'-tagged, rc WITH TRAILING WHITESPACE (the
            # parser strips only newlines), and a decoy ending in 'arc'
            if i % 4 == 1:
                rid = f"r{i} rc"
            elif i % 4 == 2:
                rid = f"r{i} rc "  # trailing space: still split()[-1]=='rc'
            elif i % 4 == 3:
                rid = f"r{i} arc"  # NOT an rc tag
            else:
                rid = f"r{i}"
            recs.append((rid, seq, qual))
            f.write(f"@{rid}\n{seq.decode()}\n+\n{qual}\n")

    args = ClusterArgs(input_files=[str(fq)], output_dir="", threads=3)
    stage1_kmers._READ_CACHE.clear()
    got_k, got_c, n_reads = _streamed_count(args)
    assert n_reads == len(recs)

    # oracle: eager encode with the exact rc predicate, no threading
    seqs, quals = [], []
    for rid, seq, qual in recs:
        fields = rid.split()
        if fields and fields[-1] == "rc":
            seqs.append(revcomp_bytes(seq))
            quals.append(qual.encode()[::-1])
        else:
            seqs.append(seq)
            quals.append(qual.encode())
    codes, phred = _batch_encode(seqs, quals)
    want_k, want_c = _count_chunked_native(codes, phred, args, chunk=17)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    # the rc flip must actually matter for this dataset: recount without
    # flipping and require a difference (guards against a vacuous test)
    codes2, phred2 = _batch_encode([s for _, s, _ in recs], [q.encode() for *_, q in recs])
    alt_k, alt_c = _count_chunked_native(codes2, phred2, args, chunk=17)
    assert len(alt_k) != len(want_k) or not (
        np.array_equal(alt_k, want_k) and np.array_equal(alt_c, want_c)
    )

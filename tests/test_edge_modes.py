"""Edge-mode coverage: --single-strand, --no-snpmers, --mask-low-quality,
FASTA input (no qualities), cutadapt 'rc' suffix handling."""
import gzip
from pathlib import Path

import numpy as np
import pytest

from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline import stage1_kmers
from savont_tpu.pipeline.asv import run_cluster

RNG = np.random.default_rng(55)


def rand_seq(n):
    return RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n).astype(np.uint8).tobytes()


def mutate(seq, rate):
    b = bytearray(seq)
    for p in RNG.choice(len(b), int(len(b) * rate), replace=False):
        b[p] = b"ACGT"[RNG.integers(4)]
    return bytes(b)


def _write_fastq(path, reads, tag_rc_half=False):
    from savont_tpu.ops.encode import revcomp_bytes

    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            suffix = ""
            if tag_rc_half and i % 2:
                r = revcomp_bytes(r)
                suffix = " rc"
            f.write(f"@read_{i}{suffix}\n{r.decode()}\n+\n{'Z' * len(r)}\n")


def _two_strain_reads(n_per=25, length=1500, fasta=False):
    t1 = rand_seq(length)
    t2 = bytearray(t1)
    for p in (300, 800, 1200):
        t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
    reads = []
    from savont_tpu.ops.encode import revcomp_bytes

    for tpl in (t1, bytes(t2)):
        for i in range(n_per):
            r = mutate(tpl, 0.004)
            if i % 2:
                r = revcomp_bytes(r)
            reads.append(r)
    return t1, bytes(t2), reads


def test_single_strand_mode(tmp_path):
    """--single-strand drops the both-strands filter (forward-only data)."""
    t1, t2, _ = _two_strain_reads()
    reads = [mutate(t1, 0.004) for _ in range(25)] + [mutate(t2, 0.004) for _ in range(25)]
    fq = tmp_path / "ss.fq.gz"
    _write_fastq(fq, reads)
    out = tmp_path / "ss_out"
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4,
                            single_strand=True, min_cluster_size=5))
    asvs = [l for l in (out / "final_asvs.fasta").read_text().splitlines() if not l.startswith(">")]
    assert len(asvs) >= 1


def test_no_snpmers_mode(tmp_path):
    """--no-snpmers: SNPmer calling skipped; clustering is k-mer only."""
    _, _, reads = _two_strain_reads()
    fq = tmp_path / "ns.fq.gz"
    _write_fastq(fq, reads)
    out = tmp_path / "ns_out"
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4,
                            no_snpmers=True, min_cluster_size=5))
    # no SNPmers -> every read has 0 snpmers -> auto low-poly kicks in
    assert (out / "final_asvs.fasta").exists()


def test_rc_suffix_counting(tmp_path):
    """Reads tagged ' rc' are reverse-complemented for counting
    (seq_parse.rs:139-147), normalizing everything to one strand: the
    both-strands filter must then abort (reference seq_parse.rs:69-72),
    while the same mixed-strand file WITHOUT tags counts both strands."""
    import savont_tpu.pipeline.stage1_kmers as s1

    t1 = rand_seq(1500)
    reads = [mutate(t1, 0.003) for _ in range(20)]

    s1._READ_CACHE.clear()
    fq1 = tmp_path / "mixed.fq.gz"
    _write_fastq(fq1, reads, tag_rc_half=False)  # helper RCs half anyway? no
    # write a genuinely mixed-strand file without tags
    from savont_tpu.ops.encode import revcomp_bytes

    with gzip.open(fq1, "wt") as f:
        for i, r in enumerate(reads):
            rr = revcomp_bytes(r) if i % 2 else r
            f.write(f"@m_{i}\n{rr.decode()}\n+\n{'Z' * len(rr)}\n")
    kmers, counts = stage1_kmers.read_to_split_kmers(ClusterArgs(input_files=[str(fq1)], threads=4))
    assert len(kmers) > 0
    assert counts[:, 0].sum() > 0 and counts[:, 1].sum() > 0

    # the same reads rc-TAGGED: counting normalizes to one strand -> abort
    s1._READ_CACHE.clear()
    fq2 = tmp_path / "tagged.fq.gz"
    _write_fastq(fq2, reads, tag_rc_half=True)
    with pytest.raises(SystemExit):
        stage1_kmers.read_to_split_kmers(ClusterArgs(input_files=[str(fq2)], threads=4))
    # --single-strand accepts it
    s1._READ_CACHE.clear()
    kmers2, counts2 = stage1_kmers.read_to_split_kmers(
        ClusterArgs(input_files=[str(fq2)], threads=4, single_strand=True)
    )
    assert len(kmers2) > 0
    s1._READ_CACHE.clear()


def test_fasta_input(tmp_path):
    """FASTA input (no qualities): est_id None, quality gates disabled."""
    _, _, reads = _two_strain_reads()
    fa = tmp_path / "reads.fasta"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">faread_{i}\n{r.decode()}\n")
    out = tmp_path / "fa_out"
    run_cluster(ClusterArgs(input_files=[str(fa)], output_dir=str(out), threads=4, min_cluster_size=5))
    assert (out / "final_asvs.fasta").exists()


def test_mask_low_quality_flag(tmp_path):
    """--mask-low-quality N-masks flagged positions (alignment.rs:1112-1114)."""
    t1, t2, reads = _two_strain_reads(n_per=30)
    fq = tmp_path / "mask.fq.gz"
    _write_fastq(fq, reads)
    out = tmp_path / "mask_out"
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4,
                            mask_low_quality=True, min_cluster_size=5))
    assert (out / "final_asvs.fasta").exists()


def test_profile_flag_writes_pstats(tmp_path, community):
    """--profile DIR runs the pipeline normally and writes loadable cProfile
    stats (SURVEY.md §5.1 tracing parity)."""
    import pstats
    import subprocess
    import sys

    out = tmp_path / "run"
    prof = tmp_path / "prof"
    r = subprocess.run(
        [sys.executable, "-m", "savont_tpu", "--profile", str(prof), "asv",
         str(community.reads), "-o", str(out), "-t", "2"],
        capture_output=True, text=True, timeout=280, cwd=Path(__file__).parent.parent,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert (out / "final_asvs.fasta").exists()
    stats = pstats.Stats(str(prof / "profile.pstats"))
    assert len(stats.stats) > 100

"""Pipeline mode tests: pooled samples, low-polymorphism, second replicate,
export of two runs (mirrors integration_test.rs:312-369, 660-812).  The
two "replicates" are the two halves of the seeded 1,000-read community."""
import gzip
from pathlib import Path

import numpy as np
import pytest

from savont_tpu.config import ClusterArgs, ExportArgs
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu.pipeline.export import export

RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def replicates(community, tmp_path_factory):
    """The community's reads split into two FASTQ files of 500 reads each."""
    lines = community.reads.read_text().splitlines(keepends=True)
    half = len(lines) // 8 * 4
    out = tmp_path_factory.mktemp("replicates")
    paths = (out / "rep1.fastq", out / "rep2.fastq")
    paths[0].write_text("".join(lines[:half]))
    paths[1].write_text("".join(lines[half:]))
    return paths


def _mutate(seq: bytes, rate: float) -> bytes:
    b = bytearray(seq)
    for p in RNG.choice(len(b), int(len(b) * rate), replace=False):
        b[p] = b"ACGT"[RNG.integers(4)]
    return bytes(b)


def _write_fastq(path: Path, reads: list[bytes], qual_char: str = "Z") -> None:
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@synthread_{i}\n{r.decode()}\n+\n{qual_char * len(r)}\n")


def test_pooled_samples(tmp_path, replicates):
    out = tmp_path / "pooled"
    args = ClusterArgs(
        input_files=[str(p) for p in replicates],
        output_dir=str(out),
        threads=4,
        pooled_samples=True,
        min_cluster_size=20,
    )
    run_cluster(args)
    ft = (out / "feature-table.tsv").read_text().splitlines()
    header = ft[0].split("\t")
    assert len(header) == 3, "pooled feature table must have 2 sample columns"
    for line in ft[1:]:
        fields = line.split("\t")
        assert len(fields) == 3
        # OTU id embeds dash-separated per-sample depths
        token = fields[0].split("_")[-1]
        parts = token.split("-")
        assert len(parts) == 2
        assert [int(x) for x in parts] == [int(fields[1]), int(fields[2])]
    # at least one ASV seen in both samples
    shared = sum(1 for l in ft[1:] if all(int(x) > 0 for x in l.split("\t")[1:]))
    assert shared > 0


def test_low_polymorphism_auto(tmp_path):
    """Single-strain sample: most reads have no SNPmers -> auto low-poly path
    (main.rs:76-79); pipeline must still emit the one ASV."""
    template = RNG.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 1500).astype(np.uint8).tobytes()
    reads = []
    for i in range(60):
        r = _mutate(template, 0.005)
        if i % 2:
            from savont_tpu.ops.encode import revcomp_bytes

            r = revcomp_bytes(r)
        reads.append(r)
    fq = tmp_path / "single_strain.fq.gz"
    _write_fastq(fq, reads)
    out = tmp_path / "lowpoly"
    args = ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4, min_cluster_size=5)
    run_cluster(args)
    asvs = [l for l in (out / "final_asvs.fasta").read_text().splitlines() if l.startswith(">")]
    assert len(asvs) >= 1
    seqs = [l for l in (out / "final_asvs.fasta").read_text().splitlines() if not l.startswith(">")]
    # consensus should match the template closely (allow end trims)
    assert any(s in template.decode() or template.decode().find(s[:1000]) >= 0 or len(s) > 1200 for s in seqs)


def test_export_two_real_runs(tmp_path, replicates):
    out1 = tmp_path / "r1"
    out2 = tmp_path / "r2"
    run_cluster(ClusterArgs(input_files=[str(replicates[0])], output_dir=str(out1), threads=4, min_cluster_size=5))
    run_cluster(ClusterArgs(input_files=[str(replicates[1])], output_dir=str(out2), threads=4, min_cluster_size=5))
    merged = tmp_path / "merged"
    export(ExportArgs(input_dirs=[str(out1), str(out2)], output_dir=str(merged)))

    lines = (merged / "merged_feature_table.tsv").read_text().splitlines()
    assert lines[0].startswith("#OTU ID\t")
    assert len(lines[0].split("\t")) == 3
    for line in lines[1:]:
        f = line.split("\t")
        assert len(f) == 3
        int(f[1]), int(f[2])
    ft_ids = {l.split("\t")[0] for l in lines[1:]}
    rs_ids = {
        l[1:].split()[0]
        for l in (merged / "merged_rep_seqs.fasta").read_text().splitlines()
        if l.startswith(">")
    }
    assert ft_ids == rs_ids
    shared = sum(
        1 for l in lines[1:] if int(l.split("\t")[1]) > 0 and int(l.split("\t")[2]) > 0
    )
    assert shared > 0, "no ASVs shared between replicates — merge may be broken"


def test_resume_checkpoint(tmp_path, community):
    """--resume: second run reuses the stage-3 checkpoint and produces the
    same ASVs."""
    out = tmp_path / "resume_out"
    args = ClusterArgs(input_files=[str(community.reads)], output_dir=str(out), threads=4, resume=True)
    run_cluster(args)
    first = (out / "final_asvs.fasta").read_text()
    assert (out / "temp" / "checkpoint_stage3.pkl").exists()
    import time as _t

    t0 = _t.time()
    args2 = ClusterArgs(input_files=[str(community.reads)], output_dir=str(out), threads=4, resume=True)
    run_cluster(args2)
    second = (out / "final_asvs.fasta").read_text()
    assert first == second


def test_use_hpc_end_to_end_zymo(tmp_path, community):
    """--use-hpc on the seeded community, NM=0 oracle.  The vote path
    HPC-compresses every oriented read with min-run quality and runs the
    consensus in HPC space (alignment.rs:357-377 + utils.rs:135-184,
    semantics-faithful as of round 4); this pins the contract end-to-end."""
    from savont_tpu.validate import validate_asvs

    out = tmp_path / "hpc_zymo"
    run_cluster(ClusterArgs(input_files=[str(community.reads)], output_dir=str(out), threads=4, use_hpc=True))
    results = validate_asvs(str(out / "final_asvs.fasta"), str(community.templates))
    assert len(results) == community.n_templates
    assert all(r.nm == 0 for r in results)


def test_use_blockmers_end_to_end_zymo(tmp_path, community):
    """--use-blockmers on the seeded community, NM=0 oracle.  NOTE: the
    blockmer branch of stage-2/3 sub-clustering uses the Python path (a
    documented perf cliff, not a correctness one)."""
    from savont_tpu.validate import validate_asvs

    out = tmp_path / "bm_zymo"
    run_cluster(ClusterArgs(input_files=[str(community.reads)], output_dir=str(out), threads=4, use_blockmers=True))
    results = validate_asvs(str(out / "final_asvs.fasta"), str(community.templates))
    assert len(results) == community.n_templates
    assert all(r.nm == 0 for r in results)

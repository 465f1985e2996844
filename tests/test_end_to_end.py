"""Golden end-to-end test, mirroring the reference's primary acceptance test
(tests/integration_test.rs:91-160): run `asv` on a seeded 1,000-read ONT
mock community (db/community.py) and assert every emitted ASV aligns to the
community's templates with NM=0, one ASV per template."""
import pytest


@pytest.fixture(scope="module")
def zymo_output(tmp_path_factory, community):
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline.asv import run_cluster

    out = tmp_path_factory.mktemp("community_asv")
    args = ClusterArgs(input_files=[str(community.reads)], output_dir=str(out), threads=4)
    run_cluster(args)
    return out


def test_asv_generation_and_perfect_alignment(zymo_output, community):
    from savont_tpu.validate import validate_asvs

    asv_fasta = zymo_output / "final_asvs.fasta"
    assert asv_fasta.exists(), "final_asvs.fasta was not created"
    results = validate_asvs(str(asv_fasta), str(community.templates))
    assert results, "savont-tpu produced zero ASVs"
    unmapped = [r.header for r in results if r.nm is None]
    assert not unmapped, f"unmapped ASVs: {unmapped}"
    imperfect = [(r.header, r.nm) for r in results if r.nm != 0]
    assert not imperfect, f"ASVs with NM > 0: {imperfect}"
    # every template recovered, each once
    assert len(results) == community.n_templates
    assert len({r.ref_hit for r in results}) == community.n_templates


def test_outputs_structure(zymo_output):
    ft = (zymo_output / "feature-table.tsv").read_text().splitlines()
    assert ft[0].startswith("#OTU ID\t")
    n_asvs = sum(1 for line in (zymo_output / "final_asvs.fasta").read_text().splitlines() if line.startswith(">"))
    assert len(ft) == n_asvs + 1
    for line in ft[1:]:
        fields = line.split("\t")
        assert len(fields) == 2
        assert fields[0].startswith("final_consensus_")
        int(fields[1])
    # depths in headers match the table
    headers = [l for l in (zymo_output / "final_asvs.fasta").read_text().splitlines() if l.startswith(">")]
    for h, line in zip(headers, ft[1:]):
        assert h[1:].split()[0] == line.split("\t")[0]
    assert (zymo_output / "final_clusters.tsv").exists()
    assert (zymo_output / "temp" / "kmer_clusters_stage2.tsv").exists()


def test_cli_black_box_run(tmp_path, community):
    """Drive the actual CLI end-to-end like integration_test.rs:20,97 does
    with the compiled binary: subprocess `python -m savont_tpu asv`, then
    assert NM=0 on every ASV and feature-table/rep-seqs ID-set equality
    (integration_test.rs:312-369)."""
    import subprocess
    import sys

    out = tmp_path / "cli_out"
    r = subprocess.run(
        [sys.executable, "-m", "savont_tpu", "asv", str(community.reads),
         "-o", str(out), "-t", "4"],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    fasta = out / "final_asvs.fasta"
    assert fasta.exists()
    from savont_tpu.validate import validate_asvs

    results = validate_asvs(str(fasta), str(community.templates))
    assert len(results) == community.n_templates and all(m.nm == 0 for m in results)

    headers = [l[1:].split()[0] for l in fasta.read_text().splitlines() if l.startswith(">")]
    ft_lines = (out / "feature-table.tsv").read_text().splitlines()
    ft_ids = [l.split("\t")[0] for l in ft_lines[1:]]
    assert sorted(ft_ids) == sorted(headers)
    assert (out / "savont.log").exists()
    assert (out / "final_clusters.tsv").exists()

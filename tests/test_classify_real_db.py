"""End-to-end classify/sintax against a realistic EMU-format database.

Instead of downloading EMU, the test builds a loadable EMU-format slice
seeded from the mock community's 16S-like templates (db/community.py) with
2,000 phylogenetically graded decoy refs (savont_tpu/db/synth.py), writes
real species_taxid.fasta + taxonomy.tsv files to disk, and drives the REAL
CLI surface:

  asv pipeline -> classify CLI -> asv_mappings.tsv / species_abundance.tsv
  asv pipeline -> sintax CLI   -> sintax output

asserting each pipeline ASV is assigned to the species of its true source
template (ground truth from the NM=0 validation), mirroring the
reference's soft-skipped real-DB integration test
(tests/integration_test.rs:503-509 of savont)."""
import pytest


@pytest.fixture(scope="module")
def emu_db(tmp_path_factory, community):
    from savont_tpu.db.synth import build_emu_slice

    out = tmp_path_factory.mktemp("realdb")
    info = build_emu_slice(community.templates, out, n_refs=2000, seed=11)
    info["templates"] = community.templates
    return info


@pytest.fixture(scope="module")
def asv_out(tmp_path_factory, community):
    from savont_tpu.cli import main

    out = tmp_path_factory.mktemp("asvrun") / "out"
    rc = main(["asv", str(community.reads), "-o", str(out), "-t", "4"])
    assert rc in (0, None)
    assert (out / "final_asvs.fasta").exists()
    return out


def _true_species(emu_db, asv_fasta):
    """Ground truth: per ASV header, the species of its exact-substring
    source template (every ASV validates NM=0 / exact)."""
    from savont_tpu.io.fastx import read_fastx
    from savont_tpu.ops.encode import revcomp_bytes

    refs = [(r.id, r.seq.upper()) for r in read_fastx(str(emu_db["templates"]))]
    truth = {}
    for rec in read_fastx(str(asv_fasta)):
        seq = rec.seq.upper()
        rc = revcomp_bytes(seq)
        rec_id = rec.id.decode() if isinstance(rec.id, bytes) else rec.id
        for rid, rseq in refs:
            if seq in rseq or rc in rseq or rseq in seq or rseq in rc:
                tid = emu_db["tax_of_seed"][rid]
                truth[rec_id.split()[0]] = emu_db["species_of_tax"][tid]
                break
    return truth


def test_classify_cli_realistic_emu_db(emu_db, asv_out):
    from savont_tpu.cli import main

    rc = main(["classify", "-i", str(asv_out), "-d", str(emu_db["out"]), "-t", "4"])
    assert rc in (0, None)
    mp = asv_out / "asv_mappings.tsv"
    assert mp.exists()
    rows = [line.rstrip("\n").split("\t") for line in mp.open()][1:]
    assert rows, "no ASV mappings written"
    truth = _true_species(emu_db, asv_out / "final_asvs.fasta")
    assert truth, "no ground-truth species resolved"
    # column layout: asv_header depth identity nm tax_id species ...
    by_asv: dict[str, list] = {}
    for r in rows:
        by_asv.setdefault(r[0].split()[0], []).append(r)
    n_checked = n_right = 0
    for asv, sp_true in truth.items():
        hits = by_asv.get(asv)
        assert hits, f"ASV {asv} has no mapping rows"
        species = {h[5] for h in hits}
        n_checked += 1
        if sp_true in species:
            n_right += 1
    # every NM=0 ASV must be assigned its true source species (the exact
    # ref is in the DB, so min-NM = 0 and ties can only be true operons
    # of the same species group)
    assert n_right == n_checked, f"species recall {n_right}/{n_checked}"
    # species_abundance.tsv must carry the real species rows
    sa = (asv_out / "species_abundance.tsv").read_text()
    assert "Zymoseed species" in sa


def test_sintax_cli_realistic_emu_db(emu_db, asv_out, tmp_path):
    from savont_tpu.cli import main

    out = tmp_path / "sintax_out"
    out.mkdir()
    rc = main([
        "sintax", "-i", str(asv_out), "-d", str(emu_db["out"]),
        "-o", str(out), "-t", "4",
    ])
    assert rc in (0, None)
    files = list(out.glob("*.tsv")) + list(out.glob("*.txt"))
    assert files, f"sintax wrote no output in {out}"
    text = "".join(f.read_text() for f in files)
    truth = _true_species(emu_db, asv_out / "final_asvs.fasta")
    # genus-level sanity: the majority of ASVs bootstrap to a genus of the
    # seeded species (synth names them Zymogenus)
    n_zymo = text.count("Zymogenus")
    assert n_zymo >= len(truth) // 2, (
        f"expected most of {len(truth)} ASVs at a Zymogenus genus, saw {n_zymo}"
    )

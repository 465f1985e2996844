"""Stage-4 pileup construction on the mesh (SAVONT_STAGE4_BACKEND=mesh).

The device step runs orient + banded align + traceback walk + count-matrix
scatter sharded over (read, consensus) pairs (parallel/mesh.py
mesh_stage4_pileups / ops/align_jax.sw_pileup_counts); outputs must be
identical to the host path (pipeline/pileup.generate_consensus_pileups)."""
import gzip

import jax
import numpy as np
import pytest

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _workload(tmp_path, seed=17, n_templates=2, n_reads=40, L=1400, hp=False):
    from savont_tpu.ops.encode import revcomp_bytes

    rng = np.random.default_rng(seed)
    t1 = bytearray(rng.choice(BASES, L).tobytes())
    if hp:
        t1[100:105] = b"AAAAA"
    templates = [bytes(t1)]
    for k in range(1, n_templates):
        t2 = bytearray(t1)
        for p in range(120 * k, L, 320):
            t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
        templates.append(bytes(t2))
    reads = []
    for tpl in templates:
        for i in range(n_reads):
            b = bytearray(tpl)
            for p in rng.choice(len(b), 2, replace=False):
                b[p] = b"ACGT"[rng.integers(4)]
            r = bytes(b)
            reads.append(revcomp_bytes(r) if i % 2 else r)
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")
    return fq


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("use_hpc", [False, True])
def test_stage4_mesh_backend_end_to_end(tmp_path, monkeypatch, use_hpc):
    """Full asv run with stage-4 pileups built on the virtual 8-device mesh
    must be byte-identical to the host run (incl. --use-hpc's hp_hist)."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline.asv import run_cluster

    fq = _workload(tmp_path, hp=use_hpc)
    outs = {}
    for tag in ("host", "mesh"):
        if tag == "mesh":
            monkeypatch.setenv("SAVONT_STAGE4_BACKEND", "mesh")
        else:
            monkeypatch.delenv("SAVONT_STAGE4_BACKEND", raising=False)
        out = tmp_path / f"{tag}{int(use_hpc)}"
        run_cluster(
            ClusterArgs(
                input_files=[str(fq)], output_dir=str(out), threads=2,
                min_cluster_size=5, use_hpc=use_hpc,
            )
        )
        outs[tag] = out
    for rel in ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv"):
        a = (outs["host"] / rel).read_bytes()
        b = (outs["mesh"] / rel).read_bytes()
        assert a == b, f"{rel} differs between host and mesh stage-4"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_stage4_mesh_matrices_match_host(tmp_path, monkeypatch):
    """Direct count-matrix parity: capture the host PileupMatrix list and
    the mesh one over the same consensus set; every matrix must be equal."""
    from savont_tpu.pipeline import pileup as pileup_mod

    captured = {}
    real = pileup_mod.generate_consensus_pileups

    def capture(twin_reads, consensuses, args):
        host = real(twin_reads, consensuses, args)
        from savont_tpu.parallel.mesh import mesh_stage4_pileups

        dev = mesh_stage4_pileups(twin_reads, consensuses, args)
        captured["n"] = captured.get("n", 0) + 1
        assert len(host) == len(dev)
        for hm, dm in zip(host, dev):
            assert np.array_equal(hm.bq, dm.bq), "bq differs"
            assert np.array_equal(hm.dels, dm.dels), "dels differs"
            assert np.array_equal(hm.ins_q, dm.ins_q), "ins_q differs"
            if hm.hp_hist is not None:
                assert np.array_equal(hm.hp_hist, dm.hp_hist), "hp_hist differs"
        return host

    monkeypatch.setattr(pileup_mod, "generate_consensus_pileups", capture)
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline.asv import run_cluster

    fq = _workload(tmp_path, seed=29)
    run_cluster(
        ClusterArgs(
            input_files=[str(fq)], output_dir=str(tmp_path / "o"), threads=2,
            min_cluster_size=5,
        )
    )
    assert captured.get("n", 0) >= 1, "pileup construction never ran"

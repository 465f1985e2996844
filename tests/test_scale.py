"""Opt-in scale test (SAVONT_RUN_SLOW=1): the seeded 20k-read mock community
(db/community.py) must stay NM=0-perfect and finish in linear-ish time.  Guards the
vectorized stage-3 paths whose dict-loop ancestors were superlinear in
cluster depth."""
import os
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not os.environ.get("SAVONT_RUN_SLOW"), reason="set SAVONT_RUN_SLOW=1 to run"
)


def test_20k_synthetic_scale(tmp_path):
    from savont_tpu.config import ClusterArgs
    from savont_tpu.db.community import write_community
    from savont_tpu.pipeline.asv import run_cluster
    from savont_tpu.validate import validate_asvs

    comm = write_community(tmp_path / "data", 20000)
    t0 = time.time()
    out_dir = tmp_path / "out"
    run_cluster(ClusterArgs(input_files=[str(comm.reads)], output_dir=str(out_dir), threads=4))
    wall = time.time() - t0
    res = validate_asvs(str(out_dir / "final_asvs.fasta"), str(comm.templates))
    assert res, "no ASVs"
    assert all(r.nm == 0 for r in res), [r.nm for r in res]
    assert len(res) == comm.n_templates
    assert wall < 300, f"20k reads took {wall:.0f}s — superlinear regression?"


def test_5k_native_vs_python_determinism(tmp_path):
    """Determinism audit: the native greedy loops (stage-2 LSH, stage-3
    SNPmer sub-clustering, recluster round, DP batches) must produce
    byte-identical cluster TSVs and ASVs to the pure-Python/NumPy fallback
    at realistic scale.  Small-scale equivalence lives in test_native.py;
    this guards the bit-exactness story as perf refactors land.  Runs the
    CLI in subprocesses because the native-lib choice is cached per
    process."""
    import subprocess
    import sys

    from savont_tpu.db.community import write_community

    path = write_community(tmp_path / "data", 5000).reads
    outs = {}
    for tag, extra_env in [("native", {}), ("python", {"SAVONT_NO_NATIVE": "1"})]:
        out_dir = tmp_path / tag
        env = dict(os.environ, **extra_env)
        r = subprocess.run(
            [sys.executable, "-m", "savont_tpu", "asv", str(path), "-o", str(out_dir), "-t", "4"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        outs[tag] = out_dir

    compare = [
        "final_asvs.fasta",
        "final_clusters.tsv",
        "temp/kmer_clusters_stage2.tsv",
        "temp/final_snpmer_clusters_stage3.tsv",
        "temp/final_clusters_merged_stage5.tsv",
        "temp/read_to_asv_mappings.tsv",
    ]
    for rel in compare:
        a = (outs["native"] / rel).read_bytes()
        b = (outs["python"] / rel).read_bytes()
        assert a == b, f"{rel} differs between native and Python paths"

#!/usr/bin/env python
"""100k-read scale benchmark.

Generates the same synthetic ONT-like readset construction as bench.py at
N=100000, runs the full fastq->ASV pipeline best-of-3 with a per-stage
wall/cpu split, validates 8/8 template ASVs at NM=0, and writes
SCALE100K.json at the repo root.

Run alone on the VM: this machine shows ~8%+ hypervisor steal with bursts
that can double a single run (CLAUDE.md), hence best-of-N and the
published cpu split alongside wall.
"""
import gzip
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (repo-root bench.py: reuses its generator)

N = 100000


def main() -> int:
    logging.basicConfig(level=logging.WARNING)
    import numpy as np  # noqa: F401

    from savont_tpu.pipeline import (  # noqa: E402
        stage1_kmers,
        stage23_cluster,
        stage4_consensus,
        stage5_merge,
        stage6_chimera,
        stage7_em,
    )
    from savont_tpu.validate import validate_asvs

    bench.N_SYNTH = N
    work = Path(tempfile.mkdtemp(prefix="savont_100k_"))
    synth = work / "synth100k.fq.gz"
    t0 = time.time()
    bench._gen_synth(synth)
    print(f"gen: {time.time() - t0:.1f}s", flush=True)

    stages = [
        (stage1_kmers, "read_to_split_kmers", "s1_count"),
        (stage1_kmers, "get_snpmers", "s1_snpmers"),
        (stage1_kmers, "twin_reads_from_files", "s1_5_twin_reads"),
        (stage23_cluster, "cluster_reads_by_kmers", "s2_lsh"),
        (stage23_cluster, "cluster_reads_by_snpmers", "s3_snpmer"),
        (stage4_consensus, "align_and_consensus", "s4_consensus"),
        (stage5_merge, "merge_similar_consensuses", "s5_merge"),
        (stage6_chimera, "detect_chimeras", "s6_chimera"),
        (stage7_em, "refine_asv_depths_with_em", "s7_em"),
    ]
    acc: dict[str, list[float]] = {}

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def inner(*a, **k):
            t0 = time.perf_counter()
            c0 = os.times()
            r = fn(*a, **k)
            c1 = os.times()
            w, c = acc.get(label, (0.0, 0.0))
            acc[label] = (
                w + time.perf_counter() - t0,
                c + (c1.user - c0.user + c1.system - c0.system),
            )
            return r

        setattr(mod, name, inner)

    for mod, name, label in stages:
        wrap(mod, name, label)

    out = work / "out100k"
    walls, splits = [], []
    try:
        for i in range(3):
            acc.clear()
            t0 = time.time()
            bench._run_once(synth, out)
            walls.append(time.time() - t0)
            splits.append(dict(acc))
            print(f"run {i}: {walls[-1]:.2f}s = {N / walls[-1]:.0f} reads/s", flush=True)
        best = int(np.argmin(walls))
        res = validate_asvs(str(out / "final_asvs.fasta"), str(bench.REF_ASVS))
        ok = len(res) >= 8 and all(r.nm == 0 for r in res)
        record = {
            "n_reads": N,
            "wall_s_best_of_3": round(min(walls), 2),
            "reads_per_s": round(N / min(walls), 1) if ok else 0.0,
            "walls_s": [round(w, 2) for w in walls],
            "n_asvs": len(res),
            "all_nm0": ok,
            "stage_split_best_run": {
                k: {"wall_s": round(v[0], 2), "cpu_s": round(v[1], 2)}
                for k, v in sorted(splits[best].items())
            },
            "note": (
                "synthetic ONT-like reads from 10 Zymo templates (bench.py "
                "construction, seed 42); ~8% hypervisor steal on this VM — "
                "single runs can degrade 50%+, hence best-of-3"
            ),
        }
        (REPO / "SCALE100K.json").write_text(json.dumps(record, indent=1) + "\n")
        print(json.dumps(record))
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    import numpy as np  # noqa: F401

    sys.exit(main())

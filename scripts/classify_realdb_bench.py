#!/usr/bin/env python
"""Prefilter recall vs an exhaustive-align oracle on the realistic
template-seeded EMU slice.

Unlike classify_scale_bench.py (uniform synthetic families), the DB here
is built by savont_tpu/db/synth.py from the seeded mock community's
16S-like templates (db/community.py) with phylogenetically graded decoys
(0.3% / 2-8% / 10-20% divergence + length variation) — the regime a real
EMU/SILVA prefilter faces.  Queries are (a) the pipeline ASVs of the
community's 1,000 reads and (b) raw error-laden reads.  Recall = the minimizer candidate set attains the
exhaustive best alignment score over the whole DB.

Appends a line to CLASSIFY_SCALE.json.  Usage:
    python scripts/classify_realdb_bench.py [n_refs] [n_read_queries]
"""
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))



def main() -> int:
    n_refs = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    n_read_q = int(sys.argv[2]) if len(sys.argv) > 2 else 24

    from savont_tpu.config import ClusterArgs
    from savont_tpu.db.community import write_community
    from savont_tpu.db.synth import build_emu_slice
    from savont_tpu.io.fastx import read_fastx
    from savont_tpu.ops.align_batch import align_pairs_nm_indexed
    from savont_tpu.pipeline.asv import run_cluster
    from savont_tpu.pipeline.classify import DbMinimizerTable

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory(prefix="realdb_") as td:
        comm = write_community(Path(td) / "community", 1000)
        print(f"building {n_refs}-ref template-seeded EMU slice...", flush=True)
        t0 = time.time()
        info = build_emu_slice(comm.templates, td, n_refs=n_refs, seed=11)
        db_records = [
            (r.id, r.seq.upper())
            for r in read_fastx(str(Path(info["out"]) / "species_taxid.fasta"))
        ]
        refs = [s for _, s in db_records]
        t_synth = time.time() - t0
        print(f"  {t_synth:.1f}s ({len(refs)} refs, "
              f"len {min(map(len, refs))}-{max(map(len, refs))})", flush=True)

        print("running asv pipeline for query ASVs...", flush=True)
        out = Path(td) / "asvout"
        run_cluster(ClusterArgs(input_files=[str(comm.reads)], output_dir=str(out), threads=4))
        asv_q = [r.seq.upper() for r in read_fastx(str(out / "final_asvs.fasta"))]
        reads = [r.seq.upper() for r in read_fastx(str(comm.reads))]
        sel = rng.choice(len(reads), n_read_q, replace=False)
        read_q = [reads[i] for i in sel]
        queries = asv_q + read_q
        q_kind = ["asv"] * len(asv_q) + ["read"] * len(read_q)
        nq = len(queries)

        t0 = time.time()
        table = DbMinimizerTable(refs)
        t_table = time.time() - t0
        t0 = time.time()
        cand_sets, dropped = [], []
        for q in queries:
            c, d = table.candidates(q)
            cand_sets.append(c)
            dropped.append(d)
        t_cand = time.time() - t0
        cs = [len(c) for c in cand_sets]
        print(f"candidates: {t_cand:.2f}s; sizes {min(cs)}/{int(np.median(cs))}/{max(cs)}",
              flush=True)

        t0 = time.time()
        qi_c = np.concatenate([np.full(len(c), i, np.int64) for i, c in enumerate(cand_sets)])
        ti_c = np.concatenate(cand_sets).astype(np.int64)
        maps_cand = align_pairs_nm_indexed(queries, refs, qi_c, ti_c, coords=False)
        t_align = time.time() - t0

        print(f"exhaustive oracle: {nq} x {len(refs)} pairs...", flush=True)
        t0 = time.time()
        best_score = np.full(nq, -1, np.int64)
        best_nm = np.full(nq, -1, np.int64)
        all_ti = np.arange(len(refs), dtype=np.int64)
        for qx in range(nq):
            maps = align_pairs_nm_indexed(
                [queries[qx]], refs, np.zeros(len(refs), np.int64), all_ti, coords=False
            )
            for m in maps:
                if m is not None and m.score > best_score[qx]:
                    best_score[qx] = m.score
                    best_nm[qx] = m.nm
        t_oracle = time.time() - t0

        hits = 0
        misses = []
        off = 0
        for qx, c in enumerate(cand_sets):
            mq = maps_cand[off : off + len(c)]
            off += len(c)
            sc = max((m.score for m in mq if m is not None), default=-1)
            if best_score[qx] < 0 or sc == best_score[qx]:
                hits += 1
            else:
                misses.append({"q": qx, "kind": q_kind[qx], "cand_best": int(sc),
                               "true_best": int(best_score[qx])})
        recall = hits / nq
        print(f"RECALL = {recall:.3f} ({hits}/{nq}); misses: {misses}", flush=True)

        rec = {
            "db": "zymo-seeded EMU slice (db/synth.py): real 16S operons + graded decoys",
            "n_refs": len(refs), "n_queries": nq,
            "query_mix": f"{len(asv_q)} pipeline ASVs + {len(read_q)} raw ONT reads",
            "recall": recall, "misses": misses,
            "cand_size_median": int(np.median(cs)), "cand_size_max": max(cs),
            "t_table_build_s": round(t_table, 2), "t_candidates_s": round(t_cand, 3),
            "t_candidate_align_s": round(t_align, 2),
            "t_exhaustive_oracle_s": round(t_oracle, 1),
        }
        with open(REPO / "CLASSIFY_SCALE.json", "a") as f:
            f.write("\n" + json.dumps(rec))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

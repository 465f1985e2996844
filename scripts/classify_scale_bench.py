"""SILVA-scale classify validation (classify.rs:152-189).

Synthesizes a 100k-reference DB (2k families x 50 variants at ~2%
divergence — the hard case for a prefilter: many near-identical refs),
then measures:

  1. PREFILTER RECALL: for error-laden query reads, does the minimizer
     candidate set (DbMinimizerTable.candidates) contain a ref achieving
     the exhaustive BEST SCORE over the WHOLE DB?  (classify ranks hits by
     alignment score — minimap2 primary semantics, classify.py:255 — and
     reports the NM of the best-scoring hit; a naive min-NM oracle is
     hijacked by short spurious local matches with NM=0.)
  2. WALL: DB table build + per-query candidate+align time at 100k refs.

Writes CLASSIFY_SCALE.json.  Usage:
    python scripts/classify_scale_bench.py [n_refs] [n_queries]
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    n_refs = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_queries = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    L = 1500
    n_fam = max(n_refs // 50, 1)

    from savont_tpu.ops.align_batch import align_pairs_nm_indexed  # noqa: F401
    from savont_tpu.pipeline.classify import DbMinimizerTable

    rng = np.random.default_rng(7)
    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

    print(f"synthesizing {n_refs} refs ({n_fam} families)...", flush=True)
    t0 = time.time()
    fams = rng.integers(0, 4, (n_fam, L)).astype(np.uint8)
    refs: list[bytes] = []
    per_fam = -(-n_refs // n_fam)
    LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
    for f in range(n_fam):
        base = fams[f]
        for v in range(per_fam):
            if len(refs) >= n_refs:
                break
            r = base.copy()
            muts = rng.choice(L, int(0.02 * L), replace=False)
            r[muts] = (r[muts] + rng.integers(1, 4, len(muts))) % 4
            refs.append(LUT[r].tobytes())
    t_synth = time.time() - t0
    print(f"  {t_synth:.1f}s", flush=True)

    print("building DB minimizer table...", flush=True)
    t0 = time.time()
    table = DbMinimizerTable(refs)
    t_table = time.time() - t0
    print(f"  {t_table:.1f}s ({len(table.hashes)} entries)", flush=True)

    # queries: reads at ~5% error from random refs
    src = rng.choice(n_refs, n_queries, replace=False)
    queries = []
    for s in src:
        q = np.frombuffer(refs[s], dtype=np.uint8).copy()
        muts = rng.choice(L, int(0.05 * L), replace=False)
        code = np.zeros(L, np.uint8)
        for i, b in enumerate(b"ACGT"):
            code[q == b] = i
        code[muts] = (code[muts] + rng.integers(1, 4, len(muts))) % 4
        queries.append(LUT[code].tobytes())

    # prefilter candidates + wall
    t0 = time.time()
    cand_sets, dropped = [], []
    for q in queries:
        c, d = table.candidates(q)
        cand_sets.append(c)
        dropped.append(d)
    t_cand = time.time() - t0
    cand_sizes = [len(c) for c in cand_sets]
    print(f"candidates: {t_cand:.2f}s for {n_queries} queries; "
          f"sizes min/med/max = {min(cand_sizes)}/{int(np.median(cand_sizes))}/{max(cand_sizes)}; "
          f"dropped-by-floor med {int(np.median(dropped))}", flush=True)

    # candidate alignment wall (the classify hot loop: score-ranked)


    t0 = time.time()
    qi_c = np.concatenate([np.full(len(c), i, np.int64) for i, c in enumerate(cand_sets)])
    ti_c = np.concatenate(cand_sets).astype(np.int64)
    maps_cand = align_pairs_nm_indexed(queries, refs, qi_c, ti_c, coords=False)
    t_align = time.time() - t0
    print(f"candidate align: {t_align:.2f}s for {len(qi_c)} pairs", flush=True)

    # ground truth: best SCORE over the WHOLE DB; report that hit's NM
    print(f"exhaustive oracle: {n_queries} x {n_refs} pairs...", flush=True)
    t0 = time.time()
    best_score_all = np.full(n_queries, -1, np.int64)
    best_nm_all = np.full(n_queries, -1, np.int64)
    chunk = 1_000_000
    all_ti = np.arange(n_refs, dtype=np.int64)
    for qx in range(n_queries):
        for s in range(0, n_refs, chunk):
            e = min(s + chunk, n_refs)
            qi = np.zeros(e - s, np.int64)
            maps = align_pairs_nm_indexed(
                [queries[qx]], refs[s:e], qi, all_ti[: e - s], coords=False
            )
            for m in maps:
                if m is not None and m.score > best_score_all[qx]:
                    best_score_all[qx] = m.score
                    best_nm_all[qx] = m.nm
        print(f"  q{qx}: best score={best_score_all[qx]} nm={best_nm_all[qx]} "
              f"({time.time()-t0:.0f}s cum)", flush=True)
    t_oracle = time.time() - t0

    # recall: the candidate set achieves the exhaustive best score
    hits = 0
    misses = []
    off = 0
    for qx, c in enumerate(cand_sets):
        mq = maps_cand[off : off + len(c)]
        off += len(c)
        sc = max((m.score for m in mq if m is not None), default=-1)
        if best_score_all[qx] < 0 or sc == best_score_all[qx]:
            hits += 1
        else:
            misses.append(
                {"q": qx, "cand_best_score": int(sc),
                 "true_best_score": int(best_score_all[qx]),
                 "true_best_nm": int(best_nm_all[qx])}
            )
    recall = hits / n_queries
    print(f"RECALL = {recall:.3f} ({hits}/{n_queries}); misses: {misses}", flush=True)

    rec = {
        "n_refs": n_refs, "n_queries": n_queries, "L": L,
        "families": n_fam, "recall": recall, "misses": misses,
        "cand_size_median": int(np.median(cand_sizes)),
        "cand_size_max": max(cand_sizes),
        "dropped_by_floor_median": int(np.median(dropped)),
        "t_table_build_s": round(t_table, 2),
        "t_candidates_s": round(t_cand, 3),
        "t_candidate_align_s": round(t_align, 2),
        "t_exhaustive_oracle_s": round(t_oracle, 1),
        "per_query_classify_ms": round((t_cand + t_align) * 1000 / n_queries, 1),
    }
    with open("CLASSIFY_SCALE.json", "w") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

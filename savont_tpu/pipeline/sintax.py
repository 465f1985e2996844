"""`sintax` subcommand: k-mer bootstrap genus-level classification
(sintax.rs).  Embarrassingly data-parallel over the reference database —
the natural multi-chip sweep (DB shards per device, max-reduce of hit
scores)."""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from ..config import SintaxArgs
from ..constants import ASV_FILE, SINTAX_K, SINTAX_SUBSAMPLE
from ..db import taxonomy as tax
from ..io.fastx import read_fastx

log = logging.getLogger("savont")

_BYTE_CODE = np.zeros(256, dtype=np.uint32)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for _ch in _b:
        _BYTE_CODE[_ch] = _c


def extract_kmers(seq: bytes, k: int = SINTAX_K) -> np.ndarray:
    """Canonical k-mers as u32 (sintax.rs:37-55), vectorized."""
    codes = _BYTE_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    f = np.zeros(n, dtype=np.uint32)
    r = np.zeros(n, dtype=np.uint32)
    for j in range(k):
        f |= codes[j : j + n] << np.uint32(2 * (k - 1 - j))
        r |= (np.uint32(3) - codes[j : j + n]) << np.uint32(2 * j)
    return np.minimum(f, r)


class Xorshift:
    """Exact replica of the reference's deterministic RNG (sintax.rs:18-33)."""

    def __init__(self, seed: int):
        self.s = max(seed, 1) & 0xFFFFFFFFFFFFFFFF

    def next(self) -> int:
        s = self.s
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = s
        return s

    def next_usize(self, n: int) -> int:
        return self.next() % n


def _host_scores(subs: np.ndarray, sentinel: np.uint32, db: tax.Database, n_pairs: int):
    """Phase 2, host path: stream the database once; per ref, dedup k-mers,
    bump (asv, iter) hit counts, keep the argmax ref's taxonomy per pair
    (strictly greater — ties keep the earliest ref, sintax.rs:219-273).
    The query map is a CSR structure so per-ref scoring is pure vector ops
    (real DBs have 10^5-10^6 references)."""
    live = subs.reshape(-1) != sentinel
    pair_of = np.repeat(np.arange(n_pairs, dtype=np.int64), subs.shape[1])[live]
    flat = subs.reshape(-1)[live]
    order = np.argsort(flat, kind="stable")
    flat, pair_of = flat[order], pair_of[order]
    query_keys_sorted = np.unique(flat)
    csr_off = np.searchsorted(flat, query_keys_sorted, side="left")
    csr_off = np.append(csr_off, len(flat)).astype(np.int64)
    csr_pairs = pair_of

    best_scores = np.zeros(n_pairs, dtype=np.int32)
    best_ref = np.full(n_pairs, -1, dtype=np.int64)
    ref_entries: list[tax.TaxonomyEntry] = []
    n_refs = 0
    for rec in read_fastx(str(db.fasta_path)):
        n_refs += 1
        key = db.extract_key(rec.id)
        if key is None:
            continue
        entry = db.taxonomy.get(key)
        if entry is None:
            continue
        ref_kmers = np.unique(extract_kmers(rec.seq.upper()))
        if len(ref_kmers) == 0:
            continue
        pos = np.searchsorted(query_keys_sorted, ref_kmers)
        pos = np.minimum(pos, max(len(query_keys_sorted) - 1, 0))
        hit = query_keys_sorted[pos] == ref_kmers if len(query_keys_sorted) else np.zeros(0, bool)
        key_idx = pos[hit]
        if len(key_idx) == 0:
            continue
        # expand CSR ranges -> flat pair indices; count hits per pair
        lens = csr_off[key_idx + 1] - csr_off[key_idx]
        total = int(lens.sum())
        if total == 0:
            continue
        starts = np.repeat(csr_off[key_idx], lens)
        within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
        pair_hits = csr_pairs[starts + within]
        counts = np.bincount(pair_hits, minlength=n_pairs).astype(np.int32)
        better = counts > best_scores
        if better.any():
            ref_entries.append(entry)
            best_scores = np.where(better, counts, best_scores)
            best_ref = np.where(better, len(ref_entries) - 1, best_ref)
        if n_refs % 10000 == 0:
            log.info("Processed %d reference sequences...", n_refs)
    best_tax: list[tax.TaxonomyEntry | None] = [
        ref_entries[r] if r >= 0 else None for r in best_ref
    ]
    return best_scores, best_tax


def _device_scores(subs: np.ndarray, sentinel: np.uint32, db: tax.Database, n_pairs: int):
    """Phase 2, mesh path (SAVONT_SINTAX_BACKEND=jax): the database is
    sharded across ALL visible devices (BASELINE.json config 5).  Each
    device scores its reference shard against the replicated query matrix;
    per-pair (score, earliest-ref) winners are pmax-reduced across the mesh via a
    packed uint32 key, so outputs are bit-identical to the host stream.
    References stream through fixed-shape (chunk, L) buckets to bound
    memory and recompiles."""
    from ..parallel.mesh import make_mesh, sharded_sintax_scores

    mesh = make_mesh()
    n_dev = mesh.devices.size
    step = sharded_sintax_scores(mesh, subs)
    REF_PAD = np.uint32(0xFFFFFFFF)
    rd = 128  # refs per device per chunk
    chunk_rows = n_dev * rd

    entries: list[tax.TaxonomyEntry] = []
    pend_k: list[np.ndarray] = []
    best_key = np.zeros(n_pairs, dtype=np.uint32)
    n_refs = 0

    def flush():
        nonlocal best_key
        if not pend_k:
            return
        lmax = max(len(a) for a in pend_k)
        L = max(8, 1 << (lmax - 1).bit_length())  # pow2 buckets bound recompiles
        refk = np.full((chunk_rows, L), REF_PAD, dtype=np.uint32)
        ridx = np.zeros(chunk_rows, dtype=np.uint32)
        base = len(entries) - len(pend_k)
        for i, a in enumerate(pend_k):
            refk[i, : len(a)] = a
            ridx[i] = base + i
        best_key = np.maximum(best_key, np.asarray(step(refk, ridx)))
        pend_k.clear()

    for rec in read_fastx(str(db.fasta_path)):
        n_refs += 1
        key = db.extract_key(rec.id)
        if key is None:
            continue
        entry = db.taxonomy.get(key)
        if entry is None:
            continue
        ref_kmers = np.unique(extract_kmers(rec.seq.upper()))
        if len(ref_kmers) == 0:
            continue
        entries.append(entry)
        pend_k.append(ref_kmers)
        if len(pend_k) == chunk_rows:
            flush()
        if n_refs % 10000 == 0:
            log.info("Processed %d reference sequences...", n_refs)
    flush()

    best_scores = (best_key >> np.uint32(26)).astype(np.int32)
    ordinal = np.uint32(0x3FFFFFF) - (best_key & np.uint32(0x3FFFFFF))
    best_tax = [
        entries[int(o)] if k > 0 else None for k, o in zip(best_key, ordinal)
    ]
    log.info(
        "SINTAX device scoring: %d kept refs sharded over %d devices",
        len(entries), n_dev,
    )
    return best_scores, best_tax


def sintax(args: SintaxArgs, db: tax.Database) -> None:
    input_fasta = Path(args.input_dir) / ASV_FILE
    if not input_fasta.exists():
        raise SystemExit(f"Input FASTA not found: {input_fasta}")
    sequences = [(f">{r.id}", r.seq.upper()) for r in read_fastx(str(input_fasta))]
    if not sequences:
        log.warning("No sequences in %s", input_fasta)
        return
    n_asvs = len(sequences)
    n_iter = args.n_iter
    n_pairs = n_asvs * n_iter
    asv_depths = tax.extract_depths_from_headers([h for h, _ in sequences])
    total_reads = sum(asv_depths)

    # Phase 1: subsample 32 k-mers per (asv, iter) with the seeded xorshift
    # into a dense (n_pairs, 32) matrix.  Rows of k-mer-less ASVs hold the
    # 0xFFFFFFFE sentinel (k=12 k-mers are < 2^24, so it never matches).
    log.info("Building SINTAX query map (%d ASVs x %d iterations)", n_asvs, n_iter)
    QUERY_SENTINEL = np.uint32(0xFFFFFFFE)
    subs = np.full((n_pairs, SINTAX_SUBSAMPLE), QUERY_SENTINEL, dtype=np.uint32)
    for asv_i, (_, seq) in enumerate(sequences):
        kmers = extract_kmers(seq)
        if len(kmers) == 0:
            continue
        for iter_j in range(n_iter):
            rng = Xorshift(asv_i * n_iter + iter_j + 1)
            row = subs[asv_i * n_iter + iter_j]
            for s in range(SINTAX_SUBSAMPLE):
                row[s] = kmers[rng.next_usize(len(kmers))]

    if os.environ.get("SAVONT_SINTAX_BACKEND") == "jax":
        best_scores, best_tax = _device_scores(subs, QUERY_SENTINEL, db, n_pairs)
    else:
        best_scores, best_tax = _host_scores(subs, QUERY_SENTINEL, db, n_pairs)
    # Phase 3: per-rank votes -> bootstrap fractions
    all_hits: list[dict | None] = []
    for asv_i in range(n_asvs):
        base = asv_i * n_iter
        votes = {r: {} for r in ("species", "genus", "family", "order", "class_", "phylum", "superkingdom")}
        classified = 0
        for j in range(n_iter):
            e = best_tax[base + j]
            if e is not None and best_scores[base + j] > 0:
                classified += 1
                for rank in votes:
                    v = getattr(e, rank)
                    votes[rank][v] = votes[rank].get(v, 0) + 1
        if classified == 0:
            all_hits.append(None)
            continue

        def top(rank):
            if not votes[rank]:
                return "", 0.0
            name, count = max(votes[rank].items(), key=lambda x: x[1])
            return name, count / n_iter

        header = sequences[asv_i][0].lstrip(">").split()[0]
        hit = {"asv_header": header, "depth": asv_depths[asv_i],
               "abundance": asv_depths[asv_i] / total_reads if total_reads else 0.0}
        for rank in votes:
            name, boot = top(rank)
            hit[rank] = name
            hit[rank + "_boot"] = boot
        all_hits.append(hit)

    # sort by abundance desc (None -> 0)
    order = sorted(range(n_asvs), key=lambda i: -(all_hits[i]["abundance"] if all_hits[i] else 0.0))
    all_hits = [all_hits[i] for i in order]
    seq_order = [sequences[i] for i in order]
    depth_order = [asv_depths[i] for i in order]

    def to_classification(i: int) -> tax.AsvClassification:
        h = all_hits[i]
        header = seq_order[i][0].lstrip(">").split()[0]
        if h is None:
            return tax.AsvClassification(
                asv_id=header, asv_header=header,
                abundance=depth_order[i] / max(total_reads, 1),
            )
        unc = f"UNCLASSIFIED-({h['asv_header']})" if args.detailed_unclassified else "UNCLASSIFIED"
        ap = lambda rank: h[rank] if h[rank + "_boot"] >= args.min_bootstrap else unc
        ta = tax.TaxonomyAssignment(
            species=unc,  # sintax is genus-level max
            genus=ap("genus"), family=ap("family"), order=ap("order"),
            class_=ap("class_"), phylum=ap("phylum"), superkingdom=ap("superkingdom"),
        )
        return tax.AsvClassification(
            asv_id=h["asv_header"], asv_header=h["asv_header"],
            abundance=h["abundance"], taxonomy=ta,
        )

    classifications = [to_classification(i) for i in range(n_asvs)]
    out_dir = Path(args.output_dir) if args.output_dir else Path(args.input_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tax.write_genus_abundance(classifications, out_dir / "genus_abundance.tsv")

    with open(out_dir / "asv_mappings.tsv", "w") as f:
        f.write(
            "asv_header\tdepth\tspecies_bootstrap\tgenus_bootstrap\tfamily_bootstrap\t"
            "order_bootstrap\tclass_bootstrap\tphylum_bootstrap\tsuperkingdom_bootstrap\t"
            "species\tgenus\tfamily\torder\tclass\tphylum\tsuperkingdom\n"
        )
        ranks = ["species", "genus", "family", "order", "class_", "phylum", "superkingdom"]
        for h in all_hits:
            if h is None:
                continue
            ap = lambda rank: h[rank] if h[rank + "_boot"] >= args.min_bootstrap else "UNCLASSIFIED"
            boots = "\t".join(f"{h[r + '_boot']:.3f}" for r in ranks)
            names = "\t".join(["UNCLASSIFIED"] + [ap(r) for r in ranks[1:]])
            f.write(f"{h['asv_header']}\t{h['depth']}\t{boots}\t{names}\n")

    classified = sum(1 for h in all_hits if h is not None)
    log.info("SINTAX complete: %d/%d ASVs classified", classified, n_asvs)

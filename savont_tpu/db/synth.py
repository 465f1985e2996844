"""Realistic EMU-format database slices for offline validation.

The classify/sintax validation story needs a database with a 16S-like
length/composition/divergence structure, without a network to download
EMU/SILVA.  This module builds the next-best thing: an EMU-format slice
seeded from 16S sequences (the seeded mock community's templates,
db/community.py, or real rRNA operons), expanded with phylogenetically
graded decoys:

  - intra-species operon variants     (~0.3% divergence, same species)
  - sibling species in the genus      (2-8% divergence, own species rows)
  - same-family relatives             (10-20% divergence)
  - unrelated background              (shuffled composition, other phyla)

with +/-8% length variation via structural indels — the hard regime for a
minimizer prefilter (many near-identical refs around every true hit).

The output directory is a loadable EMU database (species_taxid.fasta +
12-column taxonomy.tsv + .savont_db marker), exercised end-to-end by
tests/test_classify_real_db.py through the classify and sintax CLIs.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(rng, codes: np.ndarray, sub_rate: float, n_indels: int = 0) -> np.ndarray:
    """Substitutions at sub_rate plus n_indels random 1-30 bp indels."""
    out = codes.copy()
    n_sub = int(round(sub_rate * len(out)))
    if n_sub:
        pos = rng.choice(len(out), min(n_sub, len(out)), replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, len(pos)).astype(np.uint8)) % 4
    for _ in range(n_indels):
        ln = int(rng.integers(1, 31))
        at = int(rng.integers(0, max(len(out) - ln, 1)))
        if rng.random() < 0.5 and len(out) > ln + 50:
            out = np.concatenate([out[:at], out[at + ln:]])
        else:
            ins = rng.integers(0, 4, ln).astype(np.uint8)
            out = np.concatenate([out[:at], ins, out[at:]])
    return out


def _species_groups(seqs: list[bytes]) -> list[int]:
    """Group near-identical sequences (>=99% identity or containment) into
    species via union-find over pairwise NM."""
    from ..ops.align_batch import align_pairs_nm

    n = len(seqs)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    pairs, ij = [], []
    for i in range(n):
        for j in range(i + 1, n):
            pairs.append((seqs[i], seqs[j]))
            ij.append((i, j))
    res = align_pairs_nm(pairs, coords=True)
    for (i, j), m in zip(ij, res):
        if m is None:
            continue
        span = max(m.query_end - m.query_start, 1)
        ident = 1.0 - m.nm / span
        cover = span / min(len(seqs[i]), len(seqs[j]))
        if ident >= 0.99 and cover >= 0.9:
            parent[find(i)] = find(j)
    roots = {}
    return [roots.setdefault(find(i), len(roots)) for i in range(n)]


def build_emu_slice(
    seed_fasta: str | Path, out_dir: str | Path, n_refs: int = 10000, seed: int = 11
) -> dict:
    """Build an EMU-format DB at out_dir/emu from the real seed sequences.

    Returns {"tax_of_seed": {seed_record_id: tax_id}, "n_refs": N,
    "species_of_tax": {tax_id: species_name}} so callers can assert
    classification ground truth.
    """
    from ..io.fastx import read_fastx
    from .registry import write_marker

    rng = np.random.default_rng(seed)
    seeds = [(r.id, np.frombuffer(r.seq.upper(), np.uint8)) for r in read_fastx(str(seed_fasta))]
    seed_codes = []
    for _sid, s in seeds:
        c = np.zeros(len(s), np.uint8)
        for v, b in enumerate(b"ACGT"):
            c[s == b] = v
        seed_codes.append(c)
    groups = _species_groups([_BASES[c].tobytes() for c in seed_codes])
    n_species_real = max(groups) + 1

    out = Path(out_dir) / "emu"
    out.mkdir(parents=True, exist_ok=True)

    records: list[tuple[str, str, bytes]] = []  # (tax_id, ref_id, seq)
    tax_rows: dict[str, tuple] = {}  # tax_id -> (species, genus, family, order, ...)
    tax_of_seed: dict[str, str] = {}
    next_tax = [1000]

    def add_taxon(species, genus, family, order="Bacillales", cls="Bacilli",
                  phylum="Bacillota", clade="", kingdom="Bacteria"):
        tid = str(next_tax[0])
        next_tax[0] += 1
        tax_rows[tid] = (species, genus, family, order, cls, phylum, clade,
                         kingdom, "", "", "")
        return tid

    # real species: one taxon per species group; every seed ref + operon
    # variants filed under it
    species_tax = []
    for g in range(n_species_real):
        tid = add_taxon(f"Zymoseed species {g}", f"Zymogenus_{g % 8}",
                        f"Zymofam_{g % 4}")
        species_tax.append(tid)
    for (sid, _s), c, g in zip(seeds, seed_codes, groups):
        tid = species_tax[g]
        tax_of_seed[sid] = tid
        records.append((tid, f"seed_{sid}", _BASES[c].tobytes()))

    budget = n_refs - len(records)
    n_near = int(budget * 0.15)     # intra-species operon variants
    n_sib = int(budget * 0.35)      # sibling species, same genus
    n_fam = int(budget * 0.30)      # same-family relatives; rest background

    for i in range(n_near):
        g = int(rng.integers(0, len(seed_codes)))
        tid = species_tax[groups[g]]
        v = _mutate(rng, seed_codes[g], 0.003, n_indels=int(rng.integers(0, 2)))
        records.append((tid, f"operon_{i}", _BASES[v].tobytes()))
    for i in range(n_sib):
        g = int(rng.integers(0, len(seed_codes)))
        gg = groups[g]
        tid = add_taxon(f"Sibling sp. {i}", f"Zymogenus_{gg % 8}", f"Zymofam_{gg % 4}")
        v = _mutate(rng, seed_codes[g], float(rng.uniform(0.02, 0.08)),
                    n_indels=int(rng.integers(0, 4)))
        records.append((tid, f"sib_{i}", _BASES[v].tobytes()))
    for i in range(n_fam):
        g = int(rng.integers(0, len(seed_codes)))
        gg = groups[g]
        tid = add_taxon(f"Relative sp. {i}", f"Relgenus_{i % 64}", f"Zymofam_{gg % 4}")
        v = _mutate(rng, seed_codes[g], float(rng.uniform(0.10, 0.20)),
                    n_indels=int(rng.integers(2, 8)))
        records.append((tid, f"rel_{i}", _BASES[v].tobytes()))
    for i in range(n_refs - len(records)):
        g = int(rng.integers(0, len(seed_codes)))
        base = seed_codes[g]
        L = int(len(base) * rng.uniform(0.92, 1.08))
        v = rng.permutation(base)[: max(L, 600)].copy()
        v = _mutate(rng, v, 0.25)
        tid = add_taxon(f"Background sp. {i}", f"Bggenus_{i % 128}",
                        f"Bgfam_{i % 32}", order="Other", cls="Other",
                        phylum=f"Phylum_{i % 12}")
        records.append((tid, f"bg_{i}", _BASES[v].tobytes()))

    with open(out / "species_taxid.fasta", "w") as f:
        for tid, rid, seq in records:
            f.write(f">{tid}:{rid}\n{seq.decode()}\n")
    with open(out / "taxonomy.tsv", "w") as f:
        f.write("tax_id\tspecies\tgenus\tfamily\torder\tclass\tphylum\tclade\t"
                "superkingdom\tsubspecies\tspecies subgroup\tspecies group\n")
        for tid, row in tax_rows.items():
            f.write(tid + "\t" + "\t".join(row) + "\n")
    write_marker(out, "emu-1")
    return {
        "tax_of_seed": tax_of_seed,
        "n_refs": len(records),
        "species_of_tax": {t: r[0] for t, r in tax_rows.items()},
        "out": out,
    }

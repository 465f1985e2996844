"""Seeded mock community: 16S-like templates and ONT R10.4-like reads.

Every input the tests, the benchmark and the on-chip check use is made here
from a seed, so no data ships with the repository:

- templates: full-length 16S-like sequences (1,400-1,600 bp) derived from
  one random ancestor.  Each species diverges from it by 3-10 %, most of it
  inside nine variable windows (the V1-V9 regions of real 16S), so species
  share conserved stretches and differ by SNPs -- the structure SNPmer
  calling needs.  Two species carry a second operon copy that differs from
  the first by 2-4 SNPs.
- reads: one full-length read per draw from an evenly abundant template,
  with ~1.5 % substitutions, 1-2 bp deletions inside homopolymer runs (the
  dominant ONT R10.4 indel), half of them reverse-complemented, and Phred
  strings around Q25-30 that drop at the error sites.

`validate_asvs(asvs, templates)` is the truth check: every ASV must be an
exact copy of a template.

    python -m savont_tpu.db.community -o DIR --reads 20000 --seed 7
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # code complement A<->T, C<->G

#: The seed the tests and chip_smoke.py use: with it the host pipeline
#: recovers every template exactly (NM=0) at 1,000 and at 20,000 reads.
DEFAULT_SEED = 7
N_SPECIES = 10
N_SECOND_COPIES = 2


@dataclass
class Community:
    templates: Path  # FASTA, one record per template
    reads: Path  # FASTQ
    n_templates: int


def _variable_windows(rng, length: int) -> list[tuple[int, int]]:
    """Nine non-overlapping windows of 50-110 bp spread along the gene."""
    edges = np.linspace(40, length - 150, 10).astype(int)
    wins = []
    for a, b in zip(edges[:-1], edges[1:]):
        w = int(rng.integers(50, 111))
        s = int(rng.integers(a, max(a + 1, b - w)))
        wins.append((s, s + w))
    return wins


def _species(rng, ancestor: np.ndarray, windows, divergence: float) -> np.ndarray:
    """Mutate the ancestor: 85 % of the substitutions inside the variable
    windows, plus a few short indels there (length variation)."""
    seq = ancestor.copy()
    n_sub = int(round(divergence * len(seq)))
    in_win = np.concatenate([np.arange(a, b) for a, b in windows])
    n_in = min(int(0.85 * n_sub), len(in_win))
    pos = np.concatenate([
        rng.choice(in_win, n_in, replace=False),
        rng.choice(len(seq), n_sub - n_in, replace=False),
    ])
    seq[pos] = (seq[pos] + rng.integers(1, 4, len(pos))) % 4
    # indels inside the windows, applied right to left so positions hold
    for a, b in sorted(windows, reverse=True):
        if rng.random() < 0.5:
            continue
        at = int(rng.integers(a, b))
        n = int(rng.integers(1, 25))
        if rng.random() < 0.5:
            seq = np.concatenate([seq[:at], seq[at + n:]])
        else:
            seq = np.concatenate([seq[:at], rng.integers(0, 4, n).astype(np.uint8), seq[at:]])
    return seq


def make_templates(seed: int, n_species: int = N_SPECIES) -> list[np.ndarray]:
    """Template code arrays (0..3): n_species species, then the second
    operon copies of the first N_SECOND_COPIES species."""
    rng = np.random.default_rng([seed, 0])
    length = int(rng.integers(1450, 1551))
    ancestor = rng.integers(0, 4, length).astype(np.uint8)
    windows = _variable_windows(rng, length)
    species = [
        _species(rng, ancestor, windows, float(rng.uniform(0.03, 0.10)))
        for _ in range(n_species)
    ]
    copies = []
    for sp in species[:N_SECOND_COPIES]:
        c = sp.copy()
        pos = rng.choice(len(c), int(rng.integers(2, 5)), replace=False)
        c[pos] = (c[pos] + rng.integers(1, 4, len(pos))) % 4
        copies.append(c)
    return species + copies


def _hp_runs(codes: np.ndarray, min_len: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(start, length) of every homopolymer run of at least min_len."""
    change = np.flatnonzero(np.diff(codes) != 0) + 1
    starts = np.concatenate(([0], change))
    lens = np.diff(np.concatenate((starts, [len(codes)])))
    keep = lens >= min_len
    return starts[keep], lens[keep]


def _read(rng, tmpl: np.ndarray, runs) -> tuple[np.ndarray, np.ndarray]:
    """One ONT-like read of a template: (codes, phred)."""
    L = len(tmpl)
    codes = tmpl.copy()
    phred = np.clip(rng.normal(27.0, 4.0, L), 12, 40).astype(np.uint8)
    sub = np.flatnonzero(rng.random(L) < 0.015)
    codes[sub] = (codes[sub] + rng.integers(1, 4, len(sub))) % 4
    phred[sub] = rng.integers(3, 13, len(sub))
    starts, lens = runs
    n_del = min(rng.poisson(L / 500.0), len(starts))
    keep = np.ones(L, dtype=bool)
    for k in rng.choice(len(starts), n_del, replace=False):
        n = min(int(rng.integers(1, 3)), int(lens[k]) - 1)
        end = int(starts[k] + lens[k])
        keep[end - n:end] = False
        phred[max(end - n - 1, 0)] = rng.integers(5, 15)
    codes, phred = codes[keep], phred[keep]
    if rng.random() < 0.5:
        codes, phred = _COMP[codes[::-1]], phred[::-1].copy()
    return codes, phred


def write_community(out_dir: str | Path, n_reads: int, seed: int = DEFAULT_SEED) -> Community:
    """Write templates.fasta and reads.fastq (n_reads reads) under out_dir."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    templates = make_templates(seed)
    tpath = out / "templates.fasta"
    with open(tpath, "w") as f:
        for i, t in enumerate(templates):
            f.write(f">template_{i}\n{_BASES[t].tobytes().decode()}\n")
    rng = np.random.default_rng([seed, 1])
    runs = [_hp_runs(t) for t in templates]
    owner = rng.integers(0, len(templates), n_reads)
    rpath = out / "reads.fastq"
    with open(rpath, "w") as f:
        for i, ti in enumerate(owner.tolist()):
            codes, phred = _read(rng, templates[ti], runs[ti])
            f.write(
                f"@read_{i} template_{ti}\n{_BASES[codes].tobytes().decode()}\n+\n"
                f"{(phred + 33).tobytes().decode()}\n"
            )
    return Community(tpath, rpath, len(templates))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--reads", type=int, default=20000)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    a = p.parse_args(argv)
    c = write_community(a.output_dir, a.reads, a.seed)
    print(f"{c.n_templates} templates -> {c.templates}; {a.reads} reads -> {c.reads}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

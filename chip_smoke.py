#!/usr/bin/env python3
"""On-chip smoke test: drive savont's main path on an NVIDIA GPU and check it.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded paths on a 4-card mesh

Everything runs in this one process (a second JAX process on the card would
find its memory taken).  Phases, each of which must pass:

1. The device: fail at once unless JAX's default backend is "gpu"; print the
   devices and the card's name and power limit from nvidia-smi.
2. The CUDA DP kernel against the XLA scan (both variants, every pair, exact)
   and against the NumPy DP (a sample), at Lq 1,500 / band 48 and
   Lq 4,500 / band 128 on raw bands with jumps; prints both times.
3. `asv` on a seeded 20,000-read mock community: the host path, then the
   full device path with the XLA scan as its DP forward, then with the CUDA
   kernel.  final_asvs.fasta, feature-table.tsv and final_clusters.tsv
   must be byte-identical, every ASV an exact copy of a template, the
   stage-7 device EM within 1e-4 of the host EM, and each device run must
   have dispatched jitted steps.  Prints the wall time of every stage.
4. `classify` and `sintax` of those ASVs against a 10,000-reference EMU
   database built from the templates, host then device: identical outputs.

With --four, phases 3 and 4 run their device side on a 4-card mesh (stage-7
tie-break and EM, stage-4 pileups, classify pair batches and the sintax
database sharded over the cards), plus mesh-sharded stage-1 k-mer counting
against the host count, and print each card's memory use.  Phase 2 is
skipped there.

The last line printed is a JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_READS = 20000
N_REFS = 10000
DEVICE_ENV = {
    "SAVONT_ALIGN_BACKEND": "jax",
    "SAVONT_STAGE4_BACKEND": "mesh",
    "SAVONT_STAGE7_BACKEND": "mesh",
    "SAVONT_DEVICE_KMERS": "1",
}
CLASSIFY_DEVICE_ENV = {"SAVONT_ALIGN_BACKEND": "jax", "SAVONT_SINTAX_BACKEND": "jax"}
ASV_OUTPUTS = ("final_asvs.fasta", "feature-table.tsv", "final_clusters.tsv")
EM_TOLERANCE = 1e-4  # float32 device EM sums in another order than the host's


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ── dispatch census: every call of a jitted function, as in
# tests/test_dispatch_census.py; installed before savont_tpu is imported so
# the module-level jits are counted too
DISPATCHES: collections.Counter = collections.Counter()


def install_dispatch_counter(jax) -> None:
    real_jit = jax.jit

    def counting_jit(fun=None, **kw):
        if fun is None:
            return lambda f: counting_jit(f, **kw)
        jitted = real_jit(fun, **kw)
        name = getattr(fun, "__name__", type(fun).__name__)

        class Counted:
            def __call__(self, *a, **k):
                DISPATCHES[name] += 1
                return jitted(*a, **k)

            def __getattr__(self, item):
                return getattr(jitted, item)

        return Counted()

    jax.jit = counting_jit


class StageClock(logging.Handler):
    """Records when each "=== ..." stage banner of the pipeline log is
    emitted, and keeps every message for the checks."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks: list[tuple[float, str]] = []
        self.messages: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        self.messages.append(msg)
        if msg.startswith("=== "):
            self.marks.append((time.perf_counter(), msg.strip("= ")))

    def stage_times(self, t_end: float) -> dict[str, float]:
        """Seconds from each "STAGE n" banner to the next banner."""
        out = {}
        ends = [t for t, _ in self.marks[1:]] + [t_end]
        for (t0, name), t1 in zip(self.marks, ends):
            if name.startswith("STAGE"):
                key = name.split(":")[0].lower().replace(" ", "_")
                out[key] = out.get(key, 0.0) + (t1 - t0)
        return out


def run_cli(argv: list[str], env: dict[str, str]) -> tuple[float, StageClock]:
    """savont_tpu.cli.main(argv) in this process with `env` applied (and
    every other device switch cleared); returns (wall s, stage clock)."""
    from savont_tpu import cli
    from savont_tpu.pipeline import stage1_kmers

    switches = {*DEVICE_ENV, *CLASSIFY_DEVICE_ENV, "SAVONT_DP_KERNEL"}
    saved = {k: os.environ.pop(k, None) for k in switches}
    os.environ.update(env)
    stage1_kmers._READ_CACHE.clear()  # every run parses its input
    stage1_kmers._ENCODE_CACHE.clear()
    clock = StageClock()
    log = logging.getLogger("savont")
    log.addHandler(clock)
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(clock)
        for k in switches:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    check(rc == 0, f"savont {argv[0]} exited {rc}")
    return wall, clock


def same_files(a: Path, b: Path, names) -> list[str]:
    return [n for n in names if (a / n).read_bytes() != (b / n).read_bytes()]


def phase_kernel() -> None:
    from savont_tpu.ops import dp_parity

    for B, Lq, band in ((256, 1500, 48), (4096, 1500, 48), (512, 4500, 128), (4096, 4500, 128)):
        q, t, lo, tlens = dp_parity.random_pairs(B, Lq, band, seed=B + Lq)
        r = dp_parity.compare(q, t, lo, tlens, band, n_numpy=32)
        say("kernel", json.dumps(r))
        check(r["positive_scores"] == B, f"kernel check at B={B}: pairs without a hit")
        for k in ("meta_mismatch", "payload_mismatch", "numpy_mismatch"):
            check(r[k] == 0, f"CUDA kernel {k}={r[k]} at B={B} Lq={Lq} band={band}")


def phase_asv(work: Path, threads: int, runs):
    """`runs`: (tag, env) pairs after the host run; every run's outputs
    must equal the host's."""
    from savont_tpu.db.community import write_community
    from savont_tpu.validate import validate_asvs

    comm = write_community(work / "community", N_READS)
    outs = {}
    for tag, env in (("host", {}), *runs):
        out = work / f"asv_{tag}"
        DISPATCHES.clear()
        wall, clock = run_cli(["asv", str(comm.reads), "-o", str(out), "-t", str(threads)], env)
        outs[tag] = out
        say(f"asv {tag}", json.dumps({"wall_s": wall, **clock.stage_times(time.perf_counter())}))
        if tag == "host":
            continue
        say(f"asv {tag} dispatches", json.dumps(dict(DISPATCHES.most_common())))
        check(sum(DISPATCHES.values()) > 0, f"the {tag} asv run dispatched no jitted step")
        deltas = [
            float(m.group(1)) for m in
            (re.search(r"max \|host - device\| = (\S+)", s) for s in clock.messages) if m
        ]
        say(f"asv {tag} stage-7 EM |host - device|", deltas)
        check(bool(deltas), "no stage-7 device EM cross-check in the log")
        check(max(deltas) <= EM_TOLERANCE, f"stage-7 EM delta {max(deltas)} > {EM_TOLERANCE}")
        diff = same_files(outs["host"], out, ASV_OUTPUTS)
        check(not diff, f"host and {tag} asv outputs differ: {diff}")
    res = validate_asvs(str(outs["host"] / "final_asvs.fasta"), str(comm.templates))
    check(all(r.nm == 0 for r in res), f"ASVs with NM > 0: {[(r.header, r.nm) for r in res if r.nm]}")
    check(len({r.ref_hit for r in res}) == comm.n_templates,
          f"{len(res)} ASVs for {comm.n_templates} templates")
    say(f"asv: {len(res)} ASVs, all NM=0, host == {' == '.join(t for t, _ in runs)}")
    return comm, outs["host"]


def phase_classify(work: Path, comm, asv_dir: Path, threads: int) -> None:
    from savont_tpu.db.synth import build_emu_slice

    db = build_emu_slice(comm.templates, work / "db", n_refs=N_REFS)["out"]
    for cmd in ("classify", "sintax"):
        outs = {}
        for tag, env in (("host", {}), ("device", CLASSIFY_DEVICE_ENV)):
            out = work / f"{cmd}_{tag}"
            wall, _ = run_cli([cmd, "-i", str(asv_dir), "-o", str(out), "-d", str(db),
                               "-t", str(threads)], env)
            say(f"{cmd} {tag}", json.dumps({"wall_s": wall}))
            outs[tag] = out
        names = sorted(p.name for p in outs["host"].iterdir() if p.suffix != ".log")
        check(bool(names), f"{cmd} wrote nothing")
        diff = same_files(outs["host"], outs["device"], names)
        check(not diff, f"host and device {cmd} outputs differ: {diff}")
        say(f"{cmd}: host == device ({', '.join(names)})")


def phase_kmer_count(comm, n_dev: int) -> None:
    import numpy as np

    from savont_tpu.ops.kmers_native import split_kmers_flat_native
    from savont_tpu.parallel.mesh import make_mesh, sharded_split_kmer_count
    from savont_tpu.pipeline import stage1_kmers

    codes, phred = stage1_kmers._cached_encoded(str(comm.reads))
    codes, phred = list(codes[:5000]), list(phred[:5000])
    km, ct = sharded_split_kmer_count(make_mesh(n_dev), codes, phred, 17, 25)
    hk, hc = np.unique(split_kmers_flat_native(codes, phred, 17, 25, 4), return_counts=True)
    check(np.array_equal(km, hk) and np.array_equal(ct, hc),
          "mesh-sharded stage-1 counts differ from the host count")
    say(f"stage-1 sharded count: {len(km)} k-mers == host")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="On-chip smoke test of savont's main path.")
    ap.add_argument("--four", action="store_true", help="run the sharded paths on 4 cards")
    args = ap.parse_args(argv)
    want = 4 if args.four else 1
    if not args.four:  # one card: the first the launcher made visible
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

    import jax

    # ── phase 1: the device ───────────────────────────────────────────────
    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        print(f"chip_smoke: no accelerator: {e}", file=sys.stderr)
        return 1
    if backend != "gpu":
        print(f"chip_smoke: JAX runs on {backend!r}, not a GPU", file=sys.stderr)
        return 1
    devices = jax.devices()
    if len(devices) < want:
        print(f"chip_smoke: {len(devices)} GPUs visible, {want} needed", file=sys.stderr)
        return 1
    devices = devices[:want]
    say("devices:", devices, devices[0].device_kind)
    # each card's name and power limit, as nvidia-smi prints them
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    for line in smi[:want]:
        say(line)
    if not smi:
        print("chip_smoke: nvidia-smi printed no card", file=sys.stderr)
        return 1

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    install_dispatch_counter(jax)
    try:
        import savont_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: savont_tpu not found next to this script: {e}", file=sys.stderr)
        return 1

    threads = os.cpu_count() or 4
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    t_start = time.perf_counter()
    try:
        if args.four:
            runs = [("device", DEVICE_ENV)]
        else:
            phase_kernel()
            # the device path end to end with either DP forward: the XLA
            # scan, then the CUDA kernel (the default on a GPU)
            runs = [("device-xla", {**DEVICE_ENV, "SAVONT_DP_KERNEL": "xla"}),
                    ("device", DEVICE_ENV)]
        comm, asv_dir = phase_asv(work, threads, runs)
        phase_classify(work, comm, asv_dir, threads)
        if args.four:
            phase_kmer_count(comm, want)
            for d in devices:
                stats = d.memory_stats() or {}
                say(f"memory {d}:", json.dumps({
                    k: stats.get(k) for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
                }))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

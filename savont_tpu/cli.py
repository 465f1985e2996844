"""Command-line interface: savont-tpu {asv, classify, sintax, download,
export} — flag surface mirrors the reference (cli.rs)."""
from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path


TRACE = 5  # finer than DEBUG: per-read SNPmers, pileups, pairwise dumps
logging.addLevelName(TRACE, "TRACE")


def _setup_logging(level: str, log_file: Path | None) -> None:
    lvl = TRACE if level == "trace" else getattr(logging, level.upper(), logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if log_file is not None:
        log_file.parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=lvl,
        format="(%(asctime)s) %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
        force=True,
    )
    # startup banner (main.rs:444-448)
    import platform

    from . import __version__

    log = logging.getLogger("savont")
    log.info("COMMAND: %s", " ".join(sys.argv))
    log.info("VERSION: %s", __version__)
    log.info("SYSTEM NAME: %s", platform.system())
    log.info("SYSTEM HOST NAME: %s", platform.node())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="savont-tpu",
        description=(
            "savont-tpu - high-resolution ASV generation and "
            "taxonomic profiling for ONT R10.4/HiFi long-read amplicon sequencing"
        ),
    )
    p.add_argument("--log-level", default="info", choices=["error", "warn", "info", "debug", "trace"])
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="Write profiling traces to DIR: host cProfile stats "
        "(profile.pstats, inspect with pstats/snakeviz) and, when a device "
        "backend is active, a JAX profiler trace viewable in XProf/TensorBoard",
    )
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("asv", help="Turn >~98%% accuracy long reads into ASVs")
    a.add_argument("input_files", nargs="+", metavar="FASTQ/FASTA")
    a.add_argument("-o", "--output-dir", default="savont-out")
    a.add_argument("-t", "--threads", type=int, default=20)
    a.add_argument("--fl-16s", action="store_true", help="16S full-length preset (default; no-op)")
    a.add_argument("--hifi", action="store_true", help="PacBio HiFi preset (--min-cluster-size 4)")
    a.add_argument("--rrna-operon", action="store_true", help="rRNA operon preset (len 3500-5000)")
    a.add_argument("--pooled-samples", action="store_true")
    a.add_argument("-c", type=int, default=11, dest="c")
    a.add_argument("-m", "--min-read-length", type=int, default=1100)
    a.add_argument("-M", "--max-read-length", type=int, default=2000)
    a.add_argument("--quality-value-cutoff", type=float, default=98.0)
    a.add_argument("--minimum-base-quality", type=int, default=25)
    a.add_argument("-s", "--single-strand", action="store_true")
    a.add_argument("--min-cluster-size", type=int, default=12)
    a.add_argument("-b", "--bloom-filter-size", type=float, default=0.0)
    a.add_argument("-n", "--n-depth-cutoff", type=int, default=250)
    a.add_argument("-u", "--use-hpc", action="store_true")
    a.add_argument("--mask-low-quality", action="store_true")
    a.add_argument("-p", "--posterior-threshold-ln", type=float, default=30.0)
    a.add_argument("--max-iterations-recluster", type=int, default=10)
    a.add_argument("--aggressive-bloom", action="store_true")
    a.add_argument("--skip-chimera-detection", action="store_true")
    a.add_argument("--no-snpmers", action="store_true")
    a.add_argument("--low-polymorphism", action="store_true")
    a.add_argument("-k", "--kmer-size", type=int, default=17)
    a.add_argument("--blockmer-length", type=int, default=3)
    a.add_argument("--use-blockmers", action="store_true")
    a.add_argument("--chimera-allowable-errors", type=int, default=1)
    a.add_argument("--chimera-detect-length", type=int, default=None)
    a.add_argument("--clean-dir", action="store_true")
    a.add_argument("--resume", action="store_true", help="Reuse the stage-3 checkpoint in <output>/temp when inputs and parameters are unchanged")
    # hidden no-op, mirrored from cli.rs:176-179 (driver use is commented out
    # at main.rs:135)
    a.add_argument("--phase-heterogeneous", action="store_true", help=argparse.SUPPRESS)

    c = sub.add_parser("classify", help="Classify ASVs against a reference database")
    c.add_argument("-i", "--input-dir", required=True)
    c.add_argument("-o", "--output-dir", default=None)
    c.add_argument("-d", "--db", required=True)
    c.add_argument("-t", "--threads", type=int, default=20)
    c.add_argument("--species-threshold", type=float, default=99.0)
    c.add_argument("--genus-threshold", type=float, default=94.5)
    c.add_argument("--detailed-unclassified", action="store_true")

    s = sub.add_parser("sintax", help="SINTAX k-mer bootstrap classification")
    s.add_argument("-i", "--input-dir", required=True)
    s.add_argument("-o", "--output-dir", default=None)
    s.add_argument("-d", "--db", required=True)
    s.add_argument("-t", "--threads", type=int, default=20)
    s.add_argument("--min-bootstrap", type=float, default=0.8)
    s.add_argument("--n-iter", type=int, default=100)
    s.add_argument("--detailed-unclassified", action="store_true")

    d = sub.add_parser("download", help="Download reference databases")
    d.add_argument("--location", required=True)
    d.add_argument("--dbs", required=True, nargs="+")

    e = sub.add_parser("export", help="Export/merge results to QIIME2-compatible format")
    e.add_argument("-i", "--input-dirs", required=True, nargs="+")
    e.add_argument("-o", "--output-dir", required=True)
    e.add_argument("--no-fuzzy", action="store_true")
    e.add_argument("--relabel", nargs="+", default=None)

    return p


def _print_markdown_help(p: argparse.ArgumentParser) -> None:
    """--markdown-help: markdown-formatted CLI docs (cli.rs:175, the
    clap-markdown hidden flag)."""
    print(f"# {p.prog}\n\n{p.description or ''}\n")
    subs = next(
        (a for a in p._actions if isinstance(a, argparse._SubParsersAction)), None
    )
    for name, sp in (subs.choices.items() if subs else []):
        print(f"## `{p.prog} {name}`\n\n```\n{sp.format_help()}```\n")


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    raw = sys.argv[1:] if argv is None else argv
    if "--markdown-help" in raw:
        _print_markdown_help(parser)
        return 0
    ns = parser.parse_args(argv)
    level = {"warn": "warning"}.get(ns.log_level, ns.log_level)

    # multi-host: join the jax.distributed job BEFORE any device use when
    # SAVONT_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID (or =auto) are set
    from .parallel.distributed import maybe_init_from_env

    maybe_init_from_env()

    if ns.profile:
        return _run_profiled(ns, level)
    return _dispatch(ns, level)


def _run_profiled(ns, level: str) -> int:
    """--profile DIR (SURVEY.md §5.1 tracing parity): host cProfile stats
    always; a JAX profiler trace (XProf/TensorBoard) when a device backend
    is active for this run."""
    import cProfile

    out = Path(ns.profile)
    out.mkdir(parents=True, exist_ok=True)
    device_active = any(
        os.environ.get(v)
        for v in ("SAVONT_ALIGN_BACKEND", "SAVONT_DEVICE_KMERS", "SAVONT_SINTAX_BACKEND")
    )
    jax_mod = None
    if device_active:
        import jax

        jax_mod = jax
        jax.profiler.start_trace(str(out))
    pr = cProfile.Profile()
    pr.enable()
    try:
        return _dispatch(ns, level)
    finally:
        pr.disable()
        pr.dump_stats(str(out / "profile.pstats"))
        if jax_mod is not None:
            jax_mod.profiler.stop_trace()
        print(f"[savont-tpu] profile written to {out}", file=sys.stderr)


def _dispatch(ns, level: str) -> int:
    if ns.command == "asv":
        from .config import ClusterArgs
        from .pipeline.asv import run_cluster

        for f in ns.input_files:
            if not Path(f).exists():
                print(f"ERROR [savont-tpu] Input file {f} does not exist.", file=sys.stderr)
                return 1
        _setup_logging(level, Path(ns.output_dir) / "savont.log")
        args = ClusterArgs(
            input_files=ns.input_files, output_dir=ns.output_dir, threads=ns.threads,
            fl_16s=ns.fl_16s, hifi=ns.hifi, rrna_operon=ns.rrna_operon,
            pooled_samples=ns.pooled_samples, c=ns.c,
            min_read_length=ns.min_read_length, max_read_length=ns.max_read_length,
            quality_value_cutoff=ns.quality_value_cutoff,
            minimum_base_quality=ns.minimum_base_quality,
            single_strand=ns.single_strand, min_cluster_size=ns.min_cluster_size,
            bloom_filter_size=ns.bloom_filter_size, n_depth_cutoff=ns.n_depth_cutoff,
            use_hpc=ns.use_hpc, mask_low_quality=ns.mask_low_quality,
            posterior_threshold_ln=ns.posterior_threshold_ln,
            max_iterations_recluster=ns.max_iterations_recluster,
            aggressive_bloom=ns.aggressive_bloom,
            skip_chimera_detection=ns.skip_chimera_detection,
            no_snpmers=ns.no_snpmers, low_polymorphism=ns.low_polymorphism,
            kmer_size=ns.kmer_size, blockmer_length=ns.blockmer_length,
            use_blockmers=ns.use_blockmers,
            chimera_allowable_errors=ns.chimera_allowable_errors,
            chimera_detect_length=ns.chimera_detect_length, clean_dir=ns.clean_dir,
            resume=ns.resume, phase_heterogeneous=ns.phase_heterogeneous,
        )
        run_cluster(args)
        return 0

    if ns.command == "classify":
        from .config import ClassifyArgs
        from .db.registry import load_database
        from .pipeline.classify import classify

        out = Path(ns.output_dir) if ns.output_dir else Path(ns.input_dir)
        _setup_logging(level, out / "savont_classify.log")
        db = load_database(Path(ns.db))
        classify(
            ClassifyArgs(
                input_dir=ns.input_dir, output_dir=ns.output_dir, db=ns.db,
                threads=ns.threads, species_threshold=ns.species_threshold,
                genus_threshold=ns.genus_threshold,
                detailed_unclassified=ns.detailed_unclassified,
            ),
            db,
        )
        return 0

    if ns.command == "sintax":
        from .config import SintaxArgs
        from .db.registry import load_database
        from .pipeline.sintax import sintax

        out = Path(ns.output_dir) if ns.output_dir else Path(ns.input_dir)
        _setup_logging(level, out / "savont_sintax.log")
        db = load_database(Path(ns.db))
        sintax(
            SintaxArgs(
                input_dir=ns.input_dir, output_dir=ns.output_dir, db=ns.db,
                threads=ns.threads, min_bootstrap=ns.min_bootstrap,
                n_iter=ns.n_iter, detailed_unclassified=ns.detailed_unclassified,
            ),
            db,
        )
        return 0

    if ns.command == "download":
        from .db.registry import download

        _setup_logging(level, None)
        download(ns.location, ns.dbs)
        return 0

    if ns.command == "export":
        from .config import ExportArgs
        from .pipeline.export import export

        _setup_logging(level, Path(ns.output_dir) / "savont_export.log")
        export(ExportArgs(input_dirs=ns.input_dirs, output_dir=ns.output_dir,
                          no_fuzzy=ns.no_fuzzy, relabel=ns.relabel))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())

"""savont-tpu: an accelerator-backed ASV (Amplicon Sequence Variant) engine.

A from-scratch reimplementation of the capabilities of bluenote-1577/savont
(v0.6.1), with its device paths on NVIDIA GPUs:

- per-base / per-k-mer math is vectorized (NumPy/C++ host kernels + JAX
  device kernels, and a CUDA DP kernel on GPUs, over fixed-shape padded
  read batches),
- all base-level alignment is a batched banded affine DP kernel
  (replaces the reference's minimap2 C FFI calls),
- consensus generation is seed + batched pileup-vote polish
  (replaces the reference's spoa C++ POA),
- scale-out is jax.sharding over a device Mesh (replaces rayon threads).

Pipeline (mirrors reference main.rs:49-196):
  reads -> k-mer count -> SNPmer calling -> TwinReads -> LSH k-mer clustering
  -> SNPmer subclustering + reclustering -> consensus + Bayesian polish
  -> dedup/merge -> chimera filter -> EM depth refinement -> ASVs
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Stop glibc from mmap/munmap-ing every large numpy temporary.

    The pipeline allocates and frees many >128 KB arrays (k-mer streams,
    DP planes, pileup matrices); with glibc defaults each one is a fresh
    mmap, so the kernel spends significant time zeroing pages (measured:
    16.3s sys -> 3.7s sys, -24% wall on a 20k-read run).  Raising the
    mmap/trim thresholds keeps freed blocks on the heap for reuse, at the
    cost of a higher steady-state RSS.

    M_ARENA_MAX=1 matters just as much on VMs where minor faults are
    expensive (nested-EPT: ~10-40 us each, measured): glibc returns freed
    per-THREAD-arena heaps to the OS unconditionally (heap_trim is not
    gated by M_TRIM_THRESHOLD), so every numpy temporary allocated inside
    a worker thread refaults its pages on the next use.  One arena makes
    the trim threshold govern all frees.  Measured interleaved A/B at
    100k reads: minor faults 1.8M -> 1.0M, sys 25.6s -> 11.7s, wall
    40.9s -> 31.7s (min of 3).  SAVONT_NO_MALLOC_TUNE=1 opts out."""
    import ctypes
    import os
    import sys

    if os.environ.get("SAVONT_NO_MALLOC_TUNE") or not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_ARENA_MAX = -1, -3, -8
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        libc.mallopt(M_ARENA_MAX, 1)
    except OSError:  # non-glibc libc
        pass


def _disable_numpy_hugepage_madvise() -> None:
    """Keep numpy from madvise(MADV_HUGEPAGE)-ing large buffers.

    With THP in madvise mode, every >4 MB numpy allocation invites
    synchronous hugepage compaction on first touch; the pipeline's large
    transient buffers (k-mer streams, DP planes) then burn kernel time
    assembling 2 MB pages that are freed moments later.  Measured on a
    20k-read run: 9-20s sys -> 1.2s, wall 24s -> 18.5s.  numpy reads the
    NUMPY_MADVISE_HUGEPAGE env var only at import (which may have happened
    before ours), so use the runtime hook.
    SAVONT_NO_MALLOC_TUNE=1 opts out."""
    import os

    if os.environ.get("SAVONT_NO_MALLOC_TUNE"):
        return
    try:
        from numpy._core import multiarray

        multiarray._set_madvise_hugepage(False)
    except (ImportError, AttributeError):
        pass


def _tune_omp_wait_policy() -> None:
    """Default OMP_WAIT_POLICY=passive for the native kernels.

    GOMP's default active spin keeps worker threads burning cycles after
    every parallel region; this pipeline interleaves many short native
    regions (scans, chaining, DP) with numpy glue and a plan/DP pipeline
    thread, so the spinners contend with real work on small core counts.
    Measured interleaved A/B at 100k reads: wall 22.2/23.9 -> 21.8/23.0,
    cpu 51.4/54.2 -> 47.7/50.7.  Must run before libgomp's first parallel
    region (we set it at package import, before any native .so loads).
    Respects an explicit user OMP_WAIT_POLICY; SAVONT_NO_OMP_TUNE=1 opts
    out."""
    import os

    if os.environ.get("SAVONT_NO_OMP_TUNE"):
        return
    os.environ.setdefault("OMP_WAIT_POLICY", "passive")


_tune_malloc()
_disable_numpy_hugepage_madvise()
_tune_omp_wait_policy()

"""Multi-host (multi-controller) scaffolding.

The reference is a single-host rayon tool; the scale-out story here is a
jax.distributed multi-controller mesh: devices of every process pooled into
one global Mesh, with shardings laid out so only the tiny EM numerator (an
(A,) f32 psum) crosses between hosts per iteration (SURVEY.md §5.8,
BASELINE.md scaling target).

Activation is by env vars so the CLI stays identical on one machine and on
a cluster:

  SAVONT_COORDINATOR   host:port of process 0 (e.g. "10.0.0.1:8476")
  SAVONT_NUM_PROCESSES total process count
  SAVONT_PROCESS_ID    this process's rank

All three set -> `jax.distributed.initialize` is called before the first
device use; otherwise this is a no-op (single-controller).  JAX's own
cluster auto-detection works by calling `jax.distributed.initialize()` with
no args: set SAVONT_DISTRIBUTED=auto.

One process per card: a JAX process reserves most of a card's memory when
it first uses it, so a second process on the same card fails.  Process i
therefore drives card i of its host (`local_device_ids=[i]`) unless the
launcher chose the cards itself with CUDA_VISIBLE_DEVICES or
JAX_LOCAL_DEVICE_IDS (several hosts: set one of them per process).

Every process must run the SAME host pipeline (it is deterministic), and
mesh.shard_reads feeds each process only its addressable shards; replicated
outputs (EM abundances, all-gathered NM panels) come back identical on all
processes, so any process can write outputs (the CLI lets rank 0 write).

tests/test_distributed.py proves the 2-process CPU mesh produces
bit-identical stage-7 NM panels to the single-process 8-device mesh.
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger("savont")

_INITIALIZED = False


def maybe_init_from_env() -> bool:
    """Initialize jax.distributed when the env asks for it; returns whether
    this process is now (or already was) part of a multi-controller job.
    Must run before the first jax device use."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    import jax

    mode = os.environ.get("SAVONT_DISTRIBUTED", "")
    coord = os.environ.get("SAVONT_COORDINATOR")
    nproc = os.environ.get("SAVONT_NUM_PROCESSES")
    pid = os.environ.get("SAVONT_PROCESS_ID")
    if mode == "auto":
        jax.distributed.initialize()
    elif coord and nproc and pid:
        own_card = not (
            os.environ.get("CUDA_VISIBLE_DEVICES") or os.environ.get("JAX_LOCAL_DEVICE_IDS")
        )
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(pid),
            local_device_ids=[int(pid)] if own_card else None,
        )
    elif coord or nproc or pid:
        # a partial config silently degrading to single-controller would
        # leave the other ranks blocked in initialize (or all ranks racing
        # on the same output dir) — fail loudly instead
        missing = [
            name
            for name, v in (
                ("SAVONT_COORDINATOR", coord),
                ("SAVONT_NUM_PROCESSES", nproc),
                ("SAVONT_PROCESS_ID", pid),
            )
            if not v
        ]
        raise SystemExit(
            f"partial multi-host configuration: missing {', '.join(missing)} "
            "(set all three, or SAVONT_DISTRIBUTED=auto)"
        )
    else:
        return False
    _INITIALIZED = True
    log.info(
        "jax.distributed initialized: process %d/%d, %d local + %d global devices",
        jax.process_index(), jax.process_count(),
        len(jax.local_devices()), len(jax.devices()),
    )
    return True


def is_primary() -> bool:
    """True when this process should write outputs (rank 0, or
    single-controller)."""
    import jax

    return jax.process_index() == 0

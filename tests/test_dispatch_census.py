"""FULL-device dispatch census.

The FULL-device configuration once paid one device dispatch per cluster
bucket in stages 4-6; those dispatches are megabatched (length-sorted
traceback buckets, one stage-4 pileup dispatch per pair chunk).  This test
pins the property on the seeded 1,000-read community with every device
switch on: the run issues a few dozen jit dispatches at most (a regression
into per-cluster dispatching reads 50+), at least one in each device stage
(so a renamed switch that silently falls back to the host fails), and
every ASV stays NM=0 against the templates.

Runs in a subprocess so the jax.jit wrapper is installed before any
savont_tpu module creates its jitted builders (in-process, lru_cached
builders from earlier tests would escape the counter).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
MAX_DISPATCHES = 32  # measured 23 on an 8-device CPU mesh: 11 tracebacks, 9 mesh steps

PROBE = r"""
import collections, json, os, shutil, sys, tempfile, traceback
os.environ["SAVONT_ALIGN_BACKEND"] = "jax"
os.environ["SAVONT_STAGE4_BACKEND"] = "mesh"
os.environ["SAVONT_STAGE7_BACKEND"] = "mesh"
os.environ["SAVONT_DEVICE_KMERS"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")

COUNTS = collections.Counter()
real_jit = jax.jit

def counting_jit(fun=None, **kw):
    if fun is None:
        return lambda f: counting_jit(f, **kw)
    w = real_jit(fun, **kw)
    name = getattr(fun, "__name__", str(fun))

    class W:
        def __call__(self, *a, **k):
            COUNTS[name] += 1
            return w(*a, **k)

        def __getattr__(self, item):
            return getattr(w, item)

    return W()

jax.jit = counting_jit

sys.path.insert(0, os.environ["SAVONT_REPO"])
from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu.validate import validate_asvs

out = tempfile.mkdtemp(prefix="census_out_")
try:
    run_cluster(ClusterArgs(
        input_files=[os.environ["SAVONT_READS"]], output_dir=out, threads=4,
    ))
    res = validate_asvs(os.path.join(out, "final_asvs.fasta"), os.environ["SAVONT_TEMPLATES"])
finally:
    shutil.rmtree(out, ignore_errors=True)
print(json.dumps({"total": sum(COUNTS.values()), "by_fn": dict(COUNTS),
                  "n_asvs": len(res), "n_nm0": sum(r.nm == 0 for r in res)}))
"""


@pytest.mark.slow
def test_full_device_dispatch_count_stays_megabatched(community):
    env = dict(os.environ, SAVONT_REPO=str(REPO), SAVONT_READS=str(community.reads),
               SAVONT_TEMPLATES=str(community.templates))
    # drop any platform pins from the outer test process; the probe pins CPU
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, cwd=str(REPO),
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["n_asvs"] == rec["n_nm0"] == community.n_templates, rec
    # stage 1 (k-mers), stages 4-6 (tracebacks, pileups), stage 7 (mesh)
    for fn in ("split_kmers_batch", "sw_traceback_full", "per_shard"):
        assert rec["by_fn"].get(fn, 0) >= 1, rec
    # headroom over the measured count tolerates bucket-count jitter while
    # still catching any return to per-cluster dispatching (50+)
    assert rec["total"] <= MAX_DISPATCHES, rec

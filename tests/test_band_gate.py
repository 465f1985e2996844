"""Corridor-lag gate on the smoothed device paths.

smooth_lo clamps per-row band advances to <=1 column so device kernels can
use static shifts.  On large structural indels (the planner band jumps by
>> band/2 columns) the smoothed corridor lags behind the raw planner band
and the smoothed forward kernel scores DIVERGE from the host oracle
(pinned below).  The device dispatchers therefore gate on
smooth_lo_max_lag >= band/2 and realign flagged pairs on the host raw-band
kernel — making mesh results match the host for EVERY input.
"""
import numpy as np
import pytest

from savont_tpu.ops.align import smooth_lo, smooth_lo_max_lag
from savont_tpu.ops.align_batch import (
    AlignJob,
    plan_jobs_batch,
)
from savont_tpu.ops.align import TargetIndex
from savont_tpu.ops.native_build import get_lib

BAND = 48


def _structural_indel_pair(seed=7, L=1500, cut=200, gap=100):
    """(query, target): query is the target with `gap` bases deleted at
    `cut` — a structural deletion that makes the planner band jump by
    ~gap columns mid-alignment."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes()
    q = ref[:cut] + ref[cut + gap :]
    return q, ref


def _planned_job(q, t, band=BAND):
    idx = TargetIndex([np.frombuffer(t, np.uint8)])
    jobs, owners = plan_jobs_batch(idx, [q], band=band)
    fwd = [j for j in jobs if j.strand == 1]
    assert fwd, "planner found no forward chain"
    return fwd[0]


def test_structural_indel_triggers_gate_and_smoothed_kernel_diverges():
    """Pins WHY the gate exists: the smoothed corridor lags >= band/2 on a
    100 bp deletion, and the smooth=True forward kernel scores differ from
    the raw-band host oracle on this pair."""
    q, t = _structural_indel_pair()
    job = _planned_job(q, t)
    lo_full = np.concatenate(([job.lo[0]], job.lo)).astype(np.int32)
    lag = int(smooth_lo_max_lag(lo_full))
    assert lag >= BAND // 2, f"expected a gate-triggering lag, got {lag}"

    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from savont_tpu.ops.align_jax import sw_forward_meta

    Lq = len(job.qcodes)
    qa = jnp.asarray(job.qcodes[None, :].astype(np.int32))
    ta = jnp.asarray(job.tcodes[None, :].astype(np.int32))
    tl = jnp.asarray([len(job.tcodes)], jnp.int32)
    raw = sw_forward_meta(qa, ta, jnp.asarray(lo_full[None, :]), tl, band=BAND, smooth=False)
    sm = sw_forward_meta(
        qa, ta, jnp.asarray(smooth_lo(lo_full)[None, :]), tl, band=BAND, smooth=True
    )
    raw_score = int(np.asarray(raw["score"])[0])
    sm_score = int(np.asarray(sm["score"])[0])
    # the documented deviation: smoothing loses the top-of-window cells at
    # the jump and the optimal (raw-corridor) path scores higher
    assert raw_score > sm_score, (
        f"expected divergence on a {lag}-column lag: raw {raw_score}, smoothed {sm_score}"
    )


def test_mesh_stage7_gate_matches_host_on_structural_indel():
    if get_lib() is None:
        pytest.skip("native kernel unavailable")
    pytest.importorskip("jax")
    from savont_tpu.ops.align_batch import align_pairs_nm
    from savont_tpu.parallel.mesh import make_mesh, mesh_stage7_tie_break

    q, t = _structural_indel_pair()
    host = align_pairs_nm([(q, t)], band=BAND, coords=False)[0]
    assert host is not None
    mesh = make_mesh(1)
    best, abund, count = mesh_stage7_tie_break(
        [(q, t)], np.array([0]), np.array([0]), 1, 1, band=BAND, mesh=mesh
    )
    assert best[0] is not None
    assert (best[0].score, best[0].nm) == (host.score, host.nm), (
        f"gated mesh stage-7 must match host: device "
        f"({best[0].score}, {best[0].nm}) host ({host.score}, {host.nm})"
    )

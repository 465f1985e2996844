"""Multi-device scale-out: data-parallel read batches over a device Mesh.

The reference is a single-host rayon-thread tool (SURVEY.md §2.3); here
fixed-shape read batches are sharded across devices with jax.sharding +
shard_map and EM statistics are psum-reduced across the mesh:

  - reads (queries) are sharded on the batch axis ("dp"),
  - the ASV/reference panel (targets) is replicated per device,
  - each device runs the banded-DP kernel on its shard (the CUDA kernel on
    a GPU, the XLA scan elsewhere: ops/align_cuda.dp_kernel),
  - per-ASV EM numerators are psum-reduced across the mesh.

This is the full device side of stage 7 (and `classify`): candidate NM
matrices -> equivalence weights -> one EM iteration, all under one jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.align_cuda import dp_kernel
from ..ops.align_jax import forward_meta


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def replicate_to_mesh(mesh: Mesh, arr: np.ndarray):
    """Place a host array fully replicated over the mesh (multi-controller
    safe, like shard_reads but with an all-None spec)."""
    sharding = NamedSharding(mesh, P(*([None] * arr.ndim)))
    if jax.process_count() > 1:
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])
    return jax.device_put(arr, sharding)


import functools as _functools


def _build_target_pool(tgt_bytes: list[bytes]):
    """(t_pool (T, Lt) i32 pad-6, tlens_pool (T,) i32) from unique target
    bytes — the replicated panel the mesh steps gather per-slot targets
    from on device.  Falls back to a 1-dummy pool so empty workloads keep
    a gatherable shape."""
    from ..ops.align import ascii_to_align_codes

    t_list = tgt_bytes or [b"A"]
    Lt = max(len(tb) for tb in t_list)
    t_pool = np.full((len(t_list), Lt), 6, dtype=np.int32)
    for i, tb in enumerate(t_list):
        t_pool[i, : len(tb)] = ascii_to_align_codes(tb)
    tlens_pool = np.fromiter((len(tb) for tb in t_list), np.int32, len(t_list))
    return t_pool, tlens_pool


def _stage7_align_local(band: int, kernel: str):
    """LOCAL (per-shard) stage-7 align + tie-set closure: returns
    (nm, score, in_tie) for this shard's rows.  Shared by the chunked
    align step and the one-dispatch combined step.  kernel is "cuda" or
    "xla" (align_cuda.dp_kernel); the XLA scan takes its one-shift form,
    as the panels' lo is smoothed.

    Targets arrive as the REPLICATED unique pool (t_pool (T, Lt) i32 pad 6,
    tlens_pool (T,)) plus a per-slot pool id (slot_tid, -1 = empty): the
    (Rl, C, Lt) panel is gathered ON DEVICE.  Expanding on the host tripled
    the upload (every slot shipped its own copy of an ASV)."""

    big = jnp.int32(1 << 20)

    def f(q, lo, slot_tid, slot_asv, t_pool, tlens_pool):
        # panels arrive in narrow dtypes to cut host->device bytes (codes
        # int8, lo int16, slot ids int16/int32); widen on device
        q = q.astype(jnp.int32)
        lo = lo.astype(jnp.int32)
        slot_tid = slot_tid.astype(jnp.int32)
        slot_asv = slot_asv.astype(jnp.int32)
        t_pool = t_pool.astype(jnp.int32)
        tlens_pool = tlens_pool.astype(jnp.int32)
        Rl, C, Lq = q.shape
        tid = jnp.clip(slot_tid, 0)
        t = t_pool[tid]        # (Rl, C, Lt) — empty slots get pool[0]; their
        tlens = tlens_pool[tid]  # q rows are all-pad(5) so score stays 0
        out = forward_meta(
            q.reshape(Rl * C, Lq),
            t.reshape(Rl * C, -1),
            lo.reshape(Rl * C, Lq + 1),
            tlens.reshape(-1),
            band,
            kernel,
            smooth=True,
        )
        nm = out["nm"].reshape(Rl, C).astype(jnp.int32)
        score = out["score"].reshape(Rl, C).astype(jnp.int32)
        valid = (slot_asv >= 0) & (score > 0)

        # per-(read, ASV) winner: highest score, earliest slot on ties.
        # C is small (candidate sets are ~1-4 jobs), so the O(C^2) mask is
        # cheaper than a sort and keeps everything static-shaped.
        key = score * C - jnp.arange(C, dtype=jnp.int32)[None, :]
        same_asv = (slot_asv[:, :, None] == slot_asv[:, None, :]) & valid[:, :, None] & valid[:, None, :]
        beaten = (same_asv & (key[:, None, :] > key[:, :, None])).any(axis=2)
        winner = valid & ~beaten

        nm_eff = jnp.where(winner, nm, big)
        best_nm = nm_eff.min(axis=1, keepdims=True)
        in_tie = winner & (nm_eff == best_nm)
        return nm, score, in_tie

    return f


def _stage7_em_local(n_asvs: int, em_iters: int, conv: float, axis: str):
    """LOCAL (per-shard) EM fixed-point closure over this shard's tie sets
    (psum over the mesh per iteration).  Shared by the standalone EM step
    and the one-dispatch combined step."""

    def f(in_tie, slot_asv):
        slot_asv = slot_asv.astype(jnp.int32)
        assigned = in_tie.any(axis=1)
        count = lax.psum(assigned.sum(), axis)
        a_idx = jnp.clip(slot_asv, 0).reshape(-1)
        tie_f = in_tie.astype(jnp.float32)

        def em_cond(state):
            it, _, delta = state
            return (it < em_iters) & (delta >= conv / jnp.maximum(count, 1).astype(jnp.float32))

        def em_body(state):
            it, abund, _ = state
            w = tie_f * abund[jnp.clip(slot_asv, 0)]
            denom = w.sum(axis=1, keepdims=True)
            resp = jnp.where(denom > 0, w / jnp.maximum(denom, 1e-30), 0.0)
            local = jax.ops.segment_sum(resp.reshape(-1), a_idx, num_segments=n_asvs)
            num = lax.psum(local, axis)
            new = jnp.where(count > 0, num / jnp.maximum(count, 1).astype(jnp.float32), abund)
            return it + 1, new, jnp.abs(new - abund).max()

        abund0 = jnp.full((n_asvs,), 1.0 / n_asvs, dtype=jnp.float32)
        _, abund, _ = lax.while_loop(em_cond, em_body, (jnp.int32(0), abund0, jnp.float32(jnp.inf)))
        return abund, count

    return f


@_functools.lru_cache(maxsize=32)
def sharded_stage7_step(
    mesh: Mesh, n_asvs: int, band: int, em_iters: int, conv: float,
    kernel: str = "xla",
):
    """ONE-dispatch stage-7 device step: align + tie sets + the full EM
    fixed point in a single jit (the per-pair fallback when the SoA planner
    is unavailable, _mesh_stage7_legacy)."""
    axis = mesh.axis_names[0]
    align_local = _stage7_align_local(band, kernel)
    em_local = _stage7_em_local(n_asvs, em_iters, conv, axis)

    def per_shard(q, lo, slot_tid, slot_asv, t_pool, tlens_pool):
        nm, score, in_tie = align_local(q, lo, slot_tid, slot_asv, t_pool, tlens_pool)
        abund, count = em_local(in_tie, slot_asv)
        nm_g = lax.all_gather(nm, axis, axis=0, tiled=True)
        score_g = lax.all_gather(score, axis, axis=0, tiled=True)
        return abund, nm_g, score_g, count

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None), P(axis, None), P(None, None), P(None)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@_functools.lru_cache(maxsize=32)
def sharded_stage7_step_packed(
    mesh: Mesh, n_asvs: int, band: int, em_iters: int, conv: float,
    kernel: str, C: int, Lq: int,
):
    """The monolithic stage-7 step with PACKED I/O: every input panel
    rides ONE u8 row-major buffer (q codes, lo as two byte planes, slot ids
    as four), the replicated target pool is one more buffer, and all
    outputs come back as a single i32 vector — so a full align + tie + EM
    dispatch costs 2 transfers + 1 execute + 1 fetch.  Taken for reads
    whose codes contain U (see sharded_stage7_step_packed2)."""
    axis = mesh.axis_names[0]
    align_local = _stage7_align_local(band, kernel)
    em_local = _stage7_em_local(n_asvs, em_iters, conv, axis)

    def per_shard(buf, pool_buf):
        Rl = buf.shape[0]
        off = [0]

        def take(n):
            part = lax.slice_in_dim(buf, off[0], off[0] + n, axis=1)
            off[0] += n
            return part

        def take_i32(n):
            b = [take(n).astype(jnp.uint32) for _ in range(4)]
            v = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
            return lax.bitcast_convert_type(v, jnp.int32)

        q = take(C * Lq).reshape(Rl, C, Lq)
        lo_lo = take(C * (Lq + 1)).astype(jnp.int32)
        lo_hi = take(C * (Lq + 1)).astype(jnp.int32)
        lo = (lo_lo | (lo_hi << 8)).reshape(Rl, C, Lq + 1)
        tid = take_i32(C)
        asv = take_i32(C)

        Lt = pool_buf.shape[1] - 4
        t_pool = lax.slice_in_dim(pool_buf, 0, Lt, axis=1)
        tb = lax.slice_in_dim(pool_buf, Lt, Lt + 4, axis=1).astype(jnp.uint32)
        tlens = lax.bitcast_convert_type(
            tb[:, 0] | (tb[:, 1] << 8) | (tb[:, 2] << 16) | (tb[:, 3] << 24),
            jnp.int32,
        )

        nm, score, in_tie = align_local(q, lo, tid, asv, t_pool, tlens)
        abund, count = em_local(in_tie, asv)
        nm_g = lax.all_gather(nm, axis, axis=0, tiled=True)
        score_g = lax.all_gather(score, axis, axis=0, tiled=True)
        # ONE output vector: [abund (A) bitcast | nm (R*C) | score (R*C) | count]
        out = jnp.concatenate([
            lax.bitcast_convert_type(abund, jnp.int32),
            nm_g.reshape(-1),
            score_g.reshape(-1),
            count.astype(jnp.int32)[None],
        ])
        return out

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(None, None)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


@_functools.lru_cache(maxsize=32)
def sharded_stage7_step_packed2(
    mesh: Mesh, n_asvs: int, band: int, em_iters: int, conv: float,
    kernel: str, C: int, Lq: int,
):
    """Second-generation packed stage-7 dispatch: the upload carries each
    read's FORWARD codes once, 4-bit packed (the reverse complement is
    derived ON DEVICE: rc[j] = 3 - fwd[qlen-1-j] for codes < 4 — exactly
    _qcodes_cached_batch's derivation, so U-containing reads must take the
    v1 path), and each slot's smooth band corridor as lo0 + BIT-packed
    {0,1} deltas.  ~10x fewer bytes than v1's per-slot oriented panels
    (10.2 MB -> ~1.0 MB on the 902-read Zymo set), one upload + one
    execute + one fetch.

    Row layout (u8): [q4 (Lq/2) | qlen u16 | per-slot: lo0 u16, delta bits
    ceil(Lq/8), tid i16, asv i16, strand u8].
    """
    axis = mesh.axis_names[0]
    align_local = _stage7_align_local(band, kernel)
    em_local = _stage7_em_local(n_asvs, em_iters, conv, axis)
    Lq2 = (Lq + 1) // 2
    Lb = (Lq + 7) // 8
    slot_bytes = 2 + Lb + 2 + 2 + 1

    def per_shard(buf, pool_buf):
        Rl = buf.shape[0]
        off = [0]

        def take(n):
            part = lax.slice_in_dim(buf, off[0], off[0] + n, axis=1)
            off[0] += n
            return part

        def take_u16(n):
            b0 = take(n).astype(jnp.int32)
            b1 = take(n).astype(jnp.int32)
            return b0 | (b1 << 8)

        q4 = take(Lq2).astype(jnp.int32)
        fwd = jnp.stack([q4 & 0xF, q4 >> 4], axis=2).reshape(Rl, 2 * Lq2)
        fwd = lax.slice_in_dim(fwd, 0, Lq, axis=1)
        qlen = take_u16(1)  # (Rl, 1)
        cols = jnp.arange(Lq, dtype=jnp.int32)[None, :]
        ridx = jnp.clip(qlen - 1 - cols, 0, Lq - 1)
        g = jnp.take_along_axis(fwd, ridx, axis=1)
        rc = jnp.where(cols < qlen, jnp.where(g < 4, 3 - g, g), 5)

        lo0 = take_u16(C).reshape(Rl, C, 1)
        dbits = take(C * Lb).reshape(Rl, C, Lb).astype(jnp.int32)
        shifts = jnp.arange(8, dtype=jnp.int32)[None, None, None, :]
        bits = ((dbits[:, :, :, None] >> shifts) & 1).reshape(Rl, C, Lb * 8)
        bits = lax.slice_in_dim(bits, 0, Lq, axis=2)
        lo = jnp.concatenate([lo0, lo0 + jnp.cumsum(bits, axis=2)], axis=2)

        def take_i16(n):
            v = take_u16(n)
            return v - ((v >> 15) << 16)  # sign-extend

        slot_tid = take_i16(C)
        slot_asv = take_i16(C)
        strand = take(C)
        q = jnp.where(
            (strand == 1)[:, :, None], fwd[:, None, :], rc[:, None, :]
        )

        Lt = pool_buf.shape[1] - 4
        t_pool = lax.slice_in_dim(pool_buf, 0, Lt, axis=1)
        tb = lax.slice_in_dim(pool_buf, Lt, Lt + 4, axis=1).astype(jnp.uint32)
        tlens = lax.bitcast_convert_type(
            tb[:, 0] | (tb[:, 1] << 8) | (tb[:, 2] << 16) | (tb[:, 3] << 24),
            jnp.int32,
        )

        nm, score, in_tie = align_local(q, lo, slot_tid, slot_asv, t_pool, tlens)
        abund, count = em_local(in_tie, slot_asv)
        nm_g = lax.all_gather(nm, axis, axis=0, tiled=True)
        score_g = lax.all_gather(score, axis, axis=0, tiled=True)
        out = jnp.concatenate([
            lax.bitcast_convert_type(abund, jnp.int32),
            nm_g.reshape(-1),
            score_g.reshape(-1),
            count.astype(jnp.int32)[None],
        ])
        return out

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(None, None)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


def _pack_stage7_panels2(
    fwd_rows, qlen_rows, lo_panel, st_panel, slot_tid, slot_asv, R, C, Lq
):
    """Host-side packing for sharded_stage7_step_packed2.

    fwd_rows: (R, Lq) int8 forward codes (pad 5); qlen_rows: (R,) int;
    lo_panel: (R, C, Lq+1) SMOOTHED corridors; st_panel: (R, C) strand
    (+1/-1, empty slots any).
    """
    Lq2 = (Lq + 1) // 2
    Lb = (Lq + 7) // 8
    fwd = fwd_rows.astype(np.uint8)
    if Lq % 2:
        fwd = np.concatenate([fwd, np.full((R, 1), 5, np.uint8)], axis=1)
    q4 = fwd[:, 0::2] | (fwd[:, 1::2] << 4)
    qlen = np.ascontiguousarray(qlen_rows, np.uint16).view(np.uint8).reshape(R, 2)
    lo0 = np.ascontiguousarray(lo_panel[:, :, 0], np.uint16).view(np.uint8).reshape(R, 2 * C)
    deltas = (lo_panel[:, :, 1:] - lo_panel[:, :, :-1]).astype(np.uint8)
    dbits = np.packbits(deltas, axis=2, bitorder="little").reshape(R, C * Lb)
    tid = np.ascontiguousarray(slot_tid, np.int16).view(np.uint8).reshape(R, 2 * C)
    asv = np.ascontiguousarray(slot_asv, np.int16).view(np.uint8).reshape(R, 2 * C)
    st = (st_panel == 1).astype(np.uint8)
    # u16/i16 planes are stored as [all-low-bytes | all-high-bytes] (the
    # device reads them as two column slices)
    return np.concatenate([
        q4,
        qlen[:, 0::2], qlen[:, 1::2],
        lo0[:, 0::2], lo0[:, 1::2],
        dbits,
        tid[:, 0::2], tid[:, 1::2],
        asv[:, 0::2], asv[:, 1::2],
        st,
    ], axis=1)


def _pack_stage7_panels(q_panel, lo_panel, slot_tid, slot_asv, R, C, Lq):
    """Host-side row-major packing for sharded_stage7_step_packed."""
    row_bytes = C * Lq + 2 * C * (Lq + 1) + 8 * C
    buf = np.empty((R, row_bytes), np.uint8)
    o = 0
    n = C * Lq
    buf[:, o : o + n] = q_panel.reshape(R, n).view(np.uint8) if q_panel.dtype == np.uint8 else q_panel.reshape(R, n).astype(np.uint8)
    o += n
    n = C * (Lq + 1)
    lo16 = np.ascontiguousarray(lo_panel.reshape(R, n), dtype=np.int16)
    lov = lo16.view(np.uint8).reshape(R, n, 2)
    buf[:, o : o + n] = lov[:, :, 0]
    o += n
    buf[:, o : o + n] = lov[:, :, 1]
    o += n
    for ids in (slot_tid, slot_asv):
        iv = np.ascontiguousarray(ids.reshape(R, C), dtype=np.int32).view(np.uint8).reshape(R, C, 4)
        for b in range(4):
            buf[:, o : o + C] = iv[:, :, b]
            o += C
    return buf


def _pack_target_pool(t_pool, tlens_pool):
    T, Lt = t_pool.shape
    pool = np.empty((T, Lt + 4), np.uint8)
    pool[:, :Lt] = t_pool.astype(np.uint8)
    pool[:, Lt:] = tlens_pool.astype(np.int32).view(np.uint8).reshape(T, 4)
    return pool


@_functools.lru_cache(maxsize=32)
def sharded_stage7_align(mesh: Mesh, band: int, kernel: str = "scan"):
    """Build the stage-7 ALIGN step: candidate-sparse banded alignment +
    per-read tie sets over one row-chunk of candidate panels.  The chunked
    form (vs one monolithic align+EM jit) lets the host PIPELINE dispatches:
    several chunks are in flight while the host packs the next one, so
    per-call host->device latency amortizes away (the reference's batch
    economics, alignment.rs:1779-1919).

    Shapes are (Rc, C, ...) — per-read candidate panels, NOT dense R×A: each
    read carries only its planned candidate jobs (C = max jobs/read, empty
    slots padded).  Sharding on the read axis keeps every read's slots on
    one device, so tie-set reduction is shard-local.

      q        (Rc, C, Lq)   i32 sharded "dp"  oriented query codes (pad 5)
      t        (Rc, C, Lt)   i32 sharded       target codes (pad 6)
      lo       (Rc, C, Lq+1) i32 sharded       smoothed band offsets
      tlens    (Rc, C)       i32 sharded
      slot_asv (Rc, C)       i32 sharded       ASV id per slot, -1 = empty

    Returns (nm (Rc, C), score (Rc, C), in_tie (Rc, C) bool), all
    replicated so every process can read full rows back.

    Winner semantics match the host path bit-for-bit: per (read, ASV) the
    strictly-highest score wins with the EARLIEST slot keeping ties
    (align_pairs_nm's `m.score > best.score`); per read the min-NM winners
    form the tie set."""
    axis = mesh.axis_names[0]
    align_local = _stage7_align_local(band, kernel)

    def per_shard(q, lo, slot_tid, slot_asv, t_pool, tlens_pool):
        nm, score, in_tie = align_local(q, lo, slot_tid, slot_asv, t_pool, tlens_pool)
        # replicate so every PROCESS can read full rows back (under
        # multi-controller jax a "dp"-sharded output is only partially
        # addressable per process)
        nm_g = lax.all_gather(nm, axis, axis=0, tiled=True)
        score_g = lax.all_gather(score, axis, axis=0, tiled=True)
        tie_g = lax.all_gather(in_tie, axis, axis=0, tiled=True)
        return nm_g, score_g, tie_g

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None), P(axis, None), P(None, None), P(None)),
        out_specs=(P(), P(), P()),
        # the tiled all_gather makes the outputs replicated, but the static
        # rep checker can't see through it
        check_vma=False,
    )
    return jax.jit(sharded)


@_functools.lru_cache(maxsize=32)
def sharded_stage7_em(mesh: Mesh, n_asvs: int, em_iters: int, conv: float):
    """Build the stage-7 EM step: the FULL EM fixed point over the tie sets
    of every chunk, psum over the mesh (one (A,) collective per iteration;
    alignment.rs:1920-2003 economics).

      in_tie   (R, C) bool sharded "dp" — per-read min-NM tie sets
      slot_asv (R, C) i32 sharded       — ASV id per slot, -1 = empty

    Returns (abund (A,) replicated f32, assigned_count () replicated i32).
    Responsibilities are proportional to abundance within the tie set
    (ops/em.py fixed point, f32 on device)."""
    axis = mesh.axis_names[0]

    sharded = shard_map(
        _stage7_em_local(n_asvs, em_iters, conv, axis),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(), P()),
    )
    return jax.jit(sharded)


def mesh_stage7_tie_break(
    pairs: list,
    pair_read: np.ndarray,
    pair_asv: np.ndarray,
    n_reads: int,
    n_asvs: int,
    band: int | None = None,
    mesh: Mesh | None = None,
    em_iters: int | None = None,
):
    """PRODUCTION stage-7 mesh path (SAVONT_STAGE7_BACKEND=mesh): plan the
    candidate (read, ASV) pairs with the host seeding/chaining planner,
    pack the jobs into per-read (R, C) candidate panels, and run
    `sharded_stage7_step` (align + tie sets + full EM) over every visible
    device.  `dryrun_multichip` drives this exact function.

    Returns (per_pair_results, device_abund, assigned_count):
      per_pair_results — list aligned with `pairs`; dict(score, nm) of the
        pair's winning job or None, identical to align_pairs_nm's NM-only
        contract (same winner rule), so downstream eq-class construction
        is unchanged.
      device_abund — (n_asvs,) f32 EM abundances computed on-device.
    """
    import os

    from ..constants import EM_MAX_ITERATIONS
    from ..ops.align import resolve_band, smooth_lo
    from ..ops.align_batch import _plan_soa_indexed

    band = resolve_band(band)
    if em_iters is None:
        em_iters = EM_MAX_ITERATIONS
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size

    # flat SoA plan (bytes-identity dedup of the repeated read/ASV pool,
    # then one vectorized seeding/chaining sweep — the per-pair AlignJob
    # loop was the host bottleneck at device-batch scale)
    tgt_ids: dict[bytes, int] = {}
    qry_ids: dict[bytes, int] = {}
    job_uq = np.empty(len(pairs), dtype=np.int64)
    job_ti = np.empty(len(pairs), dtype=np.int64)
    for i, (qa, ta) in enumerate(pairs):
        job_uq[i] = qry_ids.setdefault(bytes(qa), len(qry_ids))
        job_ti[i] = tgt_ids.setdefault(bytes(ta), len(tgt_ids))
    plan = _plan_soa_indexed(list(qry_ids.keys()), list(tgt_ids.keys()), job_uq, job_ti, band)
    if plan is None:
        return _mesh_stage7_legacy(
            pairs, pair_read, pair_asv, n_reads, n_asvs, band, mesh, em_iters
        )
    if plan == "empty":
        owner_j = np.zeros(0, dtype=np.int64)
        q_cat = np.zeros(0, dtype=np.uint8)
        q_off_j = q_lens_j = tid_j = lo_off_j = np.zeros(0, dtype=np.int64)
        lo_flat = np.zeros(0, dtype=np.int32)
    else:
        (owner_j, _uq_j, _st_j, tid_j, q_cat, q_off_j, q_lens_j,
         _t_cat, _t_off_j, _t_lens_j, lo_flat, lo_off_j, _qlens_all, band) = plan

    # replicated unique-target pool: per-slot target panels are gathered ON
    # DEVICE from slot_tid (host-side expansion tripled the upload)
    t_pool, tlens_pool = _build_target_pool(list(tgt_ids.keys()))

    jr = pair_read[owner_j] if len(owner_j) else np.zeros(0, np.int64)  # job -> read

    # slot layout: jobs of one read occupy consecutive slots of its row
    # (plan order is the legacy per-pair order, so earliest-slot tie-breaks
    # match align_pairs_nm exactly)
    order = np.argsort(jr, kind="stable")
    jr_s = jr[order]
    slot_in_read = np.arange(len(jr_s)) - np.searchsorted(jr_s, jr_s, side="left")
    C = int(slot_in_read.max()) + 1 if len(jr_s) else 1
    if C > 32:
        import logging

        logging.getLogger("savont").info("stage-7 mesh: wide candidate row (C=%d)", C)

    # chunked rows: several dispatches in flight overlap host packing with
    # device compute; SAVONT_MESH_CHUNKS pins the count (1 = the one-dispatch
    # packed step)
    n_chunks = int(os.environ.get("SAVONT_MESH_CHUNKS", "0"))
    R_min = -(-max(n_reads, 1) // n_dev) * n_dev  # pad to mesh multiple
    if n_chunks <= 0:
        # ~128 reads per chunk, up to 8 in flight: enough rows per dispatch
        # to fill the kernel, enough chunks to overlap host packing with
        # device compute
        n_chunks = max(1, min(8, R_min // max(n_dev, 128)))
    Rc = -(-R_min // (n_chunks * n_dev)) * n_dev  # chunk rows, mesh multiple
    R = Rc * n_chunks
    Lq = int(q_lens_j.max()) if len(owner_j) else 8

    # vectorized panel packing (flat scatters; no per-job Python)
    rows_flat = jr_s * C + slot_in_read  # destination row in the (R*C) panel
    nq = q_lens_j[order].astype(np.int64)
    # narrow upload dtypes (widened on device): codes are 0..6, lo < 2^14
    # (planner guard), slot ids fit int16 up to 32k targets/ASVs
    sid_dt = np.int16 if max(n_asvs, len(t_pool)) < 32000 else np.int32
    # v2 packing ships per-READ fwd codes (the q panel is decoded on
    # device), so skip the largest host scatter when it's taken
    use_v2 = (
        n_chunks == 1
        and os.environ.get("SAVONT_MESH_PACK") != "v1"
        and not any(b"U" in qb or b"u" in qb for qb in qry_ids)
    )
    q_panel = None if use_v2 else np.full((R * C, Lq), 5, dtype=np.int8)
    lo_panel = np.zeros((R * C, Lq + 1), dtype=np.int16)
    slot_tid = np.full((R, C), -1, dtype=sid_dt)
    slot_asv = np.full((R, C), -1, dtype=sid_dt)
    if len(owner_j):
        def _scatter(dst, width, lens, src_off, src, col0):
            total = int(lens.sum())
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            dst.reshape(-1)[
                np.repeat(rows_flat * width, lens) + col0 + within
            ] = src[np.repeat(src_off, lens) + within]

        if not use_v2:
            _scatter(q_panel, Lq, nq, q_off_j[order], q_cat.astype(np.int8), 0)
        _scatter(lo_panel, Lq + 1, nq, lo_off_j[order], lo_flat.astype(np.int16), 1)
        lo_panel[rows_flat, 0] = lo_panel[rows_flat, 1]
        # pad tail: lo is non-decreasing per job (maximum.accumulate in the
        # planner), so a row-wise running max forward-fills the last value
        np.maximum.accumulate(lo_panel, axis=1, out=lo_panel)
        slot_tid.reshape(-1)[rows_flat] = tid_j[order]
        slot_asv.reshape(-1)[rows_flat] = pair_asv[owner_j[order]]
    # corridor-lag gate (smooth_lo caveat): slots whose smoothed corridor
    # lags >= band/2 columns behind the raw planner band (large structural
    # indels) are realigned on the host raw-band kernel after the device
    # pass, so the returned (score, nm) match the host oracle for EVERY
    # input, not just smooth ones
    from ..ops.align import smooth_lo_max_lag

    lag_flag = np.zeros(0, dtype=np.int64)
    if len(owner_j):
        lag = smooth_lo_max_lag(lo_panel.astype(np.int32))
        lag_flag = np.flatnonzero(lag[rows_flat] >= band // 2)
    lo_panel = smooth_lo(lo_panel).reshape(R, C, Lq + 1)
    if q_panel is not None:
        q_panel = q_panel.reshape(R, C, Lq)

    kernel = dp_kernel(band)
    if n_chunks == 1:
        # ONE combined align+EM dispatch with PACKED I/O (2 transfers + 1
        # execute + 1 fetch).  v2 packing ships each read's fwd codes once
        # (4-bit) + bit-packed corridor deltas (~10x fewer bytes than the
        # per-slot panels); reads containing U/u fall back to v1 (their rc
        # ENCODING differs from the device's 3-c derivation, see
        # _qcodes_cached_batch).
        pool = _pack_target_pool(t_pool, tlens_pool)
        if use_v2:
            from ..ops.align_batch import _qcodes_cached_batch

            fwd_rows = np.full((R, Lq), 5, np.int8)
            qlen_rows = np.zeros(R, np.int64)
            st_panel = np.ones((R, C), np.int8)
            if len(owner_j):
                fwd_codes = _qcodes_cached_batch([(qb, 1) for qb in qry_ids])
                uq_of_read = np.zeros(R, np.int64)
                uq_of_read[jr_s] = _uq_j[order]
                for r in np.unique(jr_s).tolist():
                    c = fwd_codes[uq_of_read[r]]
                    fwd_rows[r, : len(c)] = c
                    qlen_rows[r] = len(c)
                st_panel.reshape(-1)[rows_flat] = _st_j[order]
            step = sharded_stage7_step_packed2(
                mesh, n_asvs, band=int(band), em_iters=em_iters, conv=0.01,
                kernel=kernel, C=C, Lq=Lq,
            )
            buf = _pack_stage7_panels2(
                fwd_rows, qlen_rows, lo_panel, st_panel, slot_tid, slot_asv, R, C, Lq
            )
        else:
            step = sharded_stage7_step_packed(
                mesh, n_asvs, band=int(band), em_iters=em_iters, conv=0.01,
                kernel=kernel, C=C, Lq=Lq,
            )
            buf = _pack_stage7_panels(q_panel, lo_panel, slot_tid, slot_asv, R, C, Lq)
        out = np.asarray(step(shard_reads(mesh, buf), replicate_to_mesh(mesh, pool)))
        abund = out[:n_asvs].view(np.float32)
        nm = out[n_asvs : n_asvs + R * C].reshape(R, C)
        score = out[n_asvs + R * C : n_asvs + 2 * R * C].reshape(R, C)
        count = int(out[-1])
    else:
        align_step = sharded_stage7_align(mesh, band=band, kernel=kernel)
        em_step = sharded_stage7_em(mesh, n_asvs, em_iters=em_iters, conv=0.01)

        # dispatch every chunk before blocking on any result: jax dispatch
        # is async, so chunk k computes (and its transfer rides the wire)
        # while the host slices chunk k+1
        t_pool_d = replicate_to_mesh(mesh, t_pool)
        tlens_pool_d = replicate_to_mesh(mesh, tlens_pool)
        outs = []
        for c in range(n_chunks):
            s = c * Rc
            outs.append(
                align_step(
                    shard_reads(mesh, q_panel[s : s + Rc]),
                    shard_reads(mesh, lo_panel[s : s + Rc]),
                    shard_reads(mesh, slot_tid[s : s + Rc]),
                    shard_reads(mesh, slot_asv[s : s + Rc]),
                    t_pool_d,
                    tlens_pool_d,
                )
            )
        in_tie_full = jnp.concatenate([o[2] for o in outs], axis=0)
        abund_d, count_d = em_step(
            jax.device_put(in_tie_full, NamedSharding(mesh, P(mesh.axis_names[0], None))),
            shard_reads(mesh, slot_asv),
        )
        # ONE batched fetch for every chunk
        nm_parts, score_parts, abund, count = jax.device_get(
            ([o[0] for o in outs], [o[1] for o in outs], abund_d, count_d)
        )
        nm = np.concatenate(nm_parts, axis=0)
        score = np.concatenate(score_parts, axis=0)

    # per-pair winner on host (same rule as the device's per-(read,ASV)
    # reduction: strictly-greater score wins, earliest job keeps ties) —
    # vectorized: per pair take max score, first plan position on ties
    from types import SimpleNamespace

    best: list[SimpleNamespace | None] = [None] * len(pairs)
    if len(owner_j):
        s_flat = score.reshape(-1)[rows_flat]
        nm_flat = nm.reshape(-1)[rows_flat]
        if len(lag_flag):
            # host raw-band realign of the lag-gated jobs (plan order is
            # `order`; position p in the panel is plan job order[p])
            from ..ops.align_batch import nm_score_for_plan_jobs

            patched = nm_score_for_plan_jobs(plan, order[lag_flag])
            if patched is not None:
                s_flat[lag_flag] = patched[0]
                nm_flat[lag_flag] = patched[1]
        owner_s = owner_j[order]
        ok = np.flatnonzero(s_flat > 0)
        if len(ok):
            sel = np.lexsort((ok, -s_flat[ok], owner_s[ok]))
            ow = owner_s[ok][sel]
            first = sel[np.flatnonzero(np.concatenate(([True], ow[1:] != ow[:-1])))]
            for j in first:
                o = int(owner_s[ok[j]])
                best[o] = SimpleNamespace(
                    score=int(s_flat[ok[j]]), nm=int(nm_flat[ok[j]])
                )
    return best, np.asarray(abund), int(count)


def _mesh_stage7_legacy(pairs, pair_read, pair_asv, n_reads, n_asvs, band, mesh, em_iters):
    """Per-pair AlignJob fallback for mesh_stage7_tie_break when the SoA
    planner prerequisites are missing (no native libs): same packing and
    winner rule, one monolithic dispatch."""
    import os

    from ..ops.align import smooth_lo
    from ..ops.align_batch import _plan_pairs

    n_dev = mesh.devices.size
    jobs, owner = _plan_pairs(pairs, band)
    owner = np.asarray(owner, dtype=np.int64)
    jr = pair_read[owner] if len(owner) else np.zeros(0, np.int64)

    order = np.argsort(jr, kind="stable")
    jr_s = jr[order]
    slot_in_read = np.arange(len(jr_s)) - np.searchsorted(jr_s, jr_s, side="left")
    C = int(slot_in_read.max()) + 1 if len(jr_s) else 1
    R = -(-max(n_reads, 1) // n_dev) * n_dev

    # unique-target pool: the device gathers per-slot panels from slot_tid
    tgt_ids: dict[bytes, int] = {}
    for _qa, ta in pairs:
        tgt_ids.setdefault(bytes(ta), len(tgt_ids))
    t_pool, tlens_pool = _build_target_pool(list(tgt_ids.keys()))
    pair_tid = np.fromiter(
        (tgt_ids[bytes(ta)] for _qa, ta in pairs), np.int32, len(pairs)
    )

    Lq = max((len(jobs[i].qcodes) for i in order), default=8)
    q = np.full((R, C, Lq), 5, dtype=np.int32)
    lo = np.zeros((R, C, Lq + 1), dtype=np.int32)
    slot_tid = np.full((R, C), -1, dtype=np.int32)
    slot_asv = np.full((R, C), -1, dtype=np.int32)
    for pos, ji in enumerate(order):
        j = jobs[ji]
        r, c = int(jr_s[pos]), int(slot_in_read[pos])
        nq = len(j.qcodes)
        q[r, c, :nq] = j.qcodes
        lo[r, c, 1 : nq + 1] = j.lo
        lo[r, c, 0] = j.lo[0]
        if nq < Lq:
            lo[r, c, nq + 1 :] = j.lo[-1]
        slot_tid[r, c] = pair_tid[owner[ji]]
        slot_asv[r, c] = pair_asv[owner[ji]]
    lo = smooth_lo(lo.reshape(R * C, Lq + 1)).reshape(R, C, Lq + 1)

    step = sharded_stage7_step(
        mesh, n_asvs, band=band, em_iters=em_iters, conv=0.01, kernel=dp_kernel(band)
    )
    abund_d, nm_d, score_d, count_d = step(
        shard_reads(mesh, q),
        shard_reads(mesh, lo),
        shard_reads(mesh, slot_tid),
        shard_reads(mesh, slot_asv),
        replicate_to_mesh(mesh, t_pool),
        replicate_to_mesh(mesh, tlens_pool),
    )
    abund, nm, score, count = jax.device_get((abund_d, nm_d, score_d, count_d))

    from types import SimpleNamespace

    best: list[SimpleNamespace | None] = [None] * len(pairs)
    for pos, ji in enumerate(order):
        r, c = int(jr_s[pos]), int(slot_in_read[pos])
        s = int(score[r, c])
        if s <= 0:
            continue
        o = int(owner[ji])
        if best[o] is None or s > best[o].score:
            best[o] = SimpleNamespace(score=s, nm=int(nm[r, c]))
    return best, np.asarray(abund), int(count)


def sharded_classify_nm(mesh: Mesh, band: int = 128):
    """Build a jitted classify scoring step: queries (ASVs) replicated, the
    REFERENCE PANEL sharded over the mesh ("dp" axis = DB shards, the
    `classify` scale-out in BASELINE.json config 5).  Each device aligns
    every query against its local reference shard with the banded kernel;
    the (Q, R) NM/score matrices come back sharded on R.

    Step signature:
      queries (Q, Lq) int32 replicated
      lo      (Q, Lq+1) int32 replicated (smooth band offsets)
      refs    (R, Lt) int32 sharded on "dp"
      rlens   (R,) int32 sharded
    Returns (nm (Q, R) int32, score (Q, R) int32), R-axis sharded.
    """
    axis = mesh.axis_names[0]
    kernel = dp_kernel(band)

    def per_shard(queries, lo, refs, rlens):
        Q, Lq = queries.shape
        R, Lt = refs.shape
        q = jnp.repeat(queries, R, axis=0)
        lo_t = jnp.repeat(lo, R, axis=0)
        t = jnp.tile(refs, (Q, 1))
        tl = jnp.tile(rlens, Q)
        out = forward_meta(q, t, lo_t, tl, band, kernel, smooth=True)
        return out["nm"].reshape(Q, R), out["score"].reshape(Q, R)

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(axis, None), P(axis)),
        out_specs=(P(None, axis), P(None, axis)),
    )
    return jax.jit(sharded)


def sharded_sintax_scores(mesh: Mesh, query_kmers: np.ndarray):
    """Build a jitted SINTAX scoring step with the DATABASE sharded over the
    mesh (the "sintax DB shards per device" sweep — sintax.rs:219-273 is an
    embarrassingly parallel max-reduce over references).

    query_kmers (P, S) uint32: the S=32 subsampled k-mers per (asv, iter)
    pair, replicated to every device (a few hundred KB).  Rows of empty
    ASVs hold the 0xFFFFFFFE sentinel, which never matches a reference.

    The returned step takes one reference chunk:
      refk (R, L) uint32 — per-reference sorted unique k-mers padded with
                           0xFFFFFFFF, sharded on the mesh axis
      ridx (R,)  uint32 — kept-reference stream ordinals (< 2^26)
    and returns a replicated (P,) uint32 key vector:
      key = (score << 26) | (0x3FFFFFF - ordinal), or 0 when score == 0.
    Maximizing the key reproduces the host stream's tie-break exactly
    (strictly-greater score wins; equal scores keep the EARLIEST reference),
    so chunks and shards can be max-reduced in any order (lax.pmax across
    the mesh here, np.maximum across chunks on host).
    """
    axis = mesh.axis_names[0]
    qk = jnp.asarray(query_kmers, jnp.uint32)
    n_pairs, S = qk.shape
    flat = qk.reshape(-1)

    def per_shard(refk, ridx):
        def row_key(row, ri):
            pos = jnp.searchsorted(row, flat)
            hit = row[jnp.clip(pos, 0, row.shape[0] - 1)] == flat
            score = hit.reshape(n_pairs, S).sum(axis=1).astype(jnp.uint32)
            return jnp.where(
                score > 0, (score << jnp.uint32(26)) | (jnp.uint32(0x3FFFFFF) - ri),
                jnp.uint32(0),
            )

        keys = jax.vmap(row_key)(refk, ridx)  # (R/D, P)
        local = keys.max(axis=0)
        return lax.pmax(local, axis)

    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=P(),
    )
    return jax.jit(sharded)


def shard_reads(mesh: Mesh, reads: np.ndarray, axis: str = "dp"):
    """Place a host batch with batch-axis sharding over the mesh.

    Multi-controller safe: under `jax.distributed` every process runs this
    with the SAME full host array (the host pipeline is deterministic), and
    make_array_from_callback hands each process only its addressable
    shards.  In single-process meshes it degenerates to a device_put."""
    spec = P(axis) if reads.ndim == 1 else P(axis, *([None] * (reads.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        return jax.make_array_from_callback(reads.shape, sharding, lambda idx: reads[idx])
    return jax.device_put(reads, sharding)



# ── stage-4 pileup construction on the mesh ─────────────────────────────────
#
# The whole stage-4 pileup build (alignment.rs:409-652) as ONE device
# pipeline: orient (both planned strands per pair, winner on device) +
# banded align + traceback walk + direct count-matrix scatter, sharded over
# (read, consensus) pairs; the per-consensus matrices are psum-reduced so
# only ~total_L*(3*NQ+1(+64)) int32 counters ever leave the device.
# SAVONT_STAGE4_BACKEND=mesh routes pipeline/pileup.generate_consensus_pileups
# here, output-identical (tests/test_stage4_mesh.py).


def _ext_codes(b: bytes) -> np.ndarray:
    """ACGT -> 0..3; every other byte keeps its ASCII value (>= 33).  DP
    behavior is identical to ascii_to_align_codes (is_match needs code < 4)
    while code equality == ASCII equality, which the pileup is_ref column
    needs (the host compares raw bytes, alignment.rs:528)."""
    arr = np.frombuffer(bytes(b), dtype=np.uint8)
    out = arr.astype(np.int16)
    for ch, c in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3),
                  (ord("a"), 0), (ord("c"), 1), (ord("g"), 2), (ord("t"), 3)):
        out[arr == ch] = c
    return out.astype(np.int8)


@_functools.lru_cache(maxsize=8)
def _stage4_step(mesh: Mesh, band: int, total_L: int, nq: int, ops_max: int,
                 slots: int, use_hp: bool, kernel: str = "xla"):
    """Jitted sharded accumulate-step: adds one pair-chunk's pileup counts
    into the running (replicated) accumulators.  Pair rows are sharded with
    their `slots` candidate jobs packed along the feature axis, so a pair's
    strand winner is decided locally on its device.  kernel ("cuda" or
    "xla") picks the forward; both are exact on raw bands."""
    from ..ops import align_jax

    axis = mesh.axis_names[0]
    n_acc = 4 if use_hp else 3

    def per_shard(*args2):
        acc = args2[:n_acc]
        q, lo, lvl, hp, off, tid, t_pool, tlens_pool = args2[n_acc:]
        Pl = q.shape[0]
        Lq = q.shape[1] // slots
        q = q.reshape(Pl * slots, Lq).astype(jnp.int32)
        lo = lo.reshape(Pl * slots, Lq + 1).astype(jnp.int32)
        lvl = lvl.reshape(Pl * slots, Lq).astype(jnp.int32)
        hp = hp.reshape(Pl * slots, -1).astype(jnp.int32)
        off = off.reshape(Pl * slots).astype(jnp.int32)
        tid = tid.reshape(Pl * slots).astype(jnp.int32)
        tidc = jnp.clip(tid, 0, t_pool.shape[0] - 1)
        t = t_pool[tidc]
        tl = tlens_pool[tidc]
        out = align_jax.sw_pileup_counts(
            q, t, lo, tl, lvl, hp, off,
            total_L, nq, band, ops_max, slots=slots, use_hp=use_hp, kernel=kernel,
        )
        keys = ["bq", "dels", "ins"] + (["hph"] if use_hp else [])
        return tuple(a + lax.psum(out[k], axis) for a, k in zip(acc, keys))

    acc_specs = tuple(P(None) for _ in range(n_acc))
    sharded = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=acc_specs + (
            P(axis, None), P(axis, None), P(axis, None), P(axis, None),
            P(axis, None), P(axis, None), P(None, None), P(None),
        ),
        out_specs=acc_specs,
        # FFI call outputs carry no vma annotation; replication of the
        # accumulators is enforced by the explicit psum
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=tuple(range(n_acc)))


def mesh_stage4_pileups(twin_reads, consensuses, args, mesh: Mesh | None = None):
    """Device stage-4 pileup construction (SAVONT_STAGE4_BACKEND=mesh).

    Mirrors pipeline/pileup.generate_consensus_pileups exactly: same
    payload (HPC per read under --use-hpc), same SoA planning, same winner
    rule (max score, earliest plan slot), same count-matrix semantics —
    the alignment + traceback + scatter all run on the mesh in pair-row
    chunks with device-side accumulation, ONE batched fetch at the end."""
    import os

    from ..ops.align import resolve_band
    from ..ops.align_batch import _plan_soa_indexed
    from ..ops.encode import revcomp_bytes
    from ..pipeline.pileup import NQ, PileupMatrix, _pileup_payload, qlevel

    band = resolve_band(None)
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    use_hp = bool(args.use_hpc)

    owners, payload = _pileup_payload(twin_reads, consensuses, args)

    # flat count buffers (identical layout to the host path)
    L_flat = np.fromiter((len(c.sequence) for c in consensuses), np.int64, len(consensuses))
    roff = np.zeros(len(consensuses) + 1, dtype=np.int64)
    np.cumsum(L_flat, out=roff[1:])
    total_L = max(int(roff[-1]), 1)

    tgt_pool_bytes = [cons.sequence.tobytes() for cons in consensuses]
    plan = _plan_soa_indexed(
        [p[0] for p in payload], tgt_pool_bytes,
        np.arange(len(payload), dtype=np.int64),
        np.asarray(owners, dtype=np.int64), band,
    ) if payload else "empty"
    if plan is None:
        # SoA planner prerequisites missing -> host path (identical output)
        from ..pipeline import pileup as _pileup_mod

        env = os.environ.pop("SAVONT_STAGE4_BACKEND", None)
        try:
            return _pileup_mod.generate_consensus_pileups(twin_reads, consensuses, args)
        finally:
            if env is not None:
                os.environ["SAVONT_STAGE4_BACKEND"] = env

    bq = np.zeros(total_L * NQ * 2, dtype=np.int64)
    dels = np.zeros(total_L, dtype=np.int64)
    ins = np.zeros(total_L * NQ, dtype=np.int64)
    hph = np.zeros(total_L * 64, dtype=np.int64) if use_hp else None

    if plan != "empty":
        (owner_j, _uq_j, st_j, tid_j, _q_cat, _q_off_j, q_lens_j,
         _t_cat, _t_off_j, _t_lens_j, lo_flat, lo_off_j, _qlens_all, band) = plan

        # slot layout: jobs of one pair in consecutive slots, plan order
        # (strand - then +) so the device argmax-first winner rule matches
        # the host's strictly-greater replacement exactly
        order = np.argsort(owner_j, kind="stable")
        ow_s = owner_j[order]
        slot_in_pair = np.arange(len(ow_s)) - np.searchsorted(ow_s, ow_s, side="left")
        C = int(slot_in_pair.max()) + 1 if len(ow_s) else 1
        Pn = len(payload)
        Lq = int(q_lens_j.max()) if len(owner_j) else 8

        rows_flat = ow_s * C + slot_in_pair
        q_panel = np.full((Pn * C, Lq), 5, dtype=np.int8)
        lvl_panel = np.zeros((Pn * C, Lq), dtype=np.int8)
        hpw = Lq if use_hp else 1
        hp_panel = np.zeros((Pn * C, hpw), dtype=np.int8)
        lo_panel = np.zeros((Pn * C, Lq + 1), dtype=np.int16)
        tid_panel = np.full(Pn * C, -1, dtype=np.int32)
        off_panel = np.zeros(Pn * C, dtype=np.int32)

        # oriented panels (EXT codes; qual levels / clamped HP reversed for
        # strand -1), each used (pair, strand) encoded exactly once
        seq_cache: dict[tuple[int, int], tuple] = {}
        for idx, k in enumerate(order.tolist()):
            pi = int(ow_s[idx])
            row = int(rows_flat[idx])
            st = int(st_j[k])
            ent = seq_cache.get((pi, st))
            if ent is None:
                seq, qual, hp = payload[pi]
                if st == -1:
                    ob = revcomp_bytes(seq)
                    oq = qual[::-1]
                    ohp = hp[::-1] if hp is not None else None
                else:
                    ob, oq, ohp = seq, qual, hp
                codes = _ext_codes(ob)
                lv = qlevel(oq).astype(np.int8)
                hv = (np.minimum(ohp, 63).astype(np.int8)
                      if (use_hp and ohp is not None) else None)
                ent = seq_cache[(pi, st)] = (codes, lv, hv)
            codes, lv, hv = ent
            n = len(codes)
            q_panel[row, :n] = codes
            lvl_panel[row, :n] = lv
            if hv is not None:
                hp_panel[row, :n] = hv
            lo = lo_flat[lo_off_j[k] : lo_off_j[k] + n]
            if n:
                lo_panel[row, 1 : n + 1] = lo
                lo_panel[row, 0] = lo[0]
                if n < Lq:
                    lo_panel[row, n + 1 :] = lo_panel[row, n]
            tid_panel[row] = int(tid_j[k])
            off_panel[row] = int(roff[int(tid_j[k])])

        t_pool, tlens_pool = _build_target_pool(tgt_pool_bytes)
        for i, tb in enumerate(tgt_pool_bytes):
            t_pool[i, : len(tb)] = _ext_codes(tb)  # is_ref needs byte equality

        Lt = t_pool.shape[1]
        ops_max = Lq + Lt
        # chunk pair rows (payload planes are rows*Lq*band bytes on device);
        # ~512 job rows per chunk, each chunk a multiple of the mesh size
        target_rows = 512
        pair_chunk = max(n_dev, (-(-target_rows // max(C, 1)) // n_dev) * n_dev)

        accs = [
            jnp.zeros(total_L * NQ * 2, jnp.int32),
            jnp.zeros(total_L, jnp.int32),
            jnp.zeros(total_L * NQ, jnp.int32),
        ] + ([jnp.zeros(total_L * 64, jnp.int32)] if use_hp else [])
        accs = [replicate_to_mesh(mesh, np.asarray(a)) for a in accs]
        t_pool_d = replicate_to_mesh(mesh, t_pool)
        tlens_d = replicate_to_mesh(mesh, tlens_pool)

        step = _stage4_step(
            mesh, int(band), total_L, NQ, ops_max, C, use_hp, dp_kernel(int(band))
        )
        slot_cols = np.arange(C)[None, :]
        for s in range(0, Pn, pair_chunk):
            sel = np.arange(s, min(s + pair_chunk, Pn))
            rows = len(sel)
            pad = (-rows) % n_dev
            row_idx = (sel[:, None] * C + slot_cols).reshape(-1)

            def pad_rows(a, fill=0):
                part = a[row_idx].reshape(rows, -1)
                if pad:
                    part = np.concatenate(
                        [part, np.full((pad,) + part.shape[1:], fill, a.dtype)]
                    )
                return np.ascontiguousarray(part)

            accs = list(step(
                *accs,
                shard_reads(mesh, pad_rows(q_panel, 5)),
                shard_reads(mesh, pad_rows(lo_panel)),
                shard_reads(mesh, pad_rows(lvl_panel)),
                shard_reads(mesh, pad_rows(hp_panel)),
                shard_reads(mesh, pad_rows(off_panel)),
                shard_reads(mesh, pad_rows(tid_panel, -1)),
                t_pool_d,
                tlens_d,
            ))
        fetched = jax.device_get(accs)
        bq += fetched[0].astype(np.int64)
        dels += fetched[1].astype(np.int64)
        ins += fetched[2].astype(np.int64)
        if use_hp:
            hph += fetched[3].astype(np.int64)

    pms = []
    for ci, cons in enumerate(consensuses):
        L = len(cons.sequence)
        o = int(roff[ci])
        pms.append(
            PileupMatrix(
                ref=cons.sequence.copy(),
                bq=bq[o * NQ * 2 : (o + L) * NQ * 2].reshape(L, NQ, 2),
                dels=dels[o : o + L],
                ins_q=ins[o * NQ : (o + L) * NQ].reshape(L, NQ),
                hp_hist=hph[o * 64 : (o + L) * 64].reshape(L, 64) if use_hp else None,
            )
        )
    # modal HP length per position -> consensus hp_lengths (same side
    # effect as the host generate_consensus_pileups tail)
    from ..pipeline.pileup import _median_from_hist

    for cons, pm in zip(consensuses, pms):
        if pm.hp_hist is not None:
            cons.hp_lengths = _median_from_hist(pm.hp_hist)
        else:
            cons.hp_lengths = np.ones(len(cons.sequence), dtype=np.uint8)
    return pms


# ── stage-1 split-kmer counting on the mesh ─────────────────────────────────


def sharded_split_kmer_count(
    mesh: Mesh, code_list, phred_list, k: int, min_bq: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stage-1 flagged split-kmer counting sharded over the mesh — the
    SURVEY §2.3 "k-mer table shard-by-hash + merge ≈ all-to-all" mapping
    (the reference shards counters by `kmer % threads` over channel-fed
    hash maps, seq_parse.rs:316-497; here the same partition rides XLA
    collectives).

    Reads are dp-sharded.  Each device (1) extracts its shard's flagged
    canonical split k-mers (ops.kmers_jax.split_kmers_batch — exact
    seeding.rs:975-1068 semantics), (2) routes every key to the device
    owning its keyspace slice (canonical-kmer low bits % n_dev) with ONE
    lax.all_to_all of per-destination buckets, and (3) the owner lexsorts
    its slice's (hi, lo) uint32 planes and segment-reduces run lengths.
    Returns (kmers u64 ascending, counts i64) — identical to
    np.unique(all extracted flagged kmers, return_counts=True)
    (tests/test_multichip.py pins parity vs the native host scan).

    Validation-scale shapes: per-destination buckets are padded to the
    worst case (a shard's every key on one destination), so device memory
    is n_dev x the shard's key-slot count.  A production pod would cap
    bucket size with overflow rounds; the collective pattern — extract
    local, all-to-all by key ownership, reduce local — is the point.
    """
    from ..ops.kmers_jax import _combine64, pad_reads, split_kmers_batch

    axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    if not code_list:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    codes, phred, lens = pad_reads(code_list, phred_list, pad_to=64)
    has_qual = phred_list is not None and any(p is not None for p in phred_list)
    N, L = codes.shape
    pad_n = (-N) % n_dev
    if pad_n:
        codes = np.concatenate([codes, np.zeros((pad_n, L), codes.dtype)])
        phred = np.concatenate([phred, np.zeros((pad_n, L), phred.dtype)])
        lens = np.concatenate([lens, np.zeros(pad_n, lens.dtype)])
    Nd = (N + pad_n) // n_dev
    n = L - k + 1
    E = Nd * n          # key slots per shard (incl. invalid)
    NS = n_dev * E      # worst-case slots landing on one owner

    U32c = jnp.uint32
    SENT = U32c(0xFFFFFFFF)  # unreachable as a real key: hi <= 2^31|2^(2k-32)

    def step(codes_s, phred_s, lens_s):
        khi, klo, canon, valid = split_kmers_batch(
            codes_s, phred_s, lens_s, k, min_bq, has_qual
        )
        hi = (khi | (canon.astype(U32c) << U32c(31))).reshape(-1)
        lo = klo.reshape(-1)
        v = valid.reshape(-1)
        hi = jnp.where(v, hi, SENT)
        lo = jnp.where(v, lo, SENT)
        dest = (klo.reshape(-1) % U32c(n_dev)).astype(jnp.int32)
        dest = jnp.where(v, dest, jnp.int32(n_dev - 1))
        # group by destination: stable sort + within-group rank -> one
        # scatter into fixed (n_dev, E) buckets
        order = jnp.argsort(dest, stable=True)
        dsort = dest[order]
        first = jnp.searchsorted(dsort, jnp.arange(n_dev, dtype=dsort.dtype))
        rank = jnp.arange(E) - first[dsort]
        buck_hi = jnp.full((n_dev, E), SENT).at[dsort, rank].set(hi[order])
        buck_lo = jnp.full((n_dev, E), SENT).at[dsort, rank].set(lo[order])
        # ONE all-to-all: bucket row d -> device d; received row s is the
        # slice of keys source s owes this device
        rh = lax.all_to_all(buck_hi, axis, 0, 0, tiled=True).reshape(-1)
        rl = lax.all_to_all(buck_lo, axis, 0, 0, tiled=True).reshape(-1)
        o = jnp.lexsort((rl, rh))
        sh, sl = rh[o], rl[o]
        newseg = jnp.concatenate(
            [jnp.ones(1, bool), (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])]
        )
        seg = jnp.cumsum(newseg) - 1
        live = ~((sh == SENT) & (sl == SENT))
        cnt = jax.ops.segment_sum(live.astype(jnp.int32), seg, num_segments=NS)
        out_cnt = jnp.where(newseg & live, cnt[seg], 0)
        out_hi = jnp.where(newseg & live, sh, SENT)
        out_lo = jnp.where(newseg & live, sl, SENT)
        return out_hi[None], out_lo[None], out_cnt[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)),
    )
    oh, ol, oc = jax.jit(sharded)(codes, phred, lens)
    oh = np.asarray(oh).reshape(-1)
    ol = np.asarray(ol).reshape(-1)
    oc = np.asarray(oc).reshape(-1).astype(np.int64)
    keep = (oc > 0) & ~((oh == 0xFFFFFFFF) & (ol == 0xFFFFFFFF))
    kmers = _combine64(oh[keep], ol[keep])
    counts = oc[keep]
    o = np.argsort(kmers, kind="stable")
    return kmers[o], counts[o]

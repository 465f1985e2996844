"""Multi-chip sharding dry run on the virtual 8-device CPU mesh
(conftest sets XLA_FLAGS=--xla_force_host_platform_device_count=8)."""
import jax
import numpy as np
import pytest


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_kernel_matches_host_on_cpu():
    """Device kernel == host DP on a few random banded jobs."""
    from savont_tpu.ops.align import TargetIndex
    from savont_tpu.ops.align_batch import plan_jobs, run_jobs
    from savont_tpu.ops.align_jax import sw_scores_numpy_jobs

    rng = np.random.default_rng(13)
    jobs = []
    for _ in range(6):
        t = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 400).astype(np.uint8).tobytes()
        q = bytearray(t)
        for p in rng.choice(len(q), 8, replace=False):
            q[p] = b"ACGT"[rng.integers(4)]
        jobs.extend(plan_jobs(TargetIndex([t]), bytes(q), band=64, min_anchors=2))
    host = run_jobs(jobs, band=64)
    dev = sw_scores_numpy_jobs(jobs, band=64)
    for h, d in zip(host, dev):
        ht = (h[0], h[1], h[2], h[3], h[4], h[6]) if h else None
        dt = (d["score"], d["q_start"], d["q_end"], d["t_start"], d["t_end"], d["nm"]) if d else None
        assert ht == dt


def test_sharded_classify_nm():
    """DB-sharded classify scoring on the virtual mesh: each query's best
    reference (min NM) must be its known source."""
    import jax.numpy as jnp

    from savont_tpu.ops.align import smooth_lo
    from savont_tpu.parallel.mesh import make_mesh, shard_reads, sharded_classify_nm

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    band = 32
    Q, R, L = 4, 16, 96
    rng = np.random.default_rng(3)
    refs = rng.integers(0, 4, (R, L)).astype(np.int32)
    queries = np.empty((Q, L), dtype=np.int32)
    src = []
    for i in range(Q):
        j = int(rng.integers(R))
        src.append(j)
        q = refs[j].copy()
        flip = rng.integers(0, L, 2)
        q[flip] = (q[flip] + 1) % 4
        queries[i] = q
    lo = smooth_lo(
        np.tile(np.maximum.accumulate(np.clip(np.arange(L + 1) - band // 2, 0, L - band))[None, :], (Q, 1)).astype(np.int32)
    )
    step = sharded_classify_nm(mesh, band=band)
    nm, score = step(
        jnp.asarray(queries), jnp.asarray(lo),
        shard_reads(mesh, refs), shard_reads(mesh, np.full(R, L, np.int32)),
    )
    # rank by SCORE (like minimap2 primary selection); NM of the best hit
    best = np.asarray(score).argmax(axis=1)
    assert best.tolist() == src
    assert (np.asarray(nm)[np.arange(Q), best] <= 2).all()


def test_run_jobs_nm_sharded_matches_native(monkeypatch):
    """SAVONT_ALIGN_BACKEND=jax shards NM-only scoring batches over all
    devices (align_jax._sharded_forward) with results equal to the host
    kernel's (score, spans, NM)."""
    import jax

    from savont_tpu.ops.align import TargetIndex
    from savont_tpu.ops.align_batch import plan_jobs_batch, run_jobs_nm
    from savont_tpu.ops.encode import revcomp_bytes

    if jax.device_count() < 2:
        pytest.skip("needs multiple devices")
    rng = np.random.default_rng(11)

    def rand_seq(n):
        return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n).tobytes()

    targets = [rand_seq(600) for _ in range(3)]
    queries = []
    for t in targets:
        for _ in range(7):
            q = bytearray(t)
            for p in rng.choice(len(q), 30, replace=False):
                q[p] = b"ACGT"[rng.integers(4)]
            queries.append(bytes(q) if rng.random() < 0.5 else revcomp_bytes(bytes(q)))
    idx = TargetIndex(targets)
    jobs, _ = plan_jobs_batch(idx, queries, band=64)
    assert jobs
    host = run_jobs_nm(jobs, band=64)
    monkeypatch.setenv("SAVONT_ALIGN_BACKEND", "jax")
    dev = run_jobs_nm(jobs, band=64)
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        assert (h is None) == (d is None)
        if h is not None:
            # (score, q0, q1, t0, t1, cigar, nm) — device path has no cigar
            assert h[0] == d[0] and h[6] == d[6], (h, d)
            assert h[1:5] == d[1:5], (h, d)


def test_sintax_device_matches_host(tmp_path, monkeypatch):
    """SINTAX with the DB sharded over the virtual 8-device mesh must produce
    byte-identical outputs to the host streaming path, including the
    earliest-ref tie-break (two refs sharing a genus score equally)."""
    from savont_tpu.config import SintaxArgs
    from savont_tpu.db.registry import load_database
    from savont_tpu.pipeline.sintax import sintax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = {str(100 + i): rng.choice(bases, 600).tobytes().decode() for i in range(9)}
    seqs["200"] = seqs["100"]  # exact duplicate -> score tie, earliest ref wins
    db_dir = tmp_path / "db"
    db_dir.mkdir()
    with open(db_dir / "species_taxid.fasta", "w") as f:
        for tid, s in seqs.items():
            f.write(f">{tid}:x\n{s}\n")
    with open(db_dir / "taxonomy.tsv", "w") as f:
        f.write("tax_id\tspecies\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom\tsubspecies\tspecies subgroup\tspecies group\n")
        for i, tid in enumerate(seqs):
            f.write(f"{tid}\tSp{i}\tGen{i % 4}\tFam\tOrd\tCls\tPhy\t\tBacteria\t\t\t\n")
    (db_dir / ".savont_db").write_text("emu-1")

    outs = {}
    for backend in ("host", "jax"):
        run = tmp_path / f"run_{backend}"
        run.mkdir()
        with open(run / "final_asvs.fasta", "w") as f:
            f.write(f">final_consensus_0_depth_50\n{seqs['100']}\n")
            f.write(f">final_consensus_1_depth_10\n{seqs['103']}\n")
        if backend == "jax":
            monkeypatch.setenv("SAVONT_SINTAX_BACKEND", "jax")
        else:
            monkeypatch.delenv("SAVONT_SINTAX_BACKEND", raising=False)
        sintax(SintaxArgs(input_dir=str(run), db=str(db_dir)), load_database(db_dir))
        outs[backend] = (
            (run / "asv_mappings.tsv").read_text(),
            (run / "genus_abundance.tsv").read_text(),
        )
    assert outs["host"] == outs["jax"]


def test_stage7_mesh_backend_end_to_end(tmp_path, monkeypatch):
    """SAVONT_STAGE7_BACKEND=mesh routes the production stage-7 tie-break
    + EM through the sharded (R, C) candidate-panel step over the virtual
    8-device mesh; outputs must be byte-identical to the host path (same
    winner rule; emitted depths still use the host f64 EM)."""
    import gzip

    from savont_tpu.config import ClusterArgs
    from savont_tpu.ops.encode import revcomp_bytes
    from savont_tpu.pipeline.asv import run_cluster

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    rng = np.random.default_rng(17)
    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
    t1 = bytearray(rng.choice(BASES, 1400).tobytes())
    t2 = bytearray(t1)
    for p in (160, 480, 800, 1200):
        t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
    reads = []
    for tpl in (bytes(t1), bytes(t2)):
        for i in range(40):
            b = bytearray(tpl)
            for p in rng.choice(len(b), 2, replace=False):
                b[p] = b"ACGT"[rng.integers(4)]
            r = bytes(b)
            reads.append(revcomp_bytes(r) if i % 2 else r)
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")

    outs = {}
    for tag in ("host", "mesh"):
        if tag == "mesh":
            monkeypatch.setenv("SAVONT_STAGE7_BACKEND", "mesh")
        else:
            monkeypatch.delenv("SAVONT_STAGE7_BACKEND", raising=False)
        out = tmp_path / tag
        run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=2, min_cluster_size=5))
        outs[tag] = out

    for rel in ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv"):
        a = (outs["host"] / rel).read_bytes()
        b = (outs["mesh"] / rel).read_bytes()
        assert a == b, f"{rel} differs between host and mesh stage-7"


def _mesh_workload(n_reads=24, A=3, L=260, seed=29):
    import numpy as np

    rng = np.random.default_rng(seed)
    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
    asvs = [rng.choice(BASES, L).tobytes() for _ in range(A)]
    pairs, rr, ca = [], [], []
    for r in range(n_reads):
        b = bytearray(asvs[r % A])
        for p in rng.choice(len(b), 6, replace=False):
            b[p] = b"ACGT"[rng.integers(4)]
        read = bytes(b)
        for a in sorted({r % A, (r + 1) % A}):
            pairs.append((read, asvs[a]))
            rr.append(r)
            ca.append(a)
    return pairs, np.array(rr), np.array(ca), n_reads, A


def _tie_break_results(pairs, rr, ca, n_reads, A, mesh):
    from savont_tpu.parallel.mesh import mesh_stage7_tie_break

    best, abund, count = mesh_stage7_tie_break(pairs, rr, ca, n_reads, A, band=64, mesh=mesh)
    return (
        [(None if b is None else (b.score, b.nm)) for b in best],
        abund,
        count,
    )


def test_stage7_mesh_monolithic_matches_chunked(monkeypatch):
    """SAVONT_MESH_CHUNKS=1 routes through the ONE-dispatch combined step
    (the path high-latency links take; tests otherwise exercise the chunked
    pipeline because the CPU mesh roundtrip is tiny).  Winners/count must be
    identical, device abundances equal to f32 reduction-order tolerance."""
    import numpy as np

    from savont_tpu.parallel.mesh import make_mesh

    pairs, rr, ca, n_reads, A = _mesh_workload()
    mesh = make_mesh(4)
    monkeypatch.setenv("SAVONT_MESH_CHUNKS", "4")
    best_c, abund_c, count_c = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    monkeypatch.setenv("SAVONT_MESH_CHUNKS", "1")
    best_m, abund_m, count_m = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    assert best_c == best_m
    assert count_c == count_m
    assert np.allclose(abund_c, abund_m, atol=1e-6)


def test_stage7_mesh_legacy_fallback_matches_soa(monkeypatch):
    """The per-pair AlignJob fallback (_mesh_stage7_legacy, taken when the
    SoA planner prerequisites are missing) must agree with the SoA path."""
    import numpy as np

    from savont_tpu.ops import align_batch
    from savont_tpu.parallel import mesh as mesh_mod
    from savont_tpu.parallel.mesh import make_mesh

    pairs, rr, ca, n_reads, A = _mesh_workload(seed=31)
    mesh = make_mesh(4)
    best_s, abund_s, count_s = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    monkeypatch.setattr(align_batch, "_plan_soa_indexed", lambda *a, **k: None)
    best_l, abund_l, count_l = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    assert best_s == best_l
    assert count_s == count_l
    assert np.allclose(abund_s, abund_l, atol=1e-6)


def test_stage7_mesh_packed_v2_matches_v1(monkeypatch):
    """The v2 packed dispatch (per-read 4-bit fwd codes + device-derived rc
    + bit-packed corridor deltas) decodes to exactly the panels v1 ships:
    winners, count and abundances must match bit-for-bit."""
    import numpy as np

    from savont_tpu.parallel.mesh import make_mesh

    pairs, rr, ca, n_reads, A = _mesh_workload(seed=37)
    mesh = make_mesh(4)
    monkeypatch.setenv("SAVONT_MESH_CHUNKS", "1")
    monkeypatch.setenv("SAVONT_MESH_PACK", "v1")
    best_1, abund_1, count_1 = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    monkeypatch.delenv("SAVONT_MESH_PACK")
    best_2, abund_2, count_2 = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    assert best_1 == best_2
    assert count_1 == count_2
    assert np.array_equal(abund_1, abund_2)


def test_stage7_mesh_packed_v2_u_reads_fall_back(monkeypatch):
    """Reads containing U take the v1 packed path (device rc derivation
    would diverge from revcomp_bytes' U handling); results identical."""
    import numpy as np

    from savont_tpu.parallel.mesh import make_mesh

    pairs, rr, ca, n_reads, A = _mesh_workload(seed=41)
    # splice a U into one read (both its pairs share the bytes object)
    qb = bytearray(pairs[0][0])
    qb[5] = ord("U")
    pairs = [(bytes(qb) if p[0] is pairs[0][0] else p[0], p[1]) for p in pairs]
    mesh = make_mesh(4)
    monkeypatch.setenv("SAVONT_MESH_CHUNKS", "1")
    monkeypatch.setenv("SAVONT_MESH_PACK", "v1")
    best_1, abund_1, count_1 = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    monkeypatch.delenv("SAVONT_MESH_PACK")
    best_2, abund_2, count_2 = _tie_break_results(pairs, rr, ca, n_reads, A, mesh)
    assert best_1 == best_2 and count_1 == count_2
    assert np.array_equal(abund_1, abund_2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_sharded_split_kmer_count_matches_host():
    """Mesh-sharded stage-1 counting (extract local -> all_to_all by key
    ownership -> owner-side segment reduce) must equal np.unique over the
    host-parity extraction, including multiplicities (duplicated reads)
    and the mid-base quality gate."""
    from savont_tpu.ops.kmers_jax import device_split_kmers
    from savont_tpu.parallel.mesh import make_mesh, sharded_split_kmer_count

    rng = np.random.default_rng(5)
    base = [rng.integers(0, 4, int(rng.integers(60, 400))).astype(np.uint8)
            for _ in range(9)]
    # duplicates drive counts > 1; varying lengths exercise the padding
    code_list = base + [b.copy() for b in base[:5]] + base[2:4]
    phred_list = [rng.integers(10, 45, len(c)).astype(np.uint8) for c in code_list]
    k, min_bq = 17, 25

    mesh = make_mesh(8)
    km, ct = sharded_split_kmer_count(mesh, code_list, phred_list, k, min_bq)
    flat = np.concatenate(device_split_kmers(code_list, phred_list, k, min_bq))
    ek, ec = np.unique(flat, return_counts=True)
    np.testing.assert_array_equal(km, ek)
    np.testing.assert_array_equal(ct, ec.astype(np.int64))
    assert int(ct.max()) >= 2  # the duplicates really produced multiplicities

    # host-native oracle for full independence from the JAX extraction
    from savont_tpu.ops.kmers_native import get_scan_lib, split_kmers_flat_native

    if get_scan_lib() is not None:
        host_flat = split_kmers_flat_native(
            [c for c in code_list], [p for p in phred_list], k, min_bq, 2
        )
        hk, hc = np.unique(host_flat, return_counts=True)
        np.testing.assert_array_equal(km, hk)
        np.testing.assert_array_equal(ct, hc.astype(np.int64))

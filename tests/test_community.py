"""The seeded mock community (db/community.py) that every end-to-end test,
the dry run and chip_smoke.py read instead of bundled data."""
import numpy as np
import pytest

from savont_tpu.db import community as cm
from savont_tpu.io.fastx import read_fastx
from savont_tpu.ops.encode import revcomp_bytes


def test_same_seed_same_files(tmp_path):
    a = cm.write_community(tmp_path / "a", 300, seed=3)
    b = cm.write_community(tmp_path / "b", 300, seed=3)
    c = cm.write_community(tmp_path / "c", 300, seed=4)
    assert a.templates.read_bytes() == b.templates.read_bytes()
    assert a.reads.read_bytes() == b.reads.read_bytes()
    assert a.templates.read_bytes() != c.templates.read_bytes()
    assert a.reads.read_bytes() != c.reads.read_bytes()


def test_templates_share_an_ancestor():
    t = cm.make_templates(cm.DEFAULT_SEED)
    assert len(t) == cm.N_SPECIES + cm.N_SECOND_COPIES
    assert all(1400 <= len(x) <= 1600 for x in t)
    # second operon copies differ from their species by 2-4 SNPs only
    for sp, copy in zip(t, t[cm.N_SPECIES:]):
        assert len(sp) == len(copy) and 2 <= int((sp != copy).sum()) <= 4
    # species are related (common ancestor), not unrelated random sequences:
    # they share a good part of their 17-mers, where random ones share none
    def kmers(x):
        return {x[i : i + 17].tobytes() for i in range(len(x) - 16)}

    sets = [kmers(x) for x in t[: cm.N_SPECIES]]
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            assert len(sets[i] & sets[j]) / len(sets[i] | sets[j]) > 0.1


@pytest.mark.parametrize("seed", [cm.DEFAULT_SEED, 11])
def test_reads_look_like_ont(tmp_path, seed):
    c = cm.write_community(tmp_path, 400, seed=seed)
    templates = {r.id: r.seq for r in read_fastx(str(c.templates))}
    assert len(templates) == c.n_templates
    n_rc = 0
    quals = []
    for rec in read_fastx(str(c.reads)):
        tid = rec.id.split()[1]
        tmpl = templates[tid]
        seq = rec.seq
        # substitutions and deletions only: never longer than the template
        assert len(tmpl) - 40 <= len(seq) <= len(tmpl)
        fwd = np.frombuffer(seq, np.uint8)
        rc = np.frombuffer(revcomp_bytes(seq), np.uint8)
        head = np.frombuffer(tmpl[:40], np.uint8)
        if (rc[:40] == head).mean() > (fwd[:40] == head).mean():
            n_rc += 1
        q = np.frombuffer(rec.qual, np.uint8) - 33
        assert q.min() >= 3 and q.max() <= 40
        quals.append(q.mean())
    assert 0.35 < n_rc / 400 < 0.65  # about half reverse-complemented
    assert 24 < float(np.mean(quals)) < 30

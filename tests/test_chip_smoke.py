"""chip_smoke.py must refuse to run anywhere but on a GPU, and print no
result line when it does; its log-reading helpers are checked here too."""
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_fails_without_a_gpu():
    for args in ((), ("--four",)):
        r = _run(REPO, *args)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "not a GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_stage_clock_reads_the_pipeline_banners():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    clock = chip_smoke.StageClock()
    log = logging.getLogger("savont.test_chip_smoke")
    log.addHandler(clock)
    log.setLevel(logging.INFO)
    try:
        log.info("=== STAGE 1: k-mers and polymorphic markers ===")
        log.info("Stage 7 mesh EM cross-check: max |host - device| = 1.0e-09")
        log.info("=== STAGE 1.5: TwinRead construction ===")
        log.info("=== SAVONT-TPU COMPLETED in 2.0 s: 3 ASVs ===")
    finally:
        log.removeHandler(clock)
    assert [m for _, m in clock.marks] == [
        "STAGE 1: k-mers and polymorphic markers", "STAGE 1.5: TwinRead construction",
        "SAVONT-TPU COMPLETED in 2.0 s: 3 ASVs",
    ]
    clock.marks = [(t, m) for t, (_, m) in zip((10.0, 11.5, 12.0), clock.marks)]
    assert clock.stage_times(15.0) == {"stage_1": 1.5, "stage_1.5": 0.5}
    assert len(clock.messages) == 4
    assert json.dumps(clock.stage_times(15.0))

"""The compilation cache location (ops/jax_init.py) and the rule that no
savont_tpu import starts a JAX backend (jax.distributed.initialize has to
be able to run after the imports)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import json, sys
import jax
import savont_tpu.ops.align_jax, savont_tpu.ops.align_cuda, savont_tpu.ops.dp_parity
import savont_tpu.parallel.mesh, savont_tpu.ops.kmers_jax, savont_tpu.pipeline.asv
import savont_tpu.cli
from jax._src import xla_bridge
print(json.dumps({
    "backends": sorted(getattr(xla_bridge, "_backends", {}) or {}),
    "cache_dir": jax.config.jax_compilation_cache_dir,
}))
"""


def _probe(env_extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "platforms,cached",
    [(None, True), ("cuda", True), ("cuda,cpu", True), ("cpu", False)],
)
def test_imports_start_no_backend_and_cache_defaults_into_the_checkout(platforms, cached):
    """The default cache is the fixed <repo>/.jax_cache; a process pinned
    to the CPU keeps none.  No import starts a backend either way."""
    out = _probe({} if platforms is None else {"JAX_PLATFORMS": platforms})
    assert out["backends"] == []
    assert out["cache_dir"] == (str(REPO / ".jax_cache") if cached else None)


@pytest.mark.parametrize("platforms", [None, "cpu"])
def test_env_cache_dir_is_honoured(tmp_path, platforms):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    out = _probe(env)
    assert out["backends"] == []
    assert out["cache_dir"] == str(tmp_path / "cc")


def test_distributed_gives_each_process_its_own_card(monkeypatch):
    """Process i of a multi-process launch drives card i, unless the
    launcher picked the cards itself."""
    import jax

    from savont_tpu.parallel import distributed

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setenv("SAVONT_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("SAVONT_NUM_PROCESSES", "4")
    monkeypatch.setenv("SAVONT_PROCESS_ID", "2")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "local_devices", lambda: [])
    monkeypatch.setattr(jax, "devices", lambda: [])
    assert distributed.maybe_init_from_env()
    assert calls[-1]["local_device_ids"] == [2] and calls[-1]["process_id"] == 2

    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert distributed.maybe_init_from_env()
    assert calls[-1]["local_device_ids"] is None

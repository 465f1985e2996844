"""The CUDA banded Smith-Waterman forward (native/swalign_cuda.cu) as JAX ops.

The kernel is compiled with nvcc for sm_90a on first use into the git-ignored
<repo>/build/ and registered as XLA FFI targets for the CUDA platform.  Both
entry points trace like any JAX function, so they run inside jit and
shard_map, and return exactly what the plain-JAX reference in align_jax
returns on the same inputs:

    sw_forward_meta  == align_jax.sw_forward_meta(..., smooth=False)
    forward_payload  == align_jax._forward_payload(...)

One warp aligns one pair; the band lies across the warp's 32 lanes,
cells_per_lane(band) cells each, so bands up to MAX_BAND are supported.
There is no interpreter: off a GPU backend these functions raise.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "swalign_cuda.cu"
_LIB = _REPO / "build" / "libswalign_cuda.so"
_META_TARGET = "savont_sw_forward_meta"
_PAYLOAD_TARGET = "savont_sw_forward_payload"

MAX_BAND = 128
META_KEYS = ("score", "q_start", "t_start", "q_end", "t_end", "nm")


def cells_per_lane(band: int) -> int:
    """Band cells each of the warp's 32 lanes holds: the kernel is
    instantiated for 1, 2 and 4, so the band is padded up to 32, 64 or 128
    lanes' worth of cells (the padding cells are inert)."""
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"the CUDA DP kernel takes bands of 1..{MAX_BAND}, got {band}")
    return 1 if band <= 32 else 2 if band <= 64 else 4


def dp_kernel(band: int) -> str:
    """The device DP kernel for this process: "cuda" on a GPU backend when
    the band fits the kernel, else "xla" (the plain-JAX scan).

    SAVONT_DP_KERNEL=xla|cuda pins the choice, to time one against the
    other on the same card; "cuda" off a GPU raises instead of falling
    back."""
    pinned = os.environ.get("SAVONT_DP_KERNEL")
    if pinned == "cuda":
        _require_gpu()
        cells_per_lane(band)
        return "cuda"
    if pinned == "xla":
        return "xla"
    if pinned:
        raise ValueError(f"SAVONT_DP_KERNEL must be 'cuda' or 'xla', got {pinned!r}")
    return "cuda" if jax.default_backend() == "gpu" and band <= MAX_BAND else "xla"


def _require_gpu() -> None:
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the CUDA DP kernel runs only on a GPU backend "
            f"(this process runs on {jax.default_backend()!r}); "
            "the plain-JAX scan in align_jax serves every other platform"
        )


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA DP kernel needs the CUDA toolkit")
    return nvcc


def build() -> Path:
    """Compile native/swalign_cuda.cu into build/ unless the library is
    newer than the source.  Written under a per-process name, then renamed,
    so processes that build at once never load a half-written file."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _LIB.parent.mkdir(exist_ok=True)
    part = _LIB.with_name(f"{_LIB.name}.{os.getpid()}")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", str(part), str(_SRC),
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(part, _LIB)
    return _LIB


@functools.cache
def _registered() -> ctypes.CDLL:
    """Build, load and register the FFI targets once per process (the
    loaded library stays referenced for the life of the process)."""
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for target, symbol in ((_META_TARGET, "SwForwardMeta"), (_PAYLOAD_TARGET, "SwForwardPayload")):
        jax.ffi.register_ffi_target(target, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    return lib


def pack_operands(q, t, lo, tlens):
    """The kernel's operands: q (B, Lq), t (B, Lt), lo (B, Lq + 1) and
    tlens (B,), all int32 (codes compare as int32, as in the reference)."""
    B, Lq = q.shape
    if t.shape[0] != B or lo.shape != (B, Lq + 1) or tlens.shape != (B,):
        raise ValueError(
            f"expected q (B, Lq), t (B, Lt), lo (B, Lq + 1), tlens (B,); got "
            f"{q.shape}, {t.shape}, {lo.shape}, {tlens.shape}"
        )
    return tuple(jnp.asarray(a).astype(jnp.int32) for a in (q, t, lo, tlens))


def _attrs(band: int) -> dict:
    cells_per_lane(band)
    return {
        "band": np.int32(band), "match": np.int32(MATCH), "mismatch": np.int32(MISMATCH),
        "gap_open": np.int32(GAP_OPEN), "gap_ext": np.int32(GAP_EXT),
    }


def sw_forward_meta(q, t, lo, tlens, band: int) -> dict:
    """Forward DP with path metadata: dict of (B,) int32 arrays keyed
    META_KEYS, as align_jax.sw_forward_meta(smooth=False)."""
    _require_gpu()
    _registered()
    ops = pack_operands(q, t, lo, tlens)
    B = ops[0].shape[0]
    meta = jax.ffi.ffi_call(_META_TARGET, jax.ShapeDtypeStruct((6, B), jnp.int32))(
        *ops, **_attrs(band)
    )
    return {k: meta[i] for i, k in enumerate(META_KEYS)}


def forward_payload(q, t, lo, tlens, band: int):
    """Forward DP emitting the traceback decision bytes: (payload
    (B, Lq * band) uint8, score, ri, bj), as align_jax._forward_payload."""
    _require_gpu()
    _registered()
    ops = pack_operands(q, t, lo, tlens)
    B, Lq = ops[0].shape
    meta, payload = jax.ffi.ffi_call(
        _PAYLOAD_TARGET,
        (jax.ShapeDtypeStruct((3, B), jnp.int32), jax.ShapeDtypeStruct((B, Lq * band), jnp.uint8)),
    )(*ops, **_attrs(band))
    return payload, meta[0], meta[1], meta[2]

"""The CUDA DP kernel's wrapper (ops/align_cuda.py): band-to-lane layout,
operand packing, kernel choice, and that asking for the kernel off a GPU
raises.  The kernel itself has no interpreter, so its parity with the XLA
scan is the `gpu`-marked test at the end (and phase 2 of chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from savont_tpu.ops import align_cuda, align_jax, dp_parity


@pytest.mark.parametrize(
    "band,cells", [(1, 1), (32, 1), (33, 2), (48, 2), (64, 2), (65, 4), (128, 4)]
)
def test_cells_per_lane_pads_the_band_to_the_warp(band, cells):
    assert align_cuda.cells_per_lane(band) == cells
    assert band <= 32 * cells  # one warp covers the band


@pytest.mark.parametrize("band", [0, 129, 256])
def test_cells_per_lane_rejects_bands_the_kernel_lacks(band):
    with pytest.raises(ValueError):
        align_cuda.cells_per_lane(band)


def test_kernel_choice_off_gpu(monkeypatch):
    assert jax.default_backend() != "gpu"
    monkeypatch.delenv("SAVONT_DP_KERNEL", raising=False)
    assert align_cuda.dp_kernel(48) == "xla"
    assert align_cuda.dp_kernel(256) == "xla"
    monkeypatch.setenv("SAVONT_DP_KERNEL", "xla")
    assert align_cuda.dp_kernel(48) == "xla"
    monkeypatch.setenv("SAVONT_DP_KERNEL", "cuda")
    with pytest.raises(RuntimeError, match="GPU"):
        align_cuda.dp_kernel(48)
    monkeypatch.setenv("SAVONT_DP_KERNEL", "pallas")
    with pytest.raises(ValueError):
        align_cuda.dp_kernel(48)


@pytest.mark.parametrize("entry", ["sw_forward_meta", "forward_payload"])
def test_cuda_entry_points_raise_off_gpu(entry):
    q, t, lo, tlens = dp_parity.random_pairs(2, 40, 16, seed=1)
    with pytest.raises(RuntimeError, match="GPU"):
        getattr(align_cuda, entry)(q, t, lo, tlens, 16)
    with pytest.raises(RuntimeError, match="GPU"):
        getattr(align_jax, entry.replace("sw_", ""))(q, t, lo, tlens, 16, "cuda")


def test_pack_operands_shapes_and_dtypes():
    q, t, lo, tlens = dp_parity.random_pairs(3, 50, 16, seed=2)
    packed = align_cuda.pack_operands(q.astype(np.int8), t.astype(np.int16), lo, tlens)
    assert [a.dtype for a in packed] == [jnp.int32] * 4
    assert [a.shape for a in packed] == [q.shape, t.shape, lo.shape, tlens.shape]
    assert np.array_equal(np.asarray(packed[0]), q)
    with pytest.raises(ValueError):
        align_cuda.pack_operands(q, t, lo[:, :-1], tlens)
    with pytest.raises(ValueError):
        align_cuda.pack_operands(q, t[:2], lo, tlens)


def test_random_pairs_are_planner_shaped():
    B, Lq, band = 8, 200, 48
    q, t, lo, tlens = dp_parity.random_pairs(B, Lq, band, seed=3)
    assert q.shape == (B, Lq) and lo.shape == (B, Lq + 1) and t.shape[0] == B
    assert (np.diff(lo, axis=1) >= 0).all() and (lo[:, 0] == lo[:, 1]).all()
    assert (lo.max(axis=1) <= np.maximum(tlens - band, 0)).all()
    assert (np.diff(lo, axis=1) > 1).any()  # band jumps are present


@pytest.mark.parametrize("band", [16, 48])
def test_xla_kernel_choice_matches_numpy_dp(band):
    """The "xla" choice of forward_meta is the reference the CUDA kernel is
    held to; it must agree with the NumPy DP on the compared fields."""
    q, t, lo, tlens = dp_parity.random_pairs(6, 120, band, seed=band)
    out = align_jax.forward_meta(*(jnp.asarray(a) for a in (q, t, lo, tlens)), band, "xla")
    got = np.stack([np.asarray(out[k]) for k in dp_parity.NUMPY_KEYS], axis=1)
    got = np.where(got[:, :1] > 0, got, 0)
    assert np.array_equal(got, dp_parity.numpy_reference(q, t, lo, tlens, band))


@pytest.mark.gpu
@pytest.mark.parametrize("B,Lq,band", [(64, 300, 48), (32, 600, 128), (16, 200, 20)])
def test_cuda_kernel_matches_xla_scan(B, Lq, band):
    if jax.default_backend() != "gpu":
        pytest.skip("the CUDA kernel needs a GPU; chip_smoke.py runs this check on the card")
    q, t, lo, tlens = dp_parity.random_pairs(B, Lq, band, seed=B)
    r = dp_parity.compare(q, t, lo, tlens, band, n_numpy=8)
    assert r["meta_mismatch"] == r["payload_mismatch"] == r["numpy_mismatch"] == 0, r

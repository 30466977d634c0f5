"""Port: the voxel -> point readout (`csn_tpu_torch.core.interp`) against the
JAX package's `interpolate_to_points` / `nearest_voxel_to_points` on a real
batch (39 classes, the extraction chain's 256 channels and an odd width of
13), `InterpFn`'s backward (its plain version on the CPU) against `jax.vjp`
of `interpolate_to_points`, the CSR table of the backward kernel against a
brute-force scan of the corner table, the launchers' refusal of CPU
tensors, strided views, misaligned corner tables and tables past 32-bit
indices, and the body (wide rows in 16-byte pieces, or scalars) the
wrappers pick for the kernels. Tolerance: max abs <= 1e-5 * max|ref| (f32 on both
sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from csn_tpu.core import interp as jinterp
from csn_tpu_torch import kernels
from csn_tpu_torch.core import interp, interp_window
from csn_tpu_torch.core.pyramid import concat_batches, interp_csr, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.models import load_model

torch.set_num_threads(1)


# "<batch>[-<width>]": one batch or two concatenated, at 39 classes unless
# a width is named
@pytest.fixture(scope="module",
                params=["single", "concat", "single-256", "concat-13"])
def case(request):
    kind, _, width = request.param.partition("-")
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=400, voxel_size=0.15,
        conv1_kernel_size=3, shrink=1.5)
    rng = np.random.default_rng(2)
    parts = [to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2)]
    batch = parts[0] if kind == "single" else concat_batches(parts)
    B, L0 = batch.masks[0].shape
    feats = rng.normal(size=(B, L0, int(width or 39))).astype(np.float32)
    return batch, feats


def _ref(batch, feats):
    return np.asarray(jinterp.interpolate_to_points(
        jnp.asarray(feats), jnp.asarray(batch.interp_idx.numpy()),
        jnp.asarray(batch.interp_w.numpy())))


def _close(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_interpolate_to_points_matches_jax(case):
    batch, feats = case
    got = interp.interpolate_to_points(torch.from_numpy(feats),
                                       batch.interp_idx, batch.interp_w)
    _close(got.numpy(), _ref(batch, feats))


def test_interp_batch_matches_jax(case):
    batch, feats = case
    got = interp.interp_batch(torch.from_numpy(feats), batch)
    _close(got.numpy(), _ref(batch, feats))
    assert kernels.LAUNCHES["interp_fwd"] == 0


def test_nearest_voxel_to_points_matches_jax(case):
    batch, feats = case
    ref = np.asarray(jinterp.nearest_voxel_to_points(
        jnp.asarray(feats), jnp.asarray(batch.point_to_voxel.numpy())))
    got = interp.nearest_voxel_to_points(torch.from_numpy(feats),
                                         batch.point_to_voxel).numpy()
    np.testing.assert_array_equal(got, ref)


def test_k3_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        interp_window.interp_fwd(torch.zeros(4, 3),
                                 torch.zeros(5, 8, dtype=torch.int32),
                                 torch.zeros(5, 8))


def test_interp_backward_matches_jax_vjp(case):
    batch, feats = case
    rng = np.random.default_rng(5)
    g = rng.normal(size=batch.interp_w.shape[:2] + (feats.shape[-1],)
                   ).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jinterp.interpolate_to_points(
        f, jnp.asarray(batch.interp_idx.numpy()),
        jnp.asarray(batch.interp_w.numpy())), jnp.asarray(feats))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    vox = torch.from_numpy(feats).requires_grad_(True)
    interp.interp_batch(vox, batch).backward(torch.from_numpy(g))
    _close(vox.grad.numpy(), ref)
    assert kernels.LAUNCHES["interp_bwd"] == 0


def test_interp_csr_matches_brute_force_scan(case):
    batch, _ = case
    idx = batch.interp_idx.numpy()
    n_vox = batch.masks[0].numel()
    ptr, ent = interp_csr(idx, n_vox)
    if batch.interp_ptr is not None:      # to_torch built the same table
        np.testing.assert_array_equal(batch.interp_ptr.numpy(), ptr)
        np.testing.assert_array_equal(batch.interp_ent.numpy(), ent)
    else:                                 # concat_batches drops it
        assert batch.interp_ent is None
    flat = idx.reshape(-1)
    assert ptr[0] == 0 and ptr[-1] == ent.size == (flat < n_vox).sum()
    for v in range(0, n_vox, 7):
        want = [e for e in range(flat.size) if flat[e] == v]
        assert ent[ptr[v]:ptr[v + 1]].tolist() == want


def test_interp_bwd_plain_sums_duplicates():
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    idx = torch.tensor([[0, 0, 1, 3, 3, 3, 3, 3],
                        [1, 3, 3, 3, 3, 3, 3, 3]], dtype=torch.int32)
    w = torch.full((2, 8), 0.5)
    d = interp.interp_bwd_plain(g, idx, w, 3)
    np.testing.assert_allclose(d.numpy(), [[1.0, 2.0], [2.0, 3.0],
                                           [0.0, 0.0]])


def test_k3_bwd_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        interp_window.interp_bwd(torch.zeros(5, 3),
                                 torch.zeros(5, dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(5, 8))


def test_interp_launchers_refuse_strided_views():
    """The kernels read and write whole rows at a stride of C: a strided
    view is refused before the device check."""
    flat = torch.zeros(6, 4)
    idx = torch.zeros(5, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        interp_window.interp_fwd(flat[:, :3], idx, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="contiguous"):
        interp_window.interp_bwd(torch.zeros(3, 5).t(),
                                 torch.zeros(7, dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(5, 8))


class _Launcher:
    """Stands in for the kernel library: records each launcher's arguments
    and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.fixture
def launcher(monkeypatch):
    """The wrappers on meta tensors: the CUDA-device check passes, the
    launch is recorded, the counts are a copy."""
    lib = _Launcher()
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    return lib


def _meta(*shape, dtype=torch.float32, shift=0):
    """A contiguous meta view of `shape` that starts `shift` elements into
    its storage: off a 16-byte boundary iff `shift`."""
    n = int(np.prod(shape))
    t = torch.empty(n + shift, dtype=dtype, device="meta")[shift:].view(*shape)
    assert t.is_contiguous() and bool(t.data_ptr() % 16) == bool(shift)
    return t


# (type, width, shift of the row tensor) -> channels per piece: the wide
# bodies (16 bytes) where a row is 32 to 64 pieces of 16 bytes and starts
# on a 16-byte boundary, else the scalar bodies (1)
@pytest.mark.parametrize("dtype,c,shift,vec", [
    (torch.float32, 39, 0, 1),
    (torch.bfloat16, 39, 0, 1),
    (torch.float32, 256, 0, 4),
    (torch.bfloat16, 256, 0, 8),
    (torch.float32, 256, 1, 1),
    (torch.bfloat16, 256, 4, 1),
    (torch.float32, 24, 0, 1),
    (torch.float32, 128, 0, 4),
    (torch.bfloat16, 128, 0, 1),
    (torch.bfloat16, 512, 0, 8),
    (torch.float32, 1024, 0, 1),
])
def test_interp_launchers_pick_the_row_form(launcher, dtype, c, shift, vec):
    n_vox, n_pts = 10, 6
    idx = _meta(n_pts, 8, dtype=torch.int32)
    w = _meta(n_pts, 8)
    out = interp_window.interp_fwd(_meta(n_vox, c, dtype=dtype, shift=shift),
                                   idx, w)
    assert out.shape == (n_pts, c) and out.dtype == dtype
    dflat = interp_window.interp_bwd(
        _meta(n_pts, c, dtype=dtype, shift=shift),
        _meta(n_vox + 1, dtype=torch.int32), _meta(20, dtype=torch.int32), w)
    assert dflat.shape == (n_vox, c) and dflat.dtype == dtype
    fwd, bwd = (launcher.calls[f"csn_interp_{d}"] for d in ("fwd", "bwd"))
    assert fwd[5:8] == (n_vox, n_pts, c) and bwd[6:8] == (n_vox, c)
    assert (fwd[8], bwd[8]) == (vec, vec)
    assert kernels.LAUNCHES["interp_fwd"] == kernels.LAUNCHES["interp_bwd"]


@pytest.mark.parametrize("n_vox,n_pts,c", [
    (2 ** 31 // 39 + 1, 10, 39),     # the voxel table
    (10, 2 ** 31 // 39 + 1, 39),     # the point rows
    (10, 2 ** 28, 1),                # the corner table
])
def test_interp_launchers_refuse_tables_past_32_bits(launcher, n_vox, n_pts,
                                                     c):
    w = _meta(n_pts, 8)
    with pytest.raises(ValueError, match="2\\^31"):
        interp_window.interp_fwd(_meta(n_vox, c),
                                 _meta(n_pts, 8, dtype=torch.int32), w)
    with pytest.raises(ValueError, match="2\\^31"):
        interp_window.interp_bwd(_meta(n_pts, c),
                                 _meta(n_vox + 1, dtype=torch.int32),
                                 _meta(8, dtype=torch.int32), w)
    assert not launcher.calls


def test_k3_refuses_misaligned_corner_tables(launcher):
    """K3 reads each point's 8 indices and 8 weights 16 bytes at a time:
    a corner table that does not start on a 16-byte boundary is refused
    before the launch; aligned ones, and a misaligned feature table (the
    scalar body reads it element by element), reach the launcher."""
    n_pts = 6
    flat = _meta(10, 39)
    for i_shift, w_shift in ((1, 0), (0, 2), (3, 3)):
        with pytest.raises(ValueError, match="16-byte"):
            interp_window.interp_fwd(
                flat, _meta(n_pts, 8, dtype=torch.int32, shift=i_shift),
                _meta(n_pts, 8, shift=w_shift))
    assert not launcher.calls
    interp_window.interp_fwd(_meta(10, 39, shift=1),
                             _meta(n_pts, 8, dtype=torch.int32),
                             _meta(n_pts, 8))
    assert launcher.calls["csn_interp_fwd"][8] == 1

"""Port: the voxel -> point readout (`csn_tpu_torch.core.interp`) against the
JAX package's `interpolate_to_points` / `nearest_voxel_to_points` on a real
batch, `InterpFn`'s backward (its plain version on the CPU) against
`jax.vjp` of `interpolate_to_points`, the CSR table of the backward kernel
against a brute-force scan of the corner table, and the launchers' refusal
of CPU tensors. Tolerance: max abs <= 1e-5 * max|ref| (f32 on both sides)."""

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


@pytest.fixture(scope="module", params=["single", "concat"])
def case(request):
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=400, voxel_size=0.15,
        conv1_kernel_size=3, shrink=1.5)
    rng = np.random.default_rng(2)
    parts = [to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2)]
    batch = parts[0] if request.param == "single" else concat_batches(parts)
    B, L0 = batch.masks[0].shape
    feats = rng.normal(size=(B, L0, 39)).astype(np.float32)
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

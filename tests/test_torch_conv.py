"""Port: the plain sparse conv (`csn_tpu_torch.core.conv`) against the JAX
package's `_conv_impl` on a real built and concatenated batch, and the K1
launcher's refusal of CPU tensors. Tolerance: max abs <= 1e-5 * max|ref|
(f32 on both sides; the two sum the offsets in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from csn_tpu.core.conv import _conv_impl
from csn_tpu_torch import kernels
from csn_tpu_torch.core import conv, window_conv
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.host import pipeline
from csn_tpu_torch.models import load_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def big():
    """2 + 2 shapes of HRNetSimCSN3S's pyramid with the protocol's k5 stem,
    concatenated as in the combined pass."""
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=400, voxel_size=0.15,
        conv1_kernel_size=5, shrink=1.5)
    rng = np.random.default_rng(1)
    return concat_batches([to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2)])


@pytest.mark.parametrize("map_name,cin,cout", [
    ("same0k5", 3, 32), ("same0k3", 32, 64), ("same1k3", 64, 64),
    ("down0k3", 32, 64), ("up0k3", 64, 32)])
def test_sparse_conv_matches_jax(big, map_name, cin, cout):
    kmap = big.kmaps[map_name]
    src_l, _ = map_levels(map_name)
    n_in = big.masks[src_l].numel()
    rng = np.random.default_rng(sum(map_name.encode()))
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(kmap.shape[0], cin, cout)) / np.sqrt(cin)
         ).astype(np.float32)
    ref = np.asarray(_conv_impl(jnp.asarray(feats), jnp.asarray(kmap.numpy()),
                                jnp.asarray(w)))
    got = conv.sparse_conv(torch.from_numpy(feats), kmap,
                           torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape == (kmap.shape[1], cout)
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    assert kernels.LAUNCHES["sparse_conv_fwd"] == 0


def test_gather_rows_fills_sentinel_with_zeros():
    feats = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[3, 4], [0, 9]], dtype=torch.int32)
    out = conv.gather_rows(feats, idx)
    np.testing.assert_array_equal(out[0, 0].numpy(), [9, 10, 11])
    assert not out[0, 1].any() and not out[1, 1].any()
    np.testing.assert_array_equal(out[1, 0].numpy(), [0, 1, 2])


def test_k1_launcher_refuses_cpu_tensors():
    feats = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_fwd(feats, torch.zeros(27, 4, dtype=torch.int32),
                                    torch.zeros(27, 3, 8))

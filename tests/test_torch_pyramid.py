"""Port: device batches (`csn_tpu_torch.core.pyramid`) against the JAX
package's `to_jax(compact=False)` + `concat_jax_batches`, and the port
running in a process where JAX cannot be imported."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

import bench
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.host import pipeline
from csn_tpu_torch.models import load_model

torch.set_num_threads(1)

P, VOXEL, SHRINK = 400, 0.15, 1.5


def _host_batches(n, B=2, conv1_kernel_size=5, seed=0):
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=P, voxel_size=VOXEL,
        conv1_kernel_size=conv1_kernel_size, shrink=SHRINK)
    rng = np.random.default_rng(seed)
    return [pipeline.collate_shapes(
        [bench.make_surface_shape(rng, P) for _ in range(B)], spec, rng=rng)
        for _ in range(n)]


def test_to_torch_keeps_host_tables():
    vb, = _host_batches(1)
    tb = to_torch(vb, "cpu")
    assert set(tb.kmaps) == set(vb.kmaps)
    for name, t in tb.kmaps.items():
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), vb.kmaps[name])
    np.testing.assert_array_equal(tb.interp_idx.numpy(), vb.interp_idx)
    np.testing.assert_array_equal(tb.interp_w.numpy(), vb.interp_w)
    np.testing.assert_array_equal(tb.vox_feats.numpy(), vb.vox_feats)
    for lvl, m in enumerate(tb.masks):
        np.testing.assert_array_equal(m.numpy(), vb.masks[lvl])


def test_concat_matches_concat_jax_batches():
    from csn_tpu.core.pyramid import concat_jax_batches

    host = _host_batches(2)
    ref = concat_jax_batches([b.to_jax(compact=False) for b in host])
    got = concat_batches([to_torch(b, "cpu") for b in host])
    assert set(got.kmaps) == set(ref.kmaps)
    for name in ref.kmaps:
        np.testing.assert_array_equal(got.kmaps[name].numpy(),
                                      np.asarray(ref.kmaps[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(got.point_to_voxel.numpy(),
                                  np.asarray(ref.point_to_voxel))
    np.testing.assert_array_equal(got.interp_idx.numpy(),
                                  np.asarray(ref.interp_idx))
    np.testing.assert_array_equal(got.interp_w.numpy(),
                                  np.asarray(ref.interp_w))
    np.testing.assert_array_equal(got.point_mask.numpy(),
                                  np.asarray(ref.point_mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    for lvl in range(len(ref.masks)):
        np.testing.assert_array_equal(got.masks[lvl].numpy(),
                                      np.asarray(ref.masks[lvl]))


def test_concat_sentinels_become_combined_sentinels():
    host = _host_batches(2)
    parts = [to_torch(b, "cpu") for b in host]
    got = concat_batches(parts)
    total = sum(b.masks[0].shape[0] for b in host)
    caps = [m.shape[1] for m in host[0].masks]
    for name, t in got.kmaps.items():
        cap = caps[map_levels(name)[0]]
        n_sent = sum(int((p.kmaps[name] >= p.batch_size * cap).sum())
                     for p in parts)
        assert n_sent > 0, name
        assert int((t == total * cap).sum()) == n_sent, name
        assert int(t.min()) >= 0 and int(t.max()) == total * cap, name


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "h5py"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch

    import bench
    from csn_tpu_torch.core.pyramid import to_torch
    from csn_tpu_torch.host import pipeline, pyramid
    from csn_tpu_torch.models import load_model
    from csn_tpu_torch.train.steps import eval_step

    torch.set_num_threads(1)
    assert pyramid.JaxVoxelBatch is None
    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=200, voxel_size=0.15, conv1_kernel_size=3,
        shrink=1.5)
    rng = np.random.default_rng(0)
    qb, kb = (to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 200) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2))
    model = cls(out_channels=5, conv1_kernel_size=3, d_model=32, n_head=2,
                k_neighbors=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    loss, logits, pred = eval_step(model, qb, (kb,))
    assert torch.isfinite(loss) and logits.shape == (2, 200, 5)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("NO_JAX_OK", float(loss))
""")


def test_port_runs_where_jax_cannot_be_imported():
    res = subprocess.run([sys.executable, "-c", _NO_JAX],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout

"""Port: the batch construction (`csn_tpu_torch.core.pyramid`, its own copy
of the JAX package's, through the C++ engine and in numpy) bit-equal to the
JAX package's; device batches against the JAX package's `to_jax(compact=False)`
+ `concat_jax_batches`, and `to_torch`'s default against `to_jax()`'s f16
float tables; and the port running in a process where neither JAX nor the
JAX package can be imported."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from csn_tpu.core import native as j_native
from csn_tpu.core import pyramid as j_pyramid
from csn_tpu.data import pipeline as j_pipeline
from csn_tpu_torch.core import native, pyramid
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.data.synthetic import make_surface_shape
from csn_tpu_torch.models import load_model

torch.set_num_threads(1)

P, VOXEL, SHRINK = 400, 0.15, 1.5


def _host_batches(n, B=2, conv1_kernel_size=5, seed=0, pipe=pipeline):
    """n batches of B seeded shapes from `pipe`: the port's pipeline, or
    the JAX package's on the same seed."""
    spec = pipe.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=P, voxel_size=VOXEL,
        conv1_kernel_size=conv1_kernel_size, shrink=SHRINK)
    rng = np.random.default_rng(seed)
    return [pipe.collate_shapes(
        [bench.make_surface_shape(rng, P) for _ in range(B)], spec, rng=rng)
        for _ in range(n)]


def _assert_batches_bit_equal(got, ref):
    """Every table of the VoxelBatch: same dtype, same bits."""
    for f in ("points", "point_feats", "labels", "point_mask", "vox_feats",
              "interp_idx", "interp_w", "point_to_voxel"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("coords", "masks", "num_voxels"):
        assert len(getattr(got, f)) == len(getattr(ref, f))
        for lvl, (a, b) in enumerate(zip(getattr(got, f), getattr(ref, f))):
            assert a.dtype == b.dtype, (f, lvl)
            np.testing.assert_array_equal(a, b, err_msg=f"{f}[{lvl}]")
    assert got.dropped == ref.dropped
    assert list(got.kmaps) == list(ref.kmaps)
    for name in ref.kmaps:
        assert got.kmaps[name].dtype == ref.kmaps[name].dtype
        np.testing.assert_array_equal(got.kmaps[name], ref.kmaps[name],
                                      err_msg=name)


@pytest.mark.parametrize("sort_points", [False, True])
@pytest.mark.parametrize("qmode", ["RANDOM_SUBSAMPLE", "UNWEIGHTED_AVERAGE"])
@pytest.mark.parametrize("use_native", [True, False])
def test_batch_tables_bit_equal_to_jax_package(use_native, qmode, sort_points):
    """The port's own `build_voxel_batch` against the JAX package's, both
    through their own C++ engine (use_native) and both in numpy, on the same
    shapes and the same generator: bit-equal in every table."""
    if use_native:
        assert native.available() and j_native.available()
    cls = load_model("HRNetSimCSN3S")
    kw = dict(num_points=P, voxel_size=VOXEL, conv1_kernel_size=5,
              shrink=SHRINK, sort_points=sort_points)
    spec = pipeline.pyramid_spec_for_model(
        cls, qmode=pyramid.QMode[qmode], **kw)
    j_spec = j_pipeline.pyramid_spec_for_model(
        cls, qmode=j_pyramid.QMode[qmode], **kw)
    assert spec.level_caps == j_spec.level_caps
    assert spec.map_names() == j_spec.map_names()
    rng = np.random.default_rng(5)
    shapes = [bench.make_surface_shape(rng, n) for n in (P, P - 57, 3)]
    got = pyramid.build_voxel_batch(shapes, spec,
                                    rng=np.random.default_rng(1),
                                    use_native=use_native)
    ref = j_pyramid.build_voxel_batch(shapes, j_spec,
                                      rng=np.random.default_rng(1),
                                      use_native=use_native)
    _assert_batches_bit_equal(got, ref)
    assert sum(got.dropped) > 0 or got.masks[0].sum() > 0


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name,levels", [
    ("Res16UNet34C", 5), ("ResUNet14", 4), ("ResNet14", 6)])
def test_deep_pyramids_bit_equal_to_jax_package(name, levels, use_native):
    """The 5- and 6-level pyramids of the U-Net and ResNet families, with
    their k2 (8 offsets) and k1 (1 offset) down / up maps."""
    from csn_tpu.models import load_model as j_load_model

    kw = dict(num_points=P, voxel_size=0.08, conv1_kernel_size=5,
              shrink=SHRINK)
    spec = pipeline.pyramid_spec_for_model(load_model(name), **kw)
    j_spec = j_pipeline.pyramid_spec_for_model(j_load_model(name), **kw)
    assert spec.num_levels == levels
    assert spec.level_caps == j_spec.level_caps
    assert spec.map_names() == j_spec.map_names()
    rng = np.random.default_rng(9)
    shapes = [bench.make_surface_shape(rng, n) for n in (P, P - 31)]
    got = pyramid.build_voxel_batch(shapes, spec,
                                    rng=np.random.default_rng(2),
                                    use_native=use_native)
    ref = j_pyramid.build_voxel_batch(shapes, j_spec,
                                      rng=np.random.default_rng(2),
                                      use_native=use_native)
    _assert_batches_bit_equal(got, ref)
    offsets = {8: "k2", 1: "k1"}
    for n_off, tag in offsets.items():
        maps = [k for k in got.kmaps if k.endswith(tag)]
        assert all(got.kmaps[k].shape[0] == n_off for k in maps)
    assert any(k.endswith("k2") for k in got.kmaps)
    if name == "ResNet14":
        assert "down4k1" in got.kmaps and "up4k3" in got.kmaps
    # every level holds voxels, and every map points at some of them
    assert all(int(n.min()) > 0 for n in got.num_voxels)
    for k, t in got.kmaps.items():
        assert (t < got.masks[map_levels(k)[0]].size).any(), k
    tb = to_torch(got, "cpu")
    assert len(tb.masks) == levels
    assert tb.kmaps["down0k2"].dtype == torch.int32


def test_pipeline_batches_bit_equal_to_jax_package():
    for got, ref in zip(_host_batches(2, conv1_kernel_size=3),
                        _host_batches(2, conv1_kernel_size=3,
                                      pipe=j_pipeline)):
        _assert_batches_bit_equal(got, ref)


def test_port_owns_its_host_engine():
    """The port builds its own library from its own source into its own
    build directory, and never loads the JAX package's."""
    assert native.available()
    so = Path(native._SO)
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "csn_tpu_torch"
    assert Path(native._SRC).parent.parent.name == "csn_tpu_torch"
    assert "csn_window_jobs" not in Path(native._SRC).read_text()
    assert not hasattr(native._load(), "csn_encode_kmap16")
    assert str(so) != str(Path(j_native._SO))
    rng = np.random.default_rng(0)
    for a, b in zip(make_surface_shape(rng, 300),
                    bench.make_surface_shape(np.random.default_rng(0), 300)):
        np.testing.assert_array_equal(a, b)


def test_to_torch_keeps_host_tables():
    vb, = _host_batches(1)
    tb = to_torch(vb, "cpu", compact=False)
    assert set(tb.kmaps) == set(vb.kmaps)
    for name, t in tb.kmaps.items():
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), vb.kmaps[name])
    np.testing.assert_array_equal(tb.interp_idx.numpy(), vb.interp_idx)
    np.testing.assert_array_equal(tb.interp_w.numpy(), vb.interp_w)
    np.testing.assert_array_equal(tb.vox_feats.numpy(), vb.vox_feats)
    for lvl, m in enumerate(tb.masks):
        np.testing.assert_array_equal(m.numpy(), vb.masks[lvl])


def test_to_torch_compact_ships_the_float_tables_as_to_jax():
    """`compact` (the default, as `to_jax`'s): the voxel features and the
    interpolation weights are the JAX package's f16 wire values widened to
    f32, bit for bit; the index tables are unchanged."""
    vb, = _host_batches(1)
    jb, = _host_batches(1, pipe=j_pipeline)   # the same batch, JAX package
    ref = jb.to_jax()   # compact=True: f16 floats, int16-coded tables
    tb = to_torch(vb, "cpu")
    for f in ("vox_feats", "interp_w"):
        got, want = getattr(tb, f), np.asarray(getattr(ref, f))
        assert got.dtype == torch.float32 and want.dtype == np.float16, f
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32),
                                      err_msg=f)
        assert not np.array_equal(got.numpy(), getattr(vb, f)), f
    np.testing.assert_array_equal(tb.interp_idx.numpy(), vb.interp_idx)
    for name, t in tb.kmaps.items():
        np.testing.assert_array_equal(t.numpy(), vb.kmaps[name])


def test_concat_matches_concat_jax_batches():
    from csn_tpu.core.pyramid import concat_jax_batches

    host = _host_batches(2)
    ref = concat_jax_batches([b.to_jax(compact=False)
                              for b in _host_batches(2, pipe=j_pipeline)])
    got = concat_batches([to_torch(b, "cpu", compact=False) for b in host])
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

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "h5py", "csn_tpu", "bench"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch

    from csn_tpu_torch.core.pyramid import to_torch
    from csn_tpu_torch.data import pipeline
    from csn_tpu_torch.data.synthetic import make_surface_shape
    from csn_tpu_torch.midfc.training import MidfcConfig, MidfcRunner
    from csn_tpu_torch.models import load_model
    from csn_tpu_torch.train.steps import eval_step

    torch.set_num_threads(1)
    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=200, voxel_size=0.15, conv1_kernel_size=3,
        shrink=1.5)
    rng = np.random.default_rng(0)
    qb, kb = (to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, 200) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2))
    model = cls(out_channels=5, conv1_kernel_size=3, d_model=32, n_head=2,
                k_neighbors=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    loss, logits, pred = eval_step(model, qb, (kb,))
    assert torch.isfinite(loss) and logits.shape == (2, 200, 5)

    # a MID-FC CSA step: eval, grad, Adam
    cfg = MidfcConfig(num_classes=5, n_heads=2, K=2, batch_size=2,
                      d_model=16, chunk_size=20, num_points=40)
    runner = MidfcRunner(cfg, "csa", device="cpu")
    runner.initialize()
    feats = rng.normal(size=(2, 40, 16)).astype(np.float32)
    nbrs = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 40)).astype(np.int32)
    assert runner._eval(feats, nbrs).shape == (2, 40, 5)
    mf_loss, grads = runner._grad(feats, labels, nbrs, 0)
    runner._apply(grads)
    assert torch.isfinite(mf_loss) and float(mf_loss) > 0

    # a Res16UNet train step and a probe's plain path
    from csn_tpu_torch.probes import dyngather
    from csn_tpu_torch.train import optim
    from csn_tpu_torch.train.steps import train_step

    ucls = load_model("Res16UNet14")
    uspec = pipeline.pyramid_spec_for_model(
        ucls, num_points=200, voxel_size=0.15, conv1_kernel_size=3,
        shrink=1.5)
    ub = to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, 200) for _ in range(2)], uspec, rng=rng),
        "cpu")
    unet = ucls(out_channels=5, conv1_kernel_size=3)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    uopt = optim.make_optimizer(unet.parameters(), "SGD", lr=0.05)
    u_loss, u_pred = train_step(unet, uopt, ub, (), torch.Generator())
    assert torch.isfinite(u_loss) and u_pred.shape == (2, 200)
    win, rel, want = dyngather.probe_inputs()
    got = dyngather.window_gather(torch.from_numpy(win),
                                  torch.from_numpy(rel), 1)
    assert np.array_equal(got.numpy(), want)
    assert set(dyngather.time_modes(n_tiles=2, iters=1, device="cpu")) \
        == set(dyngather.MODES)

    # one trainer epoch on an in-memory collection (h5py is blocked too),
    # with the im2col form of the sparse conv
    import tempfile
    from csn_tpu_torch.config import Config
    from csn_tpu_torch.core import window_conv
    from csn_tpu_torch.data.synthetic import SurfaceShapeDataset
    from csn_tpu_torch.tasks.main_csn import build_trainer

    with tempfile.TemporaryDirectory() as log_dir, window_conv.dyng(2):
        # Bottle: 9 classes, above the synthetic shapes' labels 1..4
        tcfg = Config(model="HRNetSimCSN2S", partnet_category="Bottle",
                      batch_size=2, val_batch_size=2, test_batch_size=2,
                      conv1_kernel_size=3, d_model=16, n_head=2,
                      k_neighbors=1, max_epoch=1, num_points=64,
                      level_shrink=1.5, dataset="PartnetVoxelization0_2Dataset",
                      log_dir=log_dir, device="cpu").normalized()
        trainer = build_trainer(tcfg, datasets=(
            SurfaceShapeDataset(4, 64, 0), SurfaceShapeDataset(2, 64, 1)))
        val = trainer.train()
        assert trainer.curr_iter == 3 and all(np.isfinite(val)), val
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("NO_JAX_OK", float(loss), float(mf_loss), val[0])
""")


def test_port_runs_where_jax_cannot_be_imported():
    res = subprocess.run([sys.executable, "-c", _NO_JAX],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout

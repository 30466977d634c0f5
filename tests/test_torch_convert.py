"""Port: the MinkowskiEngine checkpoint loaders (`csn_tpu_torch/models/
convert.py`) and the ME reference conv (`models/me_reference.py`) against
the JAX package's, on synthetic state dicts in the released checkpoints' key
schema (the dict of `tests/test_mink_convert.py`, and the Res16UNet / ResUNet
schemas written out from the reference's module names).

The port's loaders must give exactly `flax_to_torch` of the JAX loaders'
trees (the same numbers, bit for bit), load into the port's models with
`strict=True`, and report the same unused keys. The ME reference conv must
equal the JAX package's copy exactly and the port's gather conv within
1e-4 (f32 against the reference's float64 loop).
"""

import numpy as np
import pytest
import torch

from csn_tpu.models import convert as j_convert
from csn_tpu.models import me_reference as j_me
from csn_tpu_torch.config import Config
from csn_tpu_torch.core.conv import sparse_conv
from csn_tpu_torch.core.pyramid import (
    MapSpec, PyramidSpec, QMode, build_voxel_batch,
)
from csn_tpu_torch.data.partnet import write_synthetic_partnet
from csn_tpu_torch.models import convert, load_model, me_reference
from csn_tpu_torch.models.blocks import Bottleneck
from csn_tpu_torch.models.convert import flax_to_torch
from tests.test_mink_convert import _mink_csn_sd

torch.set_num_threads(1)


def _assert_same_state(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("ksize", [1, 2, 3, 5])
@pytest.mark.parametrize("order", ["xyz", "zyx"])
def test_kernel_perm_matches_jax(ksize, order):
    np.testing.assert_array_equal(convert._kernel_perm(ksize, order),
                                  j_convert._kernel_perm(ksize, order))


@pytest.mark.parametrize("order", ["xyz", "zyx"])
def test_convert_mink_csn_matches_jax_and_loads(order):
    sd = _mink_csn_sd(np.random.default_rng(0))
    sd["optimizer.leftover"] = np.zeros(3, np.float32)
    got = convert.convert_mink_state_dict(
        sd, num_stages=2, num_blocks=3, csn_head=True, k_neighbors=1,
        offset_order=order)
    ref = flax_to_torch(*j_convert.convert_mink_state_dict(
        sd, num_stages=2, num_blocks=3, csn_head=True, k_neighbors=1,
        offset_order=order))
    _assert_same_state(got, ref)
    assert convert.convert_mink_state_dict.unused == ["optimizer.leftover"] \
        == j_convert.convert_mink_state_dict.unused
    model = load_model("HRNetSimCSN2S")(out_channels=5, conv1_kernel_size=3,
                                        d_model=16, n_head=2, k_neighbors=1)
    model.load_state_dict(got, strict=True)
    if order == "xyz":   # the rows really moved
        assert not torch.equal(
            got["conv1.kernel"], torch.from_numpy(sd["conv1s1.kernel"]))


def test_convert_mink_seg_head_and_missing_key():
    rng = np.random.default_rng(1)
    sd = _mink_csn_sd(rng, feat_factor=2)   # HRNetSeg2S: 32, 64, 128
    for k in [k for k in sd if k.split(".")[0] in
              ("fc_layer", "MHA", "output", "linear_q", "linear_k")]:
        del sd[k]
    arr = lambda *s: (rng.normal(size=s) * 0.02).astype(np.float32)
    sd["final.0.kernel"], sd["final.0.bias"] = arr(32 + 64 + 128, 16), \
        arr(1, 16)       # ME 0.5.x stores conv biases as [1, out]
    for n in ("weight", "bias", "running_mean", "running_var"):
        sd[f"final.1.bn.{n}"] = np.abs(arr(16))
    sd["final.3.kernel"], sd["final.3.bias"] = arr(16, 5), arr(1, 5)
    got = convert.convert_mink_state_dict(sd, 2, csn_head=False)
    ref = flax_to_torch(*j_convert.convert_mink_state_dict(
        sd, 2, csn_head=False))
    _assert_same_state(got, ref)
    assert got["fc2.linear.bias"].shape == (5,)
    load_model("HRNetSeg2S")(out_channels=5, conv1_kernel_size=3,
                             d_model=16).load_state_dict(got, strict=True)
    del sd["bn1s1.bn.weight"]
    with pytest.raises(KeyError, match="bn1s1.bn.weight"):
        convert.convert_mink_state_dict(sd, 2, csn_head=False)


def _unet_sd(rng, cls, family, k1=3, out_channels=5):
    """A synthetic reference state dict for a Res16UNet (`family` 16) or
    ResUNet (`family` 4) class, keys as the reference's modules name them
    (`models/res16unet.py`, `models/resunet.py`, `modules/resnet_block.py`),
    num_batches_tracked included as in a real dump."""
    sd = {}
    P, L, D = cls.PLANES, cls.LAYERS, cls.INIT_DIM
    bottleneck = issubclass(cls.BLOCK, Bottleneck)

    def arr(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.bn.weight"] = arr(c)
        sd[f"{name}.bn.bias"] = arr(c)
        sd[f"{name}.bn.running_mean"] = arr(c)
        sd[f"{name}.bn.running_var"] = np.abs(arr(c)) + 0.5
        sd[f"{name}.bn.num_batches_tracked"] = np.asarray(7)

    def stage(name, cin, planes, n):
        for b in range(n):
            base = f"{name}.{b}"
            c = cin if b == 0 else planes
            if bottleneck:
                mid = planes // 4
                sd[f"{base}.conv1.kernel"] = arr(c, mid)
                bn(f"{base}.norm1", mid)
                sd[f"{base}.conv2.kernel"] = arr(27, mid, mid)
                bn(f"{base}.norm2", mid)
                sd[f"{base}.conv3.kernel"] = arr(mid, planes)
                bn(f"{base}.norm3", planes)
            else:
                sd[f"{base}.conv1.kernel"] = arr(27, c, planes)
                bn(f"{base}.norm1", planes)
                sd[f"{base}.conv2.kernel"] = arr(27, planes, planes)
                bn(f"{base}.norm2", planes)
            if c != planes:
                sd[f"{base}.downsample.0.kernel"] = arr(c, planes)
                bn(f"{base}.downsample.1", planes)

    if family == 16:
        sd["conv0p1s1.kernel"] = arr(k1 ** 3, 3, D)
        bn("bn0", D)
        enc_in = (D,) + tuple(P[:3])
        for l in range(4):
            sd[f"conv{l + 1}p{2 ** l}s2.kernel"] = arr(8, enc_in[l],
                                                       enc_in[l])
            bn(f"bn{l + 1}", enc_in[l])
            stage(f"block{l + 1}", enc_in[l], P[l], L[l])
        up_in = (P[3],) + tuple(P[4:7])
        for s, name in enumerate(["convtr4p16s2", "convtr5p8s2",
                                  "convtr6p4s2", "convtr7p2s2"]):
            sd[f"{name}.kernel"] = arr(8, up_in[s], P[4 + s])
            bn(f"bntr{s + 4}", P[4 + s])
            stage(f"block{s + 5}", P[4 + s] + enc_in[3 - s], P[4 + s],
                  L[4 + s])
        sd["final.kernel"] = arr(P[7], out_channels)
        sd["final.bias"] = arr(1, out_channels)
        return sd
    sd["conv1p1s1.kernel"] = arr(k1 ** 3, 3, D)
    bn("bn1", D)
    stage("block1", D, P[0], L[0])
    for l in range(3):
        sd[f"conv{l + 2}p{2 ** l}s2.kernel"] = arr(8, P[l], P[l])
        bn(f"bn{l + 2}", P[l])
        stage(f"block{l + 2}", P[l], P[l + 1], L[l + 1])
    up_in = (P[3], P[4], P[5])
    for s, name in enumerate(["convtr4p8s2", "convtr5p4s2", "convtr6p2s2"]):
        sd[f"{name}.kernel"] = arr(8, up_in[s], P[4 + s])
        bn(f"bntr{s + 4}", P[4 + s])
        if s < 2:
            stage(f"block{s + 5}", P[4 + s] + P[2 - s], P[4 + s], L[4 + s])
    sd["final.0.kernel"] = arr(P[6] + P[0], 512)
    sd["final.0.bias"] = arr(1, 512)
    bn("final.1", 512)
    sd["final.3.kernel"] = arr(512, out_channels)
    sd["final.3.bias"] = arr(1, out_channels)
    return sd


@pytest.mark.parametrize("name,family,order", [
    ("Res16UNet14", 16, "xyz"), ("Res16UNet34C", 16, "zyx"),
    ("Res16UNet50", 16, "xyz"), ("ResUNet14", 4, "xyz"),
    ("ResUNet18", 4, "zyx"), ("ResUNet50", 4, "xyz")])
def test_convert_unets_match_jax_and_load(name, family, order):
    cls = load_model(name)
    sd = _unet_sd(np.random.default_rng(2), cls, family)
    sd["extra.key"] = np.zeros(2, np.float32)
    fn, j_fn = ((convert.convert_res16unet_state_dict,
                 j_convert.convert_res16unet_state_dict) if family == 16 else
                (convert.convert_resunet_state_dict,
                 j_convert.convert_resunet_state_dict))
    got = fn(sd, offset_order=order)
    ref = flax_to_torch(*j_fn(sd, offset_order=order))
    _assert_same_state(got, ref)
    assert fn.unused == ["extra.key"] == j_fn.unused
    model = cls(out_channels=5, conv1_kernel_size=3)
    model.load_state_dict(got, strict=True)
    # k2 kernels: 8 rows permuted between the two offset orders
    perm = convert._kernel_perm(2, order)
    assert torch.equal(got["down_convs.0.kernel"], torch.from_numpy(
        sd["conv1p1s2.kernel" if family == 16 else "conv2p1s2.kernel"][perm]))


def test_trainer_loads_reference_pth_weights(tmp_path):
    """`--weights <file>.pth` goes through the port's converter (the
    released-model eval path)."""
    from csn_tpu_torch.tasks.main_csn import build_trainer

    sd = _mink_csn_sd(np.random.default_rng(1), out_channels=4)
    pth = str(tmp_path / "weights.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, pth)
    root = str(tmp_path / "pn")
    write_synthetic_partnet(root, category="Display", n_train=2, n_val=2,
                            n_test=2, num_points=48)
    cfg = Config(
        model="HRNetSimCSN2S", partnet_path=root, partnet_category="Display",
        batch_size=2, conv1_kernel_size=3, d_model=16, n_head=2,
        k_neighbors=1, num_points=48, level_shrink=1.5, weights=pth,
        log_dir=str(tmp_path / "logs"), seed=0, device="cpu").normalized()
    trainer = build_trainer(cfg, phases=("train", "val"))
    trainer.initialize()
    state = trainer.model.state_dict()
    np.testing.assert_allclose(
        state["conv1.kernel"].numpy(),
        sd["conv1s1.kernel"][convert._kernel_perm(3, "xyz")], rtol=1e-6)
    np.testing.assert_allclose(state["norm0.mean"].numpy(),
                               sd["bn0s1.bn.running_mean"], rtol=1e-6)
    np.testing.assert_allclose(state["mha.w_qs.weight"].numpy(),
                               sd["MHA.w_qs.weight"], rtol=1e-6)
    # the bare-state-dict form of a .pth loads too
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pth)
    got = convert.load_mink_torch_checkpoint(pth, 2, k_neighbors=1)
    _assert_same_state(got, {k: v.cpu() for k, v in state.items()})


def _me_batch(n=500, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * rng.uniform(0.5, 1.0, size=(n, 1))).astype(np.float32)
    spec = PyramidSpec(voxel_size=0.12, num_points=n, level_caps=(640, 320),
                       maps=(MapSpec("same", 0, 3), MapSpec("same", 0, 5),
                             MapSpec("down", 0, 3), MapSpec("up", 0, 3),
                             MapSpec("down", 0, 2), MapSpec("up", 0, 2)),
                       qmode=QMode.UNWEIGHTED_AVERAGE)
    vb = build_voxel_batch(
        [(pts, rng.normal(size=(n, 4)).astype(np.float32),
          np.zeros(n, np.int32))], spec, use_native=False)
    assert vb.dropped == [0, 0]
    return vb, rng


@pytest.mark.parametrize("name,ksize,src,dst,transpose", [
    ("same0k3", 3, 0, 0, False), ("same0k5", 5, 0, 0, False),
    ("down0k3", 3, 0, 1, False), ("up0k3", 3, 1, 0, True),
    ("down0k2", 2, 0, 1, False), ("up0k2", 2, 1, 0, True)])
def test_me_sparse_conv_matches_jax_copy_and_the_ports_conv(
        name, ksize, src, dst, transpose):
    vb, rng = _me_batch()
    n_src, n_dst = (int(vb.num_voxels[l][0]) for l in (src, dst))
    c_src = vb.coords[src][0, :n_src].astype(np.int64)
    c_dst = vb.coords[dst][0, :n_dst].astype(np.int64)
    assert (c_src < 0).any(), "geometry must include negative coords"
    cin, cout = 4, 6
    feats = np.zeros((vb.masks[src].shape[1], cin), np.float32)
    feats[:n_src] = rng.normal(size=(n_src, cin)).astype(np.float32)
    km = rng.normal(size=(ksize ** 3, cin, cout)).astype(np.float32)
    np.testing.assert_array_equal(me_reference.me_offsets(ksize, 2),
                                  j_me.me_offsets(ksize, 2))
    ref = me_reference.me_sparse_conv(c_src, feats[:n_src], c_dst, km, ksize,
                                      1, transpose=transpose)
    np.testing.assert_array_equal(ref, j_me.me_sparse_conv(
        c_src, feats[:n_src], c_dst, km, ksize, 1, transpose=transpose))
    ours = torch.from_numpy(km[convert._kernel_perm(ksize, "xyz")])
    got = sparse_conv(torch.from_numpy(feats),
                      torch.from_numpy(vb.kmaps[name]), ours).numpy()[:n_dst]
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_conv_gradient_without_transpose_map_is_cpu_only():
    """Without `kmap_t` the CPU serves a gradient through plain autograd,
    equal to the gather backward's."""
    vb, rng = _me_batch(seed=3)
    kmap = torch.from_numpy(vb.kmaps["down0k3"])
    kmap_t = torch.from_numpy(vb.kmaps["up0k3"])
    res = []
    for kt in (None, kmap_t):
        g = torch.Generator().manual_seed(0)
        x = torch.randn(640, 4, generator=g, requires_grad=True)
        w = torch.randn(27, 4, 6, generator=g, requires_grad=True)
        out = sparse_conv(x, kmap, w, kt)
        (out * torch.randn(out.shape, generator=g)).sum().backward()
        res.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*res):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    meta = torch.zeros(3, 2, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="kmap_t"):
        sparse_conv(meta, torch.zeros(1, 3, dtype=torch.int32,
                                      device="meta"),
                    torch.zeros(1, 2, 2, device="meta"))

"""Port: the Res16UNet, ResUNet and ResNet families, their blocks, norms and
pools against the JAX package at a small size, with flax-initialized weights
carried over by `flax_to_torch`.

Small size: 2 shapes of 300 points at voxel 0.15, level caps shrinking by
1.5, k3 stem, 5 classes; the models keep their published widths and depths.
Norm scales, biases and running statistics are drawn at random so that the
folded eval BatchNorm and the converter's mapping of every norm are
exercised. The train-mode step is the forward on batch statistics, the loss
`mean(out * R)` for a fixed random R, and its backward; the port's step takes
the JAX step's masked-ReLU decisions (a gradient is only piecewise smooth,
and a ReLU input within rounding of zero may fall on either side).

Tolerances (f32 both sides, different summation orders): forward outputs
1e-5 x max|ref|; gradients 1e-4 x max|ref| per tensor; running statistics
1e-5 x max(|ref|, 1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import csn_tpu.models.blocks as j_blocks
import csn_tpu.models.res16unet as j_res16unet
import csn_tpu.models.resnet as j_resnet
import csn_tpu.models.resunet as j_resunet
import csn_tpu_torch.models.blocks as t_blocks
import csn_tpu_torch.models.res16unet as t_res16unet
import csn_tpu_torch.models.resnet as t_resnet
import csn_tpu_torch.models.resunet as t_resunet
from csn_tpu.data import pipeline as j_pipeline
from csn_tpu.models import MODELS as J_MODELS
from csn_tpu.models import layers as j_layers
from csn_tpu.models import load_model as j_load_model
from csn_tpu_torch import kernels
from csn_tpu_torch.config import Config
from csn_tpu_torch.core.pyramid import to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.models import MODELS, layers, load_model
from csn_tpu_torch.models.convert import flax_to_torch

torch.set_num_threads(1)

NAMES = ["Res16UNet14", "Res16UNet34C", "ResUNet14", "ResUNet18INBN",
         "ResNet14", "ResUNet50"]
J_RELU_MODULES = (j_blocks, j_res16unet, j_resunet, j_resnet)
T_RELU_MODULES = (t_blocks, t_res16unet, t_resunet, t_resnet)
KW = dict(out_channels=5, conv1_kernel_size=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_norms(tree, rng):
    """Random norm scale/bias (params) or mean/var (batch_stats)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_norms(v, rng)
        elif k in ("mean", "scale", "bias", "var") and v.ndim == 1:
            n = v.shape[0]
            if k == "var":
                out[k] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.7, 1.3, n).astype(np.float32)
            else:
                out[k] = (0.1 * rng.normal(size=n)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _batches(name):
    """One batch built twice from one seed, once by each package."""
    def build(pipe, cls):
        spec = pipe.pyramid_spec_for_model(
            cls, num_points=300, voxel_size=0.15, conv1_kernel_size=3,
            shrink=1.5)
        rng = np.random.default_rng(0)
        return pipe.collate_shapes(
            [bench.make_surface_shape(rng, 300) for _ in range(2)], spec,
            rng=rng)

    return (build(pipeline, load_model(name)),
            build(j_pipeline, j_load_model(name)).to_jax(compact=False))


class _Relus:
    """Records the JAX step's masked-ReLU decisions while it is traced and
    replays them in the port's step, counting the entries where the port's
    own input would have decided otherwise."""

    def __init__(self):
        self.traced, self.keeps = [], []
        self.flips = self.inputs = 0

    def record(self, x, mask):
        keep = mask[..., None] & (x > 0)
        self.traced.append(keep)
        return jnp.where(keep, x, 0.0)

    def replay(self, x, mask):
        keep = torch.from_numpy(self.keeps.pop(0))
        assert keep.shape == x.shape
        self.flips += int((keep != (mask[..., None] & (x > 0))).sum())
        self.inputs += int(mask.sum()) * x.shape[-1]
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype))


@functools.lru_cache(maxsize=None)
def _pair(name):
    th, jb = _batches(name)
    tb = to_torch(th, "cpu", compact=False)
    rng = np.random.default_rng(7)
    jm = j_load_model(name)(compute_dtype="float32", **KW)
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    params = _randomize_norms(_np(variables["params"]), rng)
    stats = _randomize_norms(_np(variables.get("batch_stats", {})), rng)

    tm = load_model(name)(**KW)
    tm.load_state_dict(flax_to_torch(params, stats), strict=True)

    j_eval = np.asarray(jax.jit(lambda p, s, b: jm.apply(
        {"params": p, "batch_stats": s}, b, train=False))(params, stats, jb))
    kernels.reset_launches()
    with torch.no_grad():
        t_eval = tm.eval()(tb).numpy()

    weight = rng.normal(size=j_eval.shape).astype(np.float32)
    relus = _Relus()

    @jax.jit
    def j_step(p, s, b):
        def loss_fn(p):
            relus.traced.clear()
            out, new_vars = jm.apply({"params": p, "batch_stats": s}, b,
                                     train=True, mutable=["batch_stats"])
            return (out * weight).mean(), (
                out, new_vars.get("batch_stats", {}), tuple(relus.traced))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, aux, grads

    with pytest.MonkeyPatch.context() as mp:
        for mod in J_RELU_MODULES:
            mp.setattr(mod, "relu_masked", relus.record)
        j_loss, (j_out, j_stats, keeps), j_grads = j_step(params, stats, jb)
    relus.traced.clear()
    relus.keeps = [np.array(k) for k in keeps]
    n_relus = len(relus.keeps)

    tm.train()
    with pytest.MonkeyPatch.context() as mp:
        for mod in T_RELU_MODULES:
            mp.setattr(mod, "relu_masked", relus.replay)
        t_out = tm(tb)
        (t_out * torch.from_numpy(weight)).mean().backward()
    assert not relus.keeps, "the two models ran different ReLUs"
    return dict(
        j_eval=j_eval, t_eval=t_eval, j_out=np.asarray(j_out),
        t_out=t_out.detach().numpy(), n_relus=n_relus,
        flips=(relus.flips, relus.inputs),
        j_grads=flax_to_torch(_np(j_grads), {}),
        t_grads={n: p.grad for n, p in tm.named_parameters()},
        j_stats=flax_to_torch({}, _np(j_stats)),
        t_state={n: t.detach().clone() for n, t in tm.state_dict().items()},
        launches=dict(kernels.LAUNCHES), mask=th.masks)


def test_registries_hold_the_same_names():
    assert sorted(MODELS) == sorted(J_MODELS)
    for name, cls in MODELS.items():
        j = J_MODELS[name]
        assert cls.num_levels() == j.num_levels(), name
        assert [m.name for m in cls.pyramid_requirements(5)] == \
            [m.name for m in j.pyramid_requirements(5)], name
        for attr in ("PLANES", "LAYERS", "INIT_DIM"):
            assert getattr(cls, attr, None) == getattr(j, attr, None), name
    assert MODELS["ResNet14"].output_level() == 5


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    r = _pair(name)
    assert r["t_eval"].shape == r["j_eval"].shape
    scale = np.abs(r["j_eval"]).max()
    assert scale > 1e-3
    assert np.abs(r["t_eval"] - r["j_eval"]).max() <= 1e-5 * scale
    assert not any(r["launches"].values())   # CPU tensors: plain versions


@pytest.mark.parametrize("name", NAMES)
def test_train_forward_matches_jax(name):
    r = _pair(name)
    scale = np.abs(r["j_out"]).max()
    assert np.abs(r["t_out"] - r["j_out"]).max() <= 1e-5 * scale
    flips, inputs = r["flips"]
    assert r["n_relus"] >= 9 and inputs > 10 ** 4
    assert flips <= 1e-4 * inputs, (flips, inputs)


@pytest.mark.parametrize("name", NAMES)
def test_train_gradients_match_jax(name):
    r = _pair(name)
    ref, got = r["j_grads"], r["t_grads"]
    assert set(ref) == set(got)
    top = max(float(g.abs().max()) for g in ref.values())
    assert top > 1e-6
    for n, g in ref.items():
        assert got[n] is not None, n
        scale = float(g.abs().max())
        err = float((got[n] - g).abs().max())
        # a bias or projection whose gradient vanishes analytically (it
        # feeds a train-mode norm) is held to the step's largest gradient
        tol = 1e-4 * (scale if scale > 1e-4 * top else top)
        assert err <= tol, (n, err, scale, top)


@pytest.mark.parametrize("name", NAMES)
def test_train_running_stats_match_jax(name):
    r = _pair(name)
    assert r["j_stats"]
    for n, s in r["j_stats"].items():
        err = float((r["t_state"][n] - s).abs().max())
        assert err <= 1e-5 * max(float(s.abs().max()), 1.0), (n, err)


def _norm_inputs(rng, c=6):
    x = rng.normal(size=(3, 17, c)).astype(np.float32) * 2.0 + 0.5
    mask = np.zeros((3, 17), dtype=bool)
    mask[0, :17], mask[1, :9], mask[2, :1] = True, True, True
    return x, mask


@pytest.mark.parametrize("norm_type", list(j_layers.NormType),
                         ids=lambda t: t.name)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_norm_matches_jax(norm_type, train):
    rng = np.random.default_rng(3)
    x, mask = _norm_inputs(rng)
    jn = j_layers.Norm(norm_type, momentum=0.1)
    variables = jn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(mask), False)
    params = _randomize_norms(_np(variables["params"]), rng)
    stats = _randomize_norms(_np(variables.get("batch_stats", {})), rng)
    ref, new = jn.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), jnp.asarray(mask), train,
                        mutable=["batch_stats"])
    tn = layers.Norm(layers.NormType[norm_type.name], 6, momentum=0.1)
    sd = {k[2:]: v for k, v in flax_to_torch(
        {"n": params}, {"n": stats} if stats else {}).items()}
    tn.load_state_dict(sd, strict=True)
    tn.train(train)
    got = tn(torch.from_numpy(x), torch.from_numpy(mask))
    ref = np.asarray(ref)
    assert np.abs(got.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert float(got.detach()[~torch.from_numpy(mask)].abs().max()) == 0.0
    for k, v in flax_to_torch({}, {"n": _np(new.get("batch_stats", {}))}
                              ).items():
        assert float((tn.state_dict()[k[2:]] - v).abs().max()) <= 1e-6, k
    # bf16 activations: statistics in f32, the output back in bf16
    got16 = tn(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert got16.dtype == torch.bfloat16


def test_sum_pool_and_global_max_pool_match_jax():
    th, jb = _batches("ResNet14")
    tb = to_torch(th, "cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(*th.masks[0].shape, 4)).astype(np.float32)
    shape = th.masks[1].shape
    ref = np.asarray(j_layers.sum_pool(jb, jnp.asarray(x), "down0k2", shape))
    got = layers.sum_pool(tb, torch.from_numpy(x), "down0k2", shape).numpy()
    assert np.abs(ref).max() > 1.0
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = np.asarray(j_layers.global_max_pool(jnp.asarray(x), jb.masks[0]))
    got = layers.global_max_pool(torch.from_numpy(x), tb.masks[0])
    np.testing.assert_array_equal(got.numpy(), ref)
    # a shape with no valid voxel pools to the dtype's lowest value
    none = torch.zeros_like(tb.masks[0])
    assert float(layers.global_max_pool(torch.from_numpy(x), none).max()) \
        == torch.finfo(torch.float32).min


def test_stem_conv_options():
    """`use_bias` adds a per-channel bias; `input_grad=False` cuts the
    gradient into the stem's input and leaves dW as it was."""
    th, _ = _batches("ResUNet14")
    tb = to_torch(th, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(*th.masks[0].shape, 3, generator=g, requires_grad=True)
    outs = {}
    for input_grad in (True, False):
        conv = layers.SparseConv(3, 8, "same0k3", use_bias=True,
                                 input_grad=input_grad)
        conv.reset_parameters(torch.Generator().manual_seed(1))
        with torch.no_grad():
            conv.bias.copy_(torch.arange(8.0))
        x.grad = None
        out = conv(tb, x, th.masks[0].shape)
        out.square().sum().backward()
        outs[input_grad] = (out.detach(), conv.kernel.grad.clone(),
                            None if x.grad is None else x.grad.clone())
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    assert outs[True][2] is not None and outs[False][2] is None
    plain = layers.SparseConv(3, 8, "same0k3")
    plain.load_state_dict({"kernel": conv.kernel.detach()})
    diff = outs[True][0] - plain(tb, x.detach(), th.masks[0].shape)
    assert torch.allclose(diff, torch.arange(8.0).expand_as(diff), atol=1e-5)


def test_main_seg_builds_the_new_families_and_refuses_level5_outputs():
    from csn_tpu_torch.data.synthetic import SurfaceShapeDataset
    from csn_tpu_torch.tasks import main_seg

    ds = SurfaceShapeDataset(2, 64, 0)
    base = dict(partnet_category="Display", conv1_kernel_size=3,
                num_points=64, level_shrink=1.5, batch_size=2, device="cpu",
                bn_momentum=0.05)
    for name in ("Res16UNet34C", "ResUNet18INBN"):
        t = main_seg.build_trainer(Config(model=name, **base).normalized(),
                                   datasets=(ds, ds))
        assert type(t.model).__name__ == name
        assert t.spec.num_levels == MODELS[name].num_levels()
        moms = {n: m.momentum for n, m in t.model.named_modules()
                if isinstance(m, layers.MaskedBatchNorm)}
        assert moms.pop("final_norm", 0.1) == 0.1   # the head keeps its own
        assert set(moms.values()) == {0.05}
    with pytest.raises(ValueError, match="level-0"):
        main_seg.build_trainer(Config(model="ResNet14", **base).normalized(),
                               datasets=(ds, ds))

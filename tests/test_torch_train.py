"""Port: the train slice (HRNetSimCSN3S, K=1) against the JAX package at a
small size, with flax-initialized weights converted by `flax_to_torch`.

Small size: d_model 32, 2 heads, k3 stem, 400 points per shape at voxel
0.15, level caps shrinking by 1.5, B = 2 query + 2 key shapes, f32,
attention dropout 0 (the JAX in-kernel dropout draws the TPU's own random
bits, which have no CPU lowering, so the two cannot share a mask), dense
attention on the JAX side. Two SGD steps (lr 0.05, momentum 0.9, dampening
0.1, weight decay 1e-4: the bench's `make_optimizer("SGD", lr=0.05)`) on
both sides, the second of which exercises the momentum buffer's first-step
rule. Norm scales, biases and running statistics start at random values.

The gradient is only piecewise smooth: a ReLU whose input lies within
float32 rounding of zero (one of about 10^6 inputs per step here) can fall
on either side in the two frameworks, and at about 150 level-2 voxels one
such flip moves a conv's gradient by up to 10 % of its max (measured at
data seed 0: an input of 1.2e-7 at a final-transition ReLU in step 2, where
the port agrees with a float64 run to 6e-6 and the JAX package is 14 %
off). So the JAX step records which entries each masked ReLU passes, and
the port's step takes those decisions (`_JaxRelus`); the values on both
sides stay each framework's own, and the decisions the port would have
taken otherwise are counted and bounded (at most 1e-5 of the inputs;
over data seeds 0-6, at most 3 of 3.6e6 per step, with every gradient
within 5.4e-5 of its max).

Tolerances (f32 both sides, different summation orders): loss rel <= 1e-5
per step; every parameter's gradient max abs <= 1e-4 * max|ref| per tensor,
except fc1's bias, whose gradient is zero up to rounding (train-mode
BatchNorm cancels a bias before it): both sides below 1e-6 and 1e-4 of the
step's largest gradient; parameters after each step and BatchNorm running
statistics max abs <= 1e-5 * max(1, max|ref|) per tensor; predictions equal
on >= 99.9 % of valid points. Also: a dropout-0.1 step is finite and
fixed by its generator; `MaskedBatchNorm` train statistics, the LR
schedules and both optimizers against the JAX package. The port's steps run
twice, with the sparse conv in its K1 form and in its im2col form
(`CSN_DYNG=2`: `conv_im2col_plain` / `conv_im2col_bwd_plain` on the CPU),
against the same JAX steps and within the same tolerances.

Again at d_model 256 in 2 heads of 128 (the heads the f32 D=128 split-TF32
attention bodies serve on the card; the plain attention here): the eval
logits of the initial weights within 1e-4 x max|ref|, and one SGD step's
loss (rel 1e-5) and gradients (1e-4 x max|ref| per tensor) as above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import csn_tpu.models.blocks as j_blocks
import csn_tpu.models.hrnet as j_hrnet
import csn_tpu_torch.models.blocks as t_blocks
import csn_tpu_torch.models.hrnet as t_hrnet
from csn_tpu.core.interp import interp_batch as j_interp_batch
from csn_tpu.data import pipeline as j_pipeline
from csn_tpu.models import load_model as j_load_model
from csn_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from csn_tpu.train import optim as joptim
from csn_tpu.train.losses import cross_entropy_ignore as j_ce
from csn_tpu.train.losses import predict_nonzero as j_pred
from csn_tpu_torch import kernels
from csn_tpu_torch.core import window_conv
from csn_tpu_torch.core.pyramid import to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.models import load_model
from csn_tpu_torch.models.convert import flax_to_torch
from csn_tpu_torch.models.layers import MaskedBatchNorm
from csn_tpu_torch.train import optim
from csn_tpu_torch.train.steps import train_step

torch.set_num_threads(1)

NAME = "HRNetSimCSN3S"
CFG = dict(out_channels=5, conv1_kernel_size=3, d_model=32, n_head=2,
           k_neighbors=1)
# d_model 256 in 2 heads of 128
WIDE_CFG = dict(CFG, d_model=256)
STEPS = 2
LR = 0.05


def _randomize_norms(tree, rng):
    """Random BN scale/bias (params) or mean/var (batch_stats)."""
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _JaxRelus:
    """The masked ReLUs' decisions: `record` stands in for the JAX
    package's `relu_masked` while a step is traced and collects each call's
    keep mask (returned by the step); `replay` stands in for the port's and
    applies the recorded masks in call order, counting the entries where
    its own input would have decided otherwise."""

    def __init__(self):
        self.traced = []
        self.keeps = []
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
def _jax_steps(wide=False):
    """The JAX package's STEPS steps at CFG (one step at WIDE_CFG with
    `wide`): (ref, keeps, relus, init, qh, kh, logits), `logits` the eval
    logits of the initial weights with `wide`, else None."""
    cfg, steps = (WIDE_CFG, 1) if wide else (CFG, STEPS)
    # the batch is built twice from one seed, once by each package
    def build(pipe, cls):
        spec = pipe.pyramid_spec_for_model(
            cls, num_points=400, voxel_size=0.15, conv1_kernel_size=3,
            shrink=1.5)
        rng = np.random.default_rng(0)
        return [pipe.collate_shapes(
            [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
            rng=rng) for _ in range(2)]

    qh, kh = build(pipeline, load_model(NAME))
    jq, jk = (b.to_jax(compact=False)
              for b in build(j_pipeline, j_load_model(NAME)))
    rng = np.random.default_rng(7)

    jm = j_load_model(NAME)(use_flash=False, compute_dtype="float32",
                            attn_dropout=0.0, **cfg)
    variables = jax.jit(lambda r, b, ks: jm.init(r, b, ks, train=False))(
        jax.random.PRNGKey(0), jq, (jk,))
    params = _randomize_norms(_np(variables["params"]), rng)
    stats = _randomize_norms(_np(variables["batch_stats"]), rng)
    init = (params, stats)
    logits = None
    if wide:
        logits = np.asarray(jax.jit(lambda v, qb, kbs: jm.apply(
            v, qb, kbs, train=False))(
                {"params": params, "batch_stats": stats}, jq, (jk,)))

    opt = joptim.make_optimizer("SGD", lr=LR)
    relus = _JaxRelus()

    @jax.jit
    def j_step(params, stats, opt_state, qb, kbs, key):
        def loss_fn(p):
            relus.traced.clear()
            out, new_vars = jm.apply(
                {"params": p, "batch_stats": stats}, qb, kbs, train=True,
                mutable=["batch_stats"], rngs={"dropout": key})
            pl = j_interp_batch(out, qb)
            loss = j_ce(pl, qb.labels, 255, qb.point_mask)
            return loss, (new_vars["batch_stats"], pl, tuple(relus.traced))

        (loss, (new_stats, pl, keeps)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = opt.update(grads, opt_state, params)
        new_params = jax.tree_util.tree_map(lambda p, u: p + u, params,
                                            updates)
        return new_params, new_stats, new_opt, loss, grads, j_pred(pl), keeps

    ref, keeps = [], []
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_blocks, j_hrnet):
            mp.setattr(mod, "relu_masked", relus.record)
        for _ in range(steps):
            key, sub = jax.random.split(key)
            params, stats, opt_state, loss, grads, pred, kp = j_step(
                params, stats, opt_state, jq, (jk,), sub)
            ref.append(dict(loss=float(loss),
                            grads=flax_to_torch(_np(grads), {}),
                            state=flax_to_torch(_np(params), _np(stats)),
                            pred=np.asarray(pred)))
            keeps.append([np.array(k) for k in kp])
    relus.traced.clear()
    return ref, keeps, relus, init, qh, kh, logits


@pytest.fixture(scope="module", params=[None, 2], ids=["dyng0", "dyng2"])
def train_pair(request):
    """The port's steps beside the JAX package's, with the port's sparse
    conv in its K1 form (CSN_DYNG unset) and in its im2col form
    (CSN_DYNG=2)."""
    ref, keeps, relus, init, qh, kh, _ = _jax_steps()
    with window_conv.dyng(request.param):
        return _port_steps(ref, keeps, relus, init, qh, kh)


@pytest.fixture(scope="module")
def wide_pair():
    """At WIDE_CFG (2 heads of 128): the port's eval logits of the initial
    weights and its one step beside the JAX package's: (ref, got, logits
    ref, logits got)."""
    ref, keeps, relus, init, qh, kh, logits = _jax_steps(wide=True)
    tm = load_model(NAME)(attn_dropout=0.0, **WIDE_CFG)
    assert tm.d_model // tm.n_head == 128
    tm.load_state_dict(flax_to_torch(*init), strict=True)
    qb, kb = (to_torch(h, "cpu", compact=False) for h in (qh, kh))
    with torch.no_grad():
        got_logits = tm.eval()(qb, (kb,)).numpy()
    ref, got, _, launches = _port_steps(ref, keeps, relus, init, qh, kh,
                                        WIDE_CFG)
    assert not any(launches.values()), launches
    return ref, got, logits, got_logits


def _port_steps(ref, keeps, relus, init, qh, kh, cfg=CFG):
    tm = load_model(NAME)(attn_dropout=0.0, **cfg)
    tm.load_state_dict(flax_to_torch(*init), strict=True)
    topt = optim.make_optimizer(tm.parameters(), "SGD", lr=LR)
    qb, kb = (to_torch(h, "cpu", compact=False) for h in (qh, kh))
    got = []
    kernels.reset_launches()
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_blocks, t_hrnet):
            mp.setattr(mod, "relu_masked", relus.replay)
        for step in range(len(ref)):
            relus.keeps = list(keeps[step])
            relus.flips = relus.inputs = 0
            loss, pred = train_step(tm, topt, qb, (kb,), gen)
            assert not relus.keeps, "the two models ran different ReLUs"
            got.append(dict(
                loss=float(loss), pred=pred.numpy(),
                grads={n: p.grad.clone() for n, p in tm.named_parameters()},
                state={n: t.clone() for n, t in tm.state_dict().items()},
                flips=(relus.flips, relus.inputs)))
    return ref, got, qh.point_mask, dict(kernels.LAUNCHES)


# analytically zero gradients: fc1's bias feeds train-mode BatchNorm
VANISHING = {"fc1.linear.bias"}


def _rel_close(got, ref, rel, what):
    assert set(got) == set(ref), what
    top = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        g = got[name].numpy()
        assert g.shape == r.shape, (what, name)
        if what == "grad" and name in VANISHING:
            assert max(np.abs(r).max(), np.abs(g).max()) <= 1e-6 * top, name
            tol = rel * top
        else:
            tol = rel * max(np.abs(r).max(), 1.0 if what != "grad" else 0.0)
        err = np.abs(g - r).max()
        assert err <= tol, (what, name, err, tol)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_loss_matches_jax(train_pair, step):
    ref, got, point_mask, launches = train_pair
    assert abs(got[step]["loss"] - ref[step]["loss"]) <= 1e-5 * abs(
        ref[step]["loss"])
    agree = (got[step]["pred"] == ref[step]["pred"])[point_mask].mean()
    assert agree >= 0.999, agree
    assert not any(launches.values()), launches
    flips, inputs = got[step]["flips"]
    assert inputs > 10 ** 5 and flips <= 1e-5 * inputs, (flips, inputs)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_gradients_match_jax(train_pair, step):
    ref, got, _, _ = train_pair
    assert max(float(g.abs().max()) for g in ref[step]["grads"].values()) \
        > 1e-3   # not a vanished signal
    _rel_close(got[step]["grads"], ref[step]["grads"], 1e-4, "grad")


@pytest.mark.parametrize("step", range(STEPS))
def test_train_params_and_bn_stats_match_jax(train_pair, step):
    ref, got, _, _ = train_pair
    _rel_close(got[step]["state"], ref[step]["state"], 1e-5, "state")


def test_wide_heads_eval_logits_match_jax(wide_pair):
    _, _, ref, got = wide_pair
    scale = float(np.abs(ref).max())
    assert scale > 1e-2   # not a vanished signal
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


def test_wide_heads_train_loss_matches_jax(wide_pair):
    ref, got, _, _ = wide_pair
    assert abs(got[0]["loss"] - ref[0]["loss"]) <= 1e-5 * abs(ref[0]["loss"])
    flips, inputs = got[0]["flips"]
    assert inputs > 10 ** 5 and flips <= 1e-5 * inputs, (flips, inputs)


def test_wide_heads_train_gradients_match_jax(wide_pair):
    ref, got, _, _ = wide_pair
    assert max(float(g.abs().max()) for g in ref[0]["grads"].values()) \
        > 1e-3   # not a vanished signal
    _rel_close(got[0]["grads"], ref[0]["grads"], 1e-4, "grad")


def _small_batches(seed=0):
    spec = pipeline.pyramid_spec_for_model(
        load_model(NAME), num_points=200, voxel_size=0.15,
        conv1_kernel_size=3, shrink=1.5)
    rng = np.random.default_rng(seed)
    return [to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 200) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2)]


def test_train_step_with_dropout_is_finite_and_fixed_by_its_generator():
    qb, kb = _small_batches()
    init = load_model(NAME)(**CFG)
    assert init.attn_dropout == 0.1
    init.reset_parameters(torch.Generator().manual_seed(0))

    def run(seed):
        tm = load_model(NAME)(**CFG)
        tm.load_state_dict(init.state_dict())
        opt = optim.make_optimizer(tm.parameters(), "SGD", lr=LR)
        gen = torch.Generator().manual_seed(seed)
        losses = [float(train_step(tm, opt, qb, (kb,), gen)[0])
                  for _ in range(2)]
        return losses, tm.state_dict()

    (l1, s1), (l2, s2), (l3, _) = run(3), run(3), run(4)
    assert all(np.isfinite(l1)), l1
    assert l1 == l2 and all(torch.equal(s1[n], s2[n]) for n in s1)
    assert l3 != l1
    tm = load_model(NAME)(**CFG).train()
    with pytest.raises(ValueError, match="generator"):
        tm(qb, (kb,))


@pytest.mark.parametrize("momentum", [0.1, 0.02])
def test_masked_batchnorm_train_matches_jax(momentum):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 3)).astype(np.float32) * 2 + 1
    mask = np.zeros((2, 16), dtype=bool)
    mask[0, :10] = True
    mask[1, :5] = True
    jbn = JMaskedBatchNorm(momentum=momentum)
    v = _np(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(mask), True))
    v["params"]["scale"] = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    v["params"]["bias"] = rng.normal(size=3).astype(np.float32)
    v["batch_stats"]["mean"] = rng.normal(size=3).astype(np.float32)
    v["batch_stats"]["var"] = rng.uniform(0.5, 2, 3).astype(np.float32)
    y, new = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), True,
                       mutable=["batch_stats"])
    tbn = MaskedBatchNorm(3, momentum=momentum)
    tbn.load_state_dict({k: torch.from_numpy(a) for k, a in
                         {**v["params"], **v["batch_stats"]}.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tbn.train()(tx, torch.from_numpy(mask))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(new["batch_stats"][k]),
                                   atol=1e-5)
    # the gradient flows through the batch statistics, as in JAX
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jbn.apply(v, a, jnp.asarray(mask), True,
                                         mutable=["batch_stats"])[0],
                     jnp.asarray(x))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)


def test_lr_schedules_match_jax():
    for name in ("StepLR", "PolyLR", "SquaredLR", "ExpLR"):
        kw = dict(step_size=7, max_iter=100, exp_step_size=13.0)
        js = joptim.make_lr_schedule(name, 0.05, **kw)
        ts = optim.make_lr_schedule(name, 0.05, **kw)
        for s in (0, 1, 6, 7, 50, 100):
            assert ts(s) == pytest.approx(js(s), rel=1e-12), (name, s)
    assert optim.make_lr_schedule("ReduceLROnPlateau", 0.05) is None
    with pytest.raises(ValueError):
        optim.make_lr_schedule("Cosine", 0.05)
    jp = joptim.ReduceLROnPlateau(lr=0.05, patience=2, cooldown=1)
    tp = optim.ReduceLROnPlateau(lr=0.05, patience=2, cooldown=1)
    for m in (1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.8, 0.85, 0.85, 0.85, 0.85):
        assert tp.step(m) == jp.step(m)
    assert tp.state_dict() == jp.state_dict()


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_optimizer_matches_jax(name):
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 5)).astype(np.float32)
    grads = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(3)]
    jopt = joptim.make_optimizer(name, lr=0.05)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = optim.make_optimizer([tp], name, lr=0.05)
    for g in grads:
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6)

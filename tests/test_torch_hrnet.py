"""Port: the whole eval slice (HRNetSimCSN3S and 2S, K=0 and K=1) against
the JAX package at a small size, with flax-initialized weights converted by
`flax_to_torch`.

Small size: d_model 32, 2 heads, k3 stem, 400 points per shape at voxel
0.15, level caps shrinking by 1.5, B = 2 query + 2 key shapes; the backbone
keeps its full widths (3S: 32, 64, 128, 256; 2S: 32, 128, 256). The JAX side runs its dense
attention core in f32 on the CPU. Norm scales, biases and running
statistics are drawn at random so that the folded eval BatchNorm and the
converter's mapping of every norm are exercised.

Tolerances (f32 both sides, different summation orders): logits and SSA
features max abs <= 1e-4; eval loss rel <= 1e-5; point logits <= 1e-4;
predictions equal on >= 99.9 % of valid points (argmax ties).
"""

import jax
import numpy as np
import pytest
import torch

import bench
from csn_tpu.core.interp import interp_batch as j_interp_batch
from csn_tpu.data import pipeline as j_pipeline
from csn_tpu.models import load_model as j_load_model
from csn_tpu.train.losses import cross_entropy_ignore as j_ce
from csn_tpu.train.losses import predict_nonzero as j_pred
from csn_tpu_torch import kernels
from csn_tpu_torch.core.pyramid import to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.models import load_model
from csn_tpu_torch.models.convert import flax_to_torch
from csn_tpu_torch.train.steps import eval_step

torch.set_num_threads(1)

CFG = dict(out_channels=5, conv1_kernel_size=3, d_model=32, n_head=2,
           k_neighbors=1)


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


@pytest.fixture(scope="module", params=["HRNetSimCSN3S", "HRNetSimCSN2S"])
def slice_pair(request):
    name = request.param
    # the batch is built twice from one seed, once by each package
    def build(pipe, cls):
        spec = pipe.pyramid_spec_for_model(
            cls, num_points=400, voxel_size=0.15, conv1_kernel_size=3,
            shrink=1.5)
        rng = np.random.default_rng(0)
        return [pipe.collate_shapes(
            [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
            rng=rng) for _ in range(2)]

    qh, kh = build(pipeline, load_model(name))
    jq, jk = (b.to_jax(compact=False)
              for b in build(j_pipeline, j_load_model(name)))
    rng = np.random.default_rng(7)

    jm = j_load_model(name)(use_flash=False, compute_dtype="float32", **CFG)
    variables = jax.jit(lambda r, b, ks: jm.init(r, b, ks, train=False))(
        jax.random.PRNGKey(0), jq, (jk,))
    params = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["params"]), rng)
    stats = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]), rng)
    v = {"params": params, "batch_stats": stats}

    @jax.jit
    def j_eval(v, qb, keys):
        out = jm.apply(v, qb, keys, train=False)
        pl = j_interp_batch(out, qb)
        return out, j_ce(pl, qb.labels, 255, qb.point_mask), pl, j_pred(pl)

    ref = dict(zip(("logits", "loss", "point_logits", "pred"),
                   map(np.asarray, j_eval(v, jq, (jk,)))))
    ref["logits_k0"] = np.asarray(
        jax.jit(lambda v, qb: jm.apply(v, qb, (), train=False))(v, jq))
    ref["ssa"] = np.asarray(jax.jit(
        lambda v, qb, keys: jm.apply(v, qb, keys, train=False,
                                     return_ssa=True))(v, jq, (jk,)))

    tm = load_model(name)(**CFG)
    tm.load_state_dict(flax_to_torch(params, stats), strict=True)
    tm.eval()
    return (tm, to_torch(qh, "cpu", compact=False),
            to_torch(kh, "cpu", compact=False), ref, qh.point_mask)


def _max_abs(got, ref):
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max())


def test_logits_k1_match_jax(slice_pair):
    tm, qb, kb, ref, _ = slice_pair
    with torch.no_grad():
        got = tm(qb, (kb,)).numpy()
    assert np.abs(ref["logits"]).max() > 1e-2   # not a vanished signal
    assert _max_abs(got, ref["logits"]) <= 1e-4


def test_logits_k0_match_jax(slice_pair):
    tm, qb, _, ref, _ = slice_pair
    with torch.no_grad():
        got = tm(qb, ()).numpy()
    assert _max_abs(got, ref["logits_k0"]) <= 1e-4


def test_ssa_features_match_jax(slice_pair):
    tm, qb, kb, ref, _ = slice_pair
    with torch.no_grad():
        got = tm(qb, (kb,), return_ssa=True).numpy()
    assert _max_abs(got, ref["ssa"]) <= 1e-4


def test_eval_step_matches_jax(slice_pair):
    tm, qb, kb, ref, point_mask = slice_pair
    kernels.reset_launches()
    loss, point_logits, pred = eval_step(tm, qb, (kb,))
    assert abs(float(loss) - float(ref["loss"])) <= 1e-5 * abs(
        float(ref["loss"]))
    assert _max_abs(point_logits.numpy(), ref["point_logits"]) <= 1e-4
    agree = (pred.numpy() == ref["pred"])[point_mask].mean()
    assert agree >= 0.999, agree
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


# -- HRNetSeg and the cached-collection methods --------------------------------

def _build_batches(pipe, cls, n_batches, seed=3):
    spec = pipe.pyramid_spec_for_model(
        cls, num_points=300, voxel_size=0.15, conv1_kernel_size=3,
        shrink=1.5)
    rng = np.random.default_rng(seed)
    return [pipe.collate_shapes(
        [bench.make_surface_shape(rng, 300) for _ in range(2)], spec,
        rng=rng) for _ in range(n_batches)]


def test_hrnet_seg_logits_match_jax():
    """HRNetSeg3S: logits and the fc1 features against the JAX model with
    converted weights; f32, max abs <= 1e-4 * max|ref|."""
    name = "HRNetSeg3S"
    kw = dict(out_channels=5, conv1_kernel_size=3, d_model=32)
    (qh,) = _build_batches(pipeline, load_model(name), 1)
    (jq,) = (b.to_jax(compact=False)
             for b in _build_batches(j_pipeline, j_load_model(name), 1))
    jm = j_load_model(name)(compute_dtype="float32", **kw)
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), jq)
    rng = np.random.default_rng(5)
    params = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["params"]), rng)
    stats = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]), rng)
    ref, ref_fc1 = map(np.asarray, jax.jit(
        lambda v, b: jm.apply(v, b, train=False, return_fc1=True))(
        {"params": params, "batch_stats": stats}, jq))
    tm = load_model(name)(**kw)
    tm.load_state_dict(flax_to_torch(params, stats), strict=True)
    tm.eval()
    with torch.no_grad():
        got, fc1 = tm(to_torch(qh, "cpu", compact=False), return_fc1=True)
    assert np.abs(ref).max() > 1e-2
    assert _max_abs(got.numpy(), ref) <= 1e-4 * np.abs(ref).max()
    assert _max_abs(fc1.numpy(), ref_fc1) <= 1e-4 * np.abs(ref_fc1).max()
    with pytest.raises(ValueError, match="key"):
        tm(to_torch(qh, "cpu"), (to_torch(qh, "cpu"),))


@pytest.fixture(scope="module", params=[1, 2], ids=["K1", "K2"])
def cache_pair(request):
    """HRNetSimCSN2S with K key batches: the JAX forward, `cache_features`
    and `csa_from_cache`, and the port's model with the converted weights."""
    K, name = request.param, "HRNetSimCSN2S"
    kw = dict(CFG, k_neighbors=K)
    hosts = _build_batches(pipeline, load_model(name), K + 1)
    jq, *jks = (b.to_jax(compact=False) for b in
                _build_batches(j_pipeline, j_load_model(name), K + 1))
    jks = tuple(jks)
    jm = j_load_model(name)(use_flash=False, compute_dtype="float32", **kw)
    variables = jax.jit(lambda r, b, ks: jm.init(r, b, ks, train=False))(
        jax.random.PRNGKey(0), jq, jks)
    rng = np.random.default_rng(9)
    params = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["params"]), rng)
    stats = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]), rng)
    v = {"params": params, "batch_stats": stats}
    ref = {"logits": np.asarray(jax.jit(
        lambda v, b, ks: jm.apply(v, b, ks, train=False))(v, jq, jks))}
    cache = [jax.jit(lambda v, b: jm.apply(v, b, method="cache_features"))(
        v, kb) for kb in jks]
    ref["feats"] = np.stack([np.asarray(c[0]) for c in cache], axis=1)
    ref["pools"] = np.stack([np.asarray(c[1]) for c in cache], axis=1)
    ref["masks"] = np.stack([np.asarray(kb.masks[0]) for kb in jks], axis=1)
    ref["cached"] = np.asarray(jax.jit(lambda v, b, f, p, m: jm.apply(
        v, b, f, p, m, method="csa_from_cache"))(
        v, jq, ref["feats"], ref["pools"], ref["masks"]))
    tm = load_model(name)(**kw)
    tm.load_state_dict(flax_to_torch(params, stats), strict=True)
    tm.eval()
    qb, *kbs = (to_torch(h, "cpu", compact=False) for h in hosts)
    return tm, qb, tuple(kbs), ref


def test_cache_features_match_jax(cache_pair):
    tm, _, kbs, ref = cache_pair
    with torch.no_grad():
        cache = [tm.cache_features(kb) for kb in kbs]
    feats = torch.stack([c[0] for c in cache], dim=1).numpy()
    pools = torch.stack([c[1] for c in cache], dim=1)
    assert pools.dtype == torch.float32
    assert _max_abs(feats, ref["feats"]) <= 1e-4 * np.abs(ref["feats"]).max()
    assert _max_abs(pools.numpy(), ref["pools"]) <= 1e-4 * np.abs(
        ref["pools"]).max()
    # padded voxel rows of the cached features are zero
    assert np.all(feats[~ref["masks"]] == 0)


def test_csa_from_cache_matches_jax_and_forward(cache_pair):
    tm, qb, kbs, ref = cache_pair
    with torch.no_grad():
        full = tm(qb, kbs).numpy()
        cache = [tm.cache_features(kb) for kb in kbs]
        got = tm.csa_from_cache(
            qb, torch.stack([c[0] for c in cache], dim=1),
            torch.stack([c[1] for c in cache], dim=1),
            torch.stack([kb.masks[0] for kb in kbs], dim=1)).numpy()
        # and from the JAX package's cache, as a host cache would hand it over
        from_jax = tm.csa_from_cache(
            qb, torch.from_numpy(ref["feats"]), torch.from_numpy(ref["pools"]),
            torch.from_numpy(ref["masks"])).numpy()
    scale = np.abs(ref["logits"]).max()
    assert scale > 1e-2
    assert _max_abs(ref["cached"], ref["logits"]) <= 1e-4 * scale
    assert _max_abs(full, ref["logits"]) <= 1e-4 * scale
    assert _max_abs(got, ref["cached"]) <= 1e-4 * scale
    # eval-mode BatchNorm: the query's rows do not depend on the key shapes
    # sharing its pass, so the cached form equals the combined pass
    assert _max_abs(got, full) <= 1e-5 * scale
    assert _max_abs(from_jax, ref["cached"]) <= 1e-4 * scale

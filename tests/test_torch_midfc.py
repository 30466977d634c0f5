"""Port: the MID-FC branch (`csn_tpu_torch.midfc`, `retrieval/graph.py`,
the MID-FC losses and metric) against the JAX package on the CPU, at a
small size: K=2, 2 heads, d_model 32 (d_k = d_v = d_model), P=80, chunks of
20 or full attention, f32. Inputs come from numpy seeds and go through both
packages; the JAX package's parameters cross over through
`flax_to_torch_midfc`.

Tolerances (f32 both sides, different summation orders): eval logits max abs
<= 1e-5 (after_fc=False, whose fc_1 + BatchNorm widen the range: 1e-4·max|ref|);
loss rel <= 1e-5; every gradient <= 1e-4·max|ref| of its tensor; parameters
after two Adam steps <= 1e-5 wherever the step's direction is defined (see
`_assert_params_close`); retrieval measure <= 1e-5, kNN graphs equal. One
CSA train step in bf16 at heads of 128 (both packages in bf16): loss rel
<= 2e-3, every gradient <= 2e-2·max|ref|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csn_tpu.midfc import data as j_data
from csn_tpu.midfc.model import CrossShapeAt as JCrossShapeAt
from csn_tpu.midfc.model import get_model as j_get_model
from csn_tpu.midfc.training import MidfcConfig as JMidfcConfig
from csn_tpu.midfc.training import MidfcRunner as JMidfcRunner
from csn_tpu.retrieval import graph as j_graph
from csn_tpu.train import losses as j_losses
from csn_tpu.train.metrics import MidfcIoUAccumulator as JMidfcIoU
from csn_tpu.train.optim import set_lr as j_set_lr
from csn_tpu_torch.midfc import chunk_size_arg, data, run_training
from csn_tpu_torch.midfc.convert import (
    convert_state_dict, flax_to_torch_midfc,
)
from csn_tpu_torch.midfc.model import CrossShapeAt, get_model
from csn_tpu_torch.midfc.training import (
    CHECKPOINT_NAME, MidfcConfig, MidfcRunner, compute_knn_graphs,
)
from csn_tpu_torch.retrieval import graph
from csn_tpu_torch.train import losses
from csn_tpu_torch.train.metrics import MidfcIoUAccumulator

torch.set_num_threads(1)

B, P, D, K, C, HEADS = 2, 80, 32, 2, 5, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, d=D, b=B):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, P, d)).astype(np.float32)
    neighbors = rng.normal(size=(b, K + 1, P, d)).astype(np.float32)
    labels = rng.integers(0, C, size=(b, P)).astype(np.int32)
    return feats, labels, neighbors


@pytest.mark.parametrize("chunk", [20, None])
@pytest.mark.parametrize("attention_type", ["ssa", "csa"])
def test_crossshapeat_eval_matches_jax(attention_type, chunk):
    feats, _, neighbors = _inputs(0)
    args = (feats, neighbors) if attention_type == "csa" else (feats,)
    jm = j_get_model(attention_type, C, HEADS, K=K, chunk_size=chunk,
                     d_model=D)
    params = _np(jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                         train=False)["params"])
    rng = np.random.default_rng(1)
    for name in ("compatibility_q", "compatibility_k"):
        if name in params:   # flax starts biases at zero: make them count
            params[name]["bias"] = rng.normal(size=D).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args),
                              train=False))
    tm = get_model(attention_type, C, HEADS, K=K, chunk_size=chunk,
                   d_model=D)
    tm.load_state_dict(flax_to_torch_midfc(params), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(*map(torch.tensor, args)).numpy()
    assert got.shape == (B, P, C)
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("attention_type", ["ssa", "csa"])
def test_crossshapeat_backbone_input_matches_jax(attention_type):
    """after_fc=False: fc_1 (no bias) + BatchNorm on running statistics +
    ReLU in front of the attention; fc_1 fixes d_model at 256."""
    rng = np.random.default_rng(2)
    cin = 48
    x = rng.normal(size=(B, 40, cin)).astype(np.float32)
    nb = rng.normal(size=(B, K + 1, 40, 256)).astype(np.float32)
    args = (x, nb) if attention_type == "csa" else (x,)
    kw = dict(num_classes=C, d_model=256, n_heads=HEADS, K=K,
              attention_type=attention_type, after_fc=False, chunk_size=20)
    jm = JCrossShapeAt(**kw)
    v = _np(jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                    train=False))
    stats = {"fc_1_bn": {
        "mean": (0.1 * rng.normal(size=256)).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}}
    ref = np.asarray(jm.apply({"params": v["params"], "batch_stats": stats},
                              *map(jnp.asarray, args), train=False))
    tm = CrossShapeAt(in_channels=cin, **kw)
    tm.load_state_dict(flax_to_torch_midfc(v["params"], stats), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(*map(torch.tensor, args)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _runner_pair(attention_type, chunk=20):
    kw = dict(num_classes=C, n_heads=HEADS, K=K, batch_size=B, d_model=D,
              chunk_size=chunk, num_points=P, use_flash=False,
              weight_decay=5e-4)
    jr = JMidfcRunner(JMidfcConfig(**kw), attention_type)
    jr.model = jr.model.clone(dropout=0.0)
    jr._grad = jax.jit(jr._make_grad())
    feats, labels, neighbors = _inputs(3)
    if attention_type == "ssa":
        neighbors = None
    jr.initialize(feats, neighbors)
    tr = MidfcRunner(MidfcConfig(**kw), attention_type, device="cpu")
    tr.initialize()
    tr.model.attention.mha.dropout = 0.0
    tr.load_state(flax_to_torch_midfc(_np(jr.params)))
    return jr, tr, feats, labels, neighbors


def _assert_params_close(got, ref, total_grad, lr):
    """Adam's first steps move an entry by about lr * g / |g|, so an entry
    whose total gradient (gradient + weight decay) is within float32 noise
    of zero has no defined direction. Entries with |g| >= 1e-3 * max|g| of
    their tensor must agree to 1e-5; every entry to 2 * lr per step."""
    for name, r in ref.items():
        d = (got[name] - r).abs()
        g = total_grad[name].abs()
        defined = g >= 1e-3 * g.max()
        assert float(d[defined].max()) <= 1e-5, name
        assert float(d.max()) <= 2 * 2 * lr, name


@pytest.mark.parametrize("attention_type", ["ssa", "csa"])
def test_runner_two_adam_steps_match_jax(attention_type):
    jr, tr, feats, labels, neighbors = _runner_pair(attention_type)
    jn = None if neighbors is None else jnp.asarray(neighbors)
    smallest = None
    for step in range(2):
        jl, jg = jr._grad(jr.params, jnp.asarray(feats), jnp.asarray(labels),
                          jn, jax.random.PRNGKey(step))
        tl, tg = tr._grad(feats, labels, neighbors, step)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        ref_g = flax_to_torch_midfc(_np(jg))
        assert set(tg) == set(ref_g)
        for name, r in ref_g.items():
            err = float((tg[name] - r).abs().max())
            assert err <= 1e-4 * float(r.abs().max()), (step, name)
        # the gradient Adam sees: + weight decay * parameter
        total = {n: (ref_g[n] + 5e-4 * tr.params[n]).abs() for n in ref_g}
        smallest = total if smallest is None else {
            n: torch.minimum(smallest[n], total[n]) for n in total}
        jr.opt_state = j_set_lr(jr.opt_state, jr.lr)
        jr.params, jr.opt_state = jr._apply(jr.params, jr.opt_state, jg)
        tr._apply(tg)
    _assert_params_close(tr.params, flax_to_torch_midfc(_np(jr.params)),
                         smallest, tr.lr)


def test_bf16_csa_train_step_matches_jax_bf16_step():
    """The slice in bf16: one MID-FC CSA train step (dropout 0) with
    compute_dtype "bfloat16" in both packages, at heads of 128 (d_model 128
    in 2 heads: the width of the bf16 D=128 kernels; the plain attention on
    the CPU), on the same numpy inputs and converted weights. Tolerances:
    the loss within 2e-3 relative (the f32 logit head reads bf16 attention
    outputs, each rounded to 2^-9 of itself), every gradient within 2e-2 x
    max|ref| of its tensor (the card's bf16 tolerance: a few bf16 roundings,
    which the two packages place differently)."""
    d, heads = 128, 2
    kw = dict(num_classes=C, n_heads=heads, K=K, batch_size=B, d_model=d,
              chunk_size=20, num_points=P, use_flash=False,
              weight_decay=5e-4, compute_dtype="bfloat16")
    jr = JMidfcRunner(JMidfcConfig(**kw), "csa")
    jr.model = jr.model.clone(dropout=0.0)
    jr._grad = jax.jit(jr._make_grad())
    feats, labels, neighbors = _inputs(3, d=d)
    jr.initialize(feats, neighbors)
    tr = MidfcRunner(MidfcConfig(**kw), "csa", device="cpu")
    tr.initialize()
    tr.model.attention.mha.dropout = 0.0
    tr.load_state(flax_to_torch_midfc(_np(jr.params)))
    assert tr.model.compute_dtype == torch.bfloat16
    jl, jg = jr._grad(jr.params, jnp.asarray(feats), jnp.asarray(labels),
                      jnp.asarray(neighbors), jax.random.PRNGKey(0))
    tl, tg = tr._grad(feats, labels, neighbors, 0)
    assert abs(float(tl) - float(jl)) <= 2e-3 * abs(float(jl))
    ref_g = flax_to_torch_midfc(_np(jg))
    assert set(tg) == set(ref_g)
    for name, r in ref_g.items():
        err = float((tg[name].float() - r).abs().max())
        assert err <= 2e-2 * float(r.abs().max()), (name, err)


def test_nan_loss_zeroes_loss_and_gradients():
    _, tr, feats, labels, neighbors = _runner_pair("csa")
    bad = feats.copy()
    bad[1, 3, :] = np.nan
    loss, grads = tr._grad(bad, labels, neighbors, 0)
    assert float(loss) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads.values())
    loss, grads = tr._grad(feats, labels, neighbors, 0)
    assert float(loss) > 0.0 and any(
        float(g.abs().max()) > 0.0 for g in grads.values())


def test_losses_and_metric_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 50, C)).astype(np.float32)
    labels = rng.integers(0, C, size=(3, 50)).astype(np.int32)
    s, n = losses.cross_entropy_positive_sum(torch.tensor(logits),
                                             torch.tensor(labels))
    js, jn = j_losses.cross_entropy_positive_sum(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    assert int(n) == int(jn) and abs(float(s) - float(js)) <= 1e-4
    got = losses.cross_entropy_positive_labels(torch.tensor(logits),
                                               torch.tensor(labels))
    ref = j_losses.cross_entropy_positive_labels(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    assert abs(float(got) - float(ref)) <= 1e-6
    none = losses.cross_entropy_positive_labels(
        torch.tensor(logits), torch.zeros(3, 50, dtype=torch.int32))
    assert float(none) == 0.0
    a, b = MidfcIoUAccumulator(C), JMidfcIoU(C)
    for i in range(3):
        pred = logits[i].argmax(-1)
        a.update(pred, labels[i])
        b.update(pred, labels[i])
    assert a.result() == b.result() and 0.0 < a.result() < 1.0


def test_retrieval_measure_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(5, 30, 16)).astype(np.float32)
    k = rng.normal(size=(11, 30, 16)).astype(np.float32)
    qm = rng.random((5, 30)) > 0.2
    km = rng.random((11, 30)) > 0.2
    km[:, 0] = True
    ref = j_graph.retrieval_measure(q, qm, k, km)
    got = graph.retrieval_measure(q, qm, k, km, device="cpu")
    assert got.shape == (5, 11) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5
    # keys streamed in blocks of 8 shapes (a byte budget below one block)
    blocked = graph.retrieval_measure(q, qm, k, km, key_bytes_budget=1,
                                      device="cpu")
    assert np.abs(blocked - ref).max() <= 1e-5


def test_knn_graphs_match_jax():
    rng = np.random.default_rng(6)
    f = rng.normal(size=(9, 20, 8)).astype(np.float32)
    ones = np.ones(f.shape[:2], dtype=bool)
    m = graph.retrieval_measure(f, ones, f, ones, device="cpu")
    jm = j_graph.retrieval_measure(f, ones, f, ones)
    np.testing.assert_array_equal(graph.knn_graph_topk_rows(m, 3),
                                  j_graph.knn_graph_topk_rows(jm, 3))
    assert graph.knn_graph_from_measure(m, 3, True) == \
        j_graph.knn_graph_from_measure(jm, 3, True)
    assert np.all(graph.knn_graph_topk_rows(m, 3)[:, 0] == np.arange(9))
    assert graph.random_pairs(9, 9, 3, True, np.random.default_rng(0)) == \
        j_graph.random_pairs(9, 9, 3, True, np.random.default_rng(0))
    # the port's own k-means against scikit-learn's on four well-separated
    # clusters: the same candidate set (test_torch_retrieval.py holds it on
    # overlapping data)
    glob = (rng.normal(size=(40, 8)) * 0.05
            + np.repeat(rng.normal(size=(4, 8)) * 5, 10, axis=0)
            ).astype(np.float32)
    np.testing.assert_array_equal(
        np.sort(graph.kmeans_candidate_indices(glob)),
        np.sort(j_graph.kmeans_candidate_indices(glob)))


def test_features_dataset_padding_matches_jax(tmp_path):
    root = data.write_synthetic_midfc(str(tmp_path / "a"), n_shapes=5,
                                      num_points=40, channels=16)
    j_root = j_data.write_synthetic_midfc(str(tmp_path / "b"), n_shapes=5,
                                          num_points=40, channels=16)
    ds, jds = data.FeaturesDataset(root, 40), j_data.FeaturesDataset(
        j_root, 40)
    assert len(ds) == 5
    for (f, l, v), (jf, jl, jv) in zip(ds.batches(2), jds.batches(2)):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)
        assert v == jv and f.shape == (2, 40, 16)
    # shape_1 has 35 points: the pad repeats its prefix
    f1, l1 = ds[1]
    np.testing.assert_array_equal(f1[35:], f1[:5])
    np.testing.assert_array_equal(l1[35:], l1[:5])
    g = np.array([[0, 1, 2], [1, 0, 2], [2, 0, 1], [3, 0, 1], [4, 0, 1]])
    csa, jcsa = (m.CSAFeaturesDataset(r, r, g, 2, 40)
                 for m, r in ((data, root), (j_data, j_root)))
    for (f, l, n, v), (jf, jl, jn_, jv) in zip(csa.batches(2),
                                               jcsa.batches(2)):
        np.testing.assert_array_equal(n, jn_)
        assert n.shape == (2, 3, 40, 16) and v == jv
    assert chunk_size_arg("0") == 0
    with pytest.raises(Exception):
        chunk_size_arg("-1")


def test_run_training_cli_smoke(tmp_path):
    """One --testing epoch of ssa, save_knn and csa on a synthetic Bed
    category: the launcher's tables, output files and the SSA -> CSA
    hand-over."""
    root, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    for split, n in (("train", 6), ("test", 4)):
        data.write_synthetic_midfc(os.path.join(root, split, "Bed"),
                                   n_shapes=n, num_points=40, channels=16)
    common = ["--data_root", root, "--logs_root", logs, "--start", "0",
              "--end", "0", "--testing", "--d_model", "16", "--num_points",
              "40", "--chunk_size", "20", "--n_heads", "2", "--K", "2",
              "--batch_size", "2", "--device", "cpu"]
    ious = run_training.main(common + ["--attention_type", "ssa"])
    assert list(ious) == ["Bed"] and 0.0 <= ious["Bed"] <= 100.0
    ssa_dir = os.path.join(logs, "ssa_n_heads_2", "run_1", "Bed")
    if ious["Bed"] > 0:
        assert os.path.exists(os.path.join(ssa_dir, CHECKPOINT_NAME))
        assert os.path.exists(os.path.join(ssa_dir, "test_summaries.csv"))
    run_training.main(common + ["--attention_type", "save_knn"])
    graph_dir = os.path.join(logs, "knn_graphs", "n_heads_2", "Bed")
    tr = np.load(os.path.join(graph_dir, "train.npy"))
    te = np.load(os.path.join(graph_dir, "test.npy"))
    assert tr.shape == (6, 3) and te.shape == (4, 3)
    assert np.all(tr[:, 0] == np.arange(6))
    ious = run_training.main(common + ["--attention_type", "csa"])
    csa_dir = os.path.join(logs, "sgd_csa_n_heads_2_K_2", "run_1", "Bed")
    assert os.path.exists(os.path.join(csa_dir, CHECKPOINT_NAME))
    sd = torch.load(os.path.join(csa_dir, CHECKPOINT_NAME))
    assert "compatibility_q.bias" in sd and "attention.mha.w_qs.weight" in sd
    # pred: the pretrained-eval loop over pretrained_models/run_1/<Cat>
    import shutil

    cat_dir = os.path.join(logs, "pretrained_models", "run_1", "Bed")
    os.makedirs(cat_dir)
    shutil.copy(os.path.join(csa_dir, CHECKPOINT_NAME), cat_dir)
    ious = run_training.main(common + ["--attention_type", "pred"])
    assert list(ious) == ["Bed"] and 0.0 <= ious["Bed"] <= 100.0
    assert os.path.exists(os.path.join(cat_dir, "part_IoU_summaries.csv"))


def test_compute_knn_graphs_big_category_path(tmp_path):
    """The KMeans candidate path of the big categories returns rows that
    index the train collection."""
    tr_root = data.write_synthetic_midfc(str(tmp_path / "tr"), n_shapes=20,
                                         num_points=40, channels=16)
    te_root = data.write_synthetic_midfc(str(tmp_path / "te"), n_shapes=4,
                                         num_points=40, channels=16, seed=1)
    cfg = MidfcConfig(num_classes=C, n_heads=2, K=1, batch_size=4,
                      d_model=16, chunk_size=20, num_points=40)
    runner = MidfcRunner(cfg, "ssa", device="cpu")
    runner.initialize()
    tr, te = compute_knn_graphs(runner, data.FeaturesDataset(tr_root, 40),
                                data.FeaturesDataset(te_root, 40), 1,
                                "Chair")
    assert tr.shape == (20, 2) and te.shape == (4, 2)
    assert tr.min() >= 0 and tr.max() < 20


def test_convert_released_checkpoint_schema():
    """A state dict with the key names and shapes of the reference's released
    `trained_layers.pth` (`MID-FC/csa_models.py:146-180`: CrossShapeAt(
    num_classes, d_model=256, n_heads=8, K=4, d_k=d_v=256, 'csa',
    after_fc=True), including keys unused at eval like fc_1.* and
    num_batches_tracked) converts into exactly the port's state_dict."""
    n_cls = 39  # Chair
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {
        "fc_1.0.0.weight": arr(256, 928, 1, 1),
        "fc_1.0.1.weight": arr(256),
        "fc_1.0.1.bias": arr(256),
        "fc_1.0.1.running_mean": arr(256),
        "fc_1.0.1.running_var": np.abs(arr(256)),
        "fc_1.0.1.num_batches_tracked": np.asarray(100),
        "logit.weight": arr(n_cls, 256, 1, 1),
        "attention.w_qs.weight": arr(8 * 256, 256),
        "attention.w_ks.weight": arr(8 * 256, 256),
        "attention.w_vs.weight": arr(8 * 256, 256),
        "attention.fc.weight": torch.tensor(arr(256, 8 * 256)),
        "attention.norm.weight": arr(256),
        "attention.norm.bias": arr(256),
        "compatibility_q.weight": arr(256, 256),
        "compatibility_q.bias": arr(256),
        "compatibility_k.weight": arr(256, 256),
        "compatibility_k.bias": arr(256),
    }
    model = get_model("csa", n_cls, n_heads=8, K=4, chunk_size=None)
    converted = convert_state_dict(sd, after_fc=True)
    model.load_state_dict(converted, strict=True)
    np.testing.assert_array_equal(model.logit.weight.detach().numpy(),
                                  sd["logit.weight"][:, :, 0, 0])
    np.testing.assert_array_equal(
        model.attention.mha.w_qs.weight.detach().numpy(),
        sd["attention.w_qs.weight"])
    full = CrossShapeAt(num_classes=n_cls, K=4, attention_type="csa",
                        after_fc=False, chunk_size=None)
    full.load_state_dict(convert_state_dict(sd, after_fc=False), strict=True)
    np.testing.assert_array_equal(full.fc_1_bn.var.numpy(),
                                  sd["fc_1.0.1.running_var"])
    # the same numbers through the JAX package's converter and
    # flax_to_torch_midfc land on the same state_dict
    from csn_tpu.midfc.convert import convert_state_dict as j_convert

    sd_np = {k: np.asarray(v) for k, v in sd.items()}
    via_flax = flax_to_torch_midfc(*j_convert(sd_np, after_fc=True))
    assert set(via_flax) == set(converted)
    for name, t in converted.items():
        np.testing.assert_array_equal(via_flax[name].numpy(), t.numpy())

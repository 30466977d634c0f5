"""Port: the HRNet trainers (`csn_tpu_torch.train.trainer`) against the JAX
package's, both built by their `tasks/main_csn.build_trainer` from one
synthetic PartNet directory.

Small size: HRNetSimCSN2S, d_model 16, 2 heads, k3 stem, K=1, 4 train / 2
val / 2 test shapes of 48 points, batch 2, level caps shrinking by 1.5, f32,
attention dropout 0 on both models (the two frameworks cannot share a
dropout mask), SGD. The port's trainer starts from the JAX trainer's
initial state, converted by `load_jax_trainer_state`. Both trainers ship
their batches as they do by default: voxel features and interpolation
weights rounded through f16 (`to_jax(compact=True)`, `to_torch(compact=
True)`), so both models see the same numbers.

Held: the host batches of the first three `_fetch_data` calls bit-equal
(the two trainers draw from the same numpy generators in the same order);
the random-pair graph and the retrieved graph equal; the first iteration's
loss within 1e-5 relative; `validate()`'s quadruple within 1e-4 (loss
relative, the scores in percent absolute); checkpoint -> `resume()` restores
every tensor bit for bit and the host state exactly; `test_on` with and
without `cached_eval` agree (the cache is f16: loss within 1e-3 relative,
IoUs within 1e-3); `truncated_batch_size` and `neighbor_slot_indices` equal
on random inputs; the plateau -> reload-best -> rebuild state machine emits
the same event sequence as the JAX `CSNTrainer` under one script of
validation metrics. No many-step loss trajectory is compared: a ReLU input
within rounding of zero may fall on either side in the two frameworks.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

import csn_tpu.train.trainer as j_trainer_mod
import csn_tpu_torch.train.trainer as t_trainer_mod
from csn_tpu.config import Config as JConfig
from csn_tpu.data.partnet import write_synthetic_partnet
from csn_tpu.tasks.main_csn import build_trainer as j_build_trainer
from csn_tpu.train.optim import get_lr as j_get_lr
from csn_tpu.train.optim import set_lr as j_set_lr
from csn_tpu_torch.config import Config
from csn_tpu_torch.models.convert import load_jax_trainer_state
from csn_tpu_torch.tasks.main_csn import build_trainer
from csn_tpu_torch.train import steps

torch.set_num_threads(1)

BASE = dict(
    model="HRNetSimCSN2S", partnet_category="Display", batch_size=2,
    val_batch_size=2, test_batch_size=2, conv1_kernel_size=3, d_model=16,
    n_head=2, k_neighbors=1, max_epoch=2, stat_freq=100, lr=0.05,
    optimizer="SGD", scheduler="ReduceLROnPlateau", num_points=48,
    level_shrink=1.5, seed=0, compute_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("partnet_torch_trainer")
    write_synthetic_partnet(str(root), category="Display", n_train=4,
                            n_val=2, n_test=2, num_points=48)
    return str(root)


def _port_trainer(root, log_dir, **kw):
    cfg = Config(partnet_path=root, log_dir=log_dir, device="cpu",
                 **{**BASE, **kw}).normalized()
    t = build_trainer(cfg, phases=("train", "val"))
    t.model.attn_dropout = t.model.mha.dropout = 0.0
    return t


def _jax_trainer(root, log_dir, **kw):
    cfg = JConfig(partnet_path=root, log_dir=log_dir,
                  **{**BASE, **kw}).normalized()
    t = j_build_trainer(cfg, phases=("train", "val"))
    # the steps look the model up when they are first traced
    t.model = t.model.clone(attn_dropout=0.0)
    return t


@pytest.fixture(scope="module")
def pair(synth_root, tmp_path_factory):
    """(JAX trainer, port trainer) at the same initial state, with the
    random-pair graph built on both, and the host batches either builds
    recorded."""
    tmp = tmp_path_factory.mktemp("logs_torch_trainer")
    with pytest.MonkeyPatch.context() as mp:
        built = {"jax": [], "port": []}
        for mod, key in ((j_trainer_mod, "jax"), (t_trainer_mod, "port")):
            inner = mod.build_batch_from_dataset

            def spy(*a, _inner=inner, _log=built[key], **k):
                out = _inner(*a, **k)
                _log.append(out)
                return out

            mp.setattr(mod, "build_batch_from_dataset", spy)
        jt = _jax_trainer(synth_root, str(tmp / "jax"))
        pt = _port_trainer(synth_root, str(tmp / "port"))
        jt.initialize()
        pt.initialize()
        load_jax_trainer_state(pt, _np(jt.params), _np(jt.batch_stats))
        jt.construct_shape_graph(recalculate=False)
        pt.construct_shape_graph(recalculate=False)
        yield jt, pt, built
        jt._close_prefetch()
        pt._close_prefetch()


HOST_FIELDS = ("points", "point_feats", "labels", "point_mask", "vox_feats",
               "interp_idx", "interp_w", "point_to_voxel")


def _assert_host_batches_equal(a, b):
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for x, y in zip(a.masks, b.masks):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.coords, b.coords):
        np.testing.assert_array_equal(x, y)
    for name, y in b.kmaps.items():   # the JAX host may add window tables
        np.testing.assert_array_equal(a.kmaps[name], y, name)


def test_random_pair_graphs_equal(pair):
    jt, pt, _ = pair
    assert jt.train_dataset.neighbors == pt.train_dataset.neighbors
    assert jt.val_dataset.neighbors == pt.val_dataset.neighbors
    assert all(len(nb) == 1 and nb[0] != i
               for i, nb in pt.train_dataset.neighbors)


def test_first_three_train_batches_bit_equal(pair):
    """Query and neighbour batches of three `_fetch_data` calls: the same
    sampler permutation, `rng.spawn(1 + K)` and quantisation draws."""
    jt, pt, built = pair
    for _ in range(3):
        n_j, n_p = len(built["jax"]), len(built["port"])
        jt._fetch_data()
        qb, keys = pt._fetch_data()
        new_j, new_p = built["jax"][n_j:], built["port"][n_p:]
        assert len(new_j) == len(new_p) == 2     # query + K=1 key batch
        # the two are built in threads: order them by their labels' bytes
        order = lambda hb: hb.labels.tobytes()   # noqa: E731
        for a, b in zip(sorted(new_j, key=order), sorted(new_p, key=order)):
            _assert_host_batches_equal(a, b)
        assert qb.labels.device.type == "cpu" and len(keys) == 1
    # neighbour slot k of the key batch lines up with the query rows
    assert not np.array_equal(new_p[0].labels, new_p[1].labels)


def test_validate_matches_jax(pair):
    jt, pt, _ = pair
    ref, got = jt.validate(), pt.validate()
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0]), (got, ref)
    for g, r in zip(got[1:], ref[1:]):
        assert abs(g - r) <= 1e-4, (got, ref)


def test_retrieved_graphs_equal(pair):
    """`construct_shape_graph(recalculate=True)`: SSA descriptors of every
    shape, the retrieval measure, top-K with self-exclusion."""
    jt, pt, _ = pair
    jf, jm = jt._all_ssa_descriptors(jt.train_dataset)
    pf, pm = pt._all_ssa_descriptors(pt.train_dataset)
    np.testing.assert_array_equal(jm, pm)
    assert pf.dtype == np.float16 and pf.shape == jf.shape
    # both sides round the same f32 features to f16: one f16 ulp apart at most
    assert np.abs(pf.astype(np.float32) - jf.astype(np.float32)).max() \
        <= 2e-3 * np.abs(jf.astype(np.float32)).max()
    jt.construct_shape_graph(recalculate=True)
    pt.construct_shape_graph(recalculate=True)
    assert jt.train_dataset.neighbors == pt.train_dataset.neighbors
    assert jt.val_dataset.neighbors == pt.val_dataset.neighbors
    test_j = copy.copy(jt.val_dataset)
    test_p = copy.copy(pt.val_dataset)
    jt.construct_test_graph(test_j)
    pt.construct_test_graph(test_p)
    assert test_j.neighbors == test_p.neighbors


def test_cached_and_recomputed_test_on_agree(pair):
    _, pt, _ = pair
    state = pt.rng.bit_generator.state
    plain = pt.test_on(pt.val_dataset)
    pt.config.cached_eval = True
    try:
        pt.rng.bit_generator.state = state    # the same quantisation draws
        cached = pt.test_on(pt.val_dataset)
        assert pt._collection_cache[0].dtype == np.float16
        assert pt._collection_cache[0].shape[0] == len(pt.train_dataset)
    finally:
        pt.config.cached_eval = False
    assert abs(cached[0] - plain[0]) <= 1e-3 * abs(plain[0]), (cached, plain)
    for c, p in zip(cached[2:], plain[2:]):
        assert abs(c - p) / 100 <= 1e-3, (cached, plain)


def test_first_iteration_loss_matches_jax(pair):
    jt, pt, built = pair
    n_j, n_p = len(built["jax"]), len(built["port"])
    jqb, jkeys = jt._fetch_data()
    qb, keys = pt._fetch_data()
    loss_j = float(jt._grad_step(jt.params, jt.batch_stats, jqb, jkeys,
                                 jax.random.PRNGKey(0))[0])
    pt.optimizer.zero_grad(set_to_none=True)
    loss_p, pred = steps.grad_step(pt.model, qb, keys, pt.generator)
    assert abs(float(loss_p) - loss_j) <= 1e-5 * abs(loss_j)
    assert pred.shape == qb.labels.shape
    assert len(built["jax"]) - n_j == len(built["port"]) - n_p == 2


def test_checkpoint_resume_restores_everything(pair, synth_root, tmp_path):
    """After two real iterations (momentum buffers exist): save, then a
    fresh trainer's `resume()`."""
    _, pt, _ = pair
    pt.config.log_dir = str(tmp_path / "ck")
    pt.plateau = pt._new_plateau()
    pt.plateau.lr, pt.plateau.best, pt.plateau.cooldown_counter = 0.0125, \
        0.123, 7
    pt._train_iter()
    pt._train_iter()
    pt._close_prefetch()
    pt.curr_iter, pt.epoch = 7, 3
    pt.best_val_part_iou, pt.best_val_part_iou_iter = 12.5, 4
    pt.best_val_loss, pt.best_val_loss_iter = 0.75, 6
    pt.patience, pt.cooldown, pt.n_graph_construction = 3, 2, 2
    pt.save_checkpoint()
    log_dir = pt.config.log_dir
    for name in ("checkpoint_HRNetSimCSN2S.pt",
                 "checkpoint_HRNetSimCSN2S.pt.json", "weights.pt",
                 "weights.pt.json", "config.json"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    assert not [f for f in os.listdir(log_dir) if f.endswith(".tmp")]
    assert os.path.islink(os.path.join(log_dir, "weights.pt"))

    # config.json loads in both packages
    with open(os.path.join(log_dir, "config.json")) as f:
        saved = json.load(f)
    assert Config.from_dict(saved).to_dict() == pt.config.to_dict()
    assert JConfig.from_dict(saved).d_model == 16

    fresh = _port_trainer(synth_root, str(tmp_path / "other"),
                          resume=log_dir)
    fresh.initialize()
    fresh.plateau = fresh._new_plateau()
    fresh.resume()
    want, got = pt.model.state_dict(), fresh.model.state_dict()
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    ws, gs = pt.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert ws["param_groups"] == gs["param_groups"]
    assert set(ws["state"]) == set(gs["state"]) and len(ws["state"]) > 50
    for i, st in ws["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           gs["state"][i]["momentum_buffer"]), i
    hw, hg = pt._host_state(), fresh._host_state()
    assert hg.pop("iteration") == hw.pop("iteration") + 1
    assert hg.pop("epoch") == hw.pop("epoch") + 1
    assert hg == hw
    assert fresh.train_dataset.neighbors == pt.train_dataset.neighbors
    assert fresh.val_dataset.neighbors == pt.val_dataset.neighbors
    assert fresh.plateau.state_dict() == pt.plateau.state_dict()

    # --weights: the model only, the optimizer stays fresh
    w = _port_trainer(synth_root, str(tmp_path / "w"),
                      weights=os.path.join(log_dir, "weights.pt"))
    w.initialize()
    assert all(torch.equal(v, w.model.state_dict()[k])
               for k, v in want.items())
    assert not w.optimizer.state_dict()["state"]


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_load_jax_trainer_state_carries_the_optimizer(pair, synth_root,
                                                      tmp_path, kind):
    """A JAX trainer state after one optimizer step (momentum buffer or Adam
    moments, host state) loaded into a port trainer: the second step, from
    the same gradients, lands on the same parameters (<= 1e-6 * max(1,
    max|ref|) per tensor), and the host state reads back equal."""
    from csn_tpu.train.optim import TraceState
    from csn_tpu.train.optim import make_optimizer as j_make_optimizer
    from csn_tpu_torch.models.convert import flax_to_torch

    jt, _, _ = pair
    params, stats = _np(jt.params), _np(jt.batch_stats)
    rng = np.random.default_rng(5)
    g1, g2 = (jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32),
        params) for _ in range(2))
    t = _port_trainer(synth_root, str(tmp_path / kind), optimizer=kind)
    cfg = t.config
    opt = j_make_optimizer(kind, lr=cfg.lr, sgd_momentum=cfg.sgd_momentum,
                           sgd_dampening=cfg.sgd_dampening,
                           adam_beta1=cfg.adam_beta1,
                           adam_beta2=cfg.adam_beta2,
                           weight_decay=cfg.weight_decay)
    add = lambda p, u: p + u   # noqa: E731
    u1, st1 = opt.update(g1, opt.init(params), params)
    p1 = jax.tree_util.tree_map(add, params, u1)
    u2, _ = opt.update(g2, st1, p1)
    p2 = jax.tree_util.tree_map(add, p1, u2)
    moments = {}
    for sub in st1.inner_state:
        if isinstance(sub, TraceState):
            moments["momentum"] = _np(sub.momentum)
        elif hasattr(sub, "mu"):
            moments["adam"] = (_np(sub.mu), _np(sub.nu))
    assert len(moments) == 1
    host = dict(jt._host_state(), iteration=9, epoch=4, best_val_loss=0.5,
                best_val_loss_iter=7)
    host["csn_data"]["patience"] = 3

    t.initialize()
    load_jax_trainer_state(t, _np(p1), stats, opt_steps=1, host=host,
                           **moments)
    got_host = json.loads(json.dumps(t._host_state()))
    assert got_host == json.loads(json.dumps(host))
    named = dict(t.model.named_parameters())
    for name, g in flax_to_torch(g2, {}).items():
        named[name].grad = g
    t.optimizer.step()
    want = flax_to_torch(_np(p2), stats)
    got = t.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-6 * max(1.0, float(w.abs().max())), (name, err)


@pytest.mark.parametrize("seed", range(5))
def test_batch_rules_match_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 100, size=rng.integers(1, 9)).tolist()
    for limit in (0, -1, 1, 50, 150, 400, 10 ** 6):
        assert t_trainer_mod.truncated_batch_size(counts, limit) == \
            j_trainer_mod.truncated_batch_size(counts, limit)
    n, K = 12, int(rng.integers(1, 4))
    neighbors = [(i, rng.choice(n, K, replace=False).tolist())
                 for i in range(n)]
    idxs = rng.choice(n, 5, replace=False).tolist()
    got = t_trainer_mod.neighbor_slot_indices(neighbors, idxs, K)
    assert got == j_trainer_mod.neighbor_slot_indices(neighbors, idxs, K)
    assert len(got) == K and all(len(slot) == 5 for slot in got)


def test_truncated_batch_masks_the_overflow(synth_root, tmp_path):
    """`--train_limit_numpoints`: both packages mask the same shapes out."""
    pt = _port_trainer(synth_root, str(tmp_path / "p"))
    jt = _jax_trainer(synth_root, str(tmp_path / "j"))
    a = t_trainer_mod.build_batch_from_dataset(
        pt.train_dataset, [0, 1], pt.spec, np.random.default_rng(0), False,
        limit_numpoints=60)
    b = j_trainer_mod.build_batch_from_dataset(
        jt.train_dataset, [0, 1], jt.spec, np.random.default_rng(0), False,
        limit_numpoints=60)
    _assert_host_batches_equal(b, a)
    assert a.point_mask[0].any() and not a.point_mask[1].any()
    assert (a.labels[1] == 255).all() and not a.masks[0][1].any()


# -- the plateau -> reload-best -> rebuild state machine ----------------------

# (val loss, precision, part IoU, shape IoU) per validation
SCRIPT = [(1.0, 50.0, iou, iou) for iou in
          (10.0, 9.0, 9.0, 9.0, 9.0, 12.0, 9.0, 9.0, 9.0, 9.0, 9.0)]


def _drive(trainer, set_opt_lr, get_opt_lr):
    """Run `train()` with scripted validations, no-op iterations that only
    set the lr as the real ones do, and a graph stub; returns the events."""
    events, script = [], iter(SCRIPT)
    trainer.MAX_PATIENCE, trainer.MAX_COOLDOWN = 2, 1
    trainer.patience, trainer.cooldown = 2, 1
    n = len(trainer.train_dataset)

    def snapshot(what):
        events.append(dict(
            what=what, epoch=trainer.epoch, patience=trainer.patience,
            cooldown=trainer.cooldown, n_graph=trainer.n_graph_construction,
            opt_lr=round(get_opt_lr(), 6),   # the JAX lr is an f32
            lr=round(trainer._current_lr(), 9),
            plateau=(round(trainer.plateau.lr, 9),
                     trainer.plateau.num_bad_epochs,
                     trainer.plateau.cooldown_counter),
            best=(trainer.best_val_part_iou, trainer.best_val_part_iou_iter,
                  trainer.best_val_loss_iter)))

    def validate():
        snapshot("validate")
        return next(script)

    def graph(recalculate):
        snapshot(f"graph recalculate={recalculate}")
        trainer.train_dataset.neighbors = [(i, [(i + 1) % n])
                                           for i in range(n)]
        trainer.val_dataset.neighbors = [
            (i, [0]) for i in range(len(trainer.val_dataset))]

    def train_iter():
        set_opt_lr(trainer._current_lr())

    trainer.validate = validate
    trainer.construct_shape_graph = graph
    trainer._train_iter = train_iter
    trainer.train()
    snapshot("end")
    return events


def test_state_machine_events_match_jax(synth_root, tmp_path):
    kw = dict(max_epoch=len(SCRIPT), lr=0.04)
    pt = _port_trainer(synth_root, str(tmp_path / "port"), **kw)
    pt.initialize()
    jt = _jax_trainer(synth_root, str(tmp_path / "jax"), **kw)
    # a stand-in state: the state machine reads no weight, and tracing the
    # model only to fill the checkpoints would cost this test its time
    jt.params = {"w": np.ones(3, np.float32)}
    jt.batch_stats = {"m": np.zeros(3, np.float32)}
    jt.opt_state = jt.optimizer.init(jt.params)

    def j_set(lr):
        jt.opt_state = j_set_lr(jt.opt_state, lr)

    ref = _drive(jt, j_set, lambda: j_get_lr(jt.opt_state))
    got = _drive(pt, pt._set_lr,
                 lambda: pt.optimizer.param_groups[0]["lr"])
    assert got == ref
    # the script does exercise the machine: two rebuilds, a plateau lr cut
    # and its reset to config.lr by the reload
    whats = [e["what"] for e in got]
    assert whats.count("graph recalculate=True") == 2
    assert whats[0] == "graph recalculate=False"
    assert got[-1]["n_graph"] == 3
    lrs = [e["lr"] for e in got]
    assert 0.02 in lrs and lrs[0] == 0.04
    assert os.path.exists(os.path.join(
        pt.config.log_dir, "checkpoint_HRNetSimCSN2Sbest_part_iou.pt"))


def test_seg_trainer_runs_and_resumes(synth_root, tmp_path):
    """`SegTrainer` on HRNetSeg2S: two epochs, then a resumed third."""
    from csn_tpu_torch.tasks import main_seg

    cfg = Config(partnet_path=synth_root, log_dir=str(tmp_path / "seg"),
                 device="cpu", **{**BASE, "model": "HRNetSeg2S",
                                  "scheduler": "StepLR"}).normalized()
    t = main_seg.build_trainer(cfg)
    val = t.train()
    assert all(np.isfinite(val)) and t.curr_iter == 5 and t.K == 0
    cfg2 = Config.from_dict({**cfg.to_dict(), "resume": cfg.log_dir,
                             "max_epoch": 3})
    t2 = main_seg.build_trainer(cfg2)
    t2.train()
    assert t2.curr_iter == 6 + 2 and t2.epoch == 3
    with pytest.raises(ValueError, match="main_csn"):
        main_seg.build_trainer(Config.from_dict(
            {**cfg.to_dict(), "model": "HRNetSimCSN2S"}))

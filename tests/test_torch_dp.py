"""Port: data parallelism over a `torch.distributed` world
(`csn_tpu_torch/parallel/dp.py`, `parallel/collection.py` and the trainer's
data-parallel paths) against the JAX package's `shard_map` steps on the
virtual CPU mesh, and against the port's single-process trainer.

The ranks are processes of their own (tests/torch_ranks.py: gloo, one thread
each, started together in the background while this process computes its
references, with their own time limit); they import the port only and
write what they computed to files. Small size of tests/test_dist.py:
HRNetSimCSN2S, d_model 16, 2 heads, k3 stem, K=1, 2 shapes of 48 points
per rank, voxel 0.3, f32, attention dropout 0, the JAX model's initial
weights carried by `flax_to_torch`.

Held, at the JAX tests' tolerances (rtol 1e-4, atol 1e-5):
* worlds of 2 and 4 ranks: the DP eval step's losses, logits and
  predictions, `make_dp_eval_step`'s gathered logits and the SSA step
  against `make_dp_trainer_steps` / `make_dp_eval_step` on a mesh of the
  same size; at 2 ranks also the grad step's loss, every gradient (rank
  0's; the others' bitwise the same, by digest) and the averaged BatchNorm
  statistics; the parameters bitwise equal on every rank after two
  optimizer steps (sha256 digests of the model states);
* `sharded_retrieval_measure` (partial masks; N_k not a multiple of the
  world) against the JAX one and the port's `retrieval_measure` (1e-5);
* `shard_collection` + `exchange_rows` bitwise equal to direct indexing;
* the trainer in a world of 2 (`main_csn.build_trainer`, batch 1 per rank)
  against the single-process trainer at batch 2: `test_on` within 1e-4
  (loss relative, scores absolute), the shared generator `rng` at the same
  state after it (every rank builds every eval chunk: the draw order of
  the JAX trainer), the cached `test_on` (sharded cache, exchanged rows)
  within `test_cached_eval.py`'s tolerances of the recomputed one, the same
  retrieved graphs, a train iteration's loss within the JAX test's bound
  (train-mode BatchNorm statistics are per rank), and the parameters bitwise
  equal on both ranks;
* the trainer in a world of ONE (the only form one card runs) bitwise equal
  to the single-process trainer: two iterations' losses, every tensor of the
  model after them, `test_on` plain and cached, the graphs.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from csn_tpu.data.pipeline import collate_shapes as j_collate
from csn_tpu.data.pipeline import pyramid_spec_for_model as j_spec
from csn_tpu.data.partnet import write_synthetic_partnet
from csn_tpu.models import load_model as j_load_model
from csn_tpu.parallel import dp as j_dp
from csn_tpu_torch.models.convert import flax_to_torch
from csn_tpu_torch.retrieval.graph import retrieval_measure
from tests import torch_ranks as tr

torch.set_num_threads(1)

WORLDS = (2, 4)
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model():
    cls = j_load_model(tr.MODEL)
    spec = j_spec(cls, num_points=tr.N_POINTS, voxel_size=tr.VOXEL,
                  conv1_kernel_size=tr.STEM, shrink=tr.SHRINK)
    model = cls(out_channels=tr.OUT, conv1_kernel_size=tr.STEM,
                k_neighbors=1, d_model=tr.D_MODEL, n_head=tr.HEADS,
                attn_dropout=0.0)
    return model, spec


def _inputs():
    rng = np.random.default_rng(0)
    r1q = rng.normal(size=(6, 12, 8)).astype(np.float32)
    r1k = rng.normal(size=(5, 12, 8)).astype(np.float32)
    r1qm, r1km = np.ones((6, 12), bool), np.ones((5, 12), bool)
    r1qm[2, 8:] = False
    r1km[1, 5:] = False
    r2q = rng.normal(size=(11, 16, 8)).astype(np.float32)
    r2k = rng.normal(size=(7, 16, 8)).astype(np.float32)
    r2qm, r2km = rng.random((11, 16)) < 0.8, rng.random((7, 16)) < 0.8
    r2qm[:, 0] = r2km[:, 0] = True
    N, L0, d, B, K = 21, 6, 4, 3, 2
    x_idx = rng.integers(0, N, size=(max(WORLDS), B, K)).astype(np.int32)
    return dict(
        r1_q=r1q, r1_qm=r1qm, r1_k=r1k, r1_km=r1km, r2_q=r2q, r2_qm=r2qm,
        r2_k=r2k, r2_km=r2km,
        x_feats=rng.normal(size=(N, L0, d)).astype(np.float16),
        x_pools=rng.normal(size=(N, d)).astype(np.float32),
        x_masks=rng.random((N, L0)) > 0.3, x_idx=x_idx)


TRAINER = dict(
    model=tr.MODEL, partnet_category="Display", conv1_kernel_size=tr.STEM,
    d_model=tr.D_MODEL, n_head=tr.HEADS, k_neighbors=1,
    num_points=tr.N_POINTS, level_shrink=tr.SHRINK, lr=0.05,
    optimizer="SGD", seed=0, max_epoch=1, stat_freq=100, device="cpu")


def _trainer_cfg(root, log_dir, bs, iters, **kw):
    return json.dumps(dict(TRAINER, partnet_path=root, log_dir=log_dir,
                           batch_size=bs, val_batch_size=bs,
                           test_batch_size=bs, iters=iters, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world of this module, started at once: the step worlds of 2
    and 4 ranks (with the JAX model's weights), the trainer in a world of 2
    and in a world of one; and the inputs."""
    base = tmp_path_factory.mktemp("torch_dp")
    model, spec = _jax_model()
    q0 = j_collate(tr.make_shapes(2, tr.N_POINTS, 0), spec).to_jax()
    k0 = j_collate(tr.make_shapes(2, tr.N_POINTS, 100), spec).to_jax()
    variables = jax.jit(lambda r, b, ks: model.init(r, b, ks, train=False))(
        jax.random.PRNGKey(0), q0, (k0,))
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    inputs = _inputs()
    root = str(base / "partnet")
    write_synthetic_partnet(root, category="Display", n_train=8, n_val=3,
                            n_test=2, num_points=tr.N_POINTS)
    started = {}
    torch.save(flax_to_torch(params, stats), base / "state.pt")
    for n in WORLDS:
        out = base / f"steps{n}"
        out.mkdir()
        (out / "state.pt").symlink_to(base / "state.pt")
        np.savez(out / "inputs.npz", **inputs)
        started[n] = tr.start_ranks("dp_steps", n, out)
    for name, world, bs, iters in (("trainer2", 2, 1, 1),
                                   ("trainer1", 1, 2, 2)):
        out = base / name
        out.mkdir()
        started[name] = tr.start_ranks(
            "trainer", world, out, _trainer_cfg(
                root, str(out / "logs"), bs, iters, data_parallel=world))
    yield dict(model=model, spec=spec, params=params, stats=stats,
               inputs=inputs, root=root, base=base, worlds=started)
    for run in started.values():   # leave nothing running
        for p in run.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(base, ignore_errors=True)   # model states: ~80 MB each


def _stack(spec, seeds, mesh):
    return j_dp.shard_stacked(j_dp.stack_batches(
        [j_collate(tr.make_shapes(2, tr.N_POINTS, s), spec) for s in seeds]),
        mesh)


_JAX = {}


def _jax_dp(runs, n, grad):
    """The JAX package's DP steps on a mesh of n: (eval, ssa, dp eval
    logits, grad or None)."""
    key = (n, grad)
    if key not in _JAX:
        model, spec = runs["model"], runs["spec"]
        mesh = j_dp.make_mesh(n)
        sq = _stack(spec, range(n), mesh)
        sk = (_stack(spec, range(100, 100 + n), mesh),)
        g_step, e_step, s_step = j_dp.make_dp_trainer_steps(
            model, mesh, k_neighbors=1)
        p, s = runs["params"], runs["stats"]
        _JAX[key] = (
            _np(e_step(p, s, sq, sk)), np.asarray(s_step(p, s, sq)),
            np.asarray(j_dp.make_dp_eval_step(model, mesh, k_neighbors=1)(
                p, s, sq, sk)),
            _np(g_step(p, s, sq, sk, jax.random.PRNGKey(1))) if grad
            else None)
    return _JAX[key]


@pytest.mark.parametrize("n", WORLDS)
def test_dp_eval_and_ssa_steps_match_jax(runs, n):
    ranks = runs["worlds"][n].results()
    (loss, plog, pred), ssa, dp_logits, _ = _jax_dp(runs, n, grad=False)
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["eval_loss"], loss, RTOL, ATOL)
        np.testing.assert_allclose(rk["eval_logits"], plog[r], RTOL, ATOL)
        np.testing.assert_array_equal(rk["eval_pred"], pred)
        np.testing.assert_allclose(rk["ssa"], ssa, RTOL, ATOL)
        np.testing.assert_allclose(rk["dp_eval_logits"], dp_logits, RTOL,
                                   ATOL)


def test_dp_grad_step_matches_jax(runs):
    """Loss, gradients and the new BatchNorm statistics, averaged over 2
    ranks, against `make_dp_trainer_steps`' pmean."""
    ranks = runs["worlds"][2].results()
    _, _, _, (loss, grads, new_stats, pred) = _jax_dp(runs, 2, grad=True)
    ref_g = flax_to_torch(grads, {})
    ref_s = flax_to_torch({}, new_stats)
    # rank 0 writes its gradients; every rank their digest
    assert {k[5:] for k in ranks[0] if k.startswith("grad:")} == set(ref_g)
    for name, ref in ref_g.items():
        np.testing.assert_allclose(ranks[0]["grad:" + name], ref.numpy(),
                                   RTOL, ATOL, err_msg=name)
    for r, rk in enumerate(ranks):
        assert str(rk["grad_digest"]) == str(ranks[0]["grad_digest"])
        np.testing.assert_allclose(rk["grad_loss"], loss, RTOL, ATOL)
        np.testing.assert_array_equal(rk["grad_pred"], pred[r])
        assert {k[6:] for k in rk if k.startswith("stats:")} == set(ref_s)
        for name, ref in ref_s.items():
            np.testing.assert_allclose(rk["stats:" + name], ref.numpy(),
                                       RTOL, ATOL, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_parameters_bitwise_equal_across_ranks(runs, n):
    ranks = runs["worlds"][n].results()
    assert int(ranks[0]["n_tensors"]) > 50 and float(ranks[0]["moved"]) > 0
    for rk in ranks[1:]:
        assert str(rk["after_digest"]) == str(ranks[0]["after_digest"])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["r1", "r2"])
def test_sharded_retrieval_measure_matches_jax(runs, n, case):
    """r1: partial masks, 5 keys over n ranks; r2: 7 keys, random masks."""
    inp = runs["inputs"]
    args = [inp[f"{case}_{s}"] for s in ("q", "qm", "k", "km")]
    ref = np.asarray(j_dp.sharded_retrieval_measure(
        *args, j_dp.make_mesh(n)))
    single = retrieval_measure(*args, device="cpu")
    for rk in runs["worlds"][n].results():
        got = rk[f"measure_{case}"]
        assert got.shape == ref.shape == (args[0].shape[0], args[2].shape[0])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_exchange_rows_matches_direct_indexing(runs, n):
    """21 rows over n ranks (zero-padded to a multiple of n): every rank
    gets exactly the rows it asked for."""
    inp = runs["inputs"]
    idx = inp["x_idx"][:n]
    for r, rk in enumerate(runs["worlds"][n].results()):
        assert int(rk["x_per"]) == int(rk["x_shard_rows"]) == -(-21 // n)
        np.testing.assert_array_equal(rk["x_f"], inp["x_feats"][idx[r]])
        np.testing.assert_array_equal(rk["x_p"], inp["x_pools"][idx[r]])
        np.testing.assert_array_equal(rk["x_m"], inp["x_masks"][idx[r]])


def _single_trainer(runs, name, bs, iters):
    """The single-process trainer's run of `torch_ranks.trainer`."""
    key = ("single", name)
    if key not in _JAX:
        out = runs["base"] / f"single_{name}"
        out.mkdir()
        _JAX[key] = tr.trainer(0, 1, out, _trainer_cfg(
            runs["root"], str(out / "logs"), bs, iters))
    return _JAX[key]


def test_dp_trainer_matches_single_process(runs):
    ranks = runs["worlds"]["trainer2"].results()
    ref = _single_trainer(runs, "b2", 2, 1)
    assert int(ref["world"]) == 0
    for rk in ranks:
        assert int(rk["world"]) == 2
        got, want = rk["test_on"], ref["test_on"]
        assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0]), (got, want)
        np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-4)
        # the sharded cache against the recompute (f16 cache)
        c = rk["test_on_cached"]
        assert int(rk["cache_rows"]) == 4      # 8 train shapes over 2 ranks
        np.testing.assert_allclose(c[0], got[0], rtol=0, atol=2e-3)
        np.testing.assert_allclose(c[1], got[1], rtol=0, atol=5e-3)
        np.testing.assert_allclose(c[2:], got[2:], rtol=0, atol=0.5)
        np.testing.assert_array_equal(rk["graph_train"], ref["graph_train"])
        np.testing.assert_array_equal(rk["graph_val"], ref["graph_val"])
        # same shapes and weights; only train-mode BN statistics and the
        # chunks' quantisation draws differ
        assert np.isfinite(rk["losses"]).all()
        assert abs(rk["losses"][0] - ref["losses"][0]) \
            < 0.1 * abs(ref["losses"][0]) + 0.05
    assert str(ranks[1]["after_digest"]) == str(ranks[0]["after_digest"])
    assert float(ranks[0]["moved"]) > 0


def test_eval_batches_draw_as_the_jax_trainer(runs):
    """Every rank builds every eval chunk in chunk order from the shared
    `rng` (random-subsample quantisation draws at augment=False), so after
    `test_on` it stands where the single-process trainer's does, as the JAX
    trainer's one process builds them."""
    ref = _single_trainer(runs, "b2", 2, 1)
    for rk in runs["worlds"]["trainer2"].results():
        assert str(rk["rng_after"]) == str(ref["rng_after"])


def test_world_of_one_is_bitwise_the_single_process_trainer(runs):
    (rk,) = runs["worlds"]["trainer1"].results()
    ref = _single_trainer(runs, "b2_2iters", 2, 2)
    assert int(rk["world"]) == 1 and int(ref["world"]) == 0
    for key in ("losses", "test_on", "test_on_cached", "graph_train",
                "graph_val", "rng_after", "init_digest", "n_tensors",
                "after_digest"):
        np.testing.assert_array_equal(rk[key], ref[key], err_msg=key)
    assert float(rk["moved"]) > 0


def test_dp_world_checks():
    from csn_tpu_torch.parallel import dp

    with pytest.raises(ValueError, match="torch.distributed world of 2"):
        dp.make_dp_world(2, "cpu")   # no initialised world in this process
    # rank 0 draws the single-device trainer's seeds, the others their own
    assert dp.rank_generator(5, 0).initial_seed() == 5
    assert len({dp.rank_generator(5, r).initial_seed()
                for r in range(4)}) == 4

"""Port: collection parallelism (`csn_tpu_torch/parallel/cp.py`,
`HRNetSimCSN.cp_forward`) over ('data', 'col') grids of `gloo` ranks,
against the JAX package's single-device combined pass, as
`tests/test_cp.py` holds the JAX collection-parallel steps.

The ranks are processes of their own (tests/torch_ranks.py); member (d, c)
of the grid is the batch of seed 97 c + d, as in `tests/test_cp.py::build`.
Small size: HRNetSimCSN2S, d_model 16, 2 heads, k3 stem, 2 shapes of 48
points per member, voxel 0.3, f32, attention dropout 0, the JAX model's
initial weights carried by `flax_to_torch`.

Held, at `tests/test_cp.py`'s tolerances:
* eval logits and predictions against the combined pass for (K, n_data) =
  (1, 2) under BatchNorm (eval uses the running statistics: exact for any
  norm) and (2, 2) under instance norm: rtol 2e-4, atol 2e-5; the loss,
  the mean over data shards of col 0's loss, rel 1e-4;
* the gradients at (1, 1) under instance norm (each member normalised by
  itself, as in the combined pass) against the combined pass's: rtol 5e-4,
  atol 1e-5; the loss rel 1e-5. The masked seeding matters: seeding every
  rank's loss would double every gradient;
* under BatchNorm: the train step finite, the statistics moved, gradients
  finite and nonzero;
* every rank's parameters bitwise equal after an optimizer step (sha256
  digests of the model states; gradients compared on rank 0, the others'
  by digest);
* the trainer's product path (`main_csn.build_trainer`, `--data_parallel 4
  --collection_parallel True --k_neighbors 1`: a (2, 2) grid, batch 2 per
  data shard) against the single-process trainer at batch 4: the first
  iteration's loss within the JAX test's bound (train-mode BatchNorm
  statistics are per member), the parameters moved and bitwise equal on
  every rank, and `test_on` (data-parallel over all 4 ranks) finite;
* the flag and grid validation errors of the JAX package.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from csn_tpu.core.interp import interpolate_to_points
from csn_tpu.data.partnet import write_synthetic_partnet
from csn_tpu.data.pipeline import collate_shapes as j_collate
from csn_tpu.data.pipeline import pyramid_spec_for_model as j_spec
from csn_tpu.models import load_model as j_load_model
from csn_tpu.models.layers import NormType as JNorm
from csn_tpu.train.losses import cross_entropy_ignore, predict_nonzero
from csn_tpu_torch.models.convert import flax_to_torch
from tests import torch_ranks as tr
from tests.test_torch_dp import _trainer_cfg

torch.set_num_threads(1)

# (K, n_data, norm)
GRIDS = {"eval_bn": (1, 2, "BATCH_NORM"), "eval_in": (2, 2, "INSTANCE_NORM"),
         "grad_in": (1, 1, "INSTANCE_NORM")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_setup(K, n_data, norm):
    """`tests/test_cp.py::build`: (model, per_data, params, stats)."""
    cls = j_load_model(tr.MODEL)
    spec = j_spec(cls, num_points=tr.N_POINTS, voxel_size=tr.VOXEL,
                  conv1_kernel_size=tr.STEM, shrink=tr.SHRINK)
    model = cls(out_channels=tr.OUT, conv1_kernel_size=tr.STEM,
                k_neighbors=K, d_model=tr.D_MODEL, n_head=tr.HEADS,
                attn_dropout=0.0, norm_type=JNorm[norm])
    per_data = [[j_collate(tr.make_shapes(2, tr.N_POINTS, 97 * c + d),
                           spec).to_jax() for c in range(K + 1)]
                for d in range(n_data)]
    variables = jax.jit(lambda r, b, ks: model.init(r, b, ks, train=False))(
        jax.random.PRNGKey(0), per_data[0][0], tuple(per_data[0][1:]))
    return (model, per_data, _np(variables["params"]),
            _np(variables.get("batch_stats", {})))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_cp")
    setups, started = {}, {}
    for name, (K, n_data, norm) in GRIDS.items():
        setups[name] = _jax_setup(K, n_data, norm)
        _, _, params, stats = setups[name]
        out = base / name
        out.mkdir()
        torch.save(flax_to_torch(params, stats), out / "state.pt")
        started[name] = tr.start_ranks("cp_steps", n_data * (K + 1), out, K,
                                       n_data, norm)
    root = str(base / "partnet")
    write_synthetic_partnet(root, category="Display", n_train=8, n_val=4,
                            n_test=2, num_points=tr.N_POINTS)
    out = base / "trainer"
    out.mkdir()
    started["trainer"] = tr.start_ranks(
        "trainer", 4, out, _trainer_cfg(root, str(out / "logs"), 2, 1,
                                        data_parallel=4,
                                        collection_parallel=True,
                                        avg_feat=True))
    yield dict(setups=setups, worlds=started, base=base, root=root)
    for run in started.values():   # leave nothing running
        for p in run.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(base, ignore_errors=True)   # model states: ~80 MB each


def _combined(model, params, stats, qb, kbs):
    def logits(p, s, qb, kbs):
        out = model.apply({"params": p, "batch_stats": s}, qb, kbs,
                          train=False)
        return interpolate_to_points(out, qb.interp_idx, qb.interp_w,
                                     qb.point_to_voxel)

    return jax.jit(logits)(params, stats, qb, kbs)


@pytest.mark.parametrize("name", ["eval_bn", "eval_in"])
def test_cp_eval_matches_the_combined_pass(runs, name):
    K, n_data, _ = GRIDS[name]
    model, per_data, params, stats = runs["setups"][name]
    ranks = runs["worlds"][name].results()
    losses = []
    for d in range(n_data):
        qb, kbs = per_data[d][0], tuple(per_data[d][1:])
        ref = np.asarray(_combined(model, params, stats, qb, kbs))
        for c in range(K + 1):   # every rank of the col group: col 0's
            rk = ranks[d * (K + 1) + c]
            np.testing.assert_allclose(rk["eval_logits"], ref, rtol=2e-4,
                                       atol=2e-5)
            np.testing.assert_array_equal(rk["eval_pred"],
                                          np.asarray(predict_nonzero(ref)))
        losses.append(float(cross_entropy_ignore(
            ref, qb.labels, 255, qb.point_mask)))
    for rk in ranks:
        assert float(rk["eval_loss"]) == pytest.approx(np.mean(losses),
                                                       rel=1e-4)


def test_cp_grads_match_the_combined_pass(runs):
    model, per_data, params, stats = runs["setups"]["grad_in"]
    qb, kbs = per_data[0][0], tuple(per_data[0][1:])

    def ref_loss(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, qb, kbs,
                             train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(3)})
        pl = interpolate_to_points(out, qb.interp_idx, qb.interp_w,
                                   qb.point_to_voxel)
        return cross_entropy_ignore(pl, qb.labels, 255, qb.point_mask)

    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_loss))(params)
    ref_g = flax_to_torch(_np(ref_g), {})
    ranks = runs["worlds"]["grad_in"].results()
    assert {k[5:] for k in ranks[0] if k.startswith("grad:")} == set(ref_g)
    for name, ref in ref_g.items():
        np.testing.assert_allclose(ranks[0]["grad:" + name], ref.numpy(),
                                   rtol=5e-4, atol=1e-5, err_msg=name)
    for rk in ranks:   # the key rank's gradients: rank 0's bits
        assert str(rk["grad_digest"]) == str(ranks[0]["grad_digest"])
        assert float(rk["grad_loss"]) == pytest.approx(float(ref_l), rel=1e-5)


def test_cp_batchnorm_step_runs_finite(runs):
    for rk in runs["worlds"]["eval_bn"].results():
        assert np.isfinite(float(rk["grad_loss"]))
        assert float(rk["stats_moved"]) > 0
        g = float(rk["grad_abs_sum"])
        assert np.isfinite(g) and g > 0


@pytest.mark.parametrize("name", list(GRIDS) + ["trainer"])
def test_parameters_bitwise_equal_across_ranks(runs, name):
    ranks = runs["worlds"][name].results()
    assert int(ranks[0]["n_tensors"]) > 50 and float(ranks[0]["moved"]) > 0
    for rk in ranks[1:]:
        assert str(rk["after_digest"]) == str(ranks[0]["after_digest"])


def test_cp_trainer_product_path(runs):
    ranks = runs["worlds"]["trainer"].results()
    out = runs["base"] / "single"
    out.mkdir()
    ref = tr.trainer(0, 1, out, _trainer_cfg(
        runs["root"], str(out / "logs"), 4, 1, avg_feat=True))
    for rk in ranks:
        assert int(rk["world"]) == 4 and int(rk["n_col"]) == 2
        assert np.isfinite(rk["losses"]).all()
        assert abs(rk["losses"][0] - ref["losses"][0]) \
            < 0.1 * abs(ref["losses"][0]) + 0.05
        assert np.isfinite(rk["test_on"]).all()
    # one seed: the same initial weights
    assert str(ranks[0]["init_digest"]) == str(ref["init_digest"])


def test_cp_flag_and_grid_validation(tmp_path):
    from csn_tpu_torch.config import Config
    from csn_tpu_torch.parallel import cp
    from csn_tpu_torch.parallel.dp import DPWorld
    from csn_tpu_torch.tasks.main_csn import build_trainer

    root = str(tmp_path / "partnet")
    write_synthetic_partnet(root, category="Display", n_train=4, n_val=2,
                            n_test=2, num_points=tr.N_POINTS)
    common = dict(model=tr.MODEL, partnet_path=root,
                  partnet_category="Display", conv1_kernel_size=tr.STEM,
                  d_model=tr.D_MODEL, n_head=tr.HEADS,
                  num_points=tr.N_POINTS, level_shrink=tr.SHRINK, seed=0,
                  log_dir=str(tmp_path / "l"), device="cpu", batch_size=1)
    with pytest.raises(ValueError, match="divide"):
        build_trainer(Config(**common, k_neighbors=2, data_parallel=8,
                             collection_parallel=True).normalized())
    with pytest.raises(ValueError, match="k_neighbors >= 1"):
        build_trainer(Config(**common, k_neighbors=0, data_parallel=8,
                             collection_parallel=True).normalized())

    grid = cp.CPGrid(2, 2, 0, 0, None, DPWorld(4, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="col mesh axis"):
        cp.make_cp_trainer_steps(tr._model(2), grid, k_neighbors=2)
    with pytest.raises(ValueError, match="k_neighbors >= 1"):
        cp.make_cp_trainer_steps(tr._model(0), grid, k_neighbors=0)
    with pytest.raises(ValueError, match="torch.distributed world of 4"):
        cp.make_cp_grid(2, 2, "cpu")   # no initialised world here
    with pytest.raises(ValueError, match="cp_forward needs k_neighbors"):
        tr._model(0).cp_forward(None, 0, 1)

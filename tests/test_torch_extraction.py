"""Port: feature extraction, `get_csa_pred`, the launcher's `pred` mode, the
paper-figure accumulators, `collect_partnet_results`, `parity_session` and
the profiling helpers, against the JAX package where it has a counterpart
that runs on the CPU.

Small sizes: HRNetSeg2S with d_model 16 and a k3 stem on 6 shapes of 64
points; MID-FC heads with 2 heads of 8 or 16 channels on 24 to 48 points.
Tolerances: extracted `fc_1` features 1e-5 x max|ref| (f32 both sides,
different summation orders), labels and points equal, predictions equal on
>= 99.9 % of points; `get_csa_pred`'s part IoU equal to 1e-9 (the same
argmax on both sides); accumulator and collector outputs equal.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from csn_tpu.data import pipeline as j_pipeline
from csn_tpu.midfc import extraction as j_extraction
from csn_tpu.midfc import get_csa_pred as j_get_csa_pred
from csn_tpu.midfc import paper as j_paper
from csn_tpu.models import load_model as j_load_model
from csn_tpu.tasks import collect_partnet_results as j_collect
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.data.partnet import write_synthetic_partnet
from csn_tpu_torch.data.synthetic import SurfaceShapeDataset
from csn_tpu_torch.midfc import extraction, get_csa_pred, paper, run_training
from csn_tpu_torch.midfc.data import FeaturesDataset, write_synthetic_midfc
from csn_tpu_torch.midfc.training import (
    CHECKPOINT_NAME, MidfcConfig, MidfcRunner, _save,
)
from csn_tpu_torch.models import load_model
from csn_tpu_torch.models.convert import flax_to_torch
from csn_tpu_torch.tasks import collect_partnet_results, parity_session
from csn_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spec(pipe, cls):
    return pipe.pyramid_spec_for_model(cls, num_points=64, voxel_size=0.15,
                                       conv1_kernel_size=3, shrink=1.5)


def test_extract_split_files_equal_the_jax_functions(tmp_path):
    ds = SurfaceShapeDataset(5, 64, 3)     # 5 shapes: a ragged last batch
    kw = dict(out_channels=5, conv1_kernel_size=3, d_model=16)
    jm = j_load_model("HRNetSeg2S")(compute_dtype="float32", **kw)
    j_spec = _spec(j_pipeline, j_load_model("HRNetSeg2S"))
    spec = _spec(pipeline, load_model("HRNetSeg2S"))
    from csn_tpu.train.trainer import build_batch_from_dataset as j_build

    jb = j_build(ds, [0, 1], j_spec, np.random.default_rng(0),
                 augment=False).to_jax()
    variables = _np(jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = load_model("HRNetSeg2S")(**kw)
    tm.load_state_dict(flax_to_torch(variables["params"], stats),
                       strict=True)

    ref_root, got_root = str(tmp_path / "jax"), str(tmp_path / "torch")
    n_ref = j_extraction.extract_split(jm, variables, ds, j_spec, ref_root,
                                       batch_size=2)
    n_got = extraction.extract_split(tm, ds, spec, got_root, batch_size=2)
    assert n_ref == n_got == 5
    agree = total = 0
    for sub in ("fc_1", "point_labels", "pts", "midfc_pred"):
        names = sorted(os.listdir(os.path.join(ref_root, sub)))
        assert names == sorted(os.listdir(os.path.join(got_root, sub))) \
            == [f"{i:05d}.npy" for i in range(5)]
        for name in names:
            ref = np.load(os.path.join(ref_root, sub, name))
            got = np.load(os.path.join(got_root, sub, name))
            assert got.shape == ref.shape and got.dtype == ref.dtype, sub
            if sub == "fc_1":
                assert ref.shape[:2] == (1, 16) and ref.shape[3] == 1
                assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
            elif sub == "midfc_pred":
                agree += int((got == ref).sum())
                total += ref.size
                assert got.min() >= 1
            else:
                np.testing.assert_array_equal(got, ref)
    assert agree >= 0.999 * total


def test_export_features_and_export_from_model(tmp_path):
    rng = np.random.default_rng(0)
    shapes = [(f"s{i}", rng.normal(size=(7 + i, 4)).astype(np.float32),
               rng.integers(0, 3, size=7 + i)) for i in range(3)]
    extraction.export_features(str(tmp_path / "t"), shapes)
    j_extraction.export_features(str(tmp_path / "j"), shapes)
    for sub in ("fc_1", "point_labels"):
        for i in range(3):
            a = np.load(tmp_path / "t" / sub / f"s{i}.npy")
            b = np.load(tmp_path / "j" / sub / f"s{i}.npy")
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cls = load_model("HRNetSimCSN2S")
    model = cls(out_channels=5, conv1_kernel_size=3, d_model=16, n_head=2,
                k_neighbors=0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ds = SurfaceShapeDataset(2, 64, 0)
    hb = pipeline.collate_shapes([ds.get(i) for i in range(2)],
                                 _spec(pipeline, cls))
    extraction.export_from_model(str(tmp_path / "m"), model, [hb],
                                 ["a", "b"])
    f = np.load(tmp_path / "m" / "fc_1" / "a.npy")
    lab = np.load(tmp_path / "m" / "point_labels" / "a.npy")
    assert f.shape == (1, 16, 64, 1) and lab.shape == (64,)
    assert np.isfinite(f).all()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """raw point clouds -> extractor training + dumps (the CLI) -> SSA ->
    kNN graphs -> CSA -> get_csa_pred, everything through the entry points
    with `--device cpu`."""
    base = str(tmp_path_factory.mktemp("extract_chain"))
    root = os.path.join(base, "partnet")
    write_synthetic_partnet(root, category="Bed", n_train=4, n_val=2,
                            n_test=2, num_points=48)
    feats = os.path.join(base, "features")
    from csn_tpu_torch.tasks.extract_features import main as extract_main

    counts = extract_main([
        "--partnet_path", root, "--partnet_category", "Bed",
        "--model", "HRNetSeg2S", "--conv1_kernel_size", "3",
        "--d_model", "16", "--batch_size", "2", "--val_batch_size", "2",
        "--test_batch_size", "2", "--max_epoch", "1", "--stat_freq", "100",
        "--num_points", "48", "--level_shrink", "1.5",
        "--log_dir", os.path.join(base, "seg_logs"),
        "--save_pred_dir", feats, "--seed", "0", "--device", "cpu"])
    logs = os.path.join(base, "logs")
    common = ["--data_root", feats, "--logs_root", logs, "--start", "0",
              "--end", "0", "--testing", "--d_model", "16", "--num_points",
              "48", "--chunk_size", "24", "--n_heads", "2", "--K", "1",
              "--batch_size", "2", "--device", "cpu"]
    ious = {at: run_training.main(common + ["--attention_type", at])
            for at in ("ssa", "save_knn", "csa")}
    return dict(base=base, feats=feats, logs=logs, counts=counts, ious=ious,
                common=common)


def test_extract_to_csa_chain_writes_the_contract(chain):
    assert chain["counts"] == {"train": 4, "test": 2}
    train_root = os.path.join(chain["feats"], "train", "Bed")
    f0 = np.load(os.path.join(train_root, "fc_1", "00000.npy"))
    assert f0.ndim == 4 and f0.shape[:2] == (1, 16) and f0.shape[3] == 1
    l0 = np.load(os.path.join(train_root, "point_labels", "00000.npy"))
    assert l0.shape[0] == f0.shape[2]
    for sub in ("pts", "midfc_pred"):
        assert os.path.exists(os.path.join(train_root, sub, "00000.npy"))
    graph = np.load(os.path.join(chain["logs"], "knn_graphs", "n_heads_2",
                                 "Bed", "train.npy"))
    assert graph.shape == (4, 2) and (graph[:, 0] == np.arange(4)).all()
    assert 0.0 <= chain["ious"]["csa"]["Bed"] <= 100.0
    assert os.path.exists(os.path.join(
        chain["logs"], "sgd_csa_n_heads_2_K_1", "run_1", "Bed",
        CHECKPOINT_NAME))


def test_get_csa_pred_and_pred_mode_on_the_chain(chain, tmp_path):
    ckpt = os.path.join(chain["logs"], "sgd_csa_n_heads_2_K_1", "run_1",
                        "Bed", CHECKPOINT_NAME)
    graph_dir = os.path.join(chain["logs"], "knn_graphs", "n_heads_2", "Bed")
    args = ["--data_root", chain["feats"], "--partname", "Bed",
            "--num_classes", "15", "--n_heads", "2", "--K", "1",
            "--chunk_size", "24", "--d_model", "16", "--num_points", "48",
            "--batch_size", "2", "--device", "cpu", "--ckpt", ckpt]
    iou = get_csa_pred.main(args + [
        "--knn_graph_dir", graph_dir, "--logs_dir", str(tmp_path / "a"),
        "--save_pred_dir", str(tmp_path / "preds")])
    assert 0.0 <= iou <= 1.0
    assert (tmp_path / "a" / "part_IoU_summaries.csv").read_text() \
        == f",Bed\n0,{iou * 100}\n"
    assert sorted(os.listdir(tmp_path / "preds" / "midfc_csa_K_1")) \
        == ["shape_0.npy", "shape_1.npy"]
    # without a saved graph the test graph is computed from the model
    iou2 = get_csa_pred.main(args + ["--logs_dir", str(tmp_path / "b")])
    assert 0.0 <= iou2 <= 1.0

    # the launcher's pred mode over the pretrained_models layout
    cat_dir = os.path.join(chain["logs"], "pretrained_models", "run_1", "Bed")
    os.makedirs(cat_dir)
    shutil.copy(ckpt, os.path.join(cat_dir, CHECKPOINT_NAME))
    g2 = os.path.join(chain["logs"], "pretrained_models", "knn_graphs",
                      "n_heads_2", "Bed")
    shutil.copytree(graph_dir, g2)
    ious = run_training.main(chain["common"] + ["--attention_type", "pred"])
    assert set(ious) == {"Bed"} and ious["Bed"] == pytest.approx(iou * 100)
    assert os.path.exists(os.path.join(cat_dir, "part_IoU_summaries.csv"))
    summary = os.path.join(chain["logs"], "pretrained_models", "run_1",
                           "part_IoU_summaries.csv")
    assert open(summary).read().startswith(",Bed,mean\n0,")


def _reference_csa_checkpoint(rng, d, heads, n_cls):
    """A state dict in the key schema of the reference's released
    `trained_layers.pth` (`MID-FC/csa_models.py:146-180`), at width d."""
    arr = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.3).astype(np.float32))
    sd = {"logit.weight": arr(n_cls, d, 1, 1),
          "attention.norm.weight": arr(d) + 1.0,
          "attention.norm.bias": arr(d),
          "fc_1.0.1.num_batches_tracked": torch.tensor(3)}
    for n in ("w_qs", "w_ks", "w_vs"):
        sd[f"attention.{n}.weight"] = arr(heads * d, d)
    sd["attention.fc.weight"] = arr(d, heads * d)
    for n in ("compatibility_q", "compatibility_k"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = arr(d, d), arr(d)
    return sd


def test_get_csa_pred_iou_equals_the_jax_entry_points(tmp_path):
    P, D, heads, K, cat, n_cls = 24, 8, 2, 2, "Bed", 15
    root = str(tmp_path / "features")
    for split, n in (("train", 5), ("test", 4)):
        write_synthetic_midfc(os.path.join(root, split, cat), n_shapes=n,
                              num_points=P, channels=D, num_classes=6,
                              seed=split == "test")
    pth = str(tmp_path / "trained_layers.pth")
    torch.save(_reference_csa_checkpoint(np.random.default_rng(0), D, heads,
                                         n_cls), pth)
    graph_dir = tmp_path / "graphs"
    os.makedirs(graph_dir)
    np.save(graph_dir / "test.npy",
            np.array([[0, 3, 1], [2, 4, 0], [1, 0, 2], [4, 2, 3]]))
    args = ["--data_root", root, "--partname", cat, "--num_classes",
            str(n_cls), "--n_heads", str(heads), "--K", str(K),
            "--chunk_size", str(P // 2), "--d_model", str(D),
            "--num_points", str(P), "--batch_size", "2", "--torch_ckpt", pth,
            "--knn_graph_dir", str(graph_dir)]
    ref = j_get_csa_pred.main(args + ["--logs_dir", str(tmp_path / "j")])
    got = get_csa_pred.main(args + ["--logs_dir", str(tmp_path / "t"),
                                    "--device", "cpu"])
    assert 0.0 < ref < 1.0
    assert got == pytest.approx(ref, abs=1e-9)
    # and with full attention (chunk_size 0)
    full = [a if a != str(P // 2) else "0" for a in args]
    ref = j_get_csa_pred.main(full + ["--logs_dir", str(tmp_path / "j0")])
    got = get_csa_pred.main(full + ["--logs_dir", str(tmp_path / "t0"),
                                    "--device", "cpu"])
    assert got == pytest.approx(ref, abs=1e-9)


def _paper_tree(root, rng, n=4, P=24, C=8, ncls=5):
    for split in ("train", "test"):
        droot = os.path.join(root, "data", split, "Chair")
        write_synthetic_midfc(droot, n_shapes=n, num_points=P, channels=C,
                              num_classes=ncls, seed=0)
        for sub in ("pts", "midfc_pred"):
            os.makedirs(os.path.join(droot, sub), exist_ok=True)
        for i in range(n):
            h = P - (i % 3) * 5
            np.save(os.path.join(droot, "pts", f"shape_{i}.npy"),
                    rng.normal(size=(h, 3)).astype(np.float32))
            np.save(os.path.join(droot, "midfc_pred", f"shape_{i}.npy"),
                    rng.integers(0, ncls, size=(h,)))


def test_paper_accumulators_match_jax(tmp_path):
    root = str(tmp_path)
    n, P, C, ncls = 4, 24, 8, 5
    _paper_tree(root, np.random.default_rng(0), n, P, C, ncls)
    cfg = MidfcConfig(logs_dir=os.path.join(root, "logs"), partname="Chair",
                      num_classes=ncls, n_heads=1, K=1, batch_size=2,
                      chunk_size=P // 2, num_points=P, d_model=C)
    runner = MidfcRunner(cfg, "ssa", device="cpu")
    runner.initialize()
    ds = FeaturesDataset(os.path.join(root, "data", "test", "Chair"), P)
    pred_root = os.path.join(root, "preds", "Chair")
    wrote = paper.save_predictions(
        runner, ds, os.path.join(pred_root, "midfc_ssa"), is_csa=False)
    assert wrote == n
    p0 = np.load(os.path.join(pred_root, "midfc_ssa", "shape_0.npy"))
    assert p0.shape == (P,) and 0 <= p0.min() and p0.max() < ncls
    shutil.copytree(os.path.join(pred_root, "midfc_ssa"),
                    os.path.join(pred_root, "midfc_csa_K_1"))
    for mod, out in ((paper, "t"), (j_paper, "j")):
        assert mod.accumulate_predictions(
            os.path.join(root, "data"), "Chair",
            os.path.join(root, out, "render"),
            pred_root=os.path.join(root, "preds"), K=1, split="test") == n
        assert mod.accumulate_neigh(
            os.path.join(root, "data"), "Chair",
            os.path.join(root, out, "neigh"), split="train") == n
    for sub, width in (("render", 7), ("neigh", 4)):
        for i in range(n):
            a = np.load(os.path.join(root, "t", sub, "Chair",
                                     f"shape_{i}.npy"))
            b = np.load(os.path.join(root, "j", sub, "Chair",
                                     f"shape_{i}.npy"))
            assert a.shape[1] == width
            np.testing.assert_array_equal(a, b)
    paper.main(["--mode", "neighbors", "--data_root",
                os.path.join(root, "data"), "--partname", "Chair",
                "--render_root", os.path.join(root, "cli")])
    assert len(os.listdir(os.path.join(root, "cli", "Chair"))) == n


def test_collect_partnet_results_matches_jax(tmp_path, capsys):
    for cat, (s, p) in (("Bed", (41.5, 30.25)), ("Chair", (60.0, 44.0))):
        d = tmp_path / f"{cat}_run" / "results"
        os.makedirs(d)
        (d / "results_log.txt").write_text(
            f"header\nShape IoU: {s}\nPart IoU: {p}\n")
    os.makedirs(tmp_path / "Lamp_x" / "results")
    (tmp_path / "Lamp_x" / "results" / "results_log.txt").write_text("died\n")
    rows = collect_partnet_results.main(["--results_root", str(tmp_path)])
    out = capsys.readouterr().out
    ref = j_collect.main(["--results_root", str(tmp_path)])
    assert rows == ref == [("Bed", 41.5, 30.25), ("Chair", 60.0, 44.0)]
    assert out == capsys.readouterr().out
    assert "Lamp: UNPARSEABLE" in out and "Vase: MISSING" in out
    assert "AVG(2 cats)\tShapeIoU=50.75\tPartIoU=37.12" in out
    assert collect_partnet_results.parse_results_log(
        str(tmp_path / "Bed_run" / "results" / "results_log.txt")) \
        == (41.5, 30.25)


def test_parity_session_rehearsal_with_expected_csv(tmp_path, capsys):
    """The MID-FC branch of the session on synthetic stand-ins: a checkpoint
    of the port, feature dumps and kNN graphs; PASS against the directly
    evaluated IoU, FAIL against a wrong one and for a planned category
    without artifacts, exit 2 with nothing to run."""
    cat, P, C, K, heads = "Bed", 24, 8, 1, 2
    feats = str(tmp_path / "features")
    for split, n in (("train", 3), ("test", 2)):
        write_synthetic_midfc(os.path.join(feats, split, cat), n_shapes=n,
                              num_points=P, channels=C, num_classes=5, seed=0)
    cfg = MidfcConfig(partname=cat, num_classes=15, n_heads=heads, K=K,
                      batch_size=1, d_model=C, chunk_size=P // 2,
                      num_points=P)
    runner = MidfcRunner(cfg, "csa", device="cpu")
    runner.initialize()
    ckpts = tmp_path / "ckpts"
    os.makedirs(ckpts / cat)
    _save(runner.params, str(ckpts / cat / CHECKPOINT_NAME))
    graphs = tmp_path / "graphs" / f"n_heads_{heads}" / cat
    os.makedirs(graphs)
    np.save(str(graphs / "test.npy"), np.array([[0, 1], [1, 0]]))
    flags = ["--n_heads", str(heads), "--K", str(K), "--chunk_size",
             str(P // 2), "--d_model", str(C), "--num_points", str(P),
             "--device", "cpu"]
    exp = get_csa_pred.main(
        ["--data_root", feats, "--partname", cat, "--num_classes", "15",
         "--ckpt", str(ckpts / cat / CHECKPOINT_NAME),
         "--knn_graph_dir", str(graphs),
         "--logs_dir", str(tmp_path / "direct")] + flags) * 100
    session = flags + ["--midfc_ckpts", str(ckpts), "--midfc_features", feats,
                       "--knn_graphs", str(tmp_path / "graphs")]
    good = tmp_path / "good.csv"
    good.write_text(f"category,iou,tol\n{cat},{exp:.6f},0.01\n")
    capsys.readouterr()
    rc = parity_session.main(session + [
        "--out", str(tmp_path / "out"), "--categories", cat,
        "--expected_csv", str(good)])
    out = capsys.readouterr().out
    assert rc == 0 and "PARITY SESSION: PASS" in out
    assert f"midfc,{cat}," in (tmp_path / "out" /
                               "parity_report.csv").read_text()
    bad = tmp_path / "bad.csv"
    bad.write_text(f"{cat},{exp + 5.0:.6f},0.01\n")
    assert parity_session.main(session + [
        "--out", str(tmp_path / "out_bad"), "--categories", cat,
        "--expected_csv", str(bad)]) == 1
    two = tmp_path / "two.csv"
    two.write_text(f"{cat},{exp:.6f},0.01\nChair,50.0,0.01\n")
    assert parity_session.main(session + [
        "--out", str(tmp_path / "out_two"), "--expected_csv", str(two)]) == 1
    assert "planned but not measured" in capsys.readouterr().out
    assert parity_session.main(["--out", str(tmp_path / "none")]) == 2
    assert parity_session.MIDFC_EXPECTED["Chair"] == 55.69
    assert parity_session.MINK_MEAN_EXPECTED["HRNetSimCSN3S"] == 49.9


def test_profiling_helpers(tmp_path):
    model = load_model("HRNetSeg2S")(out_channels=5, conv1_kernel_size=3,
                                     d_model=16)
    stats = profiling.param_stats(model)
    assert stats["__total__"] == sum(p.numel() for p in model.parameters())
    assert stats["conv0/kernel"] == 27 * 3 * 32
    assert profiling.param_stats(model.state_dict())["__total__"] \
        > stats["__total__"]          # the running statistics count too
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("region"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "region" in text

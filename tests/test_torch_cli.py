"""Port: the command-line entry points `csn_tpu_torch.tasks.main_csn` and
`main_seg`, run as a user runs them (`python -m ... --device cpu`) on a
synthetic PartNet directory: two epochs of training, then `--is_train False
--resume`, which writes `results_log.txt`. Also: the settings the port does
not run yet raise with the ROADMAP item in the message, and no module of the
port imports the JAX package (h5py only inside the PartNet reader and
writer).

Small size: 4 train / 2 val / 2 test shapes of 48 points, HRNetSimCSN2S /
HRNetSeg2S, d_model 16, 2 heads, k3 stem, batch 2, f32 on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from csn_tpu_torch.config import Config, get_config
from csn_tpu_torch.data.partnet import write_synthetic_partnet

REPO = Path(__file__).resolve().parents[1]
COMMON = ["--partnet_category", "Display", "--batch_size", "2",
          "--val_batch_size", "2", "--test_batch_size", "2",
          "--conv1_kernel_size", "3", "--d_model", "16", "--n_head", "2",
          "--max_epoch", "2", "--stat_freq", "1", "--num_points", "48",
          "--level_shrink", "1.5", "--seed", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("partnet_torch_cli")
    write_synthetic_partnet(str(root), category="Display", n_train=4,
                            n_val=2, n_test=2, num_points=48)
    return str(root)


def _run(module, args, **env):
    return subprocess.run(
        [sys.executable, "-m", f"csn_tpu_torch.tasks.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **env})


@pytest.mark.parametrize("module,model,extra,dyng", [
    ("main_csn", "HRNetSimCSN2S", ["--k_neighbors", "1"], "0"),
    ("main_csn", "HRNetSimCSN2S", ["--k_neighbors", "1", "--cached_eval",
                                   "True"], "2"),
    ("main_seg", "HRNetSeg2S", [], "0")])
def test_cli_trains_then_evaluates(synth_root, tmp_path, module, model,
                                   extra, dyng):
    logs, pred = str(tmp_path / "logs"), str(tmp_path / "pred")
    res = _run(module, ["--is_train", "True", "--model", model,
                        "--partnet_path", synth_root, "--log_dir", logs,
                        *extra, *COMMON], CSN_DYNG=dyng)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Epoch[2]" in res.stderr and "Loss" in res.stderr
    for name in (f"checkpoint_{model}.pt", f"checkpoint_{model}.pt.json",
                 f"checkpoint_{model}best_part_iou.pt", "weights.pt",
                 "config.json", "metrics.jsonl"):
        assert os.path.exists(os.path.join(logs, name)), name
    # the eval run takes the model and its sizes from the saved config.json
    res = _run(module, ["--is_train", "False", "--resume", logs,
                        "--partnet_path", synth_root, "--partnet_category",
                        "Display", "--save_pred_dir", pred, "--device", "cpu"],
               CSN_DYNG=dyng)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Loaded checkpoint" in res.stderr and "Test: loss" in res.stderr
    text = open(os.path.join(pred, "results_log.txt")).read()
    assert text.startswith("Shape IoU: ") and "\nPart IoU: " in text
    for line in text.splitlines():
        assert 0.0 <= float(line.split(": ")[1]) <= 100.0


def test_data_parallel_raises_with_the_roadmap_item(synth_root, tmp_path):
    from csn_tpu_torch.tasks.main_csn import build_trainer

    for kw in (dict(data_parallel=2), dict(collection_parallel=True)):
        cfg = Config(model="HRNetSimCSN2S", partnet_path=synth_root,
                     partnet_category="Display", device="cpu",
                     log_dir=str(tmp_path), **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            build_trainer(cfg)


def test_pth_weights_raise_with_the_roadmap_item(synth_root, tmp_path):
    """`--weights x.pth` goes through the MinkowskiEngine converter (ROADMAP
    A11, done): a file that is no such checkpoint raises the converter's
    error naming the missing key, and nothing is "not ported"."""
    import torch

    from csn_tpu_torch.tasks.main_csn import build_trainer

    pth = tmp_path / "released.pth"
    torch.save({"state_dict": {"conv0s1.kernel": torch.zeros(27, 3, 32)}},
               pth)
    cfg = Config(model="HRNetSimCSN2S", partnet_path=synth_root,
                 partnet_category="Display", conv1_kernel_size=3, d_model=16,
                 n_head=2, num_points=48, level_shrink=1.5, batch_size=2,
                 device="cpu", log_dir=str(tmp_path), weights=str(pth))
    trainer = build_trainer(cfg)
    with pytest.raises(KeyError, match="bn0s1.bn.weight"):
        trainer.initialize()


def test_config_auto_resolves_from_the_device():
    cpu, card = get_config(["--device", "cpu"]), get_config([])
    assert card.device == "cuda"
    assert (cpu.resolved_compute_dtype(), cpu.resolved_use_flash()) == \
        ("float32", False)
    assert (card.resolved_compute_dtype(), card.resolved_use_flash()) == \
        ("bfloat16", True)
    assert get_config(["--compute_dtype", "float32"]
                      ).resolved_compute_dtype() == "float32"
    with pytest.raises(ValueError, match="follows the device"):
        get_config(["--device", "cpu", "--use_flash", "true"]
                   ).check_supported()


def test_config_json_is_shared_with_the_jax_package():
    """Every field of the JAX package's Config is kept, `device` is the one
    addition, and each loads the other's dict."""
    import dataclasses

    from csn_tpu.config import Config as JConfig

    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(Config)}
    assert set(t) - set(j) == {"device"} and not set(j) - set(t)
    assert all(t[k] == v for k, v in j.items())
    assert Config.from_dict(JConfig(d_model=64).to_dict()).d_model == 64
    assert JConfig.from_dict(Config(d_model=64, device="cpu").to_dict()
                             ).d_model == 64


BANNED = {"jax", "jaxlib", "flax", "optax", "bench", "csn_tpu"}
H5PY_OK = {("csn_tpu_torch/data/partnet.py", "__init__"),
           ("csn_tpu_torch/data/partnet.py", "write_synthetic_partnet")}


def _imports(tree):
    """(module root, enclosing function or None) of every import."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            here = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], fn))
            walk(child, here)

    walk(tree, None)
    return out


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "csn_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 55
    assert REPO / "csn_tpu_torch" / "probes" / "dyngather.py" in files
    for path in files:
        rel = path.relative_to(REPO).as_posix()
        for root, fn in _imports(ast.parse(path.read_text())):
            assert root not in BANNED, (rel, root)
            if root == "h5py":
                assert (rel, fn) in H5PY_OK, (rel, fn)

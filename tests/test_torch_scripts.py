"""Port: the launch scripts of `csn_tpu_torch/scripts/` (the counterparts
of `scripts/*.sh`), run as a user runs them, with `DEVICE=cpu`.

Two tiny synthetic categories (Display and Clock) are trained through
`train_csn.sh` (`train_hrnet.sh`), each into the default log-dir layout
under a working directory; then one `testing_csn.sh all 1 <base>`
(`testing_hrnet.sh all <base>`) run must find each category's `.pt`
checkpoint, evaluate it, write its `results_log.txt`, report "no
checkpoint found" for the other 15 categories, aggregate the two through
the port's `collect_partnet_results` and exit 0. Runs of the other family,
of another K and an older run of the same model lie under the same base:
none of them is evaluated or aggregated. A named category without a
checkpoint exits 1, and `--show_categories` lists the 17 categories.

The static checks: every flag that a script passes to a task is one that
the task's parser takes (`csn_tpu_torch.config`'s fields for the trainers
and the extraction, the collector's own for the aggregation); no script
names a module of the JAX package; `partnet_categories.sh`'s lists equal the
port's table and the JAX scripts' copy; `bash -n` passes on each script.

Small size: 4 train / 2 val / 2 test shapes of 48 points, HRNetSimCSN2S /
HRNetSeg2S, d_model 16, 2 heads, k3 stem, batch 2, one epoch, f32 on the
CPU.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from csn_tpu_torch.config import _add_args
from csn_tpu_torch.data.partnet import (CATEGORIES, TRAIN_COUNTS,
                                        write_synthetic_partnet)
from csn_tpu_torch.tasks import collect_partnet_results

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "csn_tpu_torch" / "scripts"
NAMES = ("partnet_categories", "train_csn", "test_csn", "training_csn",
         "testing_csn", "train_hrnet", "test_hrnet", "training_hrnet",
         "testing_hrnet", "extract_features_all")
TRAINED = ("Display", "Clock")
SMALL = ["--val_batch_size", "2", "--test_batch_size", "2",
         "--conv1_kernel_size", "3", "--d_model", "16", "--n_head", "2",
         "--num_points", "48", "--level_shrink", "1.5", "--seed", "0"]
# family -> (train script, its positional arguments before the extra flags,
# testing script, its arguments before the base dir, model, run-dir name)
FAMILIES = {
    "csn": ("train_csn.sh", ["1"], "testing_csn.sh", ["1"], "HRNetSimCSN2S",
            "HRNetSimCSN2S-K1"),
    "hrnet": ("train_hrnet.sh", [], "testing_hrnet.sh", [], "HRNetSeg2S",
              "HRNetSeg2S"),
}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("partnet_torch_scripts")
    for cat in TRAINED:
        write_synthetic_partnet(str(root), category=cat, n_train=4, n_val=2,
                                n_test=2, num_points=48)
    return str(root)


def _bash(script, *args, cwd, **env):
    """`bash csn_tpu_torch/scripts/<script> args...` from `cwd`, with the
    port importable and `python` the interpreter running the tests."""
    path = os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"]
    pythonpath = os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    return subprocess.run(
        ["bash", str(SCRIPTS / script), *args], cwd=cwd, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PATH": path, "PYTHONPATH": pythonpath,
             "OMP_NUM_THREADS": "1", "DEVICE": "cpu", **env})


DECOY_IOU = "11.11"


def _decoy(run_dir, cat, checkpoint):
    """A run dir with a results_log.txt of DECOY_IOU (and an empty, newer
    checkpoint): nothing of it may reach the aggregate."""
    results = run_dir / f"{cat}_evaluation" / "results"
    results.mkdir(parents=True)
    (results / "results_log.txt").write_text(
        f"Shape IoU: {DECOY_IOU}\nPart IoU: {DECOY_IOU}\n")
    if checkpoint:
        (run_dir / "weights.pt").write_bytes(b"")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_scripts_train_then_evaluate_every_category(synth_root, tmp_path,
                                                    family):
    train, train_args, testing, testing_args, model, run = FAMILIES[family]
    work = tmp_path / "work"
    work.mkdir()
    env = dict(DATAPATH=synth_root, MODEL=model, BATCH_SIZE="2",
               MAX_EPOCH="1", STAT_FREQ="10")
    for cat in TRAINED:
        res = _bash(train, cat, *train_args, *SMALL, cwd=work, **env)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    base = work / "outputs"
    runs = {cat: sorted(base.glob(f"*/{cat}/{run}/*/*/weights.pt"))
            for cat in TRAINED}
    assert all(len(r) == 1 for r in runs.values()), runs
    for cat, (ckpt,) in runs.items():
        assert (ckpt.parent / f"checkpoint_{model}.pt").exists()
        assert (ckpt.parent / "config.json").exists()
        assert '"device": "cpu"' in (ckpt.parent / "config.json").read_text()

    # under the same base, runs the loop must not evaluate or aggregate:
    # the other family's model, another K, and an older run of this model
    # (no checkpoint) in a dir that sorts after this run's
    for cat, (ckpt,) in runs.items():
        for other in {"HRNetSimCSN2S-K1", "HRNetSimCSN2S-K2",
                      "HRNetSeg2S"} - {run}:
            _decoy(ckpt.parents[3] / other / "b2-old" / "t", cat,
                   checkpoint=True)
        _decoy(ckpt.parents[2] / "zz-older" / "t", cat, checkpoint=False)

    res = _bash(testing, "all", *testing_args, str(base), cwd=work, **env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert DECOY_IOU not in res.stdout
    for cat, (ckpt,) in runs.items():
        assert f"=== {cat}: evaluating {ckpt.parent}" in res.stdout
        log = ckpt.parent / f"{cat}_evaluation" / "results" / \
            "results_log.txt"
        text = log.read_text()
        assert text.startswith("Shape IoU: ") and "\nPart IoU: " in text
        # the aggregate found the file the loop wrote
        s, p = collect_partnet_results.parse_results_log(str(log))
        assert f"{cat}\tShapeIoU={s}\tPartIoU={p}" in res.stdout
    assert "AVG(2 cats)" in res.stdout
    missing = [c for c in CATEGORIES if c not in TRAINED]
    assert res.stderr.count("no checkpoint found") == len(missing) == 15
    assert f"!!! categories with no result: {' '.join(missing)}" \
        in res.stderr

    # a named category without a checkpoint fails the script
    res = _bash(testing, "Bed", *testing_args, str(base), cwd=work, **env)
    assert res.returncode == 1 and "no checkpoint found for Bed" in res.stderr
    assert "evaluation failed for: Bed" in res.stderr
    # nothing evaluated under `all`: exit 1
    (tmp_path / "empty").mkdir()
    res = _bash(testing, "all", *testing_args, str(tmp_path / "empty"),
                cwd=work, **env)
    assert res.returncode == 1
    assert res.stderr.count("no checkpoint found") == 17
    res = _bash(testing, "--show_categories", cwd=work)
    assert res.returncode == 0
    assert re.findall(r"\t(\d+)\.\t(\w+)", res.stdout) == [
        (str(i + 1), c) for i, c in enumerate(CATEGORIES)]
    shutil.rmtree(base)   # the checkpoints


def test_scripts_are_the_jax_scripts_counterparts():
    ported = sorted(p.stem for p in SCRIPTS.glob("*.sh"))
    assert ported == sorted(NAMES)
    for name in NAMES:
        assert (REPO / "scripts" / f"{name}.sh").exists(), name


def _code(name):
    """The script's lines without its comments."""
    return [line for line in (SCRIPTS / f"{name}.sh").read_text()
            .splitlines() if not line.lstrip().startswith("#")]


def test_scripts_run_the_port_only_on_the_device_they_are_given():
    for name in NAMES:
        code = "\n".join(_code(name))
        assert not re.search(r"\bcsn_tpu\.", code), name
        tasks = re.findall(r"python -m ([\w.]+)", code)
        assert all(t.startswith("csn_tpu_torch.tasks.") for t in tasks), name
        if {"csn_tpu_torch.tasks.main_csn", "csn_tpu_torch.tasks.main_seg",
                "csn_tpu_torch.tasks.extract_features"} & set(tasks):
            assert "DEVICE=${DEVICE:-cuda}" in code, name
            assert code.count('--device "$DEVICE"') == len(tasks) - code.count(
                "collect_partnet_results"), name


def test_every_flag_a_script_passes_is_taken_by_its_task(tmp_path):
    config_flags = set(_add_args(argparse.ArgumentParser())
                       ._option_string_actions)
    collector = {"--results_root", "--pattern"}
    for name in NAMES:
        flags = set(re.findall(r"(?<![\w-])(--[a-z_]+)", "\n".join(
            _code(name))))
        flags.discard("--show_categories")       # the testing scripts' own
        assert flags - config_flags - collector == set(), name
        if flags & collector:
            assert name in ("testing_csn", "testing_hrnet"), name
    # the collector takes the testing scripts' flags (nothing found here)
    assert collect_partnet_results.main(
        ["--results_root", str(tmp_path),
         "--pattern", "{cat}_evaluation/results/results_log.txt"]) == []


def _bash_lists(path):
    out = subprocess.run(
        ["bash", "-c", f'source "{path}"; echo "${{CATEGORIES[*]}}"; '
         f'echo "${{TRAIN_COUNTS[*]}}"'], capture_output=True, text=True,
        check=True).stdout.splitlines()
    return out[0].split(), [int(n) for n in out[1].split()]


def test_partnet_categories_equal_the_ports_table_and_the_jax_copy():
    cats, counts = _bash_lists(SCRIPTS / "partnet_categories.sh")
    assert tuple(cats) == CATEGORIES and len(cats) == 17
    assert counts == [TRAIN_COUNTS[c] for c in CATEGORIES]
    assert (cats, counts) == _bash_lists(
        REPO / "scripts" / "partnet_categories.sh")


@pytest.mark.parametrize("name", NAMES)
def test_script_parses(name):
    res = subprocess.run(["bash", "-n", str(SCRIPTS / f"{name}.sh")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr

"""Multi-rank runs of the port for the tests: each rank is a process of its
own (one thread), joined in a `gloo` world on the CPU, importing the port
only; it writes what it computed to `<out>/rank<r>.npz` and the test
compares. The test side starts a world with `start_ranks` (it runs in the
background while the test computes its references) and collects it with
`RankRun.results`.

Run as `python -m tests.torch_ranks MODE RANK WORLD PORT OUT [ARGS...]`.
Modes:
  dp_steps    the `parallel/dp.py` steps, `sharded_retrieval_measure` and
              `exchange_rows` on the inputs in OUT (see tests/test_torch_dp.py)
  trainer     `main_csn.build_trainer` inside the world: `test_on` plain and
              cached, a graph rebuild, train iterations (ARGS: a JSON config)
  cp_steps    the `parallel/cp.py` steps (see tests/test_torch_cp.py)
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

# the small size of tests/test_dist.py and tests/test_cp.py
MODEL = "HRNetSimCSN2S"
N_POINTS, VOXEL, SHRINK, STEM, OUT, D_MODEL, HEADS = 48, 0.3, 1.5, 3, 4, 16, 2


def make_shapes(B, n, seed):
    """`tests/test_dist.py::make_shapes`: uniform points, labels by x."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        c = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        out.append((c, c.copy(), (c[:, 0] > 0).astype(np.int32) + 1))
    return out


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankRun:
    """`world` rank processes started together; `results()` waits for all
    of them (each has `timeout` seconds), kills any left, and loads what
    each rank wrote."""

    def __init__(self, mode, world, out, *extra, timeout=240):
        self.world, self.out, self.timeout = world, Path(out), timeout
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_ranks", mode, str(r),
             str(world), str(port), str(out), *map(str, extra)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        self._res = None

    def results(self):
        if self._res is not None:
            return self._res
        fails = []
        try:
            for r, p in enumerate(self.procs):
                _, err = p.communicate(timeout=self.timeout)
                if p.returncode != 0:
                    fails.append(f"rank {r} exited {p.returncode}:\n"
                                 f"{err[-4000:]}")
        finally:
            for p in self.procs:   # leave nothing running
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not fails, "\n".join(fails)
        self._res = [dict(np.load(self.out / f"rank{r}.npz",
                                  allow_pickle=True))
                     for r in range(self.world)]
        return self._res


def start_ranks(mode, world, out, *extra, timeout=240) -> RankRun:
    return RankRun(mode, world, out, *extra, timeout=timeout)


# ---------------------------------------------------------------------------
# the rank side (imports the port only)
# ---------------------------------------------------------------------------

def _model(k_neighbors=1, norm="BATCH_NORM"):
    from csn_tpu_torch.models import load_model
    from csn_tpu_torch.models.layers import NormType

    return load_model(MODEL)(
        out_channels=OUT, conv1_kernel_size=STEM, k_neighbors=k_neighbors,
        d_model=D_MODEL, n_head=HEADS, attn_dropout=0.0,
        norm_type=NormType[norm])


def _batch(seed, B=2):
    from csn_tpu_torch.core.pyramid import to_torch
    from csn_tpu_torch.data.pipeline import collate_shapes, \
        pyramid_spec_for_model
    from csn_tpu_torch.models import load_model

    spec = pyramid_spec_for_model(load_model(MODEL), num_points=N_POINTS,
                                  voxel_size=VOXEL, conv1_kernel_size=STEM,
                                  shrink=SHRINK)
    return to_torch(collate_shapes(make_shapes(B, N_POINTS, seed), spec),
                    "cpu")


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _grads(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _prefixed(res, prefix, tree):
    res.update({f"{prefix}{k}": v for k, v in tree.items()})


def _digest(tree) -> str:
    """One sha256 over every array's name and bytes: the ranks' states
    compare bit for bit without writing them (a model state is ~80 MB)."""
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(np.ascontiguousarray(tree[k]).tobytes())
    return h.hexdigest()


def _after(res, model, init):
    """The model's state after the steps: its digest, tensor count and the
    summed |change| from `init`."""
    after = _state(model)
    res.update(after_digest=np.asarray(_digest(after)),
               n_tensors=np.asarray(len(after)),
               moved=np.asarray(sum(float(np.abs(v - init[k]).sum())
                                    for k, v in after.items())))


def dp_steps(rank, world, out):
    import torch

    from csn_tpu_torch.parallel import collection, dp

    inp = np.load(out / "inputs.npz")
    res = {}
    model = _model()
    model.load_state_dict(torch.load(out / "state.pt"))
    w = dp.make_dp_world(world, "cpu")
    steps = dp.make_dp_trainer_steps(model, w)
    init = _state(model)
    qb, kb = _batch(rank), _batch(100 + rank)
    loss, plog, pred = steps.eval_step(qb, (kb,))
    res.update(eval_loss=loss.numpy(), eval_logits=plog.numpy(),
               eval_pred=pred.numpy())
    res["dp_eval_logits"] = dp.make_dp_eval_step(model, w)(qb, (kb,)).numpy()
    res["ssa"] = steps.ssa_step(qb).numpy()
    model.zero_grad(set_to_none=True)
    loss, pred = steps.grad_step(qb, (kb,), dp.rank_generator(0, rank))
    steps.reduce_grads()
    res.update(grad_loss=loss.numpy(), grad_pred=pred.numpy())
    grads = _grads(model)
    res["grad_digest"] = np.asarray(_digest(grads))
    if rank == 0:   # the others' are the same bits (grad_digest)
        _prefixed(res, "grad:", grads)
    _prefixed(res, "stats:", {k: v.numpy().copy()
                              for k, v in model.named_buffers()})
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt.step()
    train = dp.make_dp_train_step(model, opt, w)
    train(qb, (kb,), dp.rank_generator(0, rank), lr=0.05)
    _after(res, model, init)

    for case in ("r1", "r2"):
        res[f"measure_{case}"] = dp.sharded_retrieval_measure(
            inp[f"{case}_q"], inp[f"{case}_qm"], inp[f"{case}_k"],
            inp[f"{case}_km"], w)
    cf, cp, cm, per = collection.shard_collection(
        inp["x_feats"], inp["x_pools"], inp["x_masks"], w)
    res["x_per"] = np.asarray(per)
    res["x_shard_rows"] = np.asarray(cf.shape[0])
    idx = torch.from_numpy(inp["x_idx"][:world])
    f, p, m = collection.exchange_rows(cf, cp, cm, idx, per, w)
    res.update(x_f=f.numpy(), x_p=p.numpy(), x_m=m.numpy())
    return res


def trainer(rank, world, out, cfg_json):
    """Also the single-process reference, called without a world."""
    import copy

    import torch

    from csn_tpu_torch.config import Config
    from csn_tpu_torch.tasks.main_csn import build_trainer

    torch.manual_seed(0)
    kw = json.loads(cfg_json)
    iters = kw.pop("iters")
    t = build_trainer(Config(**kw).normalized(), phases=("train", "val"))
    t.model.attn_dropout = t.model.mha.dropout = 0.0
    res = {"world": np.asarray(t.world.size if t.world else 0),
           "n_col": np.asarray(t.n_col)}
    t.initialize()
    init = _state(t.model)
    res["init_digest"] = np.asarray(_digest(init))
    n_tr, n_va = len(t.train_dataset), len(t.val_dataset)
    t.train_dataset.neighbors = [(i, [(i + 1) % n_tr]) for i in range(n_tr)]
    t.val_dataset.neighbors = [(i, [(i + 3) % n_tr]) for i in range(n_va)]
    if t.n_col == 1:
        # initialize() draws for one batch of batch_size shapes: start the
        # evaluation from one state whatever the batch size
        t.rng = np.random.default_rng(7)
        state = copy.deepcopy(t.rng.bit_generator.state)
        res["test_on"] = np.asarray(t.test_on(t.val_dataset))
        res["rng_after"] = np.asarray(json.dumps(t.rng.bit_generator.state))
        t.rng.bit_generator.state = state       # the same draws again
        t.config.cached_eval = True
        res["test_on_cached"] = np.asarray(t.test_on(t.val_dataset))
        cache = t._collection_cache_dev or t._collection_cache
        res["cache_rows"] = np.asarray(cache[0].shape[0])
        t.config.cached_eval = False
        t.construct_shape_graph(recalculate=True)
        res["graph_train"] = np.asarray(
            [nb for _, nb in t.train_dataset.neighbors])
        res["graph_val"] = np.asarray(
            [nb for _, nb in t.val_dataset.neighbors])
        t.train_dataset.neighbors = [(i, [(i + 1) % n_tr])
                                     for i in range(n_tr)]
    losses = []
    for _ in range(iters):
        t._train_iter()
        losses.append(t.losses.avg)
        t.losses.reset()
    t._close_prefetch()
    res["losses"] = np.asarray(losses)
    _after(res, t.model, init)
    if t.n_col > 1:
        res["test_on"] = np.asarray(t.test_on(t.val_dataset))
    return res


def cp_steps(rank, world, out, k_neighbors, n_data, norm):
    """Member (d, c) of the collection grid: the batch of seed 97 c + d
    (`tests/test_cp.py::build`)."""
    import torch

    from csn_tpu_torch.parallel import cp, dp

    K, n_data = int(k_neighbors), int(n_data)
    grid = cp.make_cp_grid(n_data, K + 1, "cpu")
    model = _model(K, norm)
    model.load_state_dict(torch.load(out / "state.pt"))
    steps = cp.make_cp_trainer_steps(model, grid, k_neighbors=K)
    lb = _batch(97 * grid.col_index + grid.data_index)
    res = {}
    loss, plog, pred = steps.eval_step(lb)
    res.update(eval_loss=loss.numpy(), eval_logits=plog.numpy(),
               eval_pred=pred.numpy())
    init = _state(model)
    model.zero_grad(set_to_none=True)
    loss, pred = steps.grad_step(lb, dp.rank_generator(0, rank))
    steps.reduce_grads()
    res.update(grad_loss=loss.numpy(), grad_pred=pred.numpy())
    grads = _grads(model)
    res.update(grad_digest=np.asarray(_digest(grads)),
               grad_abs_sum=np.asarray(sum(float(np.abs(g).sum())
                                           for g in grads.values())))
    if rank == 0:   # the others' are the same bits (grad_digest)
        _prefixed(res, "grad:", grads)
    res["stats_moved"] = np.asarray(sum(
        float(np.abs(v.numpy() - init[k]).sum())
        for k, v in model.named_buffers()))
    torch.optim.SGD(model.parameters(), lr=0.1).step()
    _after(res, model, init)
    return res


def main(argv):
    mode, rank, world, port, out = argv[:5]
    rank, world, out = int(rank), int(world), Path(out)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {"dp_steps": dp_steps, "trainer": trainer,
               "cp_steps": cp_steps}[mode](
            rank, world, out, *argv[5:])
        np.savez(out / f"rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

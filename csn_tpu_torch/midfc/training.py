"""MID-FC SSA / CSA training and evaluation loops.

Counterpart of `csn_tpu/midfc/training.py` (ports of `MID-FC/ssa_training.py`
and `MID-FC/csa_training.py`):

* SSA: 200 epochs of Adam(lr=1e-3, betas=(0.5, 0.999), L2 wd), gradient
  accumulation (default 32), masked CE over labels > 0, NaN-loss zeroing,
  per-epoch eval with the MID-FC dataset-aggregated part IoU, best-IoU
  checkpoint + `test_summaries.csv`, lr x0.1 at epochs T/20 and 3T/4
  (`ssa_training.py:204-258`).
* CSA: loads the trained SSA weights (shared module names, so a plain
  state-dict merge), loads precomputed kNN graphs, trains 24 epochs,
  rebuilds the kNN graph with the current model (KMeans candidate path for
  the big categories Chair/Lamp/StorageFurniture/Table), then trains 24 more
  epochs (`csa_training.py:136-176,303-376`).

Also provides `save_knn_graphs`, the functionality of the reference's missing
`save_knn_graph.py`, as the JAX package does.

`MidfcRunner` keeps the JAX runner's step surfaces: `_grad(feats, labels,
neighbors, seed) -> (loss, grads)`, `_apply(grads)`, `_eval(feats,
neighbors) -> logits` and `_ssa_feats(feats)`, on numpy inputs; the
parameters and the Adam state live in the runner's module and optimizer.
Checkpoints are the module's `state_dict`, written by `torch.save` through
an atomic rename.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from csn_tpu_torch.midfc.data import CSAFeaturesDataset, FeaturesDataset
from csn_tpu_torch.midfc.model import get_model
from csn_tpu_torch.retrieval.graph import (
    kmeans_candidate_indices, knn_graph_topk_rows, retrieval_measure,
)
from csn_tpu_torch.train.losses import cross_entropy_positive_labels
from csn_tpu_torch.train.metrics import MidfcIoUAccumulator
from csn_tpu_torch.train.optim import make_optimizer

BIG_CLASSES = ("Chair", "Lamp", "StorageFurniture", "Table")
CHECKPOINT_NAME = "trained_layers.pt"


@dataclasses.dataclass
class MidfcConfig:
    logs_dir: str = "logs/backbone_fc_ssa_logit"
    partname: str = "Bed"
    num_classes: int = 15
    n_heads: int = 1
    K: int = 1
    batch_size: int = 8
    d_model: int = 256               # == feature channels (256 for real fc_1)
    lr: float = 1e-3
    weight_decay: float = 1e-4       # ssa default; csa uses 5e-4
    gradient_accumulation_steps: int = 32
    epochs: int = 200
    testing: bool = False            # break every loop after one batch
    chunk_size: Optional[int] = 500
    # 'auto': the flash kernels for a CUDA device, the plain versions on the
    # CPU; on the same 500-point chunk grid either way, so the reference's
    # block-diagonal semantics hold (online softmax is exact; dropout moves
    # into the kernel). 'auto' covers every surface of the runner: grad
    # steps, the kNN-graph feature extraction and rebuild, and validation.
    use_flash: object = "auto"       # 'auto' | True | False
    num_points: int = 10000
    seed: int = 0
    # Multi-rank (parallel/midfc.py): 'data' shards the batch (gradients
    # all-reduced), 'seq' shards the point axis (chunked attention is
    # block-diagonal, so point shards are independent; pooled compatibility
    # descriptors are all-reduced; full attention becomes a ring).
    # data_parallel * seq_parallel ranks of an initialised torch.distributed
    # world; batch_size % data_parallel == 0 and (num_points / seq_parallel)
    # % chunk_size == 0.
    data_parallel: int = 1
    seq_parallel: int = 1
    # activation dtype of the attention stack (the logit head always
    # computes f32)
    compute_dtype: str = "float32"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write through a temporary file and a rename: a crash mid-write must
    not truncate the best-IoU checkpoint this path overwrites in place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())  # the data must be on disk before the rename
    os.replace(tmp, path)


def _save(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
    _atomic_write_bytes(path, buf.getvalue())
    logging.info("model saved to: %s!", path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu")


def _write_summary_csv(path, partname, value):
    with open(path, "w") as f:
        f.write(f",{partname}\n0,{value}\n")


class MidfcRunner:
    """Shared step machinery for the SSA and CSA phases, on `device`
    (default the card; the tests pass "cpu")."""

    def __init__(self, cfg: MidfcConfig, attention_type: str,
                 device="cuda"):
        self.cfg = cfg
        self.attention_type = attention_type
        self.device = torch.device(device)
        use_flash = cfg.use_flash
        if use_flash == "auto":
            use_flash = self.device.type == "cuda"
        self.model = get_model(attention_type, cfg.num_classes, cfg.n_heads,
                               K=cfg.K, chunk_size=cfg.chunk_size,
                               use_flash=bool(use_flash),
                               d_model=cfg.d_model,
                               compute_dtype=cfg.compute_dtype)
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.lr = cfg.lr
        self.optimizer = None

        n_par = cfg.data_parallel * cfg.seq_parallel
        if n_par > 1:
            from csn_tpu_torch.parallel.midfc import make_midfc_steps

            steps = make_midfc_steps(self, cfg.data_parallel,
                                     cfg.seq_parallel)
            self._grad = steps.grad
            self._eval = steps.eval
            self._ssa_feats = steps.ssa_feats
        else:
            self._grad = self._grad_step
            self._eval = self._eval_step
            self._ssa_feats = self._ssa_feats_step

    # -- state ---------------------------------------------------------------
    def initialize(self) -> None:
        """Seeded parameters on the device and a fresh Adam(0.5, 0.999)."""
        self.model.reset_parameters(self.generator)
        self.model.to(self.device)
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        cfg = self.cfg
        self.optimizer = make_optimizer(
            self.model.parameters(), optimizer="Adam", lr=self.lr,
            adam_beta1=0.5, adam_beta2=0.999, weight_decay=cfg.weight_decay)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def load_state(self, state_dict, strict: bool = True) -> None:
        self.model.load_state_dict(state_dict, strict=strict)

    def _dev(self, x):
        """A numpy input (or None) on the runner's device."""
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _call_model(self, feats, neighbors, generator=None):
        if self.attention_type == "csa":
            return self.model(feats, neighbors, generator=generator)
        return self.model(feats, generator=generator)

    # -- steps ---------------------------------------------------------------
    def _grad_step(self, feats, labels, neighbors, seed: int):
        """One forward and backward in train mode -> (loss, grads by
        parameter name). A NaN loss zeroes the loss and every gradient
        (`ssa_training.py:142-143`)."""
        model = self.model
        model.train()
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(int(seed))
        logits = self._call_model(self._dev(feats), self._dev(neighbors),
                                  gen)
        loss = cross_entropy_positive_labels(logits, self._dev(labels))
        loss.backward()
        isnan = torch.isnan(loss.detach())
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = torch.where(isnan, torch.zeros_like(g), g)
        model.zero_grad(set_to_none=True)
        loss = torch.where(isnan, torch.zeros_like(loss), loss).detach()
        return loss, grads

    def _apply(self, grads: Dict[str, torch.Tensor]) -> None:
        """One Adam step on `grads` at the runner's current lr."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        self.optimizer.step()
        self.model.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _eval_step(self, feats, neighbors):
        self.model.eval()
        return self._call_model(self._dev(feats), self._dev(neighbors))

    @torch.no_grad()
    def _ssa_feats_step(self, feats):
        self.model.eval()
        return self.model.get_ssa_feats(self._dev(feats))

    def draw_step_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (), generator=self.generator))

    # -- loops ---------------------------------------------------------------
    def train_epoch(self, dataset, is_csa: bool) -> float:
        """One epoch with gradient accumulation
        (`ssa_training.py:125-156`, `csa_training.py:191-222`)."""
        cfg = self.cfg
        running, count = 0.0, 0
        grads_acc, n_acc = None, 0
        batches = dataset.batches(cfg.batch_size, shuffle=not is_csa,
                                  rng=self.rng)
        n_batches = (len(dataset) + cfg.batch_size - 1) // cfg.batch_size
        for bi, data in enumerate(batches):
            if is_csa:
                feats, labels, neighbors, _ = data
            else:
                feats, labels, _ = data
                neighbors = None
            loss, grads = self._grad(feats, labels, neighbors,
                                     self.draw_step_seed())
            # NOTE: the returned "train loss" is mean_CE / accumulation_steps
            # BY DESIGN: the reference divides the same way before summing,
            # so its logged train loss sits below the val loss by that
            # factor too. Kept for log parity.
            running += float(loss) / cfg.gradient_accumulation_steps
            count += 1
            if grads_acc is None:
                grads_acc, n_acc = grads, 1
            else:
                for name, g in grads.items():
                    grads_acc[name] += g
                n_acc += 1
            if ((bi + 1) % cfg.gradient_accumulation_steps == 0
                    or (bi + 1) == n_batches):
                self._apply({k: g / n_acc for k, g in grads_acc.items()})
                grads_acc, n_acc = None, 0
            if cfg.testing:
                break
        return running / max(count, 1)

    def validate(self, dataset, is_csa: bool) -> Tuple[float, float]:
        """Returns (iou_avg, mean loss) with the MID-FC metric
        (`ssa_training.py:158-192`)."""
        cfg = self.cfg
        acc = MidfcIoUAccumulator(cfg.num_classes)
        running, count = 0.0, 0
        for data in dataset.batches(cfg.batch_size):
            if is_csa:
                feats, labels, neighbors, valid = data
            else:
                feats, labels, valid = data
                neighbors = None
            logits = self._eval(feats, neighbors)[:valid].float().cpu()
            labels_np = labels[:valid]
            loss = float(cross_entropy_positive_labels(
                logits, torch.as_tensor(labels_np)))
            if not np.isnan(loss):
                running += loss
                count += 1
            pred = logits.argmax(dim=-1).numpy()
            for b in range(valid):
                acc.update(pred[b], labels_np[b])
            if cfg.testing:
                break
        return acc.result(), running / max(count, 1)

    def all_ssa_feats(self, dataset) -> np.ndarray:
        """`csa_models.py:282-300`: SSA features for every shape [N, P, d]
        (fp16 on host)."""
        out = []
        for feats, _labels, valid in dataset.batches(self.cfg.batch_size):
            f = self._ssa_feats(feats)[:valid]
            out.append(f.float().cpu().numpy().astype(np.float16))
        return np.concatenate(out)

    def global_max_feats(self, dataset) -> np.ndarray:
        """Max-pooled SSA descriptors for KMeans (`csa_models.py:302-319`)."""
        out = []
        for feats, _labels, valid in dataset.batches(self.cfg.batch_size):
            f = self._ssa_feats(feats).amax(dim=1)[:valid]
            out.append(f.float().cpu().numpy())
        return np.concatenate(out)


def compute_knn_graphs(runner: MidfcRunner, train_ds: FeaturesDataset,
                       test_ds: FeaturesDataset, K: int, partname: str
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """kNN graphs for train (vs train) and test (vs train). Big categories
    use the KMeans candidate path (`csa_training.py:136-163`)."""
    dev = runner.device
    tr = runner.all_ssa_feats(train_ds)
    te = runner.all_ssa_feats(test_ds)
    ones_tr = np.ones(tr.shape[:2], dtype=bool)
    ones_te = np.ones(te.shape[:2], dtype=bool)
    if partname in BIG_CLASSES:
        glob = runner.global_max_feats(train_ds)
        cand = np.sort(kmeans_candidate_indices(glob))
        cand_feats = tr[cand]
        ones_c = np.ones(cand_feats.shape[:2], dtype=bool)
        m_tr = retrieval_measure(tr, ones_tr, cand_feats, ones_c, device=dev)
        m_te = retrieval_measure(te, ones_te, cand_feats, ones_c, device=dev)
        return (cand[knn_graph_topk_rows(m_tr, K)],
                cand[knn_graph_topk_rows(m_te, K)])
    m_tr = retrieval_measure(tr, ones_tr, tr, ones_tr, device=dev)
    m_te = retrieval_measure(te, ones_te, tr, ones_tr, device=dev)
    return knn_graph_topk_rows(m_tr, K), knn_graph_topk_rows(m_te, K)


def save_knn_graphs(runner: MidfcRunner, train_ds, test_ds, K: int,
                    partname: str, logs_root: str = "logs"):
    """Write `logs/knn_graphs/n_heads_*/{part}/{train,test}.npy`
    (`csa_training.py:286-290` layout)."""
    out_dir = os.path.join(logs_root, "knn_graphs",
                           f"n_heads_{runner.cfg.n_heads}", partname)
    os.makedirs(out_dir, exist_ok=True)
    tr, te = compute_knn_graphs(runner, train_ds, test_ds, K, partname)
    np.save(os.path.join(out_dir, "train.npy"), tr)
    np.save(os.path.join(out_dir, "test.npy"), te)
    return out_dir


def _barrier() -> None:
    """Multi-rank runs: wait until rank 0 has written what all will read."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _is_writer() -> bool:
    """Rank 0 of a multi-rank run writes the files; every rank of a
    single-process run does."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def train_ssa(cfg: MidfcConfig, train_ds: FeaturesDataset,
              test_ds: FeaturesDataset, device="cuda") -> Tuple[float, str]:
    """`ssa_training.py:194-258`. Returns (best IoU, checkpoint path)."""
    runner = MidfcRunner(cfg, "ssa", device=device)
    runner.initialize()
    os.makedirs(cfg.logs_dir, exist_ok=True)
    save_name = os.path.join(cfg.logs_dir, CHECKPOINT_NAME)
    df_path = os.path.join(cfg.logs_dir, "test_summaries.csv")

    T = cfg.epochs
    best_iou = 0.0
    for t in range(T):
        train_loss = runner.train_epoch(train_ds, is_csa=False)
        val_iou, val_loss = runner.validate(test_ds, is_csa=False)
        logging.info("iter: %d/%d train_loss: %g val_loss: %g val_IoU: %g "
                     "best_IoU: %g", t + 1, T, train_loss, val_loss, val_iou,
                     best_iou)
        if val_iou > best_iou:
            best_iou = val_iou
            if _is_writer():
                _save(runner.params, save_name)
                _write_summary_csv(df_path, cfg.partname, val_iou * 100)
        if (t + 1) == T // 20 or (t + 1) == (3 * T) // 4:
            runner.lr *= 0.1
        if cfg.testing:
            break
    return best_iou, save_name


def train_csa(cfg: MidfcConfig, train_root: str, test_root: str,
              train_knn_graph: np.ndarray, test_knn_graph: np.ndarray,
              ssa_params_path: Optional[str] = None,
              history: Optional[list] = None, device="cuda"
              ) -> Tuple[float, str]:
    """`csa_training.py:261-387`: two 24-epoch phases with a graph rebuild in
    between. Returns (best IoU, checkpoint path). `history`, when given,
    collects one dict per epoch (phase/epoch/train_loss/val_loss/val_iou)."""
    runner = MidfcRunner(cfg, "csa", device=device)
    train_plain = FeaturesDataset(train_root, cfg.num_points)
    test_plain = FeaturesDataset(test_root, cfg.num_points)

    csa_train = CSAFeaturesDataset(train_root, train_root, train_knn_graph,
                                   cfg.K, cfg.num_points)
    csa_test = CSAFeaturesDataset(test_root, train_root, test_knn_graph,
                                  cfg.K, cfg.num_points,
                                  same_collection=False)

    runner.initialize()
    if ssa_params_path:
        # `utils.py:29-39`: copy the SSA-trained attention/logit weights into
        # the CSA model. The modules share names, so merge directly.
        runner.load_state(load_params(ssa_params_path), strict=False)
        logging.info("trained_ssa_layers imported!")

    os.makedirs(cfg.logs_dir, exist_ok=True)
    save_name = os.path.join(cfg.logs_dir, CHECKPOINT_NAME)
    df_path = os.path.join(cfg.logs_dir, "test_summaries.csv")
    best_iou = 0.0

    def phase(csa_train, csa_test, best_iou, phase_idx=0):
        runner.lr = cfg.lr
        runner.reset_optimizer()
        T = 24
        for t in range(T):
            train_loss = runner.train_epoch(csa_train, is_csa=True)
            val_iou, val_loss = runner.validate(csa_test, is_csa=True)
            if history is not None:
                history.append(dict(phase=phase_idx, epoch=t,
                                    train_loss=float(train_loss),
                                    val_loss=float(val_loss),
                                    val_iou=float(val_iou)))
            logging.info("iter: %d/%d train_loss: %g val_loss: %g "
                         "val_IoU: %g best_IoU: %g", t + 1, T, train_loss,
                         val_loss, val_iou * 100, best_iou)
            if val_iou > best_iou or not os.path.exists(save_name):
                best_iou = max(best_iou, val_iou)
                if _is_writer():
                    _save(runner.params, save_name)
                    _write_summary_csv(df_path, cfg.partname, val_iou * 100)
            # scheduler stepped at epochs 10 and 18 (`csa_training.py:335`)
            if (t + 1) == 10 or (t + 1) == (3 * T) // 4:
                runner.lr *= 0.1
            if cfg.testing:
                break
        return best_iou

    best_iou = phase(csa_train, csa_test, best_iou, phase_idx=0)

    # reload best, rebuild graph, phase 2 (`csa_training.py:341-376`)
    _barrier()
    runner.load_state(load_params(save_name))
    logging.info("Updating KNN graph....")
    tr_graph, te_graph = compute_knn_graphs(runner, train_plain, test_plain,
                                            cfg.K, cfg.partname)
    csa_train = CSAFeaturesDataset(train_root, train_root, tr_graph, cfg.K,
                                   cfg.num_points)
    csa_test = CSAFeaturesDataset(test_root, train_root, te_graph, cfg.K,
                                  cfg.num_points, same_collection=False)
    logging.info("KNN graph UPDATED!")
    best_iou = phase(csa_train, csa_test, best_iou, phase_idx=1)

    _barrier()
    runner.load_state(load_params(save_name))
    val_iou, _ = runner.validate(csa_test, is_csa=True)
    logging.info("Final val_IoU: %g", val_iou * 100)
    if _is_writer():
        _write_summary_csv(df_path, cfg.partname, val_iou * 100)
    return best_iou, save_name

"""Training / evaluation orchestration for the sparse-voxel models on one
device (counterpart of `csn_tpu/train/trainer.py`).

Ports the reference trainers:
* `MinkowskiNet/lib/trainer_seg.py`: plain segmentation loop.
* `MinkowskiNet/lib/trainer_csn.py`: CSN loop with the
  plateau -> reload-best -> rebuild-shape-graph state machine
  (MAX_PATIENCE=10, MAX_COOLDOWN=5, MAX_GRAPH_CONSTRUCTION=3,
  `trainer_csn.py:36,115-158`), iter_size gradient accumulation
  (`trainer_csn.py:188-224`), checkpoints carrying `csn_data`
  (`trainer_csn.py:315-387`), and the static `test()` evaluation
  (`trainer_csn.py:400-500`).

The host loop owns control flow (epochs, patience, graph rebuilds, plateau
LR) and draws from the same numpy generators in the same order as the JAX
trainer, so the two build the same batches and the same random pairs from
one seed. The compute is `train/steps.py` on `config.device`; the model's
parameters, its BatchNorm statistics and the optimizer state are updated in
place.

Built inside an initialised `torch.distributed` world (one process per
rank, `--data_parallel N` = the world's size), the trainer takes the
data-parallel steps of `parallel/dp.py`, a world of one included: each rank
builds its own chunk of the global batch and the world averages gradients,
BatchNorm statistics and the loss. `--collection_parallel` trains on a
('data', 'col') grid (`parallel/cp.py`), one collection member per rank;
evaluation, the collection cache and the shape graph stay data-parallel
over all ranks. Every rank runs the same host loop on the same numbers
(every rank builds every eval chunk, so the shared generator `rng` makes
the same draws as the JAX trainer's one process), and rank 0 alone writes
checkpoints, `config.json` and the metrics log.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from csn_tpu_torch.config import Config
from csn_tpu_torch.core.pyramid import PyramidSpec, build_voxel_batch, to_torch
from csn_tpu_torch.data.prefetch import Prefetcher
from csn_tpu_torch.data.sampler import InfSampler
from csn_tpu_torch.parallel import collection as pc
from csn_tpu_torch.parallel import collectives, cp, dp
from csn_tpu_torch.retrieval import graph as retrieval
from csn_tpu_torch.train import metrics as M
from csn_tpu_torch.train import steps
from csn_tpu_torch.train.checkpoint import (
    LATEST, checkpoint_name, load_checkpoint, save_checkpoint,
)
from csn_tpu_torch.train.optim import (
    ReduceLROnPlateau, make_lr_schedule, make_optimizer,
)
from csn_tpu_torch.utils.logging import MetricsWriter
from csn_tpu_torch.utils.timer import AverageMeter, Timer


def truncated_batch_size(point_counts: Sequence[int],
                         limit_numpoints: int) -> int:
    """Collate-time batch truncation rule (`lib/transforms.py:126-136`):
    shapes are kept in order until the cumulative point count exceeds the
    limit; the shape that overflows and everything after it are dropped.
    At least one shape is kept (j > 0 guard)."""
    if not limit_numpoints or limit_numpoints <= 0:
        return len(point_counts)
    tot = 0
    for j, p in enumerate(point_counts):
        tot += int(p)
        if tot > limit_numpoints and j > 0:
            return j
    return len(point_counts)


def neighbor_slot_indices(neighbors, idxs: Sequence[int],
                          K: int) -> List[List[int]]:
    """Slot-major neighbor layout (`lib/csn_utils.py:114-130 get_neighbors`):
    slot k holds the k-th neighbor of every query, in query order, so the K
    neighbor batches line up row-for-row with the query batch."""
    return [[neighbors[i][1][k] for i in idxs] for k in range(K)]


def build_batch_from_dataset(dataset, indices: Sequence[int],
                             spec: PyramidSpec,
                             rng: np.random.Generator,
                             augment: bool,
                             limit_numpoints: int = 0):
    """Assemble one padded host VoxelBatch. `limit_numpoints` mirrors the
    reference's collate-time batch truncation (`lib/transforms.py:126-143`):
    once the cumulative point count exceeds the limit, the remaining shapes
    of the batch are masked out (the static-shape analogue of dropping
    them)."""
    shapes = [dataset.get(i, rng=rng, augment=augment) for i in indices]
    batch = build_voxel_batch(shapes, spec, rng=rng)
    if limit_numpoints > 0:
        tot = sum(int(c.shape[0]) for c, _, _ in shapes)
        kept = truncated_batch_size([c.shape[0] for c, _, _ in shapes],
                                    limit_numpoints)
        if kept < len(shapes):
            logging.warning(
                "\tCannot fit %d points into %d points limit. Truncating "
                "batch %d -> %d shapes.", tot, limit_numpoints, len(shapes),
                kept)
            batch.point_mask[kept:] = False
            batch.labels[kept:] = 255
            for m in batch.masks:
                m[kept:] = False
            batch.interp_w[kept:] = 0.0
    return batch


def _padded_indices(start: int, n: int, bs: int) -> Tuple[List[int], int]:
    """Indices start .. start+bs-1 of n items, the last one repeated to fill
    the batch; and how many are real."""
    idxs = list(range(start, min(start + bs, n)))
    valid = len(idxs)
    return idxs + [idxs[-1]] * (bs - valid), valid


class BaseTrainer:
    """Shared machinery: steps, checkpointing, eval loop."""

    def __init__(self, model, config: Config, spec: PyramidSpec,
                 train_dataset, val_dataset, num_labels: int,
                 device: Optional[str] = None):
        self.model = model
        self.config = config
        self.spec = spec
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.num_labels = num_labels
        self.device = torch.device(device if device is not None
                                   else config.device)
        self.K = getattr(config, "k_neighbors", 0) if self._uses_keys() else 0

        # `--data_parallel N`: one rank per process, N = the world's size;
        # `--collection_parallel`: the train step on a ('data', 'col') grid
        # of the same ranks, one [self]+K member per rank
        self.n_dev = max(config.data_parallel, 1)
        self.n_col = 1
        if config.collection_parallel:
            if self.K < 1:
                raise ValueError(
                    "--collection_parallel needs k_neighbors >= 1 (the col "
                    "mesh axis is the [self]+K collection)")
            if self.n_dev % (self.K + 1) != 0:
                raise ValueError(
                    f"--collection_parallel needs k_neighbors+1 "
                    f"({self.K + 1}) to divide --data_parallel "
                    f"({self.n_dev})")
            self.n_col = self.K + 1
        self.n_data = self.n_dev // self.n_col
        config.check_supported()
        ignore = config.ignore_label
        # a trainer built inside an initialised world takes the
        # data-parallel steps, a world of one included
        self.world = self.dp_steps = self.cp = None
        self._grad_step = lambda qb, keys, gen: steps.grad_step(
            self.model, qb, keys, gen, ignore)
        self._reduce_grads = lambda: None
        if collectives.world_size():
            self.world = dp.make_dp_world(self.n_dev, self.device)
            self.dp_steps = dp.make_dp_trainer_steps(model, self.world,
                                                     ignore_label=ignore)
            self._grad_step = self.dp_steps.grad_step
            self._reduce_grads = self.dp_steps.reduce_grads
            if self.n_col > 1:
                self.cp = cp.make_cp_grid(self.n_data, self.n_col,
                                          self.device)
                cp_steps = cp.make_cp_trainer_steps(
                    model, self.cp, k_neighbors=self.K, ignore_label=ignore)
                # the rank's collection member travels in the qb slot
                self._grad_step = lambda lb, keys, gen: cp_steps.grad_step(
                    lb, gen)
                self._reduce_grads = cp_steps.reduce_grads
        self.rank = self.world.rank if self.world is not None else 0

        self.writer = MetricsWriter(config.log_dir, active=self.rank == 0)
        self.data_timer, self.iter_timer = Timer(), Timer()
        self.data_time_avg, self.iter_time_avg = AverageMeter(), AverageMeter()
        self.losses, self.scores = AverageMeter(), AverageMeter()

        self.rng = np.random.default_rng(config.seed)
        # Dedicated generator for the training-data path: it is consumed from
        # the prefetch thread and must not race the eval/graph paths' rng.
        self.data_rng = np.random.default_rng(config.seed + 1)
        # attention dropout draws its seeds from this CPU generator
        self.generator = dp.rank_generator(config.seed, self.rank)
        self.sampler = InfSampler(len(train_dataset), shuffle=True,
                                  rng=self.data_rng)

        self.optimizer = None   # made by initialize(), over the parameters
        self.lr_factor = 0.5
        self.schedule = make_lr_schedule(
            config.scheduler, config.lr, step_size=config.step_size,
            step_gamma=config.step_gamma, max_iter=config.max_iter,
            poly_power=config.poly_power, exp_gamma=config.exp_gamma,
            exp_step_size=config.exp_step_size)

        self.best_val_part_iou, self.best_val_part_iou_iter = 0.0, 0
        self.best_val_shape_iou, self.best_val_shape_iou_iter = 0.0, 0
        self.best_val_loss, self.best_val_loss_iter = np.inf, 0
        self.best_val_acc, self.best_val_acc_iter = 0.0, 0
        self.curr_iter, self.epoch, self.is_training = 1, 1, True
        self._prefetch = None

    # -- model-specific hooks -------------------------------------------------
    def _uses_keys(self) -> bool:
        return False

    # -- init -----------------------------------------------------------------
    @property
    def initialized(self) -> bool:
        return self.optimizer is not None

    def initialize(self):
        idxs = list(range(min(self.config.batch_size,
                              len(self.train_dataset))))
        idxs = (idxs * self.config.batch_size)[: self.config.batch_size]
        # The JAX trainer traces its model on this batch. Building it here
        # keeps `self.rng` at the same point of its stream in both trainers,
        # so the random pairs and the eval batches that follow are the same.
        build_batch_from_dataset(self.train_dataset, idxs, self.spec,
                                 self.rng, augment=False)
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.config.seed))
        self.model.to(self.device)
        self.optimizer = make_optimizer(
            self.model.parameters(), optimizer=self.config.optimizer,
            lr=self.config.lr, sgd_momentum=self.config.sgd_momentum,
            sgd_dampening=self.config.sgd_dampening,
            adam_beta1=self.config.adam_beta1,
            adam_beta2=self.config.adam_beta2,
            weight_decay=self.config.weight_decay)
        # `--weights` pretrained load (`lib/config.py:47`): the model from a
        # checkpoint file, with the fresh optimizer state kept.
        weights = getattr(self.config, "weights", "None")
        if weights not in (None, "", "None"):
            if weights.endswith(".pth"):
                # a reference MinkowskiEngine checkpoint, through the
                # converter (models/convert.py)
                from csn_tpu_torch.models.convert import \
                    load_mink_torch_checkpoint
                from csn_tpu_torch.models.hrnet import HRNetSimCSN

                self.model.load_state_dict(load_mink_torch_checkpoint(
                    weights, num_stages=self.model.NUM_STAGES,
                    num_blocks=self.model.NUM_BLOCKS,
                    csn_head=isinstance(self.model, HRNetSimCSN),
                    k_neighbors=self.config.k_neighbors))
            else:
                tree, _ = load_checkpoint(weights, self.device,
                                          require_host=False)
                self.model.load_state_dict(tree["model"])
            logging.info("===> Loaded weights from %s", weights)
        n_params = sum(p.numel() for p in self.model.parameters())
        logging.info("===> Number of trainable parameters: %d", n_params)

    # -- data -----------------------------------------------------------------
    def _to_device(self, host_batch):
        return to_torch(host_batch, self.device)

    def _fetch_data(self, augment: bool = True,
                    rng: Optional[np.random.Generator] = None):
        rng = rng if rng is not None else self.data_rng
        idxs = self.sampler.take(self.config.batch_size * self.n_data)
        if self.cp is not None:
            return self._fetch_data_cp(idxs, augment, rng)
        if self.n_dev > 1:
            return self._fetch_data_dp(idxs, augment, rng)
        if self.K > 0:
            # the query batch and the K neighbor batches, each from its own
            # spawned generator
            rngs = rng.spawn(1 + self.K)
            return self._build_train_batches(idxs, rngs[0], rngs[1:],
                                             augment)
        qb = build_batch_from_dataset(
            self.train_dataset, idxs, self.spec, rng, augment=augment,
            limit_numpoints=self.config.train_limit_numpoints)
        return self._to_device(qb), ()

    def _build_train_batches(self, idxs, q_rng, k_rngs, augment: bool):
        """The query batch of `idxs` and its K neighbor-slot batches, built
        concurrently (independent work, a generator each), on the
        device."""
        nbr_idxs = neighbor_slot_indices(self.train_dataset.neighbors, idxs,
                                         self.K) if self.K else []
        with ThreadPoolExecutor(max_workers=1 + self.K) as ex:
            fq = ex.submit(build_batch_from_dataset, self.train_dataset,
                           idxs, self.spec, q_rng, augment,
                           self.config.train_limit_numpoints)
            fks = [ex.submit(build_batch_from_dataset,
                             self.train_dataset, nbr_idxs[k], self.spec,
                             k_rngs[k], augment)
                   for k in range(self.K)]
            qb = fq.result()
            keys = tuple(self._to_device(f.result()) for f in fks)
        return self._to_device(qb), keys

    def _fetch_data_dp(self, idxs, augment: bool, rng):
        """This rank's chunk of the global batch, built from the generators
        that the JAX trainer gives chunk `rank` (`trainer.py:343`): of
        `rng.spawn(n * (1 + K))`, child `rank` for the query and child
        n * (1 + k) + rank for neighbor slot k."""
        n, r, B = self.n_dev, self.world.rank, self.config.batch_size
        rngs = rng.spawn(n * (1 + self.K))
        return self._build_train_batches(
            idxs[r * B:(r + 1) * B], rngs[r],
            [rngs[n * (1 + k) + r] for k in range(self.K)], augment)

    def _fetch_data_cp(self, idxs, augment: bool, rng):
        """This rank's collection member (`trainer.py:367`): of
        `rng.spawn(n_data * n_col)`, child d * n_col + c builds member c of
        data shard d (c = 0 the query chunk, c = k its neighbor slot k - 1).
        It travels in the qb slot; keys is ()."""
        B = self.config.batch_size
        d, c = self.cp.data_index, self.cp.col_index
        rngs = rng.spawn(self.n_data * self.n_col)
        chunk = idxs[d * B:(d + 1) * B]
        if c == 0:
            hb = build_batch_from_dataset(
                self.train_dataset, chunk, self.spec, rngs[d * self.n_col],
                augment, self.config.train_limit_numpoints)
        else:
            nbr = [self.train_dataset.neighbors[i][1][c - 1] for i in chunk]
            hb = build_batch_from_dataset(
                self.train_dataset, nbr, self.spec,
                rngs[d * self.n_col + c], augment)
        return self._to_device(hb), ()

    # -- train loop -----------------------------------------------------------
    @property
    def data_len(self) -> int:
        n_batches = max(len(self.train_dataset)
                        // (self.config.batch_size * self.n_data), 1)
        return (n_batches + self.config.iter_size - 1) // self.config.iter_size

    def _current_lr(self) -> float:
        if self.schedule is not None:
            return float(self.schedule(self.curr_iter))
        return float(self.plateau.lr) if hasattr(self, "plateau") else \
            self.config.lr

    def _set_lr(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _close_prefetch(self):
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None

    def _start_prefetch(self):
        """Overlap host batch construction with device compute
        (data/prefetch.py)."""
        if self._prefetch is None:
            # The worker thread owns its own generator (spawned here, on the
            # main thread) so it never mutates `data_rng` concurrently with
            # main-thread draws.
            worker_rng = self.data_rng.spawn(1)[0]
            self._prefetch = Prefetcher(
                lambda: self._fetch_data(rng=worker_rng), depth=2)

    def _train_iter(self):
        self._start_prefetch()
        self.iter_timer.tic()
        data_time, batch_loss = 0.0, 0.0
        pred = qb = None
        self.optimizer.zero_grad(set_to_none=True)
        for _ in range(self.config.iter_size):
            self.data_timer.tic()
            qb, keys = next(self._prefetch)
            data_time += self.data_timer.toc(False)
            loss, pred = self._grad_step(qb, keys, self.generator)
            batch_loss += float(loss) / self.config.iter_size
        if self.config.iter_size > 1:
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad /= self.config.iter_size
        self._reduce_grads()

        self._set_lr(self._current_lr())
        self.optimizer.step()

        self.data_time_avg.update(data_time)
        self.iter_time_avg.update(self.iter_timer.toc(False))

        ign = self.config.ignore_label
        mask_np = qb.point_mask.cpu().numpy()
        pred_np = np.where(mask_np, pred.cpu().numpy(), ign)
        target_np = np.where(mask_np, qb.labels.cpu().numpy(), ign)
        if self.world is None:
            score = M.precision_at_one_partnet(pred_np, target_np, ign)
            n = int(mask_np.sum())
        else:
            score, n = self._world_score(pred_np, target_np, mask_np)
        self.losses.update(batch_loss, n)
        self.scores.update(score, n)

    def _world_score(self, pred, target, mask) -> Tuple[float, int]:
        """`precision_at_one_partnet` and the valid point count over the
        query batches of every rank (on a key rank of the collection grid:
        none), from counts summed over the world."""
        ign = self.config.ignore_label
        correct = ((pred == target) | (target == 0))[target != ign]
        own = self.cp is None or self.cp.col_index == 0
        counts = torch.tensor([int(correct.sum()), correct.size,
                               int(mask.sum())], dtype=torch.int64) * own
        c, size, n = collectives.all_reduce(
            counts.to(self.device), self.world.group).tolist()
        return (c * 100.0 / size if size else float("nan")), n

    def _log_stats(self):
        lr = self._current_lr()
        logging.info(
            "===> Epoch[%d](%d/%d): Loss %.4f\tLR: %.3e\tScore %.3f\t"
            "Data time: %.4f, Total iter time: %.4f",
            self.epoch, self.curr_iter, self.data_len, self.losses.avg, lr,
            self.scores.avg, self.data_time_avg.avg, self.iter_time_avg.avg)
        self.data_time_avg.reset()
        self.iter_time_avg.reset()
        self.writer.add_scalar("training/loss", self.losses.avg,
                               self.curr_iter)
        self.writer.add_scalar("training/precision_at_1", self.scores.avg,
                               self.curr_iter)
        self.writer.add_scalar("training/learning_rate", lr, self.curr_iter)

    def _log_params(self):
        """Weight AND gradient histograms (`trainer_csn.py:309-313` logs
        both; grads come from the most recent train iteration)."""
        if not (self.config.save_param_histogram and self.writer.active):
            return
        for name, p in self.model.named_parameters():
            tag = self.model.__class__.__name__ + "/" + name.replace(".", "/")
            self.writer.add_histogram(tag, p.detach().cpu().numpy(),
                                      self.epoch)
            if p.grad is not None:
                self.writer.add_histogram(tag + ".grad",
                                          p.grad.cpu().numpy(), self.epoch)

    # -- eval -----------------------------------------------------------------
    def validate(self) -> Tuple[float, float, float, float]:
        res = self.test_on(self.val_dataset)
        self.writer.add_scalar("validation/PartIoU", res[2], self.curr_iter)
        self.writer.add_scalar("validation/ShapeIoU", res[3], self.curr_iter)
        self.writer.add_scalar("validation/loss", res[0], self.curr_iter)
        self.writer.add_scalar("validation/precision_at_1", res[1],
                               self.curr_iter)
        return res

    def test_on(self, dataset, save_pred_dir: Optional[str] = None
                ) -> Tuple[float, float, float, float]:
        """Evaluation loop (`trainer_csn.py:400-500`): per-shape IoU with the
        Mink metric definitions, loss and precision@1 averages. Returns
        (loss, precision@1, part IoU, shape IoU)."""
        bs = max(self.config.test_batch_size, 1)
        gbs = bs * (self.world.size if self.world is not None else 1)
        self._prepare_eval(dataset)
        losses, scores, ious = AverageMeter(), AverageMeter(), {}
        n = len(dataset)
        shape_id = 0
        for start in range(0, n, gbs):
            idxs, valid = _padded_indices(start, n, gbs)
            if self.world is not None:
                # every rank builds every chunk, in chunk order: the shared
                # `rng` makes the JAX trainer's draws; each forwards its own
                chunks = self._chunks(idxs, bs)
                hosts = [build_batch_from_dataset(dataset, ch, self.spec,
                                                  self.rng, augment=False)
                         for ch in chunks]
                # final-batch padding duplicates: masked out of the loss
                for gi in range(valid, gbs):
                    hosts[gi // bs].point_mask[gi % bs] = False
                loss, _, pred = self._eval_forward_dp(
                    dataset, chunks, self._to_device(hosts[self.world.rank]))
                pred = pred.cpu().numpy().reshape(gbs, -1)
                labels = np.concatenate([h.labels for h in hosts])
                mask = np.concatenate([h.point_mask for h in hosts])
                for h, lo in zip(hosts, loss.tolist()):
                    losses.update(lo, int(h.point_mask.sum()))
            else:
                qb_host = build_batch_from_dataset(dataset, idxs, self.spec,
                                                   self.rng, augment=False)
                # the final partial batch is padded by duplicating the last
                # shape; mask the duplicates out of the loss (metrics slice
                # [:valid])
                qb_host.point_mask[valid:] = False
                loss, _, pred = self._eval_forward(dataset, idxs,
                                                   self._to_device(qb_host))
                pred = pred.cpu().numpy()
                labels, mask = qb_host.labels, qb_host.point_mask
                losses.update(float(loss), int(mask[:valid].sum()))
            for b in range(valid):
                m = mask[b]
                g, p = labels[b][m], pred[b][m]
                scores.update(M.precision_at_one_partnet(p, g), int(m.sum()))
                ious[shape_id] = M.calculate_iou(g, p, self.num_labels)
                shape_id += 1
                # progress logging (`trainer_csn.py:477-486`)
                if (self.config.test_stat_freq > 0 and shape_id > 0
                        and shape_id % self.config.test_stat_freq == 0):
                    logging.info(
                        "===> Test iter %d/%d: Loss %.4f\tScore %.3f",
                        shape_id, n, losses.avg, scores.avg)
        part_iou = M.calculate_part_iou(ious, self.num_labels) * 100
        shape_iou = M.calculate_shape_iou(ious) * 100
        if save_pred_dir and self.rank == 0:
            os.makedirs(save_pred_dir, exist_ok=True)
            with open(osp.join(save_pred_dir, "results_log.txt"), "w") as f:
                f.write("Shape IoU: " + str(np.round(shape_iou, 2))
                        + "\nPart IoU: " + str(np.round(part_iou, 2)))
        return losses.avg, scores.avg, part_iou, shape_iou

    def _chunks(self, idxs, bs: int) -> List[List[int]]:
        """The world's chunks of a global batch, rank r's at r."""
        return [idxs[r * bs:(r + 1) * bs] for r in range(self.world.size)]

    def _fetch_eval_keys(self, dataset, idxs):
        return ()

    def _fetch_eval_keys_dp(self, dataset, chunks):
        return ()

    def _prepare_eval(self, dataset):
        """Hook run once at the top of `test_on` (CSN cached-eval builds the
        key-collection cache here)."""

    def _eval_forward(self, dataset, idxs, qb):
        return steps.eval_step(self.model, qb,
                               self._fetch_eval_keys(dataset, idxs),
                               self.config.ignore_label)

    def _eval_forward_dp(self, dataset, chunks, qb):
        """(loss [n], point logits of this rank, pred [n, B, P])."""
        return self.dp_steps.eval_step(
            qb, self._fetch_eval_keys_dp(dataset, chunks))

    # -- checkpointing --------------------------------------------------------
    def _tree_state(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def _host_state(self) -> Dict:
        st = {
            "iteration": self.curr_iter,
            "epoch": self.epoch + 1,
            "arch": self.config.model,
            "best_val_part_iou": self.best_val_part_iou,
            "best_val_part_iou_iter": self.best_val_part_iou_iter,
            "best_val_shape_iou": self.best_val_shape_iou,
            "best_val_shape_iou_iter": self.best_val_shape_iou_iter,
            "best_val_loss": float(self.best_val_loss),
            "best_val_loss_iter": self.best_val_loss_iter,
            "best_val_acc": self.best_val_acc,
            "best_val_acc_iter": self.best_val_acc_iter,
        }
        # host-side ReduceLROnPlateau state (current lr, best metric,
        # cooldown): without it a resumed run restarts at the config lr
        if hasattr(self, "plateau"):
            st["plateau"] = self.plateau.state_dict()
        return st

    def save_checkpoint(self, postfix: Optional[str] = None):
        """Rank 0 writes; every rank waits until the file is there (a
        plateau rebuild reads it back on every rank)."""
        if self.rank == 0:
            save_checkpoint(
                self.config.log_dir, self.config.model, self._tree_state(),
                self._host_state(), config=self.config.to_dict(),
                postfix=postfix, overwrite=self.config.overwrite_weights)
        if self.world is not None:
            self.world.barrier()

    def _save_best_checkpoints(self, val_loss, val_score, val_part_iou,
                               val_shape_iou):
        """`trainer_csn.py:330-346`."""
        if val_part_iou > self.best_val_part_iou:
            self.best_val_part_iou = val_part_iou
            self.best_val_part_iou_iter = self.curr_iter
            self.save_checkpoint(postfix="best_part_iou")
        if val_shape_iou > self.best_val_shape_iou:
            self.best_val_shape_iou = val_shape_iou
            self.best_val_shape_iou_iter = self.curr_iter
            self.save_checkpoint(postfix="best_shape_iou")
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            self.best_val_loss_iter = self.curr_iter
            self.save_checkpoint(postfix="best_loss")
        if val_score > self.best_val_acc:
            self.best_val_acc = val_score
            self.best_val_acc_iter = self.curr_iter
            self.save_checkpoint(postfix="best_acc")

    def _load_tree(self, path: str, load_optimizer: bool):
        tree, host = load_checkpoint(path, self.device)
        self.model.load_state_dict(tree["model"])
        if load_optimizer:
            self.optimizer.load_state_dict(tree["optimizer"])
        return host

    def resume(self):
        """`trainer_csn.py:348-387`."""
        path = osp.join(self.config.resume, LATEST)
        if not osp.isfile(path):
            raise ValueError(f"=> no checkpoint found at '{path}'")
        host = self._load_tree(path, self.config.resume_optimizer)
        self.curr_iter = host["iteration"] + 1
        self.epoch = host["epoch"]
        for k in ("best_val_part_iou", "best_val_shape_iou", "best_val_loss",
                  "best_val_acc"):
            if k in host:
                setattr(self, k, host[k])
                setattr(self, k + "_iter", host.get(k + "_iter", 0))
        if "plateau" in host and hasattr(self, "plateau"):
            self.plateau.load_state_dict(dict(host["plateau"]))
        logging.info("=> Loaded checkpoint '%s' (epoch %d)", path,
                     host["epoch"])
        return host

    def _run_epoch(self):
        for _ in range(self.data_len):
            self._train_iter()
            if (self.curr_iter % self.config.stat_freq == 0
                    or self.curr_iter == 1):
                self._log_stats()
            self.curr_iter += 1

    def _end_epoch(self, val_loss: float):
        if self.config.scheduler == "ReduceLROnPlateau":
            self.plateau.step(val_loss)
        if (self.config.save_param_histogram
                and self.epoch % self.config.param_histogram_freq == 0):
            self._log_params()
        self.losses.reset()
        self.scores.reset()
        self.epoch += 1


class SegTrainer(BaseTrainer):
    """`lib/trainer_seg.py`: plain per-epoch loop, validate, best ckpts,
    scheduler step."""

    def train(self):
        if not self.initialized:
            self.initialize()
        if self.config.scheduler == "ReduceLROnPlateau":
            self.plateau = ReduceLROnPlateau(
                lr=self.config.lr, factor=self.lr_factor, patience=10,
                cooldown=10)
        if self.config.resume:
            self.resume()
        logging.info("===> Start training")
        self._log_params()
        while self.is_training:
            self._run_epoch()
            if self.epoch >= self.config.max_epoch:
                self.is_training = False
                break
            self.save_checkpoint()
            val = self.validate()
            self._save_best_checkpoints(*val)
            self._end_epoch(val[0])
        val = self.validate()
        self.save_checkpoint()
        self._save_best_checkpoints(*val)
        self._close_prefetch()
        return val


class CSNTrainer(BaseTrainer):
    """`lib/trainer_csn.py`: CSN training with the shape-graph state machine."""

    MAX_PATIENCE, MAX_COOLDOWN, MAX_GRAPH_CONSTRUCTION = 10, 5, 3

    def __init__(self, model, config: Config, spec: PyramidSpec,
                 train_dataset, val_dataset, num_labels: int,
                 device: Optional[str] = None):
        super().__init__(model, config, spec, train_dataset, val_dataset,
                         num_labels, device)
        self.patience = self.MAX_PATIENCE
        self.cooldown = self.MAX_COOLDOWN
        self.n_graph_construction = 0
        self._collection_cache = None
        # data-parallel: this rank's shard (feats, pools, masks, per) and
        # the step that exchanges the neighbor rows
        self._collection_cache_dev = None
        self._dp_cached_eval_step = None

    def _uses_keys(self) -> bool:
        return True

    def _fetch_eval_keys(self, dataset, idxs):
        if self.K <= 0:
            return ()
        slots = neighbor_slot_indices(dataset.neighbors, idxs, self.K)
        return tuple(
            self._to_device(build_batch_from_dataset(
                self.train_dataset, slots[i], self.spec, self.rng,
                augment=False))
            for i in range(self.K))

    def _fetch_eval_keys_dp(self, dataset, chunks):
        """Every chunk's neighbor batches, slot-major in chunk order as
        the JAX trainer builds them (`trainer.py:787`), this rank's kept."""
        if self.K <= 0:
            return ()
        keys = []
        for i in range(self.K):
            kbs = [build_batch_from_dataset(
                self.train_dataset, [dataset.neighbors[idx][1][i]
                                     for idx in ch],
                self.spec, self.rng, augment=False) for ch in chunks]
            keys.append(self._to_device(kbs[self.world.rank]))
        return tuple(keys)

    # -- cached-collection eval ----------------------------------------------
    # `--cached_eval`: forward every train-collection shape ONCE through the
    # backbone (`HRNetSimCSN.cache_features`), keep the per-shape K/V features
    # + pooled SSA on the host (f16/f32), and evaluate queries with
    # `csa_from_cache`: a single-B backbone pass per batch instead of the
    # (K+1)-B combined pass. The reference re-forwards every neighbor per
    # query (`lib/trainer_csn.py:442-454`). Under data parallelism the
    # cache is built one chunk per rank and SHARDED over the ranks, each
    # holding N/n shapes; the neighbor rows are exchanged per eval batch
    # (parallel/collection.py).
    @torch.no_grad()
    def build_collection_cache(self):
        """Cache (features, ssa_pool, mask) for every train-collection shape.

        Host footprint N*L0*d f16, the same budget as the retrieval
        descriptor cache `_all_ssa_descriptors` holds (and what the
        reference keeps CPU-side in `csn_utils.py:66-83`). Rebuilt on every
        `test_on` call because it is a function of the current weights."""
        ds = self.train_dataset
        bs = max(self.config.test_batch_size, 1)
        n = len(ds)
        self.model.eval()
        feats_out, pools_out, masks_out = [], [], []
        for start in range(0, n, bs):
            idxs, valid = _padded_indices(start, n, bs)
            kb = build_batch_from_dataset(ds, idxs, self.spec, self.rng,
                                          augment=False)
            feats, pools = self.model.cache_features(self._to_device(kb))
            feats_out.append(feats[:valid].to(torch.float16).cpu().numpy())
            pools_out.append(pools[:valid].float().cpu().numpy())
            masks_out.append(np.asarray(kb.masks[0])[:valid])
        self._collection_cache = (np.concatenate(feats_out),
                                  np.concatenate(pools_out),
                                  np.concatenate(masks_out))

    @torch.no_grad()
    def build_collection_cache_dp(self):
        """The data-parallel cache build (`trainer.py:864`): n collection
        batches per step, one per rank (`make_dp_cache_step`); each rank
        keeps, of every gathered step, the rows of its own shard
        [rank * per, (rank + 1) * per) (`shard_collection`), so that no
        rank holds the whole collection."""
        ds = self.train_dataset
        bs = max(self.config.test_batch_size, 1)
        gbs = bs * self.world.size
        n = len(ds)
        per = -(-n // self.world.size)
        lo = self.world.rank * per
        cache_step = pc.make_dp_cache_step(self.model, self.world)
        own = ([], [], [])
        for start in range(0, n, gbs):
            idxs, valid = _padded_indices(start, n, gbs)
            hosts = [build_batch_from_dataset(ds, ch, self.spec, self.rng,
                                              augment=False)
                     for ch in self._chunks(idxs, bs)]
            feats, pools = cache_step(
                self._to_device(hosts[self.world.rank]))
            rows = (feats.reshape(gbs, *feats.shape[2:]).cpu().numpy(),
                    pools.reshape(gbs, -1).cpu().numpy(),
                    np.concatenate([h.masks[0] for h in hosts]))
            a = min(max(lo - start, 0), valid)
            b = min(max(lo + per - start, 0), valid)
            for out, x in zip(own, rows):
                out.append(x[a:b])
        cf, cpl, cm = (pc.shard_rows(np.concatenate(x), per, self.device)
                       for x in own)
        self._collection_cache_dev = (cf, cpl, cm, per)
        self._dp_cached_eval_step = pc.make_dp_cached_eval_step(
            self.model, self.world, per=per,
            ignore_label=self.config.ignore_label)

    def _prepare_eval(self, dataset):
        # a cache of an earlier call belongs to other weights, or to a run
        # with cached_eval on
        self._collection_cache = self._collection_cache_dev = None
        if self.config.cached_eval and self.K > 0:
            logging.info("===> Building cached-eval collection (%d shapes%s)",
                         len(self.train_dataset),
                         f", sharded over {self.world.size} ranks"
                         if self.world is not None else "")
            if self.world is not None:
                self.build_collection_cache_dp()
            else:
                self.build_collection_cache()

    def _eval_forward(self, dataset, idxs, qb):
        if self._collection_cache is None or self.K <= 0:
            return super()._eval_forward(dataset, idxs, qb)
        feats, pools, masks = self._collection_cache
        nbr = np.asarray([[dataset.neighbors[idx][1][i]
                           for i in range(self.K)] for idx in idxs])  # [B,K]

        def put(x):
            return torch.from_numpy(x).to(self.device)

        return steps.cached_eval_step(
            self.model, qb, put(feats[nbr]), put(pools[nbr]), put(masks[nbr]),
            self.config.ignore_label)

    def _eval_forward_dp(self, dataset, chunks, qb):
        if self._collection_cache_dev is None or self.K <= 0:
            return super()._eval_forward_dp(dataset, chunks, qb)
        cf, cpl, cm, _ = self._collection_cache_dev
        idx = torch.tensor([[[dataset.neighbors[i][1][k]
                              for k in range(self.K)] for i in ch]
                            for ch in chunks])         # [n, B, K] global
        return self._dp_cached_eval_step(qb, cf, cpl, cm, idx)

    # -- shape graph ----------------------------------------------------------
    @torch.no_grad()
    def _all_ssa_descriptors(self, dataset):
        """Batched SSA features for every shape (augmentations disabled, like
        `csn_utils.py:26-27`). Returns (feats [N, L0, d] fp16, masks
        [N, L0]). Data-parallel: one chunk per rank and step, gathered, so
        that every rank returns every shape's features."""
        bs = self.config.batch_size
        gbs = bs * (self.world.size if self.world is not None else 1)
        n = len(dataset)
        self.model.eval()
        feats_out, masks_out = [], []
        for start in range(0, n, gbs):
            idxs, valid = _padded_indices(start, n, gbs)
            if self.world is not None:
                hosts = [build_batch_from_dataset(dataset, ch, self.spec,
                                                  self.rng, augment=False)
                         for ch in self._chunks(idxs, bs)]
                ssa = self.dp_steps.ssa_step(
                    self._to_device(hosts[self.world.rank]))
                ssa = ssa.reshape(gbs, *ssa.shape[2:])
                m0 = np.concatenate([h.masks[0] for h in hosts])
            else:
                qb_host = build_batch_from_dataset(dataset, idxs, self.spec,
                                                   self.rng, augment=False)
                ssa = self.model(self._to_device(qb_host), return_ssa=True)
                m0 = np.asarray(qb_host.masks[0])
            feats_out.append(ssa[:valid].to(torch.float16).cpu().numpy())
            masks_out.append(m0[:valid])
        return np.concatenate(feats_out), np.concatenate(masks_out)

    def _measure(self, q_feats, q_mask, k_feats, k_mask):
        """Mean-of-max cosine retrieval measure, on the trainer's device;
        data-parallel: the keys sharded over the ranks."""
        if self.world is not None:
            return dp.sharded_retrieval_measure(q_feats, q_mask, k_feats,
                                                k_mask, self.world)
        return retrieval.retrieval_measure(q_feats, q_mask, k_feats, k_mask,
                                           device=self.device)

    def construct_shape_graph(self, recalculate: bool):
        """`trainer_csn.py:262-282` + `csn_utils.py:11-111`: random pairs on
        first construction, SSA cosine retrieval on rebuilds. Train neighbors
        come from the train set (self-excluded); val neighbors from the train
        set."""
        # Flush the prefetch queue first: queued batches were built from the
        # OLD neighbor graph, and the worker thread must not read
        # `train_dataset.neighbors` while it is being replaced. The next
        # `_train_iter` restarts the prefetcher over the new graph.
        self._close_prefetch()
        K = self.config.k_neighbors
        if not recalculate:
            logging.info("===> Get random pairs")
            self.train_dataset.neighbors = retrieval.random_pairs(
                len(self.train_dataset), len(self.train_dataset), K,
                is_same=True, rng=self.rng)
            self.val_dataset.neighbors = retrieval.random_pairs(
                len(self.val_dataset), len(self.train_dataset), K,
                is_same=False, rng=self.rng)
        else:
            logging.info("===> Get pairs based on cosine similarity (SSA)")
            tr_feats, tr_masks = self._all_ssa_descriptors(self.train_dataset)
            measure = self._measure(tr_feats, tr_masks, tr_feats, tr_masks)
            self.train_dataset.neighbors = retrieval.knn_graph_from_measure(
                measure, K, is_same=True)
            va_feats, va_masks = self._all_ssa_descriptors(self.val_dataset)
            measure = self._measure(va_feats, va_masks, tr_feats, tr_masks)
            self.val_dataset.neighbors = retrieval.knn_graph_from_measure(
                measure, K, is_same=False)
        # Log the first 2 query point clouds WITH their retrieved neighbors
        # (`csn_utils.py:99-109`).
        for idx in range(min(2, len(self.train_dataset))):
            pc = self.train_dataset.coords[idx]
            self.writer.add_mesh(f"training/query_pc_{idx}", pc[None, ...],
                                 self.n_graph_construction)
            for nn_idx in self.train_dataset.neighbors[idx][1]:
                npc = self.train_dataset.coords[nn_idx]
                self.writer.add_mesh(
                    f"training/query_pc_{idx}/neighbor_pc_{nn_idx}",
                    npc[None, ...], self.n_graph_construction)

    # -- checkpoint extensions ------------------------------------------------
    def _host_state(self):
        st = super()._host_state()
        if self.config.k_neighbors > 0:
            st["csn_data"] = {
                "patience": self.patience,
                "cooldown": self.cooldown,
                "n_graph_construction": self.n_graph_construction,
                "train_neighbors": [[x[0], list(x[1])]
                                    for x in self.train_dataset.neighbors],
                "val_neighbors": [[x[0], list(x[1])]
                                  for x in self.val_dataset.neighbors],
            }
        return st

    def resume(self):
        host = super().resume()
        if "csn_data" in host:
            cd = host["csn_data"]
            self.patience = cd["patience"]
            self.cooldown = cd["cooldown"]
            self.n_graph_construction = cd["n_graph_construction"]
            self.train_dataset.neighbors = [
                (int(a), list(b)) for a, b in cd["train_neighbors"]]
            self.val_dataset.neighbors = [
                (int(a), list(b)) for a, b in cd["val_neighbors"]]
            logging.info("===> Patience=%d, Cooldown=%d, #Graph construction=%d",
                         self.patience, self.cooldown,
                         self.n_graph_construction)
        return host

    def _new_plateau(self) -> ReduceLROnPlateau:
        return ReduceLROnPlateau(
            lr=self.config.lr, factor=self.lr_factor,
            patience=self.MAX_PATIENCE, cooldown=self.MAX_COOLDOWN * 2)

    def _rebuild_on_plateau(self):
        """Patience exhausted: reload best-part-IoU weights, rebuild the shape
        graph, reset counters (`trainer_csn.py:136-158`)."""
        self._close_prefetch()  # pending batches use the old graph
        ckpt = osp.join(self.config.log_dir,
                        checkpoint_name(self.config.model, "best_part_iou"))
        logging.info("=====> Loading checkpoint '%s'", ckpt)
        # `trainer_csn.py:143-148`: with resume_optimizer the best
        # checkpoint's *optimizer state* is reloaded too (momentum buffers
        # carry over from the best epoch) and the lr resets to config.lr.
        self._load_tree(ckpt, load_optimizer=self.config.resume_optimizer)
        if self.config.resume_optimizer:
            self._set_lr(self.config.lr)
            if hasattr(self, "plateau"):
                self.plateau = self._new_plateau()
        self.construct_shape_graph(recalculate=True)
        self.n_graph_construction += 1
        self.patience = self.MAX_PATIENCE
        self.cooldown = self.MAX_COOLDOWN
        self.save_checkpoint()

    # -- main loop ------------------------------------------------------------
    def train(self):
        """`trainer_csn.py:54-186`."""
        if not self.initialized:
            self.initialize()
        if self.config.scheduler == "ReduceLROnPlateau":
            self.plateau = self._new_plateau()
        logging.info("===> Start training")

        if self.config.resume:
            self.resume()
            if self.config.k_neighbors > 0 and self.patience <= 0:
                self.construct_shape_graph(recalculate=True)
                self.n_graph_construction += 1
                self.patience = self.MAX_PATIENCE
                self.cooldown = self.MAX_COOLDOWN

        self._log_params()

        if self.config.k_neighbors > 0 and not self.config.resume:
            self.construct_shape_graph(recalculate=False)
            self.n_graph_construction += 1

        while self.is_training:
            self._run_epoch()

            if self.epoch >= self.config.max_epoch:
                self.is_training = False
                break

            self.save_checkpoint()
            self.cooldown -= 1
            val_loss, val_score, val_part_iou, val_shape_iou = self.validate()
            if val_part_iou > self.best_val_part_iou:
                self.patience = self.MAX_PATIENCE
            elif (self.config.k_neighbors > 0
                    and self.n_graph_construction
                    < self.MAX_GRAPH_CONSTRUCTION):
                if self.cooldown <= 0:
                    self.cooldown = 0
                    self.patience -= 1
                    logging.info(
                        "=====> (Iteration:%d) Patience running out "
                        "(patience:%d)", self.curr_iter, self.patience)
                else:
                    logging.info("=====> (Iteration:%d) Getting hotter "
                                 "(cooldown:%d)", self.curr_iter, self.cooldown)
            self._save_best_checkpoints(val_loss, val_score, val_part_iou,
                                        val_shape_iou)

            if self.config.k_neighbors > 0 and self.patience <= 0:
                self._rebuild_on_plateau()

            self._end_epoch(val_loss)

        val = self.validate()
        self.save_checkpoint()
        self._save_best_checkpoints(*val)
        self._log_params()
        self._close_prefetch()
        return val

    def construct_test_graph(self, test_dataset):
        """Eval-time graph: test neighbors always retrieved from the TRAIN
        collection (`tasks/main_csn.py:121-141`)."""
        tr_feats, tr_masks = self._all_ssa_descriptors(self.train_dataset)
        te_feats, te_masks = self._all_ssa_descriptors(test_dataset)
        measure = self._measure(te_feats, te_masks, tr_feats, tr_masks)
        test_dataset.neighbors = retrieval.knn_graph_from_measure(
            measure, self.config.k_neighbors, is_same=False)

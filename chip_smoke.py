"""Smoke run of the PyTorch port on one CUDA GPU: build the kernels, check
each against its plain version at the main paths' shapes, then serve a few
eval requests and take a few train steps of HRNetSimCSN3S (K=1) and of the
MID-FC CrossShapeAt heads (CSA on 500-point chunks; SSA with full attention
through a ring of one) at full width, run the HRNet trainer and the eval
CLI's path with the sparse conv in its im2col form (CSN_DYNG=2), then the
Res16UNet34C trainer, a ResUNet14 and a ResNet14 forward, the feature
extraction -> SSA -> kNN -> CSA -> `get_csa_pred` chain and the probes, and
the multi-device trainers as far as one card runs them (a data-parallel
world of one; two collection-parallel ranks sharing the card), and last the
learning check of the JAX package's `scripts/learning_check.py` in the
port's form, with the device-side IoU counts.

    python3 chip_smoke.py [--profile]

With --profile, phases 4-8 also run their step (phase 4 its eval step,
phase 8 also whole trainer iterations) under `torch.profiler` and print the
device's busy share and the device time by kernel (the breakdown PERF.md
quotes).

Phases (each prints its lines; any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi), the C++ host
     engine;
  2. build: nvcc of csn_tpu_torch/csrc/*.cu, one process per source;
  3. kernels, each in f32 and bf16 against its plain version on the same
     inputs, with median times of both (bf16, the main path's type):
     K1 (sparse conv) on every map and width of the model, and on every
     transpose map with the weights transposed (the backward's d_feats),
     where its tensor-core bodies run (bf16, and f32 in split TF32, with
     Cout % 8 == 0, the stems' Cin 3 included) also against a float64 conv
     of the same operands (K1_F64_TOL; f32 TF32_F64_TOL), and at the stems
     (its flattened steps) and on the split-TF32 bodies a repeat that must
     be bitwise equal and the densest
     offset made all sentinels (bitwise equal to that offset's W zeroed;
     rows without a live offset exact zeros); `sparse_conv_dw` (dW) at the
     same convs, random asymmetric weights, against `conv_bwd_plain`, and
     where its tensor-core bodies run (the same rule; the narrow body at
     the bf16 stems) also against a float64 reduction of the same operands
     (DW_F64_TOL; f32 TF32_F64_TOL), a repeat that must be bitwise equal,
     and the map with its densest offset made all sentinels (exact zeros
     there, the other offsets' bits unchanged), at the stems (the narrow
     body, bf16 and f32) against the im2col `dw_only` body (DW_F64_TOL;
     f32 TF32_F64_TOL), plus synthetic maps at the bodies' edges (rows not
     a multiple of their steps, splits spanning two compaction chunks,
     empty / full / one-row offsets, part channel tiles, the stems' 3 -> 32
     and 24 -> 40 on the narrow body in bf16 and f32, 48 -> 40 and 160 ->
     200 on the wide split-TF32 body, the f32 ones with a shorter last
     split), and K1's f32 flattened steps at 40 -> 64 over 27 offsets,
     24 -> 40 and 3 -> 40 over 5 (K*Cin no multiple of the step or the
     k-step); K1, d_feats, dW and the im2col pair timed in f32 at every
     conv of HRNetSimCSN3S and Res16UNet34C as device time from CUDA
     graphs; on the same inputs
     `sparse_conv_im2col_fwd` against `conv_im2col_plain` and K1 (bitwise
     where it runs K1's tensor-core body), and `sparse_conv_im2col_bwd`
     (d_feats and dW; dW only for the stem) against `conv_im2col_bwd_plain`
     and K1 / `sparse_conv_dw`, and where their tensor-core bodies run
     (bf16, and f32 in split TF32, Cout % 8 == 0, the stem included:
     `im2col_tensor_cores`, K1's rule) the forward, d_feats (K1_F64_TOL;
     f32 TF32_F64_TOL) and dW (DW_F64_TOL; f32 TF32_F64_TOL) against
     float64 references of the same operands, repeats that must be bitwise
     equal, the densest transpose-map offset made all sentinels (exact
     zeros there, the other offsets' bits unchanged), and the forward
     bitwise equal to K1, plus
     synthetic maps at the bodies' edges in bf16 and f32 (rows not a
     multiple of the row tile or the 256-row super-tile, splits with a
     remainder, Cin/Cout 48/40 and 160/200, the stem with a dead and a
     one-row offset, 640 offsets) and a
     `[perconv]` line per timed conv (per call, the im2col forward
     against K1 and each form's backward function as the autograd function
     calls it); K2 (flash attention) at the SSA and CSA
     shapes with masks, and at a ragged shape (Lq 1000 against Lk 777, a
     ragged key mask with one fully masked 64-key tile, one query tile all
     padding), at head dims 64 (4 heads) and 256 (8 heads), at dropout 0
     and 0.1 (same seed as the plain version); `flash_attn_bwd` at the same
     cases against autograd of the plain version; the f32 bodies in split
     TF32 at D=64 and D=128 (`check_f32_split`: d_model 256 in 4 heads and
     2) against float64 references (out, lse, dq, dk, dv within 1e-4 x
     max|ref|, the f32 plain version's error beside) at the ragged masks
     and the SSA masks cut to 2 shapes, at dropout 0 and 0.1, every launch
     repeated bitwise, then their device times (CUDA graphs) at the full
     SSA and CSA calls beside the bound, the library call and the plain
     version; both again at the head
     dims the main path does not run (`check_head_dims`): 32 and 16 (bf16
     on their tensor-core bodies; d_model 256 in 8 and 16 heads) at the
     SSA masks cut to 8 and 4 shapes and at the ragged masks, and 24 on
     the ragged masks, f32 and bf16, the ones without a body of their own
     zero-padded to the next, at the D=64 tolerances, and the widths 128
     and 256 (d_model 256 in 2 heads and 1: the bf16 bodies of the
     `_bf16_wide` rows, f32 in split TF32, at 128 the `_tf32_d128` rows) at
     the SSA masks (16 shapes) and the ragged masks;
     then the bf16 pair's device times (CUDA graphs) at the full SSA call
     for D = 64, 32, 16, 128 and 256, at the CSA call at D=128 and at the
     MID-FC chunk shape beside the bound and the library call, the calls of
     the `_bf16_wide` rows' paths in the kernel line; K3 (voxel -> point
     interpolation) and `interp_bwd` against their plain versions on the
     query batch's corner table, at 39 classes in f32 (the main path's
     form, timed for the kernel line) and bf16, and at the extraction
     chain's 256 channels in f32 and bf16 (timed beside the line); K2 and
     `flash_attn_bwd` at the MID-FC chunk shape [80, 8, 500, 256], the f32
     forward (out, lse) and backward at dropout 0.1 also against a float64
     reference beside the f32 plain version; `flash_attn_carry` chained
     over 4 key blocks of 2500 at [2, 8, 10000, 256] against
     `online_block_update` chained the same way and against one K2 pass
     over all 10000 keys, and `flash_attn_block_bwd` summed over the 4
     blocks against one `flash_attn_bwd` call, in f32 and in bf16 (the
     `_bf16_wide` rows: the carry and block forms of K2's bf16 split
     bodies) at dropout 0 and 0.1, each launch repeated bitwise; in the
     chains cut unevenly (blocks at columns 1, 3, 2 mod 4, f32 and bf16,
     dropout 0.1) the carry and the block backward also against a float64
     reference beside the f32 plain version, with a wrong-offset run that
     must disagree, a slice of the query rows at its row offset, and a
     block with padding query rows (scattered, and one padding 64-row
     tile) whose carry must pass through bit for bit; both timed at the
     ring of one (device time from CUDA graphs at dropout 0.1 and 0) beside
     the bound, the plain chain and the library call; all of it again at
     [2, 8, 10000, 128] (phase 7c's head dim: f32 on the split-TF32 D=128
     bodies' carry and block forms, rows `flash_attn_carry_tf32_d128` and
     `flash_attn_block_bwd_tf32_d128`; bf16 on the `_bf16_wide` rows, the
     carry form of `csrc/flash_tc_fwd.cuh` and the block form of
     `csrc/flash_bf16_wide_bwd.cuh` at 128), and at [2, 8, 10000, 64]
     (phase 7d's head dim: f32 on the split-TF32 D=64 bodies' carry and
     block forms, rows `flash_attn_carry_tf32_d64` and
     `flash_attn_block_bwd_tf32_d64`; bf16 on the carry form of
     `csrc/flash_tc_fwd.cuh` and the block form of `csrc/flash_tc_bwd.cuh`
     at 64, rows `flash_attn_carry_bf16_d64` and
     `flash_attn_block_bwd_bf16_d64`); the
     carry chain and the block backward zero-padded by their wrappers (D=32
     f32, D=24 bf16, masked, dropout 0.1, `check_ring_padded`) against the
     same plain chains, and a ring of one at D=24 bf16 (padded once at its
     entry) against `FlashAttentionFn` forward and backward; the
     four conv kernels again on every (map, Cin, Cout) of Res16UNet34C
     (8-offset k2 maps, five levels, widths 96, 192, 384; timed, B=8) and
     of ResUNet14 and ResNet14 (1-offset k1 maps, six
     levels, widths up to 768; checked only, B=2); the probe kernels:
     `probe_window_gather` in f32 and bf16, both layouts, W = 384 and 256,
     matched and unmatched, and with row ids outside the window (zero rows,
     the others bitwise); `probe_gather_accum` in its three modes (the
     one-hot product on the tensor cores, the gathers in 16-byte vectors)
     against the plain version, against each other, against a float64 sum
     of the same window values and bitwise against a repeat, bf16 and f32
     windows, with row ids outside the window; `probe_slot_load` in every
     variant, bit for bit, with ptxas's registers and shared memory of its
     kernels; the probes timed as device time from CUDA graphs beside
     `index_select` and `F.embedding_bag`, and the launch floor (an empty
     kernel's launch in a CUDA graph) beside `probe_slot_load`'s bound;
  4. eval slice: 3 eval requests (query batch + 1 key batch each) through
     `eval_step`, launch counts per kernel, ms/step, shapes/s, peak memory,
     and the f32 forward with kernels against the plain forward on the CPU;
  5. train slice: 3 train requests through `train_step` (bf16, attention
     dropout 0.1, SGD lr 0.05), launch counts per kernel and step, ms/step
     over 10 steps, shapes/s, peak memory; then one f32 train step at
     dropout 0 on B=2 shapes with the kernels on the GPU against the same
     step with the plain versions on the CPU (loss and every gradient),
     the CPU step taking the GPU step's ReLU decisions (`ReluDecisions`);
     then the same protocol with f32 activations (`--compute_dtype
     float32`): 3 eval and 3 train requests with exact launch counts per
     kernel body (the split-TF32 bodies counted apart), ms/step of the eval
     and the train step (with --profile: the attention and conv kernels of
     each step named, none of them a CUDA-core body), and all of it again
     under CSN_DYNG=2, the im2col pair's split-TF32 bodies once per conv
     (47 forwards, and 47 backwards per train request; K1 and
     `sparse_conv_dw` never), its ms/step beside the K1 form's; then the
     bf16 protocol again at d_model 256 in 2 heads of 128: 3 eval and 3
     train requests with exact launch counts (K2 and its backward in the
     `_bf16_wide` rows), ms/step of both; 5c: the f32 protocol in the K1
     form again in 2 heads of 128 (K2 and its backward in the `_tf32_d128`
     rows, the split-TF32 bodies at D=128; with --profile the attention
     kernels named, none a CUDA-core body), and one f32 B=2 train step
     at dropout 0 in those heads against the plain step on the CPU;
  6. MID-FC chunked, the JAX package's `bench.py` midfc protocol:
     `MidfcRunner(cfg, "csa")` with 8 heads of 256, K=4, B=4, P=10000,
     d_model 256, chunks of 500, 39 classes, f32, Adam(0.5, 0.999), seeded
     numpy features: 3 eval requests and 3 train steps through the runner's
     own `_eval` / `_grad` / `_apply`, launch counts per step, ms/step,
     shapes/s, peak memory; then one f32 B=1 step at dropout 0 with the
     kernels on the GPU against the plain step on the CPU; then all of it
     again with `compute_dtype="bfloat16"` (K2 and its backward at head dim
     256 on the bf16 bodies of the `_bf16_wide` rows), the B=1 step against
     the CPU's bf16 step within GRAD_TOL_BF16 / LOSS_TOL_BF16;
  7. MID-FC full attention through the ring (a ring of one: what one card
     can run): `CrossShapeAt("ssa", chunk_size=None)` sharded over a
     `torch.distributed` group of one rank, through the `parallel/midfc.py`
     steps at B=2: one eval request and one train step on
     `flash_attn_carry` and `flash_attn_block_bwd`, the logits held against
     the same model without the group (K2), ms per eval and train step,
     one f32 B=1 step against the CPU's; 7b: the same with
     `compute_dtype="bfloat16"` on the `_bf16_wide` rows (no launch of the
     CUDA-core or f32 ring rows), the B=1 step against the CPU's bf16 step
     within GRAD_TOL_BF16 / LOSS_TOL_BF16; 7c: both again at d_model 128 (8
     heads of 128, the factory's d_k = d_v = d_model): the ring's
     `_tf32_d128` rows in f32 and `_bf16_wide` rows in bf16, one carry per
     eval and one carry and one block backward per train step, the logits
     against the same model without the group (K2 at 128), the B=1 steps
     against the CPU's at phase 7's and 7b's tolerances; 7d: both again at
     d_model 64 (8 heads of 64): the ring's `_tf32_d64` rows in f32 and
     `_bf16_d64` rows in bf16, with 7c's counts and checks (K2 at 64 for
     the model without the group);
  8. the trainer, inside CSN_DYNG=2: `tasks/main_csn.build_trainer` and
     `CSNTrainer.train()` on HRNetSimCSN3S at the protocol below (SGD, bf16)
     over an in-memory synthetic collection (16 train, 8 val, 8 test shapes
     of `make_surface_shape`; no h5 file), 2 epochs, MAX_PATIENCE =
     MAX_COOLDOWN = 1: every loss finite, the first graph built from random
     pairs, exact launch counts per train iteration (the im2col pair once
     per conv, K1 and `sparse_conv_dw` never), ms per iteration inside
     `train()`, the host batch build alone, the step alone on a fixed
     batch, peak memory, the checkpoints and `config.json` on disk; then the
     eval CLI's path on a fresh trainer: `resume()` (iteration, bests,
     neighbour lists and every model tensor as saved), `construct_test_graph`
     and a graph rebuild timed, `test_on` recomputed and with `cached_eval`
     (launch counts per request, ms per shape, predictions in [1, C-1], the
     two agreeing on >= 99.9 % of points and within 1e-3 in IoU: the cache
     is f16); then one f32 B=2 train step under CSN_DYNG=2 on the GPU against
     the plain step on the CPU, as in phase 5;
  9. the other model families and the MID-FC chain: `tasks/main_seg.
     build_trainer` with `--model Res16UNet34C` (bf16, B=8, the protocol
     below with five levels) and `SegTrainer.train()` for 2 epochs on the
     in-memory collection, exact launch counts per iteration (55 convs: K1
     109 times, `sparse_conv_dw` 55), one more validation through `test_on`,
     ms per train step and eval request in both conv forms, one f32 B=2 step
     against the CPU in both conv forms; a ResUNet14 and a ResNet14 f32
     forward (B=2) against the plain forward on the CPU; then an HRNetSeg3S
     trainer (1 epoch), `extract_split` of its train and test collections
     into a temporary directory, `midfc.run_training` `ssa`, `save_knn` and
     `csa` on those files (8 heads of 256, K=1, 10000 points in 500-point
     chunks, `--testing`: one batch per epoch), `kmeans_candidate_indices`
     on descriptors with a known answer, `get_csa_pred` on the result
     (f32 through the flash kernels, held to its own `--device cpu` run) and
     the launcher's `pred` mode; last the probes' own entry points
     (`probes.dyngather`, `dyngather2`, `iw_bwd` `main()`), which print the
     `timing onehot|smem|global` lines;
 10. the multi-device trainers, as far as one card runs them: (a) the
     HRNet trainer at the protocol (K1 form) built inside an NCCL world of
     one rank, which takes the data-parallel steps, against the same
     trainer without a world: 3 train iterations with losses and every
     model tensor after each bitwise equal and equal launch counts, a graph
     rebuild whose `sharded_retrieval_measure` equals `retrieval_measure`,
     `test_on` with `cached_eval` through `shard_collection` /
     `exchange_rows` equal to the single-device cached eval, and the step's
     ms beside the single-device step's; (b) two rank processes of this
     script (`--cp-rank`) sharing the card over gloo as a (1 data x 2 col)
     collection grid, HRNetSimCSN3S at full width, B=2 per member, K=1: the
     f32 eval logits within 1e-3 max|ref| of the single-process combined
     pass, one bf16 train step with a finite loss and the parameters
     bitwise equal on both ranks, and its ms. Scaling across cards is not
     measured: one card cannot show it;
 11. the learning check (`tasks/learning_check.py` at the JAX script's
     defaults, the K1 form): csn (HRNetSimCSN2S, d_model 64 in 2 heads:
     K2 and its backward on the bf16 D=32 tensor-core bodies, which a
     spy on the wrappers confirms), seg (HRNetSeg2S) and midfc (the CSA
     runner, f32, 150 steps), each required to end below 0.8 x its first
     loss; then one eval request of the trained csn model through
     `batch_intersection_union` on the card, equal to the same call on
     the CPU and, through `mink_metrics_from_iu`, to the host's per-shape
     IoU.
The line before the last is the kernel table as JSON: per kernel (K1,
`sparse_conv_dw` and the im2col pair in two rows each: their split-TF32
bodies, the f32 form, as `sparse_conv_fwd_tf32`, `sparse_conv_dw_tf32`,
`sparse_conv_im2col_fwd_tf32` and `sparse_conv_im2col_bwd_tf32`, and their
other bodies; K2 and its backward likewise, their f32 split-TF32 bodies
at D=64 as `flash_attn_fwd_tf32_d64` and `flash_attn_bwd_tf32_d64` and at
D=128 as `flash_attn_fwd_tf32_d128` and `flash_attn_bwd_tf32_d128`, their
bf16 bodies at head dims 128 and 256 as `flash_attn_fwd_bf16_wide` and
`flash_attn_bwd_bf16_wide`; the ring's carry and block backward with
their f32 D=128 bodies as `flash_attn_carry_tf32_d128` and
`flash_attn_block_bwd_tf32_d128` and their bf16 bodies at 128 and 256 as
`flash_attn_carry_bf16_wide` and `flash_attn_block_bwd_bf16_wide`), its
launches in the train requests of phases 5 (bf16, f32, f32 under
CSN_DYNG=2, bf16 in heads of 128 and f32 in heads of 128), 6 (f32 and
bf16),
7 (f32, bf16, and both at d_model 128), 8, 9, 10 and 11 (each
phase sets the counts to 0 before and reads them after; phase 9 counts the
Res16UNet34C train iterations, the chain and the probes' entry points;
phase 10 the data-parallel trainer's iterations; phase 11 the three
learning-check trainings), its worst error
over phase 3's checks, and four times summed over one train step's launches
of every path the kernel is on (bf16 at the HRNet and Res16UNet34C shapes,
the split-TF32 rows f32 there as device time from CUDA graphs (the
`_tf32_d64` and `_tf32_d128` rows: one SSA and one CSA call each, the
plain version one call;
the `_bf16_wide` rows likewise: one SSA and one CSA call at D=128 and 9
MID-FC chunk calls at D=256, bf16; the ring's rows one call at the ring of
one per head dim of its path, device time from CUDA graphs, the plain
chain one call),
f32 at the MID-FC shapes; the interpolation pair f32 at 39 classes, as the
HRNet heads' f32 logits reach it; the probe kernels, as device time
from CUDA graphs: one call of `probe_window_gather` at [384, 128] f32, the
three modes of `probe_gather_accum` with the bf16 window at 352 tiles x 9
offsets, the seven variants of `probe_slot_load`):
the kernel's and the plain version's median ms, `bound_ms`, the least time
the card could take (the larger of bytes / 3.35 TB/s and operations / the
peak of the input type: 989 TFLOP/s bf16, 494.7 / 3 TFLOP/s f32 (split
TF32: three dense TF32 products per f32 product), the interpolation pair's
f32 FMAs over 67 TFLOP/s, counting valid
rows and keys only), and `library_ms`, the time of the one PyTorch call
that computes the same function (`F.scaled_dot_product_attention` for the
attention kernels, at their dropout, timed here and used nowhere in the
port; null where there is no such call; `embedding_bag` for the readout and
the accumulating gather probe, its gradient for the readout's backward,
`index_select` for the window gather probe). The last line is
{"ok": true, "device": {...}}.

Protocol (the JAX package's bench.py): B=8 query shapes of 10000 points,
voxel 0.05, level-0 cap 5632, level caps shrinking 3x, k5 stem, d_model 256,
4 heads, 39 classes, activations in bf16; weights are random, drawn from a
seeded generator. Float32 products run without TF32 everywhere, in the
kernel-vs-plain checks as in the models.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from csn_tpu_torch import kernels
from csn_tpu_torch.config import Config
from csn_tpu_torch.core import (
    conv, interp, interp_window, native, window_conv,
)
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.data.synthetic import (
    SurfaceShapeDataset, make_surface_shape,
)
from csn_tpu_torch.midfc import extraction, get_csa_pred, run_training
from csn_tpu_torch.midfc.training import (
    CHECKPOINT_NAME, MidfcConfig, MidfcRunner,
)
from csn_tpu_torch.models import (
    blocks, hrnet, load_model, res16unet, resnet, resunet,
)
from csn_tpu_torch.models.layers import SparseConv
from csn_tpu_torch.ops import attention, flash
from csn_tpu_torch.parallel import collectives, cp, dp
from csn_tpu_torch.parallel.midfc import make_midfc_steps
from csn_tpu_torch.probes import dyngather, dyngather2, iw_bwd
from csn_tpu_torch.retrieval import graph as retrieval_graph
from csn_tpu_torch.tasks import learning_check, main_csn, main_seg
from csn_tpu_torch.tools import conv_ab
from csn_tpu_torch.tools.timing import graph_ms
from csn_tpu_torch.train import metrics, optim
from csn_tpu_torch.train.steps import eval_step, train_step
from csn_tpu_torch.train.trainer import build_batch_from_dataset

B, P, VOXEL, K_NEIGHBORS = 8, 10000, 0.05, 1
LEVEL0_CAP, SHRINK, STEM_K = 5632, 3.0, 5
D_MODEL, N_HEAD, NUM_CLASSES = 256, 4, 39
WIDE_HEADS = 2   # phase 5's requests again at d_model 256 in heads of 128
N_REQUESTS, TIMED_STEPS, SEED = 3, 10, 0
ATTN_DROPOUT, LR = 0.1, 0.05
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max|ref|
# the ring's per-block kernels given a column offset one off must disagree
# with the plain version at the right offset by more than this x max|ref|
# (the shifted dropout mask differs in about a fifth of its entries): 100x
# TOL in f32, 5x in bf16
WRONG_OFFSET = {torch.float32: 1e-2, torch.bfloat16: 1e-1}
# f32 train step, kernels on the GPU vs plain on the CPU: x max|ref| per
# gradient tensor
GRAD_TOL = 1e-3
# K1's tensor-core body (bf16) against a float64 conv of the same bf16
# operands: x max|ref|, two bf16 ulps (the f32 sums are stored once in bf16)
K1_F64_TOL = 4e-3
# dW's tensor-core body (bf16 operands, f32 sums stored in f32) against a
# float64 reduction of the same bf16 operands: x max|ref| (no output
# rounding; the f32 sums over up to 90112 rows per offset)
DW_F64_TOL = 1e-4
# the split-TF32 bodies of K1 and dW (f32) against float64 sums of the same
# f32 operands: x max|ref|, the f32 checks' tolerance (TOL). Three TF32
# products per f32 product drop ~2^-22 of each (one TF32 product misses
# the tolerance); what is left is the tensor cores' f32 accumulation, which
# truncates the sum of every mma.sync. K1 adds each k-step's products to
# its running sum in f32 (with one accumulator over the 5184 mma.sync of a
# 512-channel, 27-offset output it came to 9.8e-5 in these checks on an
# H100); dW keeps one accumulator over a split's live pairs (2.9e-5 at most
# in these checks).
TF32_F64_TOL = 1e-4
# the probe gather_accum's bodies against a float64 sum of the same window
# values: x max|ref|. The f32 sums of 9 offsets (27 products of the split
# f32 window on the tensor cores) round at most 27 times by an ulp of a
# running sum below 9 x max|win|, about 3.5 x max|ref| here: under 1.2e-5;
# a window rounded to bf16 (2^-9 of each value) misses it many times over.
PROBE_F64_TOL = 2e-5
# the bf16 MID-FC step, kernels on the GPU vs plain on the CPU, both in
# bf16: x max|ref| per gradient tensor (TOL's bf16 tolerance: a few bf16
# roundings, which the kernels and the plain version place differently),
# and x |ref| for the loss (the f32 logit head reads bf16 attention outputs,
# each rounded to 2^-9 of itself)
GRAD_TOL_BF16, LOSS_TOL_BF16 = 2e-2, 2e-3
# gradients that vanish analytically (a bias right before train-mode
# BatchNorm): held to GRAD_TOL x the largest gradient of the step
VANISHING = {"fc1.linear.bias"}

# the MID-FC protocol (the JAX package's bench.py, mode midfc)
MF_HEADS, MF_K, MF_B, MF_P, MF_D, MF_CHUNK = 8, 4, 4, 10000, 256, 500
MF_RING_B, MF_BLOCKS = 2, 4   # phase 7's batch; key blocks of phase 3's chain
# the head dims of the ring's forms that phases 7 and 7b (256), 7c (128:
# d_model 128) and 7d (64: d_model 64) run, timed in phase 3 at the ring of
# one
RING_TIMED_DIMS = (MF_D, 128, 64)
RAGGED_LQ, RAGGED_LK = 1000, 777   # phase 3's ragged flash case
LC_TASKS = ("csn", "seg", "midfc")   # phase 11, the learning check

HBM_BYTES_S = 3.35e12                       # H100 SXM, NVIDIA's data sheet
# f32: the f32 products run on the tensor cores in split TF32, three TF32
# products each at the dense TF32 rate of 494.7 TFLOP/s, so the least time
# for f32-accurate products is 3 x work / 494.7e12 (the CUDA cores' f32
# rate, 67 TFLOP/s, is slower)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
# f32 FMAs on the CUDA cores (the interpolation pair, in either type)
PEAK_FLOPS_FMA = 67e12

KERNELS = {
    "sparse_conv_fwd": ("csn_tpu_torch/csrc/sparse_conv.cu",
                        "csn_tpu/core/window_conv.py:973"),
    "sparse_conv_dw": ("csn_tpu_torch/csrc/sparse_conv_bwd.cu",
                       "csn_tpu/core/window_conv.py:1067"),
    # the f32 forms of K1 and sparse_conv_dw: their split-TF32 bodies on the
    # tensor cores (f32 with Cout % 8 == 0, the stems' flattened steps and
    # narrow body included), whose launches count apart; the two rows above
    # are the bf16 bodies and the CUDA-core ones (Cout % 8 != 0)
    "sparse_conv_fwd_tf32": ("csn_tpu_torch/csrc/sparse_conv_tc.cuh",
                             "csn_tpu/core/window_conv.py:973"),
    "sparse_conv_dw_tf32": ("csn_tpu_torch/csrc/sparse_conv_bwd.cu",
                            "csn_tpu/core/window_conv.py:1067"),
    "sparse_conv_im2col_fwd": ("csn_tpu_torch/csrc/sparse_conv_im2col.cu",
                               "csn_tpu/core/window_conv.py:1021"),
    "sparse_conv_im2col_bwd": ("csn_tpu_torch/csrc/sparse_conv_im2col_bwd.cu",
                               "csn_tpu/core/window_conv.py:1135"),
    # the f32 forms of the im2col pair (CSN_DYNG=2/3): the forward on K1's
    # split-TF32 body, the backward's split-TF32 body, whose launches count
    # apart; the two rows above are the bf16 bodies and the CUDA-core ones
    "sparse_conv_im2col_fwd_tf32": ("csn_tpu_torch/csrc/sparse_conv_tc.cuh",
                                    "csn_tpu/core/window_conv.py:1021"),
    "sparse_conv_im2col_bwd_tf32": (
        "csn_tpu_torch/csrc/sparse_conv_im2col_bwd.cu",
        "csn_tpu/core/window_conv.py:1135"),
    # the MID-FC bodies (f32, head dim 256, split TF32 on the tensor cores);
    # flash_attn.cu, flash_attn_bwd.cu, flash_attn_carry.cu and
    # flash_attn_block_bwd.cu hold the dispatch (and the bf16 head-dim-64
    # bodies); sparse_conv.cu holds K1's dispatch to the tensor-core body
    # of sparse_conv_tc.cuh and its CUDA-core body
    "flash_attn_fwd": ("csn_tpu_torch/csrc/flash_tf32_fwd.cuh",
                       "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd": ("csn_tpu_torch/csrc/flash_tf32_bwd.cuh",
                       "csn_tpu/ops/flash.py:600"),
    # the f32 D=64 forms of K2 and its backward (the HRNet heads with f32
    # activations): their split-TF32 bodies, whose launches count apart
    "flash_attn_fwd_tf32_d64": ("csn_tpu_torch/csrc/flash_tf32_d64_fwd.cuh",
                                "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd_tf32_d64": ("csn_tpu_torch/csrc/flash_tf32_d64_bwd.cuh",
                                "csn_tpu/ops/flash.py:600"),
    # the f32 D=128 forms (the HRNet heads with f32 activations at d_model
    # 256 in 2 heads): their split-TF32 bodies (the backward's passes are
    # flash_tf32_bwd.cuh's at head dim 128), whose launches count apart
    "flash_attn_fwd_tf32_d128": ("csn_tpu_torch/csrc/flash_tf32_d128_fwd.cuh",
                                 "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd_tf32_d128": ("csn_tpu_torch/csrc/flash_tf32_bwd.cuh",
                                 "csn_tpu/ops/flash.py:600"),
    # the bf16 forms of K2 and its backward at head dims 128 and 256 (d_model
    # 256 in 2 heads or 1, the MID-FC heads in bf16): their tensor-core
    # bodies, whose launches count apart (the forward at 128 runs
    # flash_tc.cuh's template, which flash_attn.cu instantiates)
    "flash_attn_fwd_bf16_wide": ("csn_tpu_torch/csrc/flash_bf16_wide_fwd.cuh",
                                 "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd_bf16_wide": ("csn_tpu_torch/csrc/flash_bf16_wide_bwd.cuh",
                                 "csn_tpu/ops/flash.py:600"),
    # the ring's carry and block backward: their f32 D=256 forms (split
    # TF32)
    "flash_attn_carry": ("csn_tpu_torch/csrc/flash_tf32_fwd.cuh",
                         "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd": ("csn_tpu_torch/csrc/flash_tf32_bwd.cuh",
                             "csn_tpu/ops/flash.py:488"),
    # their f32 and bf16 D=64 forms (the MID-FC full attention at d_model
    # 64, phase 7d): the carry and block forms of K2's D=64 bodies (f32 in
    # split TF32; bf16 on flash_tc_fwd.cuh's and flash_tc_bwd.cuh's
    # templates), whose launches count apart
    "flash_attn_carry_tf32_d64": ("csn_tpu_torch/csrc/flash_tf32_d64_fwd.cuh",
                                  "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd_tf32_d64": (
        "csn_tpu_torch/csrc/flash_tf32_d64_bwd.cuh",
        "csn_tpu/ops/flash.py:488"),
    "flash_attn_carry_bf16_d64": ("csn_tpu_torch/csrc/flash_tc_fwd.cuh",
                                  "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd_bf16_d64": ("csn_tpu_torch/csrc/flash_tc_bwd.cuh",
                                      "csn_tpu/ops/flash.py:488"),
    # their f32 D=128 forms (the MID-FC full attention at d_model 128, phase
    # 7c): the carry and block forms of K2's split-TF32 D=128 bodies, whose
    # launches count apart
    "flash_attn_carry_tf32_d128": (
        "csn_tpu_torch/csrc/flash_tf32_d128_fwd.cuh",
        "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd_tf32_d128": (
        "csn_tpu_torch/csrc/flash_tf32_bwd.cuh",
        "csn_tpu/ops/flash.py:488"),
    # their bf16 forms at head dims 256 and 128 (the MID-FC full attention in
    # bf16, phases 7b and 7c): the carry and block forms of K2's bf16
    # tensor-core bodies (the carry at 128 on flash_tc_fwd.cuh's template),
    # whose launches count apart
    "flash_attn_carry_bf16_wide": (
        "csn_tpu_torch/csrc/flash_bf16_wide_fwd.cuh",
        "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd_bf16_wide": (
        "csn_tpu_torch/csrc/flash_bf16_wide_bwd.cuh",
        "csn_tpu/ops/flash.py:488"),
    "interp_fwd": ("csn_tpu_torch/csrc/interp.cu",
                   "csn_tpu/core/interp_window.py:288"),
    "interp_bwd": ("csn_tpu_torch/csrc/interp_bwd.cu",
                   "csn_tpu/core/interp_window.py:322"),
    "probe_window_gather": ("csn_tpu_torch/csrc/probe_gather.cu",
                            "scripts/probe_dyngather.py:37"),
    "probe_gather_accum": ("csn_tpu_torch/csrc/probe_gather.cu",
                           "scripts/probe_dyngather.py:109"),
    "probe_slot_load": ("csn_tpu_torch/csrc/probe_slots.cu",
                        "scripts/probe_iw_bwd.py:52"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median device time of one call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def build_requests(spec, dev, n_shapes=B, n_requests=N_REQUESTS, seed=SEED):
    """n_requests (query batch, key batch) pairs of n_shapes shapes each,
    each from its own seed."""
    reqs = []
    for r in range(n_requests):
        rng = np.random.default_rng(seed + 1000 * r)
        qb, kb = (pipeline.collate_shapes(
            [make_surface_shape(rng, P) for _ in range(n_shapes)],
            spec, rng=rng) for _ in range(K_NEIGHBORS + 1))
        reqs.append((qb, kb))
    if any(reqs[0][0].dropped[1:]):
        print(f"[batch] voxels dropped by the level caps in request 0's "
              f"query batch: {reqs[0][0].dropped}")
    return [(to_torch(q, dev), (to_torch(k, dev),)) for q, k in reqs]


class ReluDecisions:
    """Records which entries each masked ReLU of one forward passes, and
    makes another forward take the same decisions. A train step's gradient
    is only piecewise smooth: at full width a step has about 10^7 ReLU
    inputs, some within float32 rounding of zero, and each that falls on
    the other side on another device moves a conv's gradient by up to 1 %
    of its max (measured: a 1e-7 relative parameter noise moves the plain
    step's gradients by up to 1.2e-2 of their max, PERF.md). Replaying the
    GPU step's decisions on the CPU leaves only rounding between the two;
    `flips` counts the decisions the CPU forward would have taken
    otherwise."""

    def __init__(self):
        self.masks = []
        self.flips = 0
        self.inputs = 0

    def _record(self, x, mask):
        keep = mask[..., None] & (x > 0)
        self.masks.append(keep.cpu())
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    def _replay(self, x, mask):
        keep = self.masks[self._next].to(x.device)
        self._next += 1
        self.flips += int((keep != (mask[..., None] & (x > 0))).sum())
        self.inputs += int(mask.sum()) * x.shape[-1]
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    @contextlib.contextmanager
    def active(self, replay: bool):
        """Within: the models' masked ReLU records (replay False) or
        replays (replay True) the decisions."""
        self._next = 0
        fn = self._replay if replay else self._record
        mods = (blocks, hrnet, res16unet, resunet, resnet)
        saved = [m.relu_masked for m in mods]
        for m in mods:
            m.relu_masked = fn
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.relu_masked = f


def make_model(cls, dtype: str, attn_dropout: float, n_head: int = N_HEAD):
    kw = {}
    if issubclass(cls, hrnet.HRNetSimCSN):
        kw = dict(d_model=D_MODEL, n_head=n_head, k_neighbors=K_NEIGHBORS,
                  attn_dropout=attn_dropout)
    model = cls(out_channels=NUM_CLASSES, conv1_kernel_size=STEM_K,
                compute_dtype=dtype, **kw)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


class Table:
    """Per-kernel results for the JSON kernel line."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}
        self.bound_ms = {k: 0.0 for k in KERNELS}
        self.bound_bytes_ms = {k: 0.0 for k in KERNELS}
        self.bound_ops_ms = {k: 0.0 for k in KERNELS}
        self.library_ms = {k: None for k in KERNELS}
        self.dw_f64 = []   # (error / max|ref|) of each dW float64 line
        # (error / max|ref|) of the split-TF32 bodies' float64 lines
        self.tf32_f64 = {"sparse_conv_fwd_tf32": [],
                         "sparse_conv_dw_tf32": [],
                         "sparse_conv_im2col_fwd_tf32": [],
                         "sparse_conv_im2col_bwd_tf32": []}
        # (error / max|ref|) of the im2col pair's bf16 float64 lines:
        # forward and d_feats, dW
        self.im2col_f64 = {"out": [], "dW": []}

    def check(self, name, what, got, ref, dtype, valid=None, exact=False):
        """One `[check]` line: `got` within TOL[dtype] x max|ref| of `ref`,
        or with `exact` bit for bit (tolerance 0)."""
        got, ref = got.float(), ref.float()
        if valid is not None:
            got = torch.where(valid, got, torch.zeros_like(got))
            ref = torch.where(valid, ref, torch.zeros_like(ref))
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 0.0 if exact else TOL[dtype] * scale
        ok = bool(torch.isfinite(got).all()) and (
            torch.equal(got, ref) if exact else err <= tol)
        print(f"[check] {name} {what} {str(dtype)[6:]}: max_abs_err {err:.3e}"
              f" tol {tol:.3e}{', bitwise' if exact else ''} "
              f"(max|ref| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {what} {dtype} disagrees with its plain version")
        self.err[name] = max(self.err[name], err)

    def time(self, name, what, fn_kernel, fn_plain, count=1, reps=7, *,
             nbytes, flops, dtype=torch.bfloat16, peak_flops=None,
             fn_library=None, graph=False, graph_calls=20):
        """Median ms of the kernel and its plain version, the call's bound
        (`nbytes` moved once over the memory rate, `flops` over
        `peak_flops`, by default the peak of `dtype`) and, with
        `fn_library`, the median ms of the one PyTorch call that computes
        the same function; all added `count` times to the train step's
        totals (count 0: printed only). With `graph`, the kernel's and the
        library call's ms are device times from CUDA graphs of
        `graph_calls` calls with a warm L2 (`graph_ms`), the line also
        shows the kernel's time from device memory and one call timed with
        its wrapper, and the plain version (not capturable: it synchronises
        with the host) stays one call with its host work. Returns the
        kernel's median ms."""
        gkw = dict(calls=graph_calls, reps=7 if graph_calls >= 20 else 3)
        ms = graph_ms(fn_kernel, **gkw) if graph else median_ms(fn_kernel)
        pms = median_ms(fn_plain, warmup=1, reps=reps)
        b_ms = nbytes / HBM_BYTES_S * 1e3
        o_ms = flops / (peak_flops or PEAK_FLOPS[dtype]) * 1e3
        kern = (f"kernel {ms:.4f} ms (device, CUDA graph, warm L2; from "
                f"device memory {graph_ms(fn_kernel, cold=True, **gkw):.4f} "
                f"ms; one call with its wrapper {median_ms(fn_kernel):.4f} "
                f"ms)" if graph else f"kernel {ms:.4f} ms")
        line = (f"[time] {name} {what} {str(dtype)[6:]}: {kern}, "
                f"plain {pms:.4f} ms{' (one call)' if graph else ''}, "
                f"bound {max(b_ms, o_ms):.4f} ms "
                f"({'bytes' if b_ms >= o_ms else 'operations'}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        lms = None
        if fn_library is not None:
            lms = graph_ms(fn_library, **gkw) if graph \
                else median_ms(fn_library, warmup=1, reps=reps)
            line += f", library {lms:.4f} ms{' (device)' if graph else ''}"
        print(f"{line} (x{count} per train step)" if count
              else f"{line} (not in the kernel line)")
        self.add(name, count, ms, pms, b_ms, o_ms, lms)
        return ms

    def add(self, name, count, ms, plain_ms, bytes_ms, ops_ms,
            library_ms=None):
        """One call's kernel, plain, bound (bytes and operations) and
        library ms, added `count` times to the train step's totals."""
        self.ms[name] += count * ms
        self.plain_ms[name] += count * plain_ms
        self.bound_ms[name] += count * max(bytes_ms, ops_ms)
        self.bound_bytes_ms[name] += count * bytes_ms
        self.bound_ops_ms[name] += count * ops_ms
        if library_ms is not None and count:
            self.library_ms[name] = (self.library_ms[name] or 0.0) \
                + count * library_ms

    def bound(self, name):
        """(bound_ms, bound_by) of the kernel's launches of one train step:
        each call's bound is the larger of its two times; `bound_by` names
        the larger share of the total."""
        by = "bytes" if self.bound_bytes_ms[name] >= self.bound_ops_ms[name] \
            else "operations"
        return self.bound_ms[name], by


def conv_work(kmap, n_in, cin, cout, es, out_es):
    """(bytes, flops) of one sparse conv over `kmap` [K, N_out] from n_in
    source rows: features, map, weights and output moved once; two
    operations per (valid map entry, cin, cout). The same count holds for
    the dW reduction over the transpose map (out_es 4: dW is f32)."""
    k, n_out = kmap.shape
    nnz = int((kmap < n_in).sum())
    return (n_in * cin * es + k * n_out * 4 + k * cin * cout * out_es
            + n_out * cout * es, 2 * nnz * cin * cout)


def conv_bwd_work(kmap_t, n_g, cin, cout, es, input_grad):
    """(bytes, flops) of the fused im2col backward over `kmap_t` [K, N_in]
    from n_g gradient rows: features, gradient (once), map and f32 dW moved
    once, and with `input_grad` the stacked weights and d_feats; two
    operations per (valid map entry, cin, cout) for dW and two for
    d_feats."""
    k, n_in = kmap_t.shape
    nnz = int((kmap_t < n_g).sum())
    nbytes = (n_in * cin * es + n_g * cout * es + k * n_in * 4
              + k * cin * cout * 4)
    if input_grad:
        nbytes += k * cin * cout * es + n_in * cin * es
    return nbytes, 2 * nnz * cin * cout * (2 if input_grad else 1)


def conv_f64(feats, kmap, weights):
    """The sparse conv in float64 on the same operands (bf16 values held
    exactly): the reference that bounds K1's one rounding."""
    f, w = feats.double(), weights.double()
    out = torch.zeros((kmap.shape[1], w.shape[2]), dtype=torch.float64,
                      device=feats.device)
    for k in range(kmap.shape[0]):
        out += conv.gather_rows(f, kmap[k]) @ w[k]
    return out


def check_f64(table, name, what, got, ref, tol, vs="float64",
              body="bfloat16 (tensor cores)"):
    """One `vs float64` line of a kernel body (by default a bf16
    tensor-core body): max|got - ref| within tol x max|ref| (ref a float64
    result of the same operands, or, named by `vs`, another body's f32 sums
    of them). Returns the error's share of max|ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    print(f"[check] {name} {what} {body} vs {vs}: "
          f"max_abs_err {err:.3e} tol {tol * scale:.3e} (max|ref| "
          f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name} {what}: {body} vs {vs}")
    table.err[name] = max(table.err[name], err)
    return err / scale if scale else 0.0


def check_same(name, what, check, same, body="bfloat16 (tensor cores)"):
    """One exact line of a kernel body (by default a bf16 tensor-core
    body): `check` holds (`same`)."""
    print(f"[check] {name} {what} {body} {check} "
          f"{'ok' if same else 'FAIL'}")
    require(same, f"{name} {what}: {check}")


def check_dead_offset(name, what, dw_call, kmap_t, n_g, dw,
                      body="bfloat16 (tensor cores)"):
    """The map `kmap_t` with its densest offset made all sentinels:
    `dw_call(map)` -> dW_t gives exact zeros at that offset and the bits of
    `dw` (the call on `kmap_t`) at every other."""
    k0 = int((kmap_t < n_g).sum(1).argmax())
    dead = kmap_t.clone()
    dead[k0] = n_g
    got = dw_call(dead)
    zero = not got[k0].any().item()
    rest = torch.equal(torch.cat([got[:k0], got[k0 + 1:]]),
                       torch.cat([dw[:k0], dw[k0 + 1:]]))
    check_same(name, what, f"offset {k0} without live rows: exact zeros "
               f"{zero}, other offsets bitwise equal {rest}", zero and rest,
               body)


def form_name(kernel, dtype, cin, cout):
    """The row of the kernel line that a conv of K1 or `sparse_conv_dw`
    (`kernel`) counts in: its split-TF32 form, or the kernel's other
    bodies."""
    tf32 = window_conv.k1_split_tf32(dtype, cin, cout)
    return f"{kernel}_tf32" if tf32 else kernel


def tc_body(dtype):
    """The tensor-core body of a dtype, as the check lines name it."""
    return ("float32 (split TF32)" if dtype == torch.float32
            else "bfloat16 (tensor cores)")


def check_k1_f64(table, what, got, feats, kmap, weights):
    """K1's tensor-core body against `conv_f64`: bf16 within K1_F64_TOL,
    f32 (split TF32) within TF32_F64_TOL."""
    dt, cin, cout = feats.dtype, feats.shape[1], weights.shape[2]
    name = form_name("sparse_conv_fwd", dt, cin, cout)
    tf32 = dt == torch.float32
    err = check_f64(table, name, what, got, conv_f64(feats, kmap, weights),
                    TF32_F64_TOL if tf32 else K1_F64_TOL, body=tc_body(dt))
    if tf32:
        table.tf32_f64[name].append(err)


def check_k1_flat(what, got, feats, kmap, weights):
    """K1's tensor-core bodies where no other check pins their bits (the
    flattened steps at Cin % 16 != 0, the stems; the split-TF32 body),
    beside `check_k1_f64`: a repeat bitwise equal, and the map with its
    densest offset made all sentinels bitwise equal to the map as it is
    with that offset's W zeroed (a dead offset adds exact zeros), its rows
    without a live offset exact zeros."""
    dt = feats.dtype
    name = form_name("sparse_conv_fwd", dt, feats.shape[1], weights.shape[2])
    body = tc_body(dt)
    check_same(name, what, "repeat: bitwise equal", torch.equal(
        got, window_conv.sparse_conv_fwd(feats, kmap, weights)), body)
    n_in = feats.shape[0]
    k0 = int((kmap < n_in).sum(1).argmax())
    dead = kmap.clone()
    dead[k0] = n_in
    w0 = weights.clone()
    w0[k0] = 0
    out = window_conv.sparse_conv_fwd(feats, dead, weights)
    same = torch.equal(out, window_conv.sparse_conv_fwd(feats, kmap, w0))
    rows = ((dead < 0) | (dead >= n_in)).all(0)
    zero = not out[rows].any().item()
    check_same(name, what, f"offset {k0} without live rows: bitwise equal "
               f"to W[{k0}] = 0 {same}, the {int(rows.sum())} rows without "
               f"a live offset exact zeros {zero}", same and zero, body)


def dw_f64(feats, g, kmap_t):
    """dW_t in float64 on the same operands (bf16 values held exactly):
    dW_t[k] = feats^T . gather(g, kmap_t[k]), the reference that bounds the
    tensor-core body's f32 sums."""
    f, gg = feats.double(), g.double()
    return torch.stack([f.t() @ conv.gather_rows(gg, kmap_t[k])
                        for k in range(kmap_t.shape[0])])


def check_dw_tc(table, what, feats, g, kmap_t):
    """`sparse_conv_dw` on its tensor-core body: against `dw_f64` within
    DW_F64_TOL (bf16) or TF32_F64_TOL (f32, split TF32), a second call
    equal bit for bit, and the same map with one offset made all sentinels
    (the densest one): exact zeros there and the first call's bits at every
    other offset. Returns the first call."""
    dt = feats.dtype
    name = form_name("sparse_conv_dw", dt, feats.shape[1], g.shape[1])
    body = tc_body(dt)
    got = window_conv.sparse_conv_dw(feats, g, kmap_t)
    err = check_f64(table, name, what, got, dw_f64(feats, g, kmap_t),
                    TF32_F64_TOL if dt == torch.float32 else DW_F64_TOL,
                    body=body)
    (table.tf32_f64[name] if dt == torch.float32 else table.dw_f64).append(
        err)
    check_same(name, what, "repeat: bitwise equal", torch.equal(
        got, window_conv.sparse_conv_dw(feats, g, kmap_t)), body)
    check_dead_offset(name, what,
                      lambda km: window_conv.sparse_conv_dw(feats, g, km),
                      kmap_t, g.shape[0], got, body)
    return got


def check_dw_edges(dev, table, g):
    """The tensor-core dW bodies on synthetic maps cut to their edges: N_in
    not a multiple of the row step (the wide body's 32 live pairs, the
    narrow one's tile of 256), splits whose row counts are not either and
    that span more than one compaction chunk (pairs carried over), an
    offset fully live, one without a live row, one with only the last row,
    sparse ones; Cin and Cout that leave part tiles: the wide body at 48 and
    40 (one warp row of 16 channels, a half 16-column block) and 160 and
    200 (a 32-channel Cin tile, one 256-column tile), the narrow body at 3
    and 32 (the stems' channels) and 24 and 40 (two 16-channel tiles, the
    second half empty; a 64-column tile with a half 16-column block);
    the wide body in f32 (split TF32) at 48 and 40 and 160 and 200, whose
    rows and live pairs per split are no multiple of its 8-pair k-step, and
    the narrow body in f32 at 3 and 32 and 24 and 40, the f32 ones with a
    last split shorter than the others. Against the plain version (TOL) and
    `check_dw_tc`."""
    n_in, n_g = 9 * window_conv.DW_TC_CHUNK + 77, 7000
    gen = torch.Generator().manual_seed(SEED + 7)
    pick = torch.randint(0, n_g, (5, n_in), generator=gen, dtype=torch.int32)
    live = torch.rand(5, n_in, generator=gen) < torch.tensor(
        [0.3, 1.0, 0.0, 0.0, 0.05])[:, None]
    live[3, -1] = True
    kmap_t = torch.where(live, pick, n_g).to(dev)
    bf, f32 = torch.bfloat16, torch.float32
    for cin, cout, dt in ((48, 40, bf), (160, 200, bf), (3, 32, bf),
                          (24, 40, bf), (48, 40, f32), (160, 200, f32),
                          (3, 32, f32), (24, 40, f32)):
        step = (window_conv.DW_NARROW_TILE if cin % 16
                else 8 if dt == f32 else window_conv.DW_TC_STEP)
        s = window_conv.dw_splits(n_in, 5, cin, cout, tensor_cores=True,
                                  dtype=dt)
        rows = -(-n_in // s)
        require(n_in % step and rows % step and rows > window_conv.DW_TC_CHUNK
                and s > 1 and (dt == bf or n_in % rows),
                f"dW edge case {cin}->{cout}: S={s} rows {rows}")
        f = torch.randn(n_in, cin, generator=gen).to(dev, dt)
        gd = torch.randn(n_g, cout, generator=gen).to(dev, dt)
        what = (f"edges {cin}->{cout} N_in={n_in} S={s} ({rows} rows per "
                f"split, the last {n_in - (s - 1) * rows}; step {step})")
        got = check_dw_tc(table, what, f, gd, kmap_t)
        _, ref = conv.conv_bwd_plain(
            f, gd, kmap_t, torch.zeros(5, cin, cout, device=dev), False,
            False)
        table.check(form_name("sparse_conv_dw", dt, cin, cout), what, got,
                    ref, dt)
        require(not got[2].any().item() and got[3].any().item(),
                f"dW {what}: the empty offset and the one-row offset")


def check_k1_edges(dev, table):
    """K1's flattened steps in f32 (split TF32, Cin % 16 != 0) on synthetic
    maps cut to their edges: N_out = 7000 rows (no multiple of the 128- or
    64-row tile), K*Cin no multiple of the 32-column step (1080 at Cin 40 x
    27 offsets, 120 at 24 x 5) or of the 8-column k-step (15 at 3 x 5), Cout
    40 (a part column block) and 64; an offset without a live row, one with
    only the last row, sparse ones. Against the plain version (TOL),
    float64 (`check_k1_f64`) and `check_k1_flat`."""
    n_in, n_out = 9000, 7000
    gen = torch.Generator().manual_seed(SEED + 9)
    for cin, cout, n_off in ((40, 64, 27), (24, 40, 5), (3, 40, 5)):
        live = torch.rand(n_off, n_out, generator=gen) < 0.5 * torch.rand(
            n_off, 1, generator=gen)
        live[2] = False
        live[3] = False
        live[3, -1] = True
        kmap = torch.where(live, torch.randint(
            0, n_in, (n_off, n_out), generator=gen, dtype=torch.int32),
            n_in).to(dev)
        f = torch.randn(n_in, cin, generator=gen).to(dev)
        w = ((torch.rand(n_off, cin, cout, generator=gen) * 2 - 1)
             / (cin * n_off) ** 0.5).to(dev)
        what = f"edges {cin}->{cout} K={n_off} N_out={n_out}"
        got = window_conv.sparse_conv_fwd(f, kmap, w)
        table.check(form_name("sparse_conv_fwd", torch.float32, cin, cout),
                    what, got, conv.conv_plain(f, kmap, w), torch.float32)
        check_k1_f64(table, what, got, f, kmap, w)
        check_k1_flat(what, got, f, kmap, w)


def check_im2col_fwd_tc(table, what, feats, kmap, weights):
    """`sparse_conv_im2col_fwd` on its tensor-core bodies (K1's: bf16, and
    f32 in split TF32, `im2col_tensor_cores`): against `conv_f64`
    (K1_F64_TOL; f32 TF32_F64_TOL), a repeat bitwise equal, and bitwise
    equal to K1 (one body: K1's loop where Cin % 16 == 0, the flattened
    steps elsewhere). Returns the first call."""
    dt = feats.dtype
    name = form_name("sparse_conv_im2col_fwd", dt, feats.shape[1],
                     weights.shape[2])
    body = tc_body(dt)
    out = window_conv.sparse_conv_im2col_fwd(feats, kmap, weights)
    err = check_f64(table, name, what, out, conv_f64(feats, kmap, weights),
                    TF32_F64_TOL if dt == torch.float32 else K1_F64_TOL,
                    body=body)
    (table.tf32_f64[name] if dt == torch.float32
     else table.im2col_f64["out"]).append(err)
    check_same(name, what, "repeat: bitwise equal", torch.equal(
        out, window_conv.sparse_conv_im2col_fwd(feats, kmap, weights)), body)
    loop = ("K1's loop" if feats.shape[1] % 16 == 0
            else "the flattened steps")
    check_same(name, what, f"vs K1 ({loop}): bitwise equal",
               torch.equal(out, window_conv.sparse_conv_fwd(feats, kmap,
                                                            weights)), body)
    return out


def check_im2col_bwd_tc(table, what, feats, g, kmap_t, w_pair, dw_only):
    """`sparse_conv_im2col_bwd` on its tensor-core bodies (bf16, and f32 in
    split TF32): d_feats (unless `dw_only`) against `conv_f64` over the
    transpose map with the paired weights `w_pair` [K, Cin, Cout]
    transposed (K1_F64_TOL; f32 TF32_F64_TOL), dW against `dw_f64`
    (DW_F64_TOL; f32 TF32_F64_TOL), a repeat bitwise equal in both, and the
    same map with its densest offset made all sentinels: exact zeros in that
    offset's dW, the first call's bits at every other offset. Returns the
    first call's dW_t [K, Cin, Cout]."""
    dt = feats.dtype
    tf32 = dt == torch.float32
    name = form_name("sparse_conv_im2col_bwd", dt, feats.shape[1],
                     g.shape[1])
    body = tc_body(dt)
    n_off = kmap_t.shape[0]
    wt_flat = None if dw_only else conv.stack_pair_transposed(
        w_pair).contiguous()

    def call(km):
        d, dw = window_conv.sparse_conv_im2col_bwd(feats, g, km, wt_flat,
                                                   dw_only)
        return d, conv.unstack_dw(dw, n_off)

    def f64_line(part, got, ref, tol):
        err = check_f64(table, name, f"{what} {part}", got, ref,
                        TF32_F64_TOL if tf32 else tol, body=body)
        (table.tf32_f64[name] if tf32
         else table.im2col_f64["out" if part == "d_feats" else part]
         ).append(err)

    what = f"{what} dw_only {dw_only}"
    d_feats, dw = call(kmap_t)
    if not dw_only:
        f64_line("d_feats", d_feats,
                 conv_f64(g, kmap_t, w_pair.transpose(1, 2)), K1_F64_TOL)
    f64_line("dW", dw, dw_f64(feats, g, kmap_t), DW_F64_TOL)
    d2, dw2 = call(kmap_t)
    check_same(name, what, "repeat: bitwise equal", torch.equal(dw, dw2)
               and (dw_only or torch.equal(d_feats, d2)), body)
    check_dead_offset(name, what, lambda km: call(km)[1], kmap_t, g.shape[0],
                      dw, body)
    return dw


def check_im2col_edges(dev, table, g):
    """The im2col pair's tensor-core bodies, bf16 and f32 (split TF32), on
    synthetic maps cut to their edges: a conv from N_in = 141 super-tiles -
    179 rows (not a multiple of the backward's 256-row super-tile) to 7000
    rows (not a multiple of the forward's 64- or 128-row tile), with splits
    of whole super-tiles that leave a remainder; offsets fully live, without
    a live row, with only the last row, sparse ones; Cin and Cout 48 and 40
    (a part channel tile, chunks of 64 bf16 or 32 f32 columns that span
    offsets, in f32 a part last chunk of 8 columns) and 160 and 200 (three
    channel tiles, one 256-column tile); the k5 stem (Cin 3, 125 offsets:
    the forward's flattened steps, the backward's 16-channel tile) with and
    without d_feats; IM2COL_MAX_OFFSETS offsets (the forward's shorter row
    tiles). Against the plain versions (TOL), `check_im2col_fwd_tc` and
    `check_im2col_bwd_tc`."""
    lib = kernels.library()
    rows = lib.csn_sparse_conv_im2col_bwd_tc_rows()
    n_in, n_out = 141 * rows - 179, 7000
    gen = torch.Generator().manual_seed(SEED + 8)
    bf, f32 = torch.bfloat16, torch.float32
    for cin, cout, n_off, dense in ((48, 40, 5, None), (160, 200, 5, None),
                                    (3, 32, 125, 0.1)):
        fill = (torch.tensor([0.3, 1.0, 0.0, 0.0, 0.05]) if dense is None
                else torch.full((n_off,), dense))
        maps = []
        for n_dst, n_src in ((n_out, n_in), (n_in, n_out)):
            pick = torch.randint(0, n_src, (n_off, n_dst), generator=gen,
                                 dtype=torch.int32)
            live = torch.rand(n_off, n_dst, generator=gen) < fill[:, None]
            live[2] = False
            live[3] = False
            live[3, -1] = True
            maps.append(torch.where(live, pick, n_src).to(dev))
        kmap, kmap_t = maps
        s = window_conv.im2col_bwd_tc_splits(
            n_in, n_off, cin, cout, rows,
            lib.csn_sparse_conv_im2col_bwd_tc_channels(cin))
        n_st = -(-n_in // rows)
        per = -(-n_st // s)
        require(n_in % rows and n_out % 64 and s > 1 and n_st % per,
                f"im2col edge case {cin}->{cout}: S={s}, {n_st} super-tiles")
        f = torch.randn(n_in, cin, generator=gen).to(dev)
        w = ((torch.rand(n_off, cin, cout, generator=gen) * 2 - 1)
             / (cin * n_off) ** 0.5).to(dev)
        gd = torch.randn(n_out, cout, generator=gen).to(dev)
        what = (f"edges {cin}->{cout} K={n_off} N_in={n_in} N_out={n_out} "
                f"S={s} ({per} super-tiles of {rows} per split, {n_st} in "
                f"all)")
        for dt in (bf, f32):
            fd, wd, gdd = f.to(dt), w.to(dt), gd.to(dt)
            fwd = form_name("sparse_conv_im2col_fwd", dt, cin, cout)
            bwd = form_name("sparse_conv_im2col_bwd", dt, cin, cout)
            out = check_im2col_fwd_tc(table, what, fd, kmap, wd)
            table.check(fwd, what, out, conv.conv_im2col_plain(fd, kmap, wd),
                        dt)
            for dw_only in ((True, False) if cin == 3 else (False,)):
                dw = check_im2col_bwd_tc(table, what, fd, gdd, kmap_t, wd,
                                         dw_only)
                pl_df, pl_dw = conv.conv_im2col_bwd_plain(
                    fd, gdd, kmap_t, wd.float(), False, not dw_only)
                im_df, im_dw = conv.conv_im2col_bwd_kernels(
                    fd, gdd, kmap_t, wd.float(), False, not dw_only)
                if not dw_only:
                    table.check(bwd, f"{what} d_feats", im_df, pl_df, dt)
                table.check(bwd, f"{what} dw_only {dw_only} dW", im_dw,
                            pl_dw, dt)
                require(not dw[2].any().item() and dw[3].any().item(),
                        f"im2col dW {what} {dt}: the empty offset and the "
                        f"one-row offset")
    # the most offsets the wrappers take: the kmap slab does not fit beside
    # the full tiles, so the shared launcher gives fewer rows per tile (K1's
    # loop at Cin 32, still bitwise equal to K1; the flattened steps at Cin
    # 40)
    n_off, n_in, n_out = window_conv.IM2COL_MAX_OFFSETS, 2000, 3000
    for cin, cout in ((32, 64), (32, 256), (40, 64)):
        kmap, kmap_t = (torch.where(
            torch.rand(n_off, n_dst, generator=gen) < 0.05,
            torch.randint(0, n_src, (n_off, n_dst), generator=gen,
                          dtype=torch.int32), n_src).to(dev)
            for n_dst, n_src in ((n_out, n_in), (n_in, n_out)))
        f = torch.randn(n_in, cin, generator=gen).to(dev)
        w = ((torch.rand(n_off, cin, cout, generator=gen) * 2 - 1)
             / (cin * n_off) ** 0.5).to(dev)
        gd = torch.randn(n_out, cout, generator=gen).to(dev)
        what = f"edges {cin}->{cout} K={n_off} N_in={n_in} N_out={n_out}"
        for dt in (bf, f32):
            fd, wd, gdd = f.to(dt), w.to(dt), gd.to(dt)
            out = check_im2col_fwd_tc(table, what, fd, kmap, wd)
            table.check(form_name("sparse_conv_im2col_fwd", dt, cin, cout),
                        what, out, conv.conv_im2col_plain(fd, kmap, wd), dt)
            check_im2col_bwd_tc(table, what, fd, gdd, kmap_t, wd, False)


def time_f32_convs(table, what, t_name, count, n_dfeats, f, gd, kmap,
                   kmap_t, wt, w_t, mirror):
    """K1, d_feats and dW of one conv in f32, and the im2col pair
    (`CSN_DYNG=2/3`) on the same inputs, timed as device time from CUDA
    graphs (warm L2) beside one call of the plain version, with bytes at 4
    per element and the f32 rate (split TF32) for the bound: added `count`
    times per train step to the split-TF32 rows (the stems' too), printed
    only where a CUDA-core body runs (Cout % 8 != 0: no conv of
    HRNetSimCSN3S or Res16UNet34C). The im2col backward is timed as the
    autograd function calls it (`conv_im2col_bwd_kernels`: the weights'
    flip, stack and cast, the kernel and the splits' sum), in graphs of 5
    calls (its per-split partials are several MB a call)."""
    f32 = torch.float32
    n_in, n_out = f.shape[0], kmap.shape[1]
    cin, cout = wt.shape[1], wt.shape[2]

    def rows(name, n):   # the split-TF32 rows take the time, the rest none
        return n if name.endswith("_tf32") else 0

    def tc_or_cuda(name):
        return "split TF32" if name.endswith("_tf32") else "CUDA cores"

    nb, fl = conv_work(kmap, n_in, cin, cout, 4, 4)
    name = form_name("sparse_conv_fwd", f32, cin, cout)
    table.time(name, f"{what} (f32 {tc_or_cuda(name)})",
               lambda: window_conv.sparse_conv_fwd(f, kmap, wt),
               lambda: conv.conv_plain(f, kmap, wt), rows(name, count),
               reps=3, nbytes=nb, flops=fl, dtype=f32, graph=True)
    name = form_name("sparse_conv_im2col_fwd", f32, cin, cout)
    table.time(name, f"{what} (f32 {tc_or_cuda(name)})",
               lambda: window_conv.sparse_conv_im2col_fwd(f, kmap, wt),
               lambda: conv.conv_im2col_plain(f, kmap, wt), rows(name, count),
               reps=1, nbytes=nb, flops=fl, dtype=f32, graph=True,
               graph_calls=5)
    if n_dfeats:
        nb, fl = conv_work(kmap_t, n_out, cout, cin, 4, 4)
        name = form_name("sparse_conv_fwd", f32, cout, cin)
        table.time(name, f"d_feats over {t_name} (f32 {tc_or_cuda(name)})",
                   lambda: window_conv.sparse_conv_fwd(gd, kmap_t, w_t),
                   lambda: conv.conv_plain(gd, kmap_t, w_t),
                   rows(name, n_dfeats), reps=3, nbytes=nb, flops=fl,
                   dtype=f32, graph=True)
    nb, fl = conv_work(kmap_t, n_out, cout, cin, 4, 4)
    name = form_name("sparse_conv_dw", f32, cin, cout)
    table.time(name, f"{what} (f32 {tc_or_cuda(name)})",
               lambda: window_conv.sparse_conv_dw(f, gd, kmap_t),
               lambda: conv.conv_bwd_plain(f, gd, kmap_t, wt, mirror, False),
               rows(name, count), reps=3, nbytes=nb, flops=fl, dtype=f32,
               graph=True)
    nb, fl = conv_bwd_work(kmap_t, n_out, cin, cout, 4, n_dfeats > 0)
    name = form_name("sparse_conv_im2col_bwd", f32, cin, cout)
    table.time(name, f"{what} dw_only {n_dfeats == 0} (f32 "
               f"{tc_or_cuda(name)})",
               lambda: conv.conv_im2col_bwd_kernels(
                   f, gd, kmap_t, wt, mirror, n_dfeats > 0),
               lambda: conv.conv_im2col_bwd_plain(
                   f, gd, kmap_t, wt, mirror, n_dfeats > 0),
               rows(name, count), reps=1, nbytes=nb, flops=fl, dtype=f32,
               graph=True, graph_calls=5)


def check_convs(model, big, dev, table, g, timed=True):
    """K1 forward and on the transpose map, and `sparse_conv_dw`, at every
    (map, Cin, Cout) the model runs, in f32 and bf16; where K1 takes its
    tensor-core bodies (bf16, and f32 in split TF32, at Cout % 8 == 0), also
    against a float64 conv of the same operands, and at the stems (its
    flattened steps) and on the split-TF32 bodies `check_k1_flat`; on the
    same inputs the im2col pair (`CSN_DYNG=2/3`) against its plain versions
    and against K1 (in bf16 bitwise: one body) / `sparse_conv_dw`; where
    `sparse_conv_dw` takes its tensor-core bodies (the same rule), also
    `check_dw_tc`, and at the stems its narrow body against the im2col
    `dw_only` body within DW_F64_TOL (f32 TF32_F64_TOL); where the im2col
    pair takes its tensor-core bodies (the same rule, bf16 and f32),
    `check_im2col_fwd_tc` and `check_im2col_bwd_tc`; with `timed`, each
    family's times are added to the table: bf16 as single calls, and K1,
    d_feats, dW and the im2col pair in f32 as device time from CUDA graphs
    (warm L2; the split-TF32 bodies in their own rows, `time_f32_convs`).
    Returns the number of convs."""
    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv):
            key = (m.map_name, *m.kernel.shape[1:])
            convs[key] = convs.get(key, 0) + 1
    stem = (model.conv0.map_name, *model.conv0.kernel.shape[1:])
    for (name, cin, cout), count in sorted(convs.items()):
        kmap = big.kmaps[name]
        t_name, mirror = conv.transpose_map_name(name)
        kmap_t = big.kmaps[t_name]
        n_in = big.masks[map_levels(name)[0]].numel()
        n_dfeats = count - int((name, cin, cout) == stem)  # stem: none
        feats = torch.randn(n_in, cin, generator=g).to(dev)
        w = ((torch.rand(kmap.shape[0], cin, cout, generator=g) * 2 - 1)
             / (cin * kmap.shape[0]) ** 0.5).to(dev)
        grad = torch.randn(kmap.shape[1], cout, generator=g).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            f, wt, gd = feats.to(dt), w.to(dt), grad.to(dt)
            w_t = (wt.flip(0) if mirror else wt).transpose(1, 2).contiguous()
            what = f"{name} {cin}->{cout} N_out={kmap.shape[1]}"
            got = window_conv.sparse_conv_fwd(f, kmap, wt)
            table.check(form_name("sparse_conv_fwd", dt, cin, cout), what,
                        got, conv.conv_plain(f, kmap, wt), dt)
            if window_conv.k1_tensor_cores(dt, cin, cout):
                check_k1_f64(table, what, got, f, kmap, wt)
                if cin % 16 or dt == torch.float32:
                    check_k1_flat(what, got, f, kmap, wt)
            ref_df, ref_dw = conv.conv_bwd_plain(f, gd, kmap_t, wt.float(),
                                                 mirror, n_dfeats > 0)
            got_df, got_dw = conv.conv_bwd_kernels(f, gd, kmap_t, wt.float(),
                                                   mirror, n_dfeats > 0)
            if n_dfeats:
                dwhat = f"d_feats over {t_name} {cout}->{cin} N_out={n_in}"
                table.check(form_name("sparse_conv_fwd", dt, cout, cin),
                            dwhat, got_df, ref_df, dt)
                if window_conv.k1_tensor_cores(dt, cout, cin):
                    check_k1_f64(table, dwhat, got_df, gd, kmap_t, w_t)
            table.check(form_name("sparse_conv_dw", dt, cin, cout),
                        f"{what} ({t_name}, mirror {mirror})", got_dw, ref_dw,
                        dt)
            dw_tc = window_conv.dw_tensor_cores(dt, cin, cout)
            if dw_tc:
                check_dw_tc(table, f"{what} ({t_name})", f, gd, kmap_t)
            # the im2col pair on the same inputs: against its plain versions
            # and against K1 / sparse_conv_dw (another order of the same sum)
            fwd = form_name("sparse_conv_im2col_fwd", dt, cin, cout)
            bwd = form_name("sparse_conv_im2col_bwd", dt, cin, cout)
            got = window_conv.sparse_conv_im2col_fwd(f, kmap, wt)
            table.check(fwd, what, got, conv.conv_im2col_plain(f, kmap, wt),
                        dt)
            im_tc = window_conv.im2col_tensor_cores(dt, cin, cout)
            k1_out = window_conv.sparse_conv_fwd(f, kmap, wt)
            if im_tc:   # K1's tensor-core body: the same bits
                check_same(fwd, what, "vs K1: bitwise equal",
                           torch.equal(got, k1_out), tc_body(dt))
            else:
                table.check(fwd, f"{what} vs K1", got, k1_out, dt)
            del k1_out
            pl_df, pl_dw = conv.conv_im2col_bwd_plain(
                f, gd, kmap_t, wt.float(), mirror, n_dfeats > 0)
            im_df, im_dw = conv.conv_im2col_bwd_kernels(
                f, gd, kmap_t, wt.float(), mirror, n_dfeats > 0)
            btag = (f"{what} ({t_name}, mirror {mirror}, "
                    f"dw_only {n_dfeats == 0})")
            if n_dfeats:
                table.check(bwd, f"{btag} d_feats", im_df, pl_df, dt)
                table.check(bwd, f"{btag} d_feats vs K1", im_df, got_df, dt)
            else:
                require(im_df is None, f"{bwd} {btag}: d_feats under dw_only")
            table.check(bwd, f"{btag} dW", im_dw, pl_dw, dt)
            table.check(bwd, f"{btag} dW vs sparse_conv_dw", im_dw, got_dw,
                        dt)
            if dw_tc and cin % 16:   # the narrow body: the stems
                check_f64(table, form_name("sparse_conv_dw", dt, cin, cout),
                          f"{what} ({t_name})", got_dw, im_dw,
                          TF32_F64_TOL if dt == torch.float32
                          else DW_F64_TOL, vs="the im2col dw_only body",
                          body=tc_body(dt))
            del ref_df, ref_dw, got_df, got_dw, got, pl_df, pl_dw, im_df, \
                im_dw
            if im_tc:
                check_im2col_fwd_tc(table, what, f, kmap, wt)
                check_im2col_bwd_tc(table, f"{what} ({t_name}, mirror "
                                    f"{mirror})", f, gd, kmap_t,
                                    wt.flip(0) if mirror else wt,
                                    n_dfeats == 0)
            if not timed:
                continue
            if dt == torch.float32:
                time_f32_convs(table, what, t_name, count, n_dfeats, f, gd,
                               kmap, kmap_t, wt, w_t, mirror)
                continue
            nb, fl = conv_work(kmap, n_in, cin, cout, 2, 2)
            k1_ms = table.time("sparse_conv_fwd", what,
                               lambda: window_conv.sparse_conv_fwd(f, kmap,
                                                                   wt),
                               lambda: conv.conv_plain(f, kmap, wt), count,
                               nbytes=nb, flops=fl)
            if n_dfeats:
                nb, fl = conv_work(kmap_t, kmap.shape[1], cout, cin, 2, 2)
                table.time(
                    "sparse_conv_fwd", f"d_feats over {t_name}",
                    lambda: window_conv.sparse_conv_fwd(gd, kmap_t, w_t),
                    lambda: conv.conv_plain(gd, kmap_t, w_t), n_dfeats,
                    nbytes=nb, flops=fl)
            # dW reads the features and the output gradient, writes f32
            nb, fl = conv_work(kmap_t, kmap.shape[1], cout, cin, 2, 4)
            body = ("CUDA cores" if not dw_tc else "tensor cores"
                    if cin % 16 == 0 else "tensor cores, narrow")
            table.time(
                "sparse_conv_dw", f"{what} ({body})",
                lambda: window_conv.sparse_conv_dw(f, gd, kmap_t),
                lambda: conv.conv_bwd_plain(f, gd, kmap_t, wt.float(),
                                            mirror, False), count,
                reps=3, nbytes=nb, flops=fl)
            body = "tensor cores" if im_tc else "CUDA cores"
            nb, fl = conv_work(kmap, n_in, cin, cout, 2, 2)
            im_ms = table.time(fwd, f"{what} ({body})",
                               lambda: window_conv.sparse_conv_im2col_fwd(
                                   f, kmap, wt),
                               lambda: conv.conv_im2col_plain(f, kmap, wt),
                               count, reps=3, nbytes=nb, flops=fl)
            # stem: dW only; every other conv of the family: both gradients
            for with_df, n in ((True, n_dfeats), (False, count - n_dfeats)):
                if not n:
                    continue
                nb, fl = conv_bwd_work(kmap_t, kmap.shape[1], cin, cout, 2,
                                       with_df)
                table.time(
                    bwd, f"{what} dw_only {not with_df} ({body})",
                    lambda: conv.conv_im2col_bwd_kernels(
                        f, gd, kmap_t, wt.float(), mirror, with_df),
                    lambda: conv.conv_im2col_bwd_plain(
                        f, gd, kmap_t, wt.float(), mirror, with_df),
                    n, reps=3, nbytes=nb, flops=fl)
            # the data of a per-conv choice between the forms, per call: the
            # forward wrappers, and each form's backward as the autograd
            # function calls it (weight flip, casts and copies included)
            w32 = wt.float()
            bwd_ms = [median_ms(lambda: fn(f, gd, kmap_t, w32, mirror,
                                           n_dfeats > 0), reps=15)
                      for fn in (conv.conv_im2col_bwd_kernels,
                                 conv.conv_bwd_kernels)]
            print(f"[perconv] {what} (x{count}, {body}): forward im2col "
                  f"{im_ms:.4f} / K1 {k1_ms:.4f} ms; backward im2col "
                  f"{bwd_ms[0]:.4f} / K1 "
                  f"{'d_feats + ' if n_dfeats else ''}sparse_conv_dw "
                  f"{bwd_ms[1]:.4f} ms")
        torch.cuda.empty_cache()
    return sum(convs.values())


def attention_work(qm, km, n_head, dk, es):
    """(bytes forward, bytes backward, flops forward, flops backward) of
    masked attention at q [b, H, Lq, dk], k / v [b, H, Lk, dk]: every
    tensor moved once (q, k, v, out and the f32 lse forward; q, k, v, dout,
    lse, delta, dq, dk, dv backward); two products of 2 * dk operations per
    (valid query, valid key, head) pair forward, five backward."""
    b, lq = qm.shape
    lk = km.shape[1]
    pairs = int((qm.sum(dim=1) * km.sum(dim=1)).sum()) * n_head
    rows_q, rows_k = b * n_head * lq, b * n_head * lk
    fwd_b = (2 * rows_q + 2 * rows_k) * dk * es + rows_q * 4 + b * (lq + lk)
    bwd_b = (3 * rows_q + 4 * rows_k) * dk * es + rows_q * 8 + b * (lq + lk)
    return fwd_b, bwd_b, 4 * pairs * dk, 10 * pairs * dk


def attention_fwd_f64(q, k, v, km, temp, dropout, seed):
    """(out, lse) of masked attention with dropout in float64: a reference
    that bounds the kernel and the f32 plain version."""
    s = torch.matmul(q.double() / temp, k.double().transpose(-1, -2))
    s = s.masked_fill(~km[:, None, None, :], flash.NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    del s
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(p.shape),
                                       p.device)
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros_like(p))
        del keep
    return torch.matmul(p, v.double()), lse


def carry_f64(q, k, v, km, temp, dropout, seed):
    """(m, l, acc) of the online-softmax carry over all keys in float64:
    m = max_j s_j over valid keys, l = sum_j exp(s_j - m), acc = sum_j
    keep_j exp(s_j - m) v_j / (1 - dropout). A carry chain ends in this state
    whatever its blocks, so it bounds the kernel's chain and the f32 plain
    chain."""
    s = torch.matmul(q.double() / temp, k.double().transpose(-1, -2))
    s = s.masked_fill(~km[:, None, None, :], flash.NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    del s
    l = e.sum(dim=-1)
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(e.shape),
                                       e.device)
        e = torch.where(keep, e / (1.0 - dropout), torch.zeros_like(e))
        del keep
    return m, l, torch.matmul(e, v.double())


def attention_bwd_f64(q, k, v, km, dout, temp, dropout, seed):
    """(dq, dk, dv) of masked attention with dropout in float64, from its
    own float64 forward (lse, out, delta): a reference that bounds both
    f32 versions."""
    qd, kd, vd, gd = (x.double() for x in (q, k, v, dout))
    s = torch.matmul(qd / temp, kd.transpose(-1, -2))
    s = s.masked_fill(~km[:, None, None, :], flash.NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    del s
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(p.shape),
                                       p.device)
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros_like(p))
        del keep
    delta = (gd * torch.matmul(p, vd)).sum(dim=-1)
    del p
    return flash.block_backward_plain(qd, kd, vd, km, lse, delta, gd, temp,
                                      dropout, seed,
                                      compute_dtype=torch.float64)


def check_flash(table, dev, g, what, qm, km, n_head, dk, time_dt, count,
                ref64=False):
    """K2 at dropout 0 and ATTN_DROPOUT and its backward kernel at q
    [b, n_head, Lq, dk] against k, v [b, n_head, Lk, dk] under the masks qm,
    km, in f32 and bf16; timed in `time_dt` (None: not timed) at dropout
    ATTN_DROPOUT (the train path's call, `count` per train step), beside the
    library call `F.scaled_dot_product_attention` with the key mask at the
    same dropout (it draws its own mask: a time yardstick, never a check),
    and at dropout 0 (the eval path's call) both again, outside the kernel
    line. With `ref64`, the f32 forward (out, lse) and backward at
    ATTN_DROPOUT are also held, with the f32 plain version beside them,
    against `attention_fwd_f64` and `attention_bwd_f64`."""
    temp = float(dk) ** 0.5
    seed = 0x5EED_0F_C5A
    b, L = qm.shape
    q, dout = (torch.randn(b, n_head, L, dk, generator=g).to(dev)
               for _ in range(2))
    k, v = (torch.randn(b, n_head, km.shape[1], dk, generator=g).to(dev)
            for _ in range(2))
    valid = qm[:, None, :, None]
    dout = dout * valid   # padded query rows carry no gradient
    shape = f"{what} [{b},{n_head},{L},{dk}]"
    if km.shape[1] != L:
        shape += f" Lk={km.shape[1]}"
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd, dod = (x.to(dt) for x in (q, k, v, dout))
        fname, bname = (flash.k2_row(n, dt, dk)
                        for n in ("flash_attn_fwd", "flash_attn_bwd"))
        for drop in (0.0, ATTN_DROPOUT):
            sd = seed if drop else None
            tag = f"{shape} dropout {drop}"
            out, lse = flash.flash_attention(qd, kd, vd, km, qm, temp,
                                             drop, sd)
            ref, ref_lse = attention.scaled_dot_product_attention(
                qd, kd, vd, km, temp, dropout=drop, seed=sd,
                return_lse=True)
            table.check(fname, tag, out, ref, dt, valid)
            table.check(fname, tag + " lse", lse, ref_lse, dt,
                        valid[..., 0])
            if ref64 and dt == torch.float32 and drop:
                r64 = attention_fwd_f64(qd, kd, vd, km, temp, drop, sd)
                for nm, gk, gr, rr, vm in zip(
                        ("out", "lse"), (out, lse), (ref, ref_lse), r64,
                        (valid, valid[..., 0])):
                    zero = torch.zeros((), dtype=torch.float64, device=dev)
                    gk, gr, rr = (torch.where(vm, x.double(), zero)
                                  for x in (gk, gr, rr))
                    err = (gk - rr).abs().max().item()
                    perr = (gr - rr).abs().max().item()
                    scale = rr.abs().max().item()
                    ok = err <= TOL[dt] * scale
                    print(f"[check] {fname} {tag} {nm} vs float64: "
                          f"kernel {err:.3e} ({err / scale:.2e} of max|ref|)"
                          f", f32 plain {perr:.3e} ({perr / scale:.2e}), tol "
                          f"{TOL[dt] * scale:.3e} (max|ref| {scale:.3e}) "
                          f"{'ok' if ok else 'FAIL'}")
                    require(ok, f"{fname} {tag} {nm}: float64 "
                            f"reference")
                    table.err[fname] = max(table.err[fname], err)
                del r64
            del ref, ref_lse
            delta = (dod.float() * out.float()).sum(dim=-1)
            got = flash.flash_attention_bwd(qd, kd, vd, dod, lse, delta,
                                            km, qm, temp, drop, sd)
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (qd, kd, vd)]
            plain = attention.scaled_dot_product_attention(
                *leaves, km, temp, dropout=drop, seed=sd)
            refs = torch.autograd.grad(plain, leaves, dod,
                                       retain_graph=True)
            for nm, gk, gr, vm in zip(("dq", "dk", "dv"), got, refs,
                                      (valid, None, None)):
                table.check(bname, f"{tag} {nm}", gk, gr, dt,
                            vm)
            if ref64 and dt == torch.float32 and drop:
                r64 = attention_bwd_f64(qd, kd, vd, km, dod, temp, drop, sd)
                for nm, gk, gr, rr, vm in zip(("dq", "dk", "dv"), got, refs,
                                              r64, (valid, None, None)):
                    zero = torch.zeros((), dtype=torch.float64, device=dev)
                    if vm is not None:
                        gk, gr, rr = (torch.where(vm, x.double(), zero)
                                      for x in (gk, gr, rr))
                    err = (gk.double() - rr).abs().max().item()
                    perr = (gr.double() - rr).abs().max().item()
                    scale = rr.abs().max().item()
                    ok = err <= TOL[dt] * scale
                    print(f"[check] {bname} {tag} {nm} vs float64: "
                          f"kernel {err:.3e}, f32 plain {perr:.3e}, tol "
                          f"{TOL[dt] * scale:.3e} (max|ref| {scale:.3e}) "
                          f"{'ok' if ok else 'FAIL'}")
                    require(ok, f"{bname} {tag} {nm}: float64 "
                            f"reference")
                    table.err[bname] = max(table.err[bname], err)
                del r64
            del got, refs
            if dt == time_dt:
                # the library call: one fused attention with the key mask,
                # at the kernel's dropout
                lib = F.scaled_dot_product_attention(
                    *leaves, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp, dropout_p=drop)
            if dt == time_dt and not drop:   # the eval path's forward
                fwd_ms = median_ms(lambda: flash.flash_attention(
                    qd, kd, vd, km, qm, temp))
                bwd_ms = median_ms(lambda: flash.flash_attention_bwd(
                    qd, kd, vd, dod, lse, delta, km, qm, temp))
                lfwd_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp))
                lbwd_ms = median_ms(lambda: torch.autograd.grad(
                    lib, leaves, dod, retain_graph=True))
                print(f"[time] flash_attn_fwd {tag} {str(dt)[6:]}: kernel "
                      f"{fwd_ms:.4f} ms, library {lfwd_ms:.4f} ms; "
                      f"flash_attn_bwd kernel {bwd_ms:.4f} ms, library "
                      f"{lbwd_ms:.4f} ms (dropout 0: the eval path's call; "
                      f"not in the kernel line)")
                del lib
            if dt == time_dt and drop:   # the train path's call
                fb, bb, ff, bf = attention_work(qm, km, n_head, dk,
                                                qd.element_size())
                table.time(
                    fname, tag,
                    lambda: flash.flash_attention(qd, kd, vd, km, qm,
                                                  temp, drop, sd),
                    lambda: attention.scaled_dot_product_attention(
                        qd, kd, vd, km, temp, dropout=drop, seed=sd),
                    count, reps=3, nbytes=fb, flops=ff, dtype=dt,
                    fn_library=lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=km[:, None, None, :],
                        scale=1.0 / temp, dropout_p=drop))
                table.time(
                    bname, tag,
                    lambda: flash.flash_attention_bwd(
                        qd, kd, vd, dod, lse, delta, km, qm, temp, drop,
                        sd),
                    lambda: torch.autograd.grad(plain, leaves, dod,
                                                retain_graph=True),
                    count, reps=3, nbytes=bb, flops=bf, dtype=dt,
                    fn_library=lambda: torch.autograd.grad(
                        lib, leaves, dod, retain_graph=True))
                del lib
            del out, lse, delta, plain, leaves
            torch.cuda.empty_cache()


def check_attention(qb, kb, big, dev, table, g):
    """K2 and its backward at the HRNet SSA (combined pass) and CSA (query
    against key) shapes, their f32 D=64 and D=128 bodies against float64
    and timed (`check_f32_split`), and at the MID-FC chunk shape (80 chunks
    of 500 points, 8 heads of 256, 9 calls per CSA train step)."""
    dk = D_MODEL // N_HEAD
    bmask, qmask, kmask = big.masks[0], qb.masks[0], kb.masks[0]
    check_flash(table, dev, g, "SSA", bmask, bmask, N_HEAD, dk,
                torch.bfloat16, 1)
    check_flash(table, dev, g, "CSA", qmask, kmask, N_HEAD, dk,
                torch.bfloat16, 1)
    # ragged edges of the D=64 bodies: Lq != Lk, neither a multiple of 64, a
    # ragged key mask with one fully masked 64-key tile, one query tile all
    # padding
    rq = torch.rand(2, RAGGED_LQ, generator=g) < 0.8
    rk = torch.rand(2, RAGGED_LK, generator=g) < 0.7
    rk[:, 64:128] = False
    rq[:, 128:192] = False
    check_flash(table, dev, g, "ragged", rq.to(dev), rk.to(dev), N_HEAD, dk,
                None, 0)
    for split_dk in (64, 128):
        check_f32_split(qb, kb, big, dev, table, split_dk)
    # the same edges at the MID-FC heads (8 of 256; the f32 backward's
    # split-TF32 body walks 32-row tiles, which these masks also cut)
    rq = torch.rand(2, RAGGED_LQ, generator=g) < 0.8
    rk = torch.rand(2, RAGGED_LK, generator=g) < 0.7
    rk[:, 64:128] = False
    rq[:, 128:192] = False
    check_flash(table, dev, g, "ragged", rq.to(dev), rk.to(dev), MF_HEADS,
                MF_D, None, 0)
    ones = torch.ones(MF_B * MF_P // MF_CHUNK, MF_CHUNK, dtype=torch.bool,
                      device=dev)
    check_flash(table, dev, g, "MID-FC chunks", ones, ones, MF_HEADS, MF_D,
                torch.float32, 2 * MF_K + 1, ref64=True)


def check_f32_split(qb, kb, big, dev, table, dk):
    """The split-TF32 bodies of K2 and its backward at f32 head dim `dk`:
    64 (`csrc/flash_tf32_d64_fwd.cuh`, `csrc/flash_tf32_d64_bwd.cuh`) or
    128 (`csrc/flash_tf32_d128_fwd.cuh`, `csrc/flash_tf32_bwd.cuh` at half
    the MID-FC width), the HRNet heads with f32 activations at d_model 256
    in 4 heads or 2, against float64 references of the same operands
    (`attention_fwd_f64`, `attention_bwd_f64`) within TOL[f32] x max|ref|,
    the f32 plain version's error beside: out, lse, dq, dk, dv at dropout
    0 and ATTN_DROPOUT, at the ragged masks (RAGGED_LQ / RAGGED_LK, a
    fully masked 64-key tile, a query tile all padding) and at the SSA
    masks cut to 2 shapes; every launch repeated and bitwise equal. Then
    `time_f32_split`."""
    g = torch.Generator().manual_seed(SEED + 29 + dk - 64)
    rq = torch.rand(2, RAGGED_LQ, generator=g) < 0.8
    rk = torch.rand(2, RAGGED_LK, generator=g) < 0.7
    rk[:, 64:128] = False
    rq[:, 128:192] = False
    bmask = big.masks[0][:2]
    heads = D_MODEL // dk
    body = f"float32 (split TF32, D={dk})"
    fname, bname = (flash.k2_row(n, torch.float32, dk)
                    for n in ("flash_attn_fwd", "flash_attn_bwd"))
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    for tag, qm, km in (("ragged", rq.to(dev), rk.to(dev)),
                        ("SSA", bmask, bmask)):
        b, lq = qm.shape
        lk = km.shape[1]
        q, dout = (torch.randn(b, heads, lq, dk, generator=g).to(dev)
                   for _ in range(2))
        k, v = (torch.randn(b, heads, lk, dk, generator=g).to(dev)
                for _ in range(2))
        valid = qm[:, None, :, None]
        dout = dout * valid
        temp = float(dk) ** 0.5
        for drop in (0.0, ATTN_DROPOUT):
            sd = 0x5EED_0F_C5A if drop else None
            what = f"{tag} [{b},{heads},{lq},{dk}] Lk={lk} dropout {drop}"
            out, lse = flash.flash_attention(q, k, v, km, qm, temp, drop, sd)
            delta = (dout * out).sum(dim=-1)
            grads = flash.flash_attention_bwd(q, k, v, dout, lse, delta, km,
                                              qm, temp, drop, sd)
            again = flash.flash_attention(q, k, v, km, qm, temp, drop, sd)
            check_same(fname, what, "repeat: out and lse bitwise equal",
                       all(torch.equal(a, c) for a, c in
                           zip(again, (out, lse))), body)
            again = flash.flash_attention_bwd(q, k, v, dout, lse, delta, km,
                                              qm, temp, drop, sd)
            check_same(bname, what, "repeat: dq, dk, dv bitwise equal",
                       all(torch.equal(a, c) for a, c in zip(again, grads)),
                       body)
            del again
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            ref, ref_lse = attention.scaled_dot_product_attention(
                *leaves, km, temp, dropout=drop, seed=sd, return_lse=True)
            plain = [ref.detach(), ref_lse.detach()] + list(
                torch.autograd.grad(ref, leaves, dout))
            del ref, ref_lse, leaves
            r64 = list(attention_fwd_f64(q, k, v, km, temp, drop, sd)) + list(
                attention_bwd_f64(q, k, v, km, dout, temp, drop, sd))
            for nm, got, pl, rr, vm in zip(
                    ("out", "lse", "dq", "dk", "dv"), (out, lse) + grads,
                    plain, r64, (valid, valid[..., 0], valid, None, None)):
                if vm is not None:
                    got, pl, rr = (torch.where(vm, x.double(), zero)
                                   for x in (got, pl, rr))
                perr = (pl.double() - rr).abs().max().item()
                name = fname if nm in ("out", "lse") else bname
                check_f64(table, name, f"{what} {nm}", got, rr,
                          TOL[torch.float32], body=body,
                          vs=f"float64 (f32 plain {perr:.3e})")
            del out, lse, grads, plain, r64
            torch.cuda.empty_cache()
    time_f32_split(qb, kb, big, dev, table, dk)


def time_f32_split(qb, kb, big, dev, table, dk):
    """Device ms (CUDA graphs, warm L2) of K2 and its backward in f32 at
    head dim `dk` (64 or 128: d_model 256 in 4 heads or 2) at the HRNet SSA
    call [16, H, 5632, dk] and the CSA call [8, H, 5632, dk] against 5632
    keys under their masks, at dropout ATTN_DROPOUT (the f32 train step's
    call) and 0 (the eval request's), beside the call's bound
    (`attention_work` over PEAK_FLOPS[f32]: three TF32 products per f32
    product) and the library call `F.scaled_dot_product_attention` with the
    key mask at the same dropout in f32 (its backward: a graph of forward
    and backward less the forward's), and the plain version's one call at
    dropout ATTN_DROPOUT. The calls at ATTN_DROPOUT go into the `_tf32_d64`
    or `_tf32_d128` rows of the kernel line once each, as the f32 train
    step in those heads makes them (one SSA and one CSA call of each
    kernel)."""
    gd = torch.Generator(device=dev).manual_seed(SEED + 31 + dk - 64)
    f32 = torch.float32
    heads = D_MODEL // dk
    fname, bname = (flash.k2_row(n, f32, dk)
                    for n in ("flash_attn_fwd", "flash_attn_bwd"))
    for tag, qm, km in (("SSA", big.masks[0], big.masks[0]),
                        ("CSA", qb.masks[0], kb.masks[0])):
        b, L = qm.shape
        temp = float(dk) ** 0.5
        q, dout = (torch.randn(b, heads, L, dk, generator=gd, device=dev)
                   for _ in range(2))
        k, v = (torch.randn(b, heads, km.shape[1], dk, generator=gd,
                            device=dev) for _ in range(2))
        dout = dout * qm[:, None, :, None]
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fb, bb, ff, bf = attention_work(qm, km, heads, dk, 4)
        # (bytes ms, operations ms) of each call's bound
        parts_f = (fb / HBM_BYTES_S * 1e3, ff / PEAK_FLOPS[f32] * 1e3)
        parts_b = (bb / HBM_BYTES_S * 1e3, bf / PEAK_FLOPS[f32] * 1e3)
        bound_f, bound_b = max(parts_f), max(parts_b)
        for drop in (ATTN_DROPOUT, 0.0):
            sd = 0x5EED_0F_C5A if drop else None
            out, lse = flash.flash_attention(q, k, v, km, qm, temp, drop, sd)
            delta = (dout * out).sum(dim=-1)
            kf = graph_ms(lambda: flash.flash_attention(
                q, k, v, km, qm, temp, drop, sd), calls=10)
            kb_ = graph_ms(lambda: flash.flash_attention_bwd(
                q, k, v, dout, lse, delta, km, qm, temp, drop, sd),
                calls=10)

            def lib(x, y, z):
                return F.scaled_dot_product_attention(
                    x, y, z, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp, dropout_p=drop)

            lf = graph_ms(lambda: lib(q, k, v), calls=10)
            lfb = graph_ms(lambda: torch.autograd.grad(
                lib(*leaves), leaves, dout), calls=10)
            plain = ""
            if drop:   # one call of the plain version, host work included
                pf = median_ms(lambda: attention.scaled_dot_product_attention(
                    q, k, v, km, temp, dropout=drop, seed=sd), warmup=1,
                    reps=1)
                pfb = median_ms(lambda: torch.autograd.grad(
                    attention.scaled_dot_product_attention(
                        *leaves, km, temp, dropout=drop, seed=sd), leaves,
                    dout), warmup=1, reps=1)
                plain = (f"; plain (one call) forward {pf:.4f} ms, backward "
                         f"{pfb - pf:.4f} ms")
                table.add(fname, 1, kf, pf, *parts_f, lf)
                table.add(bname, 1, kb_, pfb - pf, *parts_b, lfb - lf)
            print(f"[time] flash_attn_fwd / flash_attn_bwd {tag} "
                  f"[{b},{heads},{L},{dk}] Lk={km.shape[1]} dropout {drop} "
                  f"float32 (split TF32, D={dk}; device, CUDA graphs, warm "
                  f"L2): forward kernel {kf:.4f} ms, library {lf:.4f} ms, "
                  f"bound {bound_f:.4f} ms; backward kernel {kb_:.4f} ms, "
                  f"library {lfb - lf:.4f} ms (forward and backward "
                  f"{lfb:.4f} less the forward), bound {bound_b:.4f} ms"
                  f"{plain} "
                  + ("(x1 per f32 train step)" if drop
                     else "(not in the kernel line)"))
            del out, lse, delta
        del q, k, v, dout, leaves
        torch.cuda.empty_cache()


def check_head_dims(qb, kb, big, dev, table):
    """K2 and its backward at the head dims the JAX package also runs and
    the HRNet main path does not: bf16 at 32 and 16 on their tensor-core
    bodies (d_model 256 in 8 and 16 heads, at the SSA call's masks, cut to 8
    and 4 shapes so that the plain version's f32 score matrices stay within
    the card: the same batch * heads as the D=64 check), and on the ragged
    masks (RAGGED_LQ / RAGGED_LK) at 32, 16 and 24 (8 heads), in f32 and
    bf16, dropout 0 and ATTN_DROPOUT, held to the plain version at the D=64
    tolerances (TOL). f32 at 16, 24 and 32 and bf16 at 24 run zero-padded
    to the next body (`ops/flash.py` `k2_head_dim`). Then the bf16 widths
    128 and 256 (d_model 256 in 2 heads and 1: the bf16 bodies of
    `"_bf16_wide"`; f32 in split TF32, at 128 the bodies of `"_tf32_d128"`)
    at the SSA call's masks, all 16 shapes (batch * heads 32 and 16, under
    the D=64 check's 64), at 128 also at the CSA call's masks (query batch
    against key batch, as phase 5b runs it), and on the ragged masks, the
    same way (the MID-FC chunk shape is `check_attention`'s). Then the
    device times
    (`time_head_dims`). Generators of their own keep the inputs of the
    other checks those of the D=64 runs."""
    g = torch.Generator().manual_seed(SEED + 17)
    bmask = big.masks[0]
    for dk, n_b in ((32, 8), (16, 4)):
        check_flash(table, dev, g, "SSA", bmask[:n_b], bmask[:n_b],
                    D_MODEL // dk, dk, None, 0)
    rq = torch.rand(2, RAGGED_LQ, generator=g) < 0.8
    rk = torch.rand(2, RAGGED_LK, generator=g) < 0.7
    rk[:, 64:128] = False
    rq[:, 128:192] = False
    for dk, heads in ((32, 8), (16, 16), (24, 8)):
        check_flash(table, dev, g, "ragged", rq.to(dev), rk.to(dev), heads,
                    dk, None, 0)
    gw = torch.Generator().manual_seed(SEED + 37)
    for dk in (128, 256):
        check_flash(table, dev, gw, "SSA", bmask, bmask, D_MODEL // dk, dk,
                    None, 0)
    check_flash(table, dev, gw, "CSA", qb.masks[0], kb.masks[0], WIDE_HEADS,
                D_MODEL // WIDE_HEADS, None, 0)
    rq = torch.rand(2, RAGGED_LQ, generator=gw) < 0.8
    rk = torch.rand(2, RAGGED_LK, generator=gw) < 0.7
    rk[:, 64:128] = False
    rq[:, 128:192] = False
    for dk in (128, 256):
        check_flash(table, dev, gw, "ragged", rq.to(dev), rk.to(dev),
                    D_MODEL // dk, dk, None, 0)
    time_head_dims(qb, kb, big, dev, table)


def time_head_dims(qb, kb, big, dev, table):
    """Device ms (CUDA graphs, warm L2: `tools/timing.py`) of the bf16 K2
    and its backward at the HRNet SSA call [16, H, 5632, D] with d_model
    256 split into heads of D = 64, 32, 16, 128 and 256, at the CSA call
    [8, 2, 5632, 128] against 5632 keys, and at the MID-FC chunk shape
    [80, 8, 500, 256], at dropout ATTN_DROPOUT (the train path's call) and
    0, beside the call's bound and the library call
    `F.scaled_dot_product_attention` with the key mask at the same dropout
    (its backward: a graph of forward and backward less the forward's).
    The calls at ATTN_DROPOUT of the paths that run the `"_bf16_wide"`
    bodies go into those rows of the kernel line, with the plain version's
    one call beside them, as their train steps make them: the SSA and the
    CSA call at D=128 once per train step at d_model 256 in 2 heads
    (`train_slice` at WIDE_HEADS), the MID-FC chunks 2 K + 1 times per bf16 MID-FC
    CSA train step (`midfc_chunked_slice`). The others are printed only:
    the main path runs D = 64."""
    gd = torch.Generator(device=dev).manual_seed(SEED + 23)
    bmask = big.masks[0]
    ones = torch.ones(MF_B * MF_P // MF_CHUNK, MF_CHUNK, dtype=torch.bool,
                      device=dev)
    # (tag, q mask, k mask, heads, D, calls per train step of its path)
    cases = [("SSA", bmask, bmask, D_MODEL // dk, dk, 0)
             for dk in (64, 32, 16)]
    cases += [("SSA", bmask, bmask, WIDE_HEADS, 128, 1),
              ("CSA", qb.masks[0], kb.masks[0], WIDE_HEADS, 128, 1),
              ("SSA", bmask, bmask, 1, 256, 0),
              ("MID-FC chunks", ones, ones, MF_HEADS, MF_D, 2 * MF_K + 1)]
    bf16 = torch.bfloat16
    for tag, qm, km, h, dk, count in cases:
        b, L = qm.shape
        temp = float(dk) ** 0.5
        q, dout = (torch.randn(b, h, L, dk, generator=gd, device=dev)
                   .to(bf16) for _ in range(2))
        k, v = (torch.randn(b, h, km.shape[1], dk, generator=gd, device=dev)
                .to(bf16) for _ in range(2))
        dout = dout * qm[:, None, :, None]
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fb, bb, ff, bf = attention_work(qm, km, h, dk, 2)
        parts_f = (fb / HBM_BYTES_S * 1e3, ff / PEAK_FLOPS[bf16] * 1e3)
        parts_b = (bb / HBM_BYTES_S * 1e3, bf / PEAK_FLOPS[bf16] * 1e3)
        bound_f, bound_b = max(parts_f), max(parts_b)
        fname, bname = (flash.k2_row(n, bf16, dk)
                        for n in ("flash_attn_fwd", "flash_attn_bwd"))
        for drop in (ATTN_DROPOUT, 0.0):
            sd = 0x5EED_0F_C5A if drop else None
            out, lse = flash.flash_attention(q, k, v, km, qm, temp, drop, sd)
            delta = (dout.float() * out.float()).sum(dim=-1)
            kf = graph_ms(lambda: flash.flash_attention(
                q, k, v, km, qm, temp, drop, sd), calls=10)
            kb_ = graph_ms(lambda: flash.flash_attention_bwd(
                q, k, v, dout, lse, delta, km, qm, temp, drop, sd),
                calls=10)

            def lib(x, y, z):
                return F.scaled_dot_product_attention(
                    x, y, z, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp, dropout_p=drop)

            lf = graph_ms(lambda: lib(q, k, v), calls=10)
            lfb = graph_ms(lambda: torch.autograd.grad(
                lib(*leaves), leaves, dout), calls=10)
            plain, where = "", "(not in the kernel line)"
            if drop and count:   # one call of the plain version
                pf = median_ms(lambda: attention.scaled_dot_product_attention(
                    q, k, v, km, temp, dropout=drop, seed=sd), warmup=1,
                    reps=1)
                pfb = median_ms(lambda: torch.autograd.grad(
                    attention.scaled_dot_product_attention(
                        *leaves, km, temp, dropout=drop, seed=sd), leaves,
                    dout), warmup=1, reps=1)
                plain = (f"; plain (one call) forward {pf:.4f} ms, backward "
                         f"{pfb - pf:.4f} ms")
                where = f"(x{count} per train step, rows {fname}, {bname})"
                table.add(fname, count, kf, pf, *parts_f, lf)
                table.add(bname, count, kb_, pfb - pf, *parts_b, lfb - lf)
            print(f"[time] flash_attn_fwd / flash_attn_bwd {tag} "
                  f"[{b},{h},{L},{dk}] Lk={km.shape[1]} dropout {drop} "
                  f"bfloat16 (d_model {h * dk} in {h} heads of {dk}; device, "
                  f"CUDA graphs, warm L2): forward kernel {kf:.4f} ms, "
                  f"library {lf:.4f} ms, bound {bound_f:.4f} ms; backward "
                  f"kernel {kb_:.4f} ms, library {lfb - lf:.4f} ms (forward "
                  f"and backward {lfb:.4f} less the forward), bound "
                  f"{bound_b:.4f} ms{plain} {where}")
            del out, lse, delta
        del q, k, v, dout, leaves
        torch.cuda.empty_cache()


def check_ring_padded(dev, table):
    """The per-block kernels at head dims they are not built for, zero-padded
    by their wrappers to 64 (the D=64 tensor-core bodies, rows `_tf32_d64`
    and `_bf16_d64`): a carry chain and the block backward at the ring's
    block layout (`check_ring_kernels`) at D=32 in f32 and D=24 in bf16,
    masked, dropout ATTN_DROPOUT; then `ring_flash_attention` (a ring of
    one: `RingFlashAttentionFn` pads once at its entry) at D=24 in bf16,
    forward and backward, against `FlashAttentionFn` (K2 and its backward
    on the D=32 tensor-core body) on the same inputs."""
    g = torch.Generator().manual_seed(SEED + 19)
    check_ring_kernels(dev, table, g, dk=32,
                       cases=((torch.float32, ATTN_DROPOUT, True, False),))
    check_ring_kernels(dev, table, g, dk=24,
                       cases=((torch.bfloat16, ATTN_DROPOUT, True, False),))
    b, h, L, dk = MF_RING_B, MF_HEADS, MF_P // MF_BLOCKS, 24
    temp, sd = float(dk) ** 0.5, 0x5EED_0F_C5A + 2
    km = torch.rand(b, L, generator=g) < 0.8
    km[1, 512:1024] = False
    km = km.to(dev)
    x = [torch.randn(b, h, L, dk, generator=g).to(dev, torch.bfloat16)
         for _ in range(4)]
    dout = x[3] * km[:, None, :, None]
    tag = f"ring of one [{b},{h},{L},{dk}] masked dropout {ATTN_DROPOUT}"
    res = []
    for fn in (lambda q, k, v: attention.ring_flash_attention(
                   q, k, v, km, None, temp, dropout=ATTN_DROPOUT, seed=sd),
               lambda q, k, v: flash.FlashAttentionFn.apply(
                   q, k, v, km, km, temp, ATTN_DROPOUT, sd)):
        leaves = [t.detach().clone().requires_grad_(True) for t in x[:3]]
        out = fn(*leaves)
        res.append([out.detach()] + list(torch.autograd.grad(
            out, leaves, dout)))
    valid = km[:, None, :, None]
    cname, bname = (flash.ring_row(n, torch.bfloat16, dk) for n in (
        "flash_attn_carry", "flash_attn_block_bwd"))
    for nm, a, r, name in zip(("out", "dq", "dk", "dv"), *res,
                              (cname, bname, bname, bname)):
        table.check(name, f"{tag} {nm} vs FlashAttentionFn", a, r,
                    torch.bfloat16, valid if nm in ("out", "dq") else None)
    del res, x, dout
    torch.cuda.empty_cache()


def check_ring_kernels(dev, table, g, dk=MF_D, cases=None):
    """`flash_attn_carry` chained over MF_BLOCKS key blocks at phase 7's
    shape (head dim `dk`; another than 64, 128 or 256 runs zero-padded by
    the wrappers) against `online_block_update` chained the same way and
    against one K2 pass over all keys; `flash_attn_block_bwd` on every block
    against `block_backward_plain` on that block, and summed over the
    blocks against one `flash_attn_bwd` call. The backward's inputs (out,
    lse) are the plain chain's, so no kernel's output feeds a check of
    another.
    Every case repeats one launch of each kernel and wants the same bits.
    A chain cut unevenly, at columns that are no multiple of 4 (a block then
    starts inside a 4-column Philox group), also checks a slice of the query
    rows at its row offset, both kernels against a float64 reference beside
    the f32 plain version with a wrong-offset run that must disagree, and
    padding query rows that keep their carry bit for bit. The one call over
    all keys that phase 7 (7b in bf16, 7c at 128, 7d at 64) makes, a ring
    of one, is held against the plain chains too, and timed at the head
    dims of RING_TIMED_DIMS (`ring_graph_ms`: device time from CUDA graphs
    at dropout ATTN_DROPOUT, in the kernel line, and 0, beside it, in both
    dtypes) beside the bound, the plain chain (one call) and the library
    call. bf16 at 128 and 256 runs the `_bf16_wide` rows, at 64 the
    `_bf16_d64` rows, f32 at 128 and 64 the `_tf32_d128` and `_tf32_d64`
    rows (`flash.ring_row`). `cases`: (dtype, dropout, masked, uneven) of
    each chain; by default the six."""
    b, h, L = MF_RING_B, MF_HEADS, MF_P
    temp = float(dk) ** 0.5
    seed = 0x5EED_0F_C5A + 1
    lb = L // MF_BLOCKS
    even = tuple(range(0, L + 1, lb))
    uneven = (0, lb + 1, 2 * lb - 1, 3 * lb + 2, L)   # starts at 1, 3, 2 mod 4
    q, k, v, dout = (torch.randn(b, h, L, dk, generator=g).to(dev)
                     for _ in range(4))
    full = torch.ones(b, L, dtype=torch.bool, device=dev)
    ragged = full.clone()   # a masked tail, and one fully masked key block
    ragged[0, L - 777:] = False
    ragged[1, lb:2 * lb] = False
    if cases is None:
        cases = ((torch.float32, 0.0, False, False),
                 (torch.float32, ATTN_DROPOUT, True, False),
                 (torch.bfloat16, ATTN_DROPOUT, True, False),
                 (torch.bfloat16, 0.0, True, False),
                 (torch.float32, ATTN_DROPOUT, True, True),
                 (torch.bfloat16, ATTN_DROPOUT, True, True))
    for dt, drop, masked, cut_unevenly in cases:
        cname, bname = (flash.ring_row(n, dt, dk) for n in (
            "flash_attn_carry", "flash_attn_block_bwd"))
        km, mtag = (ragged, "masked") if masked else (full, "unmasked")
        cuts = uneven if cut_unevenly else even
        qd, kd, vd, dod = (x.to(dt) for x in (q, k, v, dout))
        sd = seed if drop else None
        sizes = f"{lb}" if cuts is even else f"cuts {cuts[1:-1]}"
        tag = (f"[{b},{h},{L},{dk}] x {MF_BLOCKS} blocks of {sizes} {mtag} "
               f"dropout {drop}")
        blocks_ = [(c0, kd[:, :, c0:c1].contiguous(),
                    vd[:, :, c0:c1].contiguous(), km[:, c0:c1].contiguous())
                   for c0, c1 in zip(cuts, cuts[1:])]
        carry = flash.flash_carry_init(b, h, L, dk, dev)
        plain = flash.flash_carry_init(b, h, L, dk, dev)
        qt = (qd / temp).float()
        hop_in = {}   # the kernel's carry into each block
        for c0, kb_, vb_, mb_ in blocks_:
            hop_in[c0] = carry
            carry = flash.flash_forward_carry(qd, kb_, vb_, mb_, None, carry,
                                              temp, drop, sd, col_offset=c0)
            plain = attention.online_block_update(plain, qt, kb_, vb_, mb_,
                                                  drop, sd, col_offset=c0)
        for nm, a, r in zip(("m", "l", "acc"), carry, plain):
            table.check(cname, f"{tag} carry {nm} vs plain chain", a, r, dt)
        out_c, lse_c = flash.flash_carry_finalize(carry)
        out_p, lse = flash.flash_carry_finalize(plain)
        out = out_p.to(dt)
        final = carry if cuts is uneven else None
        del carry, out_p
        out_k2, lse_k2 = flash.flash_attention(qd, kd, vd, km, full, temp,
                                               drop, sd)
        table.check(cname, f"{tag} out vs one K2 pass", out_c.to(dt), out_k2,
                    dt)
        table.check(cname, f"{tag} lse vs one K2 pass", lse_c, lse_k2, dt)
        del out_c, lse_c, out_k2, lse_k2
        delta = (dod.float() * out.float()).sum(dim=-1)
        ref = flash.flash_attention_bwd(qd, kd, vd, dod, lse, delta, km,
                                        full, temp, drop, sd)
        dq = torch.zeros(qd.shape, dtype=torch.float32, device=dev)
        dq_p = torch.zeros_like(dq)
        dks, dvs, dks_p, dvs_p = [], [], [], []
        for i, (c0, kb_, vb_, mb_) in enumerate(blocks_):
            got = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0, delta=delta)
            want = flash.block_backward_plain(
                qd, kb_, vb_, mb_, lse, delta, dod, temp, drop, sd,
                col_offset=c0)
            for nm, a, r in zip(("dq", "dk", "dv"), got, want):
                table.check(bname, f"{tag} block {i} at column {c0} {nm} vs "
                            f"plain", a, r, dt)
            dq += got[0]
            dq_p += want[0]
            dks.append(got[1])
            dvs.append(got[2])
            dks_p.append(want[1])
            dvs_p.append(want[2])
            del got, want
        sums = (dq, torch.cat(dks, 2), torch.cat(dvs, 2))
        sums_p = (dq_p, torch.cat(dks_p, 2), torch.cat(dvs_p, 2))
        for nm, a, r in zip(("dq", "dk", "dv"), sums, ref):
            table.check(bname, f"{tag} {nm} vs one "
                        f"{flash.k2_row('flash_attn_bwd', dt, dk)} call", a,
                        r, dt)
        del dq, dks, dvs, dq_p, dks_p, dvs_p, ref, sums
        # one launch of each kernel again, on the block at column c0 from
        # the chain's carry into it: the same bits
        c0, kb_, vb_, mb_ = blocks_[1]
        same = all(torch.equal(a, r) for a, r in zip(*(
            flash.flash_forward_carry(qd, kb_, vb_, mb_, None, hop_in[c0],
                                      temp, drop, sd, col_offset=c0)
            for _ in range(2))))
        same_b = all(torch.equal(a, r) for a, r in zip(*(
            flash.flash_block_backward(qd, kb_, vb_, mb_, out, lse, dod, temp,
                                       drop, sd, col_offset=c0, delta=delta)
            for _ in range(2))))
        print(f"[check] {cname}, {bname} {tag} block at column {c0} repeat: "
              f"bitwise equal {'ok' if same and same_b else 'FAIL'}")
        require(same and same_b, f"{cname} / {bname}: a repeated launch gave "
                f"other bits")
        if cuts is uneven:
            # a slice of the query rows against one key block, both at
            # their offsets in the global score matrix
            r0, r1 = cuts[1], cuts[2]
            c0, kb_, vb_, mb_ = blocks_[2]
            otag = (f"[{b},{h},{r1 - r0},{dk}] rows at {r0} x keys at {c0} "
                    f"{mtag} dropout {drop}")
            qs, dos = (x[:, :, r0:r1].contiguous() for x in (qd, dod))
            init = flash.flash_carry_init(b, h, r1 - r0, dk, dev)
            got = flash.flash_forward_carry(
                qs, kb_, vb_, mb_, None, init, temp, drop, sd,
                row_offset=r0, col_offset=c0)
            want = attention.online_block_update(
                init, (qs / temp).float(), kb_, vb_, mb_, drop, sd,
                row_offset=r0, col_offset=c0)
            for nm, a, r in zip(("m", "l", "acc"), got, want):
                table.check(cname, f"{otag} carry {nm} vs plain", a, r, dt)
            lse_s = lse[:, :, r0:r1].contiguous()
            delta_s = delta[:, :, r0:r1].contiguous()
            got = flash.flash_block_backward(
                qs, kb_, vb_, mb_, out[:, :, r0:r1].contiguous(), lse_s, dos,
                temp, drop, sd, row_offset=r0, col_offset=c0, delta=delta_s)
            want = flash.block_backward_plain(
                qs, kb_, vb_, mb_, lse_s, delta_s, dos, temp, drop, sd,
                row_offset=r0, col_offset=c0)
            for nm, a, r in zip(("dq", "dk", "dv"), got, want):
                table.check(bname, f"{otag} {nm} vs plain", a, r, dt)
            del got, want, init, qs, dos
            # The kernel (split TF32 or bf16 on the tensor cores) and the
            # f32 plain version round at different places. A float64
            # reference on batch row 0, heads 0-1 bounds both, and the
            # kernel given a wrong column offset must disagree.
            hs = (slice(0, 1), slice(0, 2))
            wrong = WRONG_OFFSET[dt]
            got = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0, delta=delta)
            want = flash.block_backward_plain(
                qd, kb_, vb_, mb_, lse, delta, dod, temp, drop, sd,
                col_offset=c0)
            ref64 = flash.block_backward_plain(
                qd[hs].double(), kb_[hs].double(), vb_[hs].double(), mb_[:1],
                lse[hs], delta[hs], dod[hs].double(), temp, drop, sd,
                col_offset=c0, compute_dtype=torch.float64)
            off = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0 + 1, delta=delta)
            for nm, a, r, r64, o in zip(("dq", "dk", "dv"), got, want, ref64,
                                        off):
                err = (a[hs].double() - r64).abs().max().item()
                perr = (r[hs].double() - r64).abs().max().item()
                oerr = (o.float() - r.float()).abs().max().item()
                scale = r64.abs().max().item()
                ok = err <= TOL[dt] * scale and oerr > wrong * scale
                print(f"[check] {bname} block at column {c0} {nm} "
                      f"{str(dt)[6:]} vs float64 (batch row 0, heads 0-1): "
                      f"kernel {err:.3e}, f32 plain {perr:.3e}, tol "
                      f"{TOL[dt] * scale:.3e} (max|ref| {scale:.3e}); kernel "
                      f"at column offset {c0 + 1} vs plain at {c0}: "
                      f"{oerr:.3e}, must exceed {wrong * scale:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                require(ok, f"{bname} {nm}: float64 reference or "
                        f"wrong-offset check failed")
                table.err[bname] = max(table.err[bname], err)
            del got, want, ref64, off
            # The carry chain against float64 on the same rows (its final
            # state does not depend on the blocks); the kernel on the block
            # at c0 from the same carry but at column offset c0 + 1 must
            # disagree in acc (m and l are undropped)
            ref64 = carry_f64(qd[hs], kd[hs], vd[hs], km[:1], temp, drop, sd)
            off = flash.flash_forward_carry(
                qd, kb_, vb_, mb_, None, hop_in[c0], temp, drop, sd,
                col_offset=c0 + 1)[2]
            want = attention.online_block_update(
                hop_in[c0], qt, kb_, vb_, mb_, drop, sd, col_offset=c0)[2]
            for nm, a, r, r64 in zip(("m", "l", "acc"), final, plain, ref64):
                err = (a[hs].double() - r64).abs().max().item()
                perr = (r[hs].double() - r64).abs().max().item()
                scale = r64.abs().max().item()
                ok = err <= TOL[dt] * scale
                line = (f"[check] {cname} chain at cuts {cuts[1:-1]} {mtag} "
                        f"dropout {drop} {nm} {str(dt)[6:]} vs float64 "
                        f"(batch row 0, heads 0-1): kernel {err:.3e}, f32 "
                        f"plain {perr:.3e}, tol {TOL[dt] * scale:.3e} "
                        f"(max|ref| {scale:.3e})")
                if nm == "acc":
                    oerr = (off - want).abs().max().item()
                    ok = ok and oerr > wrong * scale
                    line += (f"; kernel on the block at column {c0} given "
                             f"offset {c0 + 1} vs plain at {c0}: {oerr:.3e}, "
                             f"must exceed {wrong * scale:.3e}")
                print(f"{line} {'ok' if ok else 'FAIL'}")
                require(ok, f"{cname} {nm}: float64 reference or "
                        f"wrong-offset check failed")
                table.err[cname] = max(table.err[cname], err)
            del ref64, off, want
            # padding query rows scattered through live 64-row tiles, and
            # one padding tile (rows 128-191): the kernel keeps their carry
            # bit for bit; the live rows agree with the plain version
            c0, kb_, vb_, mb_ = blocks_[1]
            gq = torch.Generator().manual_seed(SEED + 11)
            qmask = (torch.rand(b, L, generator=gq) > 0.2).to(dev)
            qmask[:, 128:192] = False
            c_in = hop_in[c0]
            got = flash.flash_forward_carry(qd, kb_, vb_, mb_, qmask, c_in,
                                            temp, drop, sd, col_offset=c0)
            new = attention.online_block_update(c_in, qt, kb_, vb_, mb_,
                                                drop, sd, col_offset=c0)
            ptag = (f"[{b},{h},{L},{dk}] keys at {c0}, padding query rows "
                    f"(scattered, and rows 128-191) {mtag} dropout {drop}")
            same = True
            for nm, a, n_, c in zip(("m", "l", "acc"), got, new, c_in):
                lv = qmask[:, None, :] if a.dim() == 3 else \
                    qmask[:, None, :, None]
                table.check(cname, f"{ptag} carry {nm} vs plain", a,
                            torch.where(lv, n_, c), dt)
                pad = ~lv.expand_as(a)
                same = same and torch.equal(a[pad], c[pad])
            print(f"[check] {cname} {ptag} {str(dt)[6:]}: the padding rows "
                  f"keep the carry bit for bit {'ok' if same else 'FAIL'}")
            require(same, f"{cname}: a padding row changed the carry")
            del got, new, c_in, final
        hop_in.clear()
        if cuts is even and masked and dk in RING_TIMED_DIMS:
            # phase 7's calls (7b's in bf16; 7c's and 7d's at head dims 128
            # and 64)
            cin = flash.flash_carry_init(b, h, L, dk, dev)
            atag = f"[{b},{h},{L},{dk}] all keys {mtag}"
            got = flash.flash_forward_carry(qd, kd, vd, km, None, cin, temp,
                                            drop, sd)
            for nm, a, r in zip(("m", "l", "acc"), got, plain):
                table.check(cname, f"{atag} dropout {drop} one call, carry "
                            f"{nm} vs plain chain", a, r, dt)
            got = flash.flash_block_backward(qd, kd, vd, km, out, lse, dod,
                                             temp, drop, sd, delta=delta)
            for nm, a, r in zip(("dq", "dk", "dv"), got, sums_p):
                table.check(bname, f"{atag} dropout {drop} one call, {nm} vs "
                            f"plain chain", a, r, dt)
            del got
            print(f"[time] {cname}, {bname}: the plain versions walk the "
                  f"keys in {MF_BLOCKS} blocks (all keys at once would hold "
                  f"a [{b},{h},{L},{L}] f32 score matrix); the library call "
                  f"runs at the kernels' dropout and draws its own mask")
            bf_ms, bb_ms = ring_bounds(km, h, dk, dt)
            # f32 has one masked even case: its dropout 0 is timed beside
            for p in (drop, 0.0) if dt == torch.float32 else (drop,):
                psd = seed if p else None
                kf, kb2, lf, lb = ring_graph_ms(qd, kd, vd, dod, km, out, lse,
                                                delta, cin, temp, p, psd)

                def plain_chain():
                    c = cin
                    for c0, kb_, vb_, mb_ in blocks_:
                        c = attention.online_block_update(
                            c, qt, kb_, vb_, mb_, p, psd, col_offset=c0)
                    return c

                def plain_bwd_chain():
                    return [flash.block_backward_plain(
                        qd, kb_, vb_, mb_, lse, delta, dod, temp, p, psd,
                        col_offset=c0) for c0, kb_, vb_, mb_ in blocks_]

                # one call each (the checks above ran the chains warm)
                pf, pb = (median_ms(fn, warmup=0, reps=1)
                          for fn in (plain_chain, plain_bwd_chain))
                count = 1 if p else 0
                table.add(cname, count, kf, pf, *bf_ms, lf)
                table.add(bname, count, kb2, pb, *bb_ms, lb)
                print(f"[time] {cname} / {bname} {atag} dropout {p} "
                      f"{str(dt)[6:]} (device, CUDA graphs, warm L2): carry "
                      f"kernel {kf:.4f} ms, plain chain {pf:.4f} ms (one "
                      f"call), bound {max(bf_ms):.4f} ms, library {lf:.4f} "
                      f"ms; block backward kernel {kb2:.4f} ms, plain chain "
                      f"{pb:.4f} ms (one call), bound {max(bb_ms):.4f} ms, "
                      f"library {lb:.4f} ms (forward and backward less the "
                      f"forward) "
                      + (f"(x{count} per train step)" if count
                         else "(not in the kernel line)"))
            del cin
        del out, lse, delta, blocks_, plain, sums_p
        torch.cuda.empty_cache()


def ring_bounds(km, h, dk, dt):
    """((bytes ms, operations ms) of the carry, the same of the block
    backward) over all keys of a ring of one at q [b, h, L, dk] in `dt`
    with key mask `km` [b, L] (every query row valid): `attention_work`'s
    counts with the carry in and out in place of out and lse, and dQ in
    f32."""
    b, L = km.shape
    es = torch.finfo(dt).bits // 8
    fb, bb, ff, bf = attention_work(torch.ones_like(km), km, h, dk, es)
    fb += 2 * b * h * L * (dk + 2) * 4 - b * h * L * (dk * es + 4)
    bb += b * h * L * dk * (4 - es)
    return ((fb / HBM_BYTES_S * 1e3, ff / PEAK_FLOPS[dt] * 1e3),
            (bb / HBM_BYTES_S * 1e3, bf / PEAK_FLOPS[dt] * 1e3))


def ring_graph_ms(q, k, v, dout, km, out, lse, delta, cin, temp, p, seed):
    """Device ms from CUDA graphs (warm L2) of the ring of one over all
    keys at dropout `p`: (the carry from `cin`, the block backward against
    the global out / lse / delta, the library call's forward, its backward:
    forward and backward less the forward). The library call runs at the
    same dropout and draws its own mask."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def lib(x, y, z):
        return F.scaled_dot_product_attention(
            x, y, z, attn_mask=km[:, None, None, :], scale=1.0 / temp,
            dropout_p=p)

    kf, kb, lf, lfb = (graph_ms(fn, calls=5, reps=3) for fn in (
        lambda: flash.flash_forward_carry(q, k, v, km, None, cin, temp, p,
                                          seed),
        lambda: flash.flash_block_backward(q, k, v, km, out, lse, dout, temp,
                                           p, seed, delta=delta),
        lambda: lib(q, k, v),
        lambda: torch.autograd.grad(lib(*leaves), leaves, dout)))
    return kf, kb, lf, lfb - lf


def check_interp(qb, dev, table, g):
    """K3 and its backward kernel on the query batch's readout: at the main
    path's 39 classes in f32 (what the HRNet heads hand `interp_batch`; the
    kernel line's times) and in bf16, and at the extraction chain's 256
    channels (f32 `fc_1`) in f32 and bf16, all on the same corner table."""
    n0 = qb.masks[0].numel()
    idx = qb.interp_idx.reshape(-1, 8)
    w8 = qb.interp_w.reshape(-1, 8)
    n_pts = idx.shape[0]
    nnz = int((idx < n0).sum())
    require(qb.interp_ent.numel() == nnz,
            f"interp CSR table: {qb.interp_ent.numel()} entries, {nnz} live "
            f"corners")
    # the one-call yardstick: a weighted bag sum of 8 rows per point (the
    # sentinel rows point at an appended zero row)
    bags = idx.clamp(max=n0).long()
    # the same bags flat, as the bag sum's forward and backward operators
    # take them
    ind = bags.reshape(-1)
    offs = torch.arange(0, ind.numel(), 8, device=dev)
    flat = torch.randn(n0, NUM_CLASSES, generator=g).to(dev)
    grad = torch.randn(n_pts, NUM_CLASSES, generator=g).to(dev)
    # the 256-channel inputs come from a generator of their own, so that
    # the checks after this one draw what they drew before
    g256 = torch.Generator(device="cpu").manual_seed(SEED + 256)
    wide = (torch.randn(n0, 256, generator=g256).to(dev),
            torch.randn(n_pts, 256, generator=g256).to(dev))
    for (fl32, gd32), dt in (((flat, grad), torch.float32),
                             ((flat, grad), torch.bfloat16),
                             (wide, torch.float32), (wide, torch.bfloat16)):
        fl, gd = fl32.to(dt), gd32.to(dt)
        c = fl.shape[1]
        what = f"[{n0},{c}] -> [{n_pts},{c}]"
        table.check("interp_fwd", what, interp_window.interp_fwd(fl, idx, w8),
                    interp.interpolate_to_points(fl, idx[None], w8[None])[0],
                    dt)
        bwd = f"[{n_pts},{c}] -> [{n0},{c}]"
        table.check("interp_bwd", bwd,
                    interp_window.interp_bwd(gd, qb.interp_ptr, qb.interp_ent,
                                             w8),
                    interp.interp_bwd_plain(gd, idx, w8, n0), dt)
        # one launch of each per main-path step reads f32 at 39 classes:
        # those times go into the kernel line, the others beside it. The
        # kernels' and library calls' times are device times (CUDA graphs
        # of calls): one call's wrapper takes longer on the host than the
        # kernel on the card
        count = int(dt == torch.float32 and c == NUM_CLASSES)
        # both move the voxel and point features once, and the sums are f32
        # FMAs on the CUDA cores whatever the features' type. The forward
        # reads the corner table (int32 index + f32 weight per corner); the
        # backward reads the CSR table (ptr, an int32 entry per live
        # corner) and the weights
        rows = (n0 + n_pts) * c * fl.element_size()
        nb_fwd = rows + idx.numel() * 4 + w8.numel() * 4
        nb_bwd = rows + (qb.interp_ptr.numel() + qb.interp_ent.numel()
                         + w8.numel()) * 4
        flz = torch.cat([fl, fl.new_zeros(1, c)])
        wb = w8.to(dt)
        table.time("interp_fwd", what,
                   lambda: interp_window.interp_fwd(fl, idx, w8),
                   lambda: interp.interpolate_to_points(fl, idx[None],
                                                        w8[None]),
                   count=count, nbytes=nb_fwd, flops=2 * nnz * c, dtype=dt,
                   peak_flops=PEAK_FLOPS_FMA, graph=True,
                   fn_library=lambda: F.embedding_bag(
                       bags, flz, per_sample_weights=wb, mode="sum"))
        # the backward's yardstick: the gradient of that bag sum with
        # respect to the voxel features, the same scatter-add, as the one
        # operator that autograd calls for it (its forward's bag tables
        # made once, as autograd saves them)
        wf = wb.reshape(-1)
        _, o2b, bag_size, max_idx = torch.ops.aten._embedding_bag(
            flz, ind, offs, False, 0, False, wf)
        lib_bwd = torch.ops.aten._embedding_bag_backward
        flz_l = flz.detach().requires_grad_(True)
        lib_g = lib_bwd(gd, ind, offs, o2b, bag_size, max_idx, n0 + 1, False,
                        0, False, wf).float()
        auto_g = torch.autograd.grad(F.embedding_bag(
            bags, flz_l, per_sample_weights=wb, mode="sum"), flz_l,
            gd)[0].float()
        require(float((lib_g - auto_g).abs().max())
                <= TOL[dt] * float(auto_g.abs().max()),
                "the bag sum's backward operator is not its gradient")
        table.time("interp_bwd", bwd,
                   lambda: interp_window.interp_bwd(
                       gd, qb.interp_ptr, qb.interp_ent, w8),
                   lambda: interp.interp_bwd_plain(gd, idx, w8, n0),
                   count=count, nbytes=nb_bwd, flops=2 * nnz * c,
                   dtype=dt, peak_flops=PEAK_FLOPS_FMA, graph=True,
                   fn_library=lambda: lib_bwd(
                       gd, ind, offs, o2b, bag_size, max_idx, n0 + 1, False,
                       0, False, wf))
        del fl, gd, flz, flz_l, o2b, bag_size, max_idx, lib_g, auto_g
    del wide
    torch.cuda.empty_cache()


def check_point_outputs(tag, loss, point_logits, pred, qb):
    valid = qb.point_mask
    require(bool(torch.isfinite(loss)), f"{tag}: loss {loss}")
    if point_logits is not None:
        require(point_logits.shape == (B, P, NUM_CLASSES)
                and bool(torch.isfinite(point_logits[valid]).all()),
                f"{tag}: bad point logits")
    require(pred.shape == (B, P), f"{tag}: predictions {tuple(pred.shape)}")
    p = pred[valid]
    require(int(p.min()) >= 1 and int(p.max()) <= NUM_CLASSES - 1,
            f"{tag}: predictions outside [1, {NUM_CLASSES - 1}]")
    return (f"loss {float(loss):.6f}, {int(valid.sum())} points, pred in "
            f"[{int(p.min())}, {int(p.max())}]")


def require_launches(tag, launches, expect, n_requests=N_REQUESTS):
    """Every kernel launched exactly as often as `expect` says per request
    (a kernel that `expect` does not name: never)."""
    print(f"[{tag}] launches over {n_requests} requests: {launches} "
          f"(expected per request: {expect})")
    for name, got in launches.items():
        want = n_requests * expect.get(name, 0)
        require(got == want,
                f"{tag}: {name} {got} launches, expected {want}")


def time_steps(tag, step, what=f"B={B}, K={K_NEIGHBORS}, bf16", n_shapes=B,
               timed_steps=TIMED_STEPS):
    """ms/step of `step()` over `timed_steps` after 2 warm-up steps, and the
    peak device memory of the timed steps. Returns the ms/step."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {ms:.3f} ms/step over {timed_steps} steps ({what}), "
          f"{n_shapes / ms * 1e3:.3f} query shapes/s, peak memory "
          f"{peak / 2 ** 30:.3f} GiB")
    return ms


def profile_steps(tag, step, n_steps=3, step_ms=None):
    """Device busy share and device time by kernel over `n_steps` of
    `step()`, by torch.profiler (the wall time from the profiler's start,
    so its set-up is not counted); with `step_ms`, the unprofiled ms/step,
    also the device time's share of that, and the host's operators with the
    most CPU time of their own (under the profiler, which inflates them).
    Returns the device rows (ms per step, launches per step, name)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    events = prof.key_averages()
    rows = [(e.device_time_total / 1e3 / n_steps, e.count // n_steps, e.key)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    unprofiled = (f"; {100 * busy / step_ms:.1f} % of the unprofiled "
                  f"{step_ms:.3f} ms/step" if step_ms else "")
    print(f"[profile] {tag}: {wall_ms:.1f} ms/step wall under the profiler, "
          f"{busy:.1f} ms/step device time ({100 * busy / wall_ms:.1f} % "
          f"busy{unprofiled})")
    for ms, n, key in rows[:12]:
        print(f"[profile] {tag}: {ms:9.3f} ms/step {100 * ms / busy:5.1f} % "
              f"x{n:<4d} {key[:90]}")
    if step_ms:
        host = sorted(((e.self_cpu_time_total / 1e3 / n_steps,
                        e.count // n_steps, e.key) for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      reverse=True)
        for ms, n, key in host[:6]:
            print(f"[profile] {tag} host: {ms:9.3f} ms/step self CPU "
                  f"x{n:<5d} {key[:80]}")
    return rows


def heads_names(n_head):
    """(K2 forward row, K2 backward row, label prefix, what of the step
    times) of the bf16 eval and train slices at d_model D_MODEL in `n_head`
    heads: phase 4 and 5 at N_HEAD, phase 5b at WIDE_HEADS."""
    dk = D_MODEL // n_head
    fwd, bwd = (flash.k2_row(n, torch.bfloat16, dk)
                for n in ("flash_attn_fwd", "flash_attn_bwd"))
    if n_head == N_HEAD:
        return fwd, bwd, "", f"B={B}, K={K_NEIGHBORS}, bf16"
    return (fwd, bwd, f"heads of {dk} ",
            f"B={B}, K={K_NEIGHBORS}, bf16, {n_head} heads of {dk}")


def eval_slice(cls, reqs, dev, n_convs, do_profile=False, n_head=N_HEAD):
    """Phase 4 (at WIDE_HEADS, phase 5b's eval): 3 bf16 eval requests in
    `n_head` heads with exact launch counts per kernel, the ms/step (with
    --profile, also under the profiler); at N_HEAD, then the f32 forward
    through the kernels against the plain forward on the CPU."""
    fwd, _, pre, what = heads_names(n_head)
    tag = f"{pre}eval" if pre else "slice"
    model = make_model(cls, "bfloat16", ATTN_DROPOUT, n_head).eval().to(dev)
    kernels.reset_launches()
    for r, (qb, keys) in enumerate(reqs):
        loss, point_logits, pred = eval_step(model, qb, keys)
        print(f"[{tag}] request {r}: " + check_point_outputs(
            f"{pre}eval {r}", loss, point_logits, pred, qb))
    torch.cuda.synchronize()
    require_launches(tag, dict(kernels.LAUNCHES),
                     {"sparse_conv_fwd": n_convs, fwd: 2, "interp_fwd": 1})
    qb, keys = reqs[0]
    ms = time_steps(tag, lambda: eval_step(model, qb, keys), what)
    if do_profile:
        profile_steps(f"eval K=1{', ' + pre.strip() if pre else ''}",
                      lambda: eval_step(model, qb, keys), step_ms=ms)
    del model
    torch.cuda.empty_cache()
    if n_head != N_HEAD:
        return

    # the f32 forward through the kernels against the plain forward (CPU)
    m32 = make_model(cls, "float32", ATTN_DROPOUT).eval().to(dev)
    with torch.no_grad():
        got = m32(qb, keys).cpu()
        m32.cpu()
        t0 = time.perf_counter()
        ref = m32(qb.to("cpu"), tuple(k.to("cpu") for k in keys))
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[slice] f32 logits, kernels on the GPU vs plain on the CPU "
          f"({time.perf_counter() - t0:.1f} s): max_abs_err {err:.3e} tol "
          f"{1e-3 * scale:.3e} (max|ref| {scale:.3e})")
    require(err <= 1e-3 * scale, "f32 forward: kernels disagree with plain")


def f32_step_check(cls, spec, dev, tag, mode=None, n_head=N_HEAD):
    """One f32 train step at dropout 0 on B=2 shapes, d_model D_MODEL in
    `n_head` heads, with the kernels on the GPU (under `CSN_DYNG=mode`)
    against the same step with the plain versions on the CPU (`CSN_DYNG`
    unset): loss and every gradient, the CPU step taking the GPU step's
    ReLU decisions (`ReluDecisions`)."""
    (qh, kh), = build_requests(spec, "cpu", n_shapes=2, n_requests=1,
                               seed=SEED + 7)
    if not issubclass(cls, hrnet.HRNetSimCSN):
        kh = ()   # a plain segmentation model takes no key batches
    init = make_model(cls, "float32", 0.0, n_head).state_dict()
    relus = ReluDecisions()
    res = []
    for replay, where in enumerate((dev, "cpu")):
        m32 = make_model(cls, "float32", 0.0, n_head)
        m32.load_state_dict(init)
        m32.to(where)
        opt = optim.make_optimizer(m32.parameters(), "SGD", lr=LR)
        t0 = time.perf_counter()
        kernels.reset_launches()
        with relus.active(replay=bool(replay)), \
                window_conv.dyng(None if replay else mode):
            loss, _ = train_step(m32, opt, qh.to(where),
                                 tuple(k.to(where) for k in kh),
                                 torch.Generator())
        res.append((float(loss), {n: p.grad.detach().cpu() for n, p in
                                  m32.named_parameters()}))
        print(f"[{tag}] f32 B=2 step on {where} (CSN_DYNG "
              f"{None if replay else mode}): loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s), launches "
              f"{ {k: n for k, n in kernels.LAUNCHES.items() if n} }")
        if not replay:
            require_no_cuda_core_f32(tag, m32, kernels.LAUNCHES, True,
                                     im2col=mode in (2, 3))
    (lg, gg), (lc, gc) = res
    print(f"[{tag}] ReLU decisions of the GPU step replayed on the CPU: "
          f"{relus.flips} of {relus.inputs} would have differed")
    require(abs(lg - lc) <= GRAD_TOL * abs(lc),
            f"{tag} f32 train step: loss {lg} on the GPU, {lc} on the CPU")
    top = max(float(t.abs().max()) for t in gc.values())
    worst = (0.0, "")
    for name, ref in gc.items():
        scale = top if name in VANISHING else float(ref.abs().max())
        err = float((gg[name] - ref).abs().max())
        require(err <= GRAD_TOL * scale,
                f"{tag} f32 train step: gradient of {name} off by {err:.3e} "
                f"(tol {GRAD_TOL * scale:.3e})")
        worst = max(worst, (err / max(scale, 1e-30), name))
    print(f"[{tag}] f32 gradients, kernels on the GPU vs plain on the CPU: "
          f"{len(gc)} tensors, worst max_abs_err / max|ref| {worst[0]:.3e} "
          f"({worst[1]}), tol {GRAD_TOL:.0e}; loss {lg:.6f} vs {lc:.6f}")


def train_slice(cls, spec, reqs, dev, n_convs, n_stems, do_profile=False,
                n_head=N_HEAD):
    """Phase 5 (at WIDE_HEADS, phase 5b's train): 3 bf16 train requests in
    `n_head` heads with exact launch counts per kernel, the ms/step (with
    --profile, also under the profiler); at N_HEAD, then the f32 train step
    through the kernels against the plain step on the CPU
    (`f32_step_check`). Returns the launch counts of the 3 requests."""
    fwd, bwd, pre, what = heads_names(n_head)
    tag = f"{pre}train"
    model = make_model(cls, "bfloat16", ATTN_DROPOUT, n_head).to(dev)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR)
    gen = torch.Generator().manual_seed(SEED)
    kernels.reset_launches()
    for r, (qb, keys) in enumerate(reqs):
        loss, pred = train_step(model, opt, qb, keys, gen)
        print(f"[{tag}] request {r}: " + check_point_outputs(
            f"{tag} {r}", loss, None, pred, qb))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require_launches(tag, launches, {
        "sparse_conv_fwd": 2 * n_convs - n_stems, "sparse_conv_dw": n_convs,
        fwd: 2, bwd: 2, "interp_fwd": 1, "interp_bwd": 1})
    qb, keys = reqs[0]
    ms = time_steps(tag, lambda: train_step(model, opt, qb, keys, gen), what)
    if do_profile:
        profile_steps(f"train K=1{', ' + pre.strip() if pre else ''}",
                      lambda: train_step(model, opt, qb, keys, gen),
                      step_ms=ms)
    del model, opt
    torch.cuda.empty_cache()

    if n_head == N_HEAD:
        f32_step_check(cls, spec, dev, "train")
    return launches


def f32_conv_launches(model, train, im2col=False):
    """Launches per request of the sparse conv kernels' rows in an f32 step
    of `model`: per conv, in the K1 form K1's forward at (Cin, Cout), and in
    a train step d_feats at (Cout, Cin) (not at the stem, which reads the
    raw features) and dW at (Cin, Cout); in the im2col form (`im2col`) the
    im2col forward, and in a train step the fused backward, each at (Cin,
    Cout); each in its split-TF32 row where the rule holds (`form_name`),
    else in the CUDA-core bodies' row."""
    f32 = torch.float32
    counts = collections.Counter()
    for m in model.modules():
        if isinstance(m, SparseConv):
            cin, cout = m.kernel.shape[1:]
            if im2col:
                counts[form_name("sparse_conv_im2col_fwd", f32, cin,
                                 cout)] += 1
                if train:
                    counts[form_name("sparse_conv_im2col_bwd", f32, cin,
                                     cout)] += 1
                continue
            counts[form_name("sparse_conv_fwd", f32, cin, cout)] += 1
            if train:
                if m is not model.conv0:
                    counts[form_name("sparse_conv_fwd", f32, cout,
                                     cin)] += 1
                counts[form_name("sparse_conv_dw", f32, cin, cout)] += 1
    return dict(counts)


def require_no_cuda_core_f32(tag, model, launches, train, im2col=False):
    """An f32 run of `model` in the K1 form (or the im2col form, `im2col`)
    launched the CUDA-core rows of its conv kernels only for convs the
    split-TF32 rule leaves there (Cout % 8 != 0: none in the four
    families)."""
    want = f32_conv_launches(model, train, im2col)
    names = (("sparse_conv_im2col_fwd", "sparse_conv_im2col_bwd") if im2col
             else ("sparse_conv_fwd", "sparse_conv_dw"))
    for name in names:
        require(name in want or not launches.get(name, 0),
                f"{tag}: an f32 conv ran a CUDA-core body ({name} "
                f"{launches.get(name, 0)} launches)")


# the CUDA-core conv bodies in f32, as the profiler names them
CUDA_CORE_F32_CONVS = ("sparse_conv_fwd_kernel<float>",
                       "sparse_conv_dw_kernel<float", "im2col_fwd_kernel<float>",
                       "im2col_bwd_kernel<float")


def f32_conv_kernels(tag, rows):
    """The conv kernels of a profiled f32 HRNet step: named with their
    device ms, and none of them a CUDA-core body (CUDA_CORE_F32_CONVS)."""
    convs = [(ms, n, key.replace("(anonymous namespace)::", "").split("(")[0])
             for ms, n, key in rows
             if "conv" in key or "im2col" in key or "sum_splits" in key]
    print(f"[f32] {tag} conv kernels: " + ", ".join(
        f"{name.replace('void ', '')} x{n} {ms:.3f} ms/step"
        for ms, n, name in convs)
        + f"; {sum(r[0] for r in convs):.3f} ms/step in all")
    require(convs and not any(c in name for _, _, name in convs
                              for c in CUDA_CORE_F32_CONVS),
            f"{tag}: a CUDA-core conv body ran in the f32 step")


def f32_slice(cls, reqs, dev, do_profile=False, mode=None, n_head=N_HEAD):
    """Phase 5, f32 (at WIDE_HEADS, phase 5c): the HRNetSimCSN3S eval step
    and train step at the bench protocol with f32 activations
    (`--compute_dtype float32`, the JAX package's choice off the TPU) in
    `n_head` heads, under `CSN_DYNG=mode` (None: the K1 form; 2: the
    im2col pair): 3 eval requests and 3 train requests (dropout 0.1, SGD)
    with exact launch counts per kernel body (K2 and its backward in the
    split-TF32 rows of the head dim, `flash.k2_row`), ms/step over 10 steps
    of each, and with `do_profile` their device time by kernel, naming the
    attention and the conv kernels (none of them a CUDA-core body). Returns
    the launch counts of the 3 train requests and the two ms/step."""
    im2col = mode in (2, 3)
    dk = D_MODEL // n_head
    fwd, bwd = (flash.k2_row(n, torch.float32, dk)
                for n in ("flash_attn_fwd", "flash_attn_bwd"))
    what = f"B={B}, K={K_NEIGHBORS}, f32, CSN_DYNG={mode}"
    tag = "f32" if mode is None else f"f32 CSN_DYNG={mode}"
    if n_head != N_HEAD:
        what += f", {n_head} heads of {dk}"
        tag += f" heads of {dk}"
    model = make_model(cls, "float32", ATTN_DROPOUT, n_head).to(dev)
    with window_conv.dyng(mode):
        kernels.reset_launches()
        for r, (qb, keys) in enumerate(reqs):
            loss, point_logits, pred = eval_step(model, qb, keys)
            res = check_point_outputs(f"{tag} eval {r}", loss, point_logits,
                                      pred, qb)
            print(f"[{tag}] eval request {r}: {res}")
        torch.cuda.synchronize()
        require_launches(f"{tag} eval", dict(kernels.LAUNCHES), {
            **f32_conv_launches(model, False, im2col), fwd: 2,
            "interp_fwd": 1})
        qb, keys = reqs[0]
        eval_ms = time_steps(f"{tag} eval",
                             lambda: eval_step(model, qb, keys), what)
        if do_profile:
            rows = profile_steps(f"{tag} eval K=1",
                                 lambda: eval_step(model, qb, keys),
                                 step_ms=eval_ms)
            f32_attention_kernels(f"{tag} eval", rows)
            f32_conv_kernels(f"{tag} eval", rows)
        opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR)
        gen = torch.Generator().manual_seed(SEED)
        kernels.reset_launches()
        for r, (qb, keys) in enumerate(reqs):
            loss, pred = train_step(model, opt, qb, keys, gen)
            res = check_point_outputs(f"{tag} train {r}", loss, None, pred,
                                      qb)
            print(f"[{tag}] train request {r}: {res}")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        require_launches(f"{tag} train", launches, {
            **f32_conv_launches(model, True, im2col), fwd: 2, bwd: 2,
            "interp_fwd": 1, "interp_bwd": 1})
        qb, keys = reqs[0]
        train_ms = time_steps(f"{tag} train",
                              lambda: train_step(model, opt, qb, keys, gen),
                              what)
        if do_profile:
            rows = profile_steps(f"{tag} train K=1",
                                 lambda: train_step(model, opt, qb, keys,
                                                    gen), step_ms=train_ms)
            f32_attention_kernels(f"{tag} train", rows)
            f32_conv_kernels(f"{tag} train", rows)
    del model, opt
    torch.cuda.empty_cache()
    return launches, eval_ms, train_ms


def f32_attention_kernels(tag, rows):
    """The attention kernels of a profiled f32 HRNet step (K2 and its
    backward at D=64 or D=128, f32): named with their device ms, and none
    of them a CUDA-core body (`flash_fwd_wide`, `flash_bwd_wide_*`)."""
    attn = [(ms, n, key.replace("(anonymous namespace)::", "").split("(")[0])
            for ms, n, key in rows if "flash_" in key]
    print(f"[f32] {tag} attention kernels: " + ", ".join(
        f"{name} x{n} {ms:.3f} ms/step" for ms, n, name in attn)
        + f"; {sum(r[0] for r in attn):.3f} ms/step in all")
    require(attn and not any("_wide" in name for _, _, name in attn),
            f"{tag}: a CUDA-core attention body ran in the f32 step")


def midfc_data(n_shapes, seed, d_model=MF_D):
    """Seeded numpy MID-FC inputs at the protocol's sizes: features
    [B, P, d_model], neighbor features [B, K+1, P, d_model], labels [B, P]
    in [0, C). Every shape's points are drawn around a mean of its own, as
    a backbone's features of different shapes are: the mean-pooled
    descriptors then differ between shapes and the compatibility softmax
    is not uniform."""
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(n_shapes, MF_P, d_model))
             + rng.normal(size=(n_shapes, 1, d_model))).astype(np.float32)
    neighbors = (rng.normal(size=(n_shapes, MF_K + 1, MF_P, d_model))
                 + rng.normal(size=(n_shapes, MF_K + 1, 1, d_model))
                 ).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES,
                          size=(n_shapes, MF_P)).astype(np.int32)
    return feats, labels, neighbors


def check_midfc_outputs(tag, logits, n_shapes):
    require(logits.shape == (n_shapes, MF_P, NUM_CLASSES)
            and bool(torch.isfinite(logits).all()), f"{tag}: bad logits")
    pred = logits.argmax(dim=-1)
    require(int(pred.min()) >= 0 and int(pred.max()) <= NUM_CLASSES - 1,
            f"{tag}: predictions outside [0, {NUM_CLASSES - 1}]")
    return (f"logits {tuple(logits.shape)} finite, pred in "
            f"[{int(pred.min())}, {int(pred.max())}]")


def compare_grads(tag, got, ref, loss_got, loss_ref, tol=GRAD_TOL,
                  loss_tol=GRAD_TOL):
    """Loss within `loss_tol` x |ref| and every gradient of `got` (kernels,
    GPU) within `tol` x max|ref| of the same tensor of `ref` (plain, CPU)."""
    require(abs(loss_got - loss_ref) <= loss_tol * abs(loss_ref),
            f"{tag}: loss {loss_got} on the GPU, {loss_ref} on the CPU")
    top = max(float(r.abs().max()) for r in ref.values())
    worst = (0.0, "")
    for name, r in ref.items():
        scale = float(r.abs().max())
        err = float((got[name].cpu() - r).abs().max())
        print(f"[{tag}] gradient of {name}: max|ref| {scale:.3e} "
              f"({scale / top:.1e} of the step's largest), max_abs_err "
              f"{err:.3e} = {err / max(scale, 1e-30):.3e} x max|ref|")
        require(scale > 0.0 and err <= tol * scale,
                f"{tag}: gradient of {name} off by {err:.3e} (tol "
                f"{tol * scale:.3e})")
        worst = max(worst, (err / scale, name))
    kind = "f32" if tol == GRAD_TOL else "bf16"
    print(f"[{tag}] {kind} gradients, kernels on the GPU vs plain on the CPU:"
          f" {len(ref)} tensors, worst max_abs_err / max|ref| {worst[0]:.3e} "
          f"({worst[1]}), tol {tol:.0e}; loss {loss_got:.6f} vs "
          f"{loss_ref:.6f} (tol {loss_tol:.0e} x |ref|)")


def midfc_config(batch_size, chunk_size, compute_dtype="float32",
                 d_model=MF_D):
    """The MID-FC protocol's runner config (8 heads; the factory sets d_k =
    d_v = d_model)."""
    return MidfcConfig(num_classes=NUM_CLASSES, n_heads=MF_HEADS, K=MF_K,
                       batch_size=batch_size, d_model=d_model,
                       chunk_size=chunk_size, num_points=MF_P,
                       weight_decay=5e-4, compute_dtype=compute_dtype,
                       seed=SEED)


def midfc_chunked_slice(dev, profile=False, compute_dtype="float32"):
    """Phase 6 at `compute_dtype` (f32; bf16 runs K2 and its backward at
    head dim 256 on the bf16 bodies, `"_bf16_wide"`). Returns the launch
    counts of the 3 train steps."""
    n_mha = 2 * MF_K + 1   # SSA of the query and of K neighbors, K cross
    dt = getattr(torch, compute_dtype)
    bf16 = dt == torch.bfloat16
    tag = "midfc bf16" if bf16 else "midfc"
    fwd, bwd = (flash.k2_row(n, dt, MF_D)
                for n in ("flash_attn_fwd", "flash_attn_bwd"))
    runner = MidfcRunner(midfc_config(MF_B, MF_CHUNK, compute_dtype), "csa",
                         device=dev)
    runner.initialize()
    data = [midfc_data(MF_B, SEED + 100 * r) for r in range(N_REQUESTS)]
    kernels.reset_launches()
    for r, (feats, _labels, neighbors) in enumerate(data):
        logits = runner._eval(feats, neighbors)
        print(f"[{tag}] eval request {r}: "
              f"{check_midfc_outputs(f'{tag} eval {r}', logits, MF_B)}")
    torch.cuda.synchronize()
    require_launches(f"{tag} eval", dict(kernels.LAUNCHES), {fwd: n_mha})
    kernels.reset_launches()
    for r, (feats, labels, neighbors) in enumerate(data):
        loss, grads = runner._grad(feats, labels, neighbors,
                                   runner.draw_step_seed())
        runner._apply(grads)
        require(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
            f"{tag} train {r}: loss {loss} or a gradient not finite")
        print(f"[{tag}] train step {r}: loss {float(loss):.6f}, "
              f"{len(grads)} finite gradients")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require_launches(f"{tag} train", launches, {fwd: n_mha, bwd: n_mha})
    feats, labels, neighbors = data[0]
    what = (f"CSA, B={MF_B}, K={MF_K}, P={MF_P}, chunks of {MF_CHUNK}, "
            f"{MF_HEADS} heads of {MF_D}, {'bf16' if bf16 else 'f32'}")
    time_steps(f"{tag} eval", lambda: runner._eval(feats, neighbors), what,
               MF_B)

    def step():
        _, grads = runner._grad(feats, labels, neighbors,
                                runner.draw_step_seed())
        runner._apply(grads)

    ms = time_steps(f"{tag} train", step, what + ", dropout 0.1, Adam", MF_B)
    if profile:
        profile_steps(f"{tag} train", step, step_ms=ms)
    del runner
    torch.cuda.empty_cache()

    # one B=1 step at dropout 0: kernels (GPU) vs plain (CPU), in the same
    # compute dtype
    feats, labels, neighbors = midfc_data(1, SEED + 7)
    res = []
    init = None
    for where in (dev, "cpu"):
        r1 = MidfcRunner(midfc_config(1, MF_CHUNK, compute_dtype), "csa",
                         device=where)
        r1.initialize()
        r1.model.attention.mha.dropout = 0.0
        if init is None:
            init = {k: v.cpu().clone() for k, v in r1.params.items()}
        r1.load_state(init)
        t0 = time.perf_counter()
        loss, grads = r1._grad(feats, labels, neighbors, 0)
        res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
        print(f"[{tag}] {'bf16' if bf16 else 'f32'} B=1 step on {where}: "
              f"loss {float(loss):.6f} ({time.perf_counter() - t0:.1f} s)")
    (lg, gg), (lc, gc) = res
    compare_grads(tag, gg, gc, lg, lc,
                  *((GRAD_TOL_BF16, LOSS_TOL_BF16) if bf16 else ()))
    return launches


def free_tcp_addr():
    """An address on this host for a torch.distributed rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def midfc_ring_slice(dev, profile=False, compute_dtype="float32",
                     d_model=MF_D):
    """Phase 7 at `compute_dtype` (f32; bf16, phase 7b, runs the carry and
    the block backward at head dim 256 on the `_bf16_wide` rows, and the
    reference model without the group K2 on `flash_attn_fwd_bf16_wide`) and
    `d_model` (the heads' d_k = d_v; phase 7c: 128, the ring's rows
    `_tf32_d128` in f32 and `_bf16_wide` in bf16; phase 7d: 64, the rows
    `_tf32_d64` and `_bf16_d64`; K2's rows at that head dim for the model
    without the group). Returns the launch counts of the train step."""
    dt = getattr(torch, compute_dtype)
    bf16 = dt == torch.bfloat16
    tag, kind = ("ring bf16", "bf16") if bf16 else ("ring", "f32")
    if d_model != MF_D:
        tag = f"{tag} d_model {d_model}"
    carry, block = (flash.ring_row(n, dt, d_model) for n in (
        "flash_attn_carry", "flash_attn_block_bwd"))
    k2 = flash.k2_row("flash_attn_fwd", dt, d_model)
    grad_tols = (GRAD_TOL_BF16, LOSS_TOL_BF16) if bf16 else ()
    dist.init_process_group("gloo", init_method=free_tcp_addr(),
                            world_size=1, rank=0)
    try:
        feats, labels, _ = midfc_data(MF_RING_B, SEED + 11, d_model)
        ring = MidfcRunner(midfc_config(MF_RING_B, None, compute_dtype,
                                        d_model), "ssa", device=dev)
        ring.initialize()
        # full attention through the sharded steps is a ring over the seq
        # group, here of one rank
        steps = make_midfc_steps(ring, 1, 1)
        kernels.reset_launches()
        logits = steps.eval(feats, None)
        print(f"[{tag}] eval request: "
              f"{check_midfc_outputs(f'{tag} eval', logits, MF_RING_B)}")
        torch.cuda.synchronize()
        require_launches(f"{tag} eval", dict(kernels.LAUNCHES), {carry: 1},
                         n_requests=1)

        plain = MidfcRunner(midfc_config(MF_RING_B, None, compute_dtype,
                                         d_model), "ssa", device=dev)
        plain.initialize()
        plain.load_state(ring.params)
        kernels.reset_launches()
        ref = plain._eval(feats, None)
        require_launches(f"{tag} eval, same model without the group",
                         dict(kernels.LAUNCHES), {k2: 1}, n_requests=1)
        err = (logits - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"[{tag}] {kind} logits, ring of one (carry kernel {carry}) "
              f"vs the same model without the group (K2, {k2}): "
              f"max_abs_err {err:.3e} tol {TOL[dt] * scale:.3e} (max|ref| "
              f"{scale:.3e})")
        require(err <= TOL[dt] * scale,
                f"{tag} logits disagree with the unsharded model")
        del plain, ref

        kernels.reset_launches()
        loss, grads = steps.grad(feats, labels, None, ring.draw_step_seed())
        ring._apply(grads)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        require(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
            f"{tag} train: loss {loss} or a gradient not finite")
        print(f"[{tag}] train step: loss {float(loss):.6f}, {len(grads)} "
              f"finite gradients")
        require_launches(f"{tag} train", launches, {carry: 1, block: 1},
                         n_requests=1)
        what = (f"SSA, full attention, ring of one, B={MF_RING_B}, "
                f"P={MF_P}, {MF_HEADS} heads of {d_model}, {kind}")
        time_steps(f"{tag} eval", lambda: steps.eval(feats, None), what,
                   MF_RING_B, timed_steps=3)

        def step():
            _, grads = steps.grad(feats, labels, None, ring.draw_step_seed())
            ring._apply(grads)

        ms = time_steps(f"{tag} train", step, what + ", dropout 0.1, Adam",
                        MF_RING_B, timed_steps=3)
        if profile:
            profile_steps(f"{tag} train", step, step_ms=ms)
        del ring, steps
        torch.cuda.empty_cache()

        # one B=1 step at dropout 0: the ring's kernels (GPU) vs the plain
        # blocked attention without a group (CPU), in the same compute dtype
        feats, labels, _ = midfc_data(1, SEED + 13, d_model)
        res = []
        init = None
        for where in (dev, "cpu"):
            r1 = MidfcRunner(midfc_config(1, None, compute_dtype, d_model),
                             "ssa", device=where)
            r1.initialize()
            r1.model.attention.mha.dropout = 0.0
            if init is None:
                init = {k: v.cpu().clone() for k, v in r1.params.items()}
            r1.load_state(init)
            grad = make_midfc_steps(r1, 1, 1).grad if where == dev \
                else r1._grad
            t0 = time.perf_counter()
            kernels.reset_launches()
            loss, grads = grad(feats, labels, None, 0)
            res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
            print(f"[{tag}] {kind} B=1 step on {where}: loss "
                  f"{float(loss):.6f} ({time.perf_counter() - t0:.1f} s), "
                  f"launches "
                  f"{ {k: n for k, n in kernels.LAUNCHES.items() if n} }")
            if where == dev:
                require_launches(f"{tag} B=1 step", dict(kernels.LAUNCHES),
                                 {carry: 1, block: 1}, n_requests=1)
            del r1
        (lg, gg), (lc, gc) = res
        compare_grads(tag, gg, gc, lg, lc, *grad_tols)
    finally:
        dist.destroy_process_group()
    return launches


TR_TRAIN, TR_VAL, TR_TEST, TR_EPOCHS = 16, 8, 8, 2
# the cached eval keeps its key features in f16
CACHED_AGREE, CACHED_IOU_TOL = 0.999, 1e-3


def trainer_config(log_dir, dev, **kw):
    return Config(
        model="HRNetSimCSN3S", partnet_category="Chair",
        conv1_kernel_size=STEM_K, d_model=D_MODEL, n_head=N_HEAD,
        k_neighbors=K_NEIGHBORS, batch_size=B, val_batch_size=B,
        test_batch_size=B, num_points=P, level0_cap=LEVEL0_CAP,
        level_shrink=SHRINK, compute_dtype="bfloat16", optimizer="SGD",
        lr=LR, max_epoch=TR_EPOCHS, stat_freq=1, log_dir=log_dir,
        seed=SEED, device=str(dev), **kw).normalized()


def trainer_datasets():
    """(train, val, test) in-memory collections, each from its own seed."""
    return tuple(SurfaceShapeDataset(n, P, SEED + 31 * i) for i, n in
                 enumerate((TR_TRAIN, TR_VAL, TR_TEST)))


def spy_launches(obj, method, log):
    """Wrap `obj.method` so that each call runs from zeroed launch counts
    and appends (counts, seconds, result) to `log`."""
    inner = getattr(obj, method)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((dict(kernels.LAUNCHES), time.perf_counter() - t0, out))
        return out

    setattr(obj, method, wrapped)


def trainer_slice(dev, n_convs, do_profile=False):
    """Phase 8: `tasks/main_csn.build_trainer` + `CSNTrainer.train()` at
    full width under CSN_DYNG=2, then the eval CLI's path on a fresh
    trainer. Returns the launch counts summed over the train iterations."""
    C = NUM_CLASSES
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        with window_conv.dyng(2):
            return _trainer_slice(dev, n_convs, log_dir, C, do_profile)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _trainer_slice(dev, n_convs, log_dir, C, do_profile):
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = trainer_config(log_dir, dev)
    trainer = main_csn.build_trainer(cfg, datasets=(train_ds, val_ds))
    trainer.MAX_PATIENCE = trainer.MAX_COOLDOWN = 1
    trainer.patience = trainer.cooldown = 1
    graphs, iters = [], []
    build_graph = trainer.construct_shape_graph

    def graph_spy(recalculate):
        graphs.append(recalculate)
        return build_graph(recalculate)

    trainer.construct_shape_graph = graph_spy
    spy_launches(trainer, "_train_iter", iters)
    saved = {}
    save = trainer.save_checkpoint

    def save_spy(postfix=None):
        if postfix is None:   # the file `weights.pt` links to
            saved["host"] = trainer._host_state()
            saved["model"] = {k: v.clone() for k, v in
                              trainer.model.state_dict().items()}
        return save(postfix)

    trainer.save_checkpoint = save_spy
    losses = []
    update = trainer.losses.update
    trainer.losses.update = lambda v, n=1: (losses.append(v), update(v, n))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val = trainer.train()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iters = TR_EPOCHS * (TR_TRAIN // B)
    require(len(iters) == n_iters and len(losses) == n_iters,
            f"trainer: {len(iters)} iterations, expected {n_iters}")
    require(all(np.isfinite(losses)) and all(np.isfinite(val)),
            f"trainer: losses {losses}, final validation {val}")
    require(graphs and graphs[0] is False,
            f"trainer: graph constructions {graphs}")
    expect = {"sparse_conv_im2col_fwd": n_convs,
              "sparse_conv_im2col_bwd": n_convs, "flash_attn_fwd": 2,
              "flash_attn_bwd": 2, "interp_fwd": 1, "interp_bwd": 1}
    total = {k: 0 for k in kernels.LAUNCHES}
    for counts, _, _ in iters:
        for name, got in counts.items():
            require(got == expect.get(name, 0),
                    f"trainer: {name} {got} launches in a train iteration, "
                    f"expected {expect.get(name, 0)}")
            total[name] += got
    print(f"[trainer] train(): {n_iters} iterations of B={B}, K={K_NEIGHBORS} "
          f"over {TR_EPOCHS} epochs in {train_s:.1f} s with 2 validations "
          f"and {len(graphs)} graph construction(s) {graphs}; losses "
          f"{[round(v, 4) for v in losses]}; final validation loss "
          f"{val[0]:.4f}, part IoU {val[2]:.2f}, shape IoU {val[3]:.2f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB")
    print(f"[trainer] launches per train iteration under CSN_DYNG=2: "
          f"{ {k: n for k, n in iters[0][0].items() if n} } (K1 and "
          f"sparse_conv_dw: 0)")
    it_ms = [1e3 * sec for _, sec, _ in iters]
    print(f"[trainer] ms per train iteration inside train(), host batch "
          f"wait included: {[round(t, 1) for t in it_ms]} (the first waits "
          f"for its batch; median of the rest "
          f"{statistics.median(it_ms[1:]):.1f})")
    for name in ("", "best_part_iou"):
        path = os.path.join(log_dir, f"checkpoint_{cfg.model}{name}.pt")
        require(os.path.isfile(path) and os.path.isfile(path + ".json"),
                f"trainer: {path} or its sidecar missing")
    require(os.path.isfile(os.path.join(log_dir, "config.json")),
            "trainer: config.json missing")

    # the host batch build alone, and the step alone on a batch held fixed
    t0 = time.perf_counter()
    qb, keys = trainer._fetch_data()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[trainer] host batch build (query + {K_NEIGHBORS} key batch of "
          f"{B} shapes, built in 2 threads, moved to the card): "
          f"{build_ms:.1f} ms; the prefetch thread overlaps it with the step")
    gen = torch.Generator().manual_seed(SEED)

    def step():
        train_step(trainer.model, trainer.optimizer, qb, keys, gen)

    ms = time_steps("trainer", step, f"B={B}, K={K_NEIGHBORS}, bf16, "
                    f"CSN_DYNG=2, batch held fixed: no host batch build",
                    timed_steps=5)
    if do_profile:
        profile_steps("trainer step, CSN_DYNG=2", step, step_ms=ms)
        # whole iterations as train() runs them: prefetch thread, batch
        # wait, step, the predictions' copy back for the score
        profile_steps("trainer iteration, CSN_DYNG=2", trainer._train_iter)
        trainer._close_prefetch()
    del qb, keys

    # the eval CLI's path on a fresh trainer: resume, test graph, test_on
    want, want_model = saved["host"], saved["model"]
    del trainer
    torch.cuda.empty_cache()
    train2, val2, _ = trainer_datasets()
    res, preds = {}, {}
    for cached in (False, True):
        cfg2 = trainer_config(log_dir, dev, resume=log_dir, is_train=False,
                              cached_eval=cached)
        ev = main_csn.build_trainer(cfg2, datasets=(train2, val2))
        ev.initialize()
        ev.resume()
        if not cached:
            got = ev._host_state()
            for key in ("best_val_part_iou", "best_val_shape_iou",
                        "best_val_loss", "best_val_acc",
                        "best_val_part_iou_iter", "csn_data"):
                require(got[key] == want[key],
                        f"resume: {key} {got[key]} != {want[key]}")
            require(ev.curr_iter == want["iteration"] + 1,
                    f"resume: iteration {ev.curr_iter}")
            for k, v in ev.model.state_dict().items():
                require(torch.equal(v, want_model[k]),
                        f"resume: {k} differs from the saved model")
            print(f"[trainer] resume(): iteration {ev.curr_iter}, epoch "
                  f"{ev.epoch}, bests, patience/cooldown and both neighbour "
                  f"lists restored exactly; {len(want_model)} model tensors "
                  f"bit-equal")
            t0 = time.perf_counter()
            ev.construct_test_graph(test_ds)
            torch.cuda.synchronize()
            print(f"[trainer] construct_test_graph: {TR_TEST} test x "
                  f"{TR_TRAIN} train shapes (SSA descriptors + retrieval "
                  f"measure) in {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            ev.construct_shape_graph(recalculate=True)
            torch.cuda.synchronize()
            print(f"[trainer] construct_shape_graph(recalculate=True): "
                  f"{TR_TRAIN} train + {TR_VAL} val shapes in "
                  f"{time.perf_counter() - t0:.2f} s")
        reqs = []
        spy_launches(ev, "_eval_forward", reqs)
        t0 = time.perf_counter()
        res[cached] = ev.test_on(test_ds)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        preds[cached] = torch.cat([out[2].cpu() for _, _, out in reqs])
        want_req = {"sparse_conv_im2col_fwd": n_convs, "flash_attn_fwd": 2,
                    "interp_fwd": 1}
        for counts, _, _ in reqs:
            for name, n in counts.items():
                require(n == want_req.get(name, 0),
                        f"test_on cached={cached}: {name} {n} launches in a "
                        f"request, expected {want_req.get(name, 0)}")
        fwd_ms = statistics.median(1e3 * s_ for _, s_, _ in reqs)
        first = f", cache of {TR_TRAIN} shapes built first" if cached else ""
        fwd = "query pass + cached keys" if cached \
            else "combined query + key pass"
        print(f"[trainer] test_on cached_eval={cached}: loss "
              f"{res[cached][0]:.4f}, part IoU {res[cached][2]:.3f}, shape "
              f"IoU {res[cached][3]:.3f}; {1e3 * sec / TR_TEST:.1f} ms per "
              f"test shape all in ({TR_TEST} shapes, {len(reqs)} request(s)"
              f"{first}), {fwd_ms / B:.1f} ms per shape in the request's "
              f"forward ({fwd}); launches per request "
              f"{ {k: n for k, n in reqs[0][0].items() if n} }")
        p = preds[cached]
        require(int(p.min()) >= 1 and int(p.max()) <= C - 1,
                f"test_on cached={cached}: predictions outside [1, {C - 1}]")
        require(all(np.isfinite(res[cached])), f"test_on: {res[cached]}")
        del ev
        torch.cuda.empty_cache()
    agree = float((preds[False] == preds[True]).float().mean())
    d_iou = max(abs(res[False][i] - res[True][i]) / 100 for i in (2, 3))
    print(f"[trainer] cached vs recomputed test_on: predictions equal on "
          f"{100 * agree:.3f} % of points (>= {100 * CACHED_AGREE} %), IoUs "
          f"within {d_iou:.2e} (<= {CACHED_IOU_TOL})")
    require(agree >= CACHED_AGREE and d_iou <= CACHED_IOU_TOL,
            "cached and recomputed test_on disagree")
    return total



def check_probes(dev, table):
    """The three probe kernels against their plain versions, and their
    device times (CUDA graphs) at the probe scripts' shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    # probe_window_gather: both layouts, both types, W = 384 and 256, the
    # matched call, a row id outside the window (a zero row)
    for w, t in ((384, 256), (256, 256)):
        win_np, rel_np, want = dyngather.probe_inputs(w, t, dyngather.C)
        rel = torch.from_numpy(rel_np).to(dev)
        bad = rel.clone()
        bad[5] = w + 3
        bad[9] = -1
        for dt in (f32, bf16):
            win = torch.from_numpy(win_np).to(device=dev, dtype=dt)
            plain = dyngather.window_gather_plain(win, rel)
            for layout in (0, 1):
                what = f"W={w} T={t} layout {layout}"
                table.check("probe_window_gather", what,
                            dyngather.window_gather(win, rel, layout), plain,
                            dt)
                table.check("probe_window_gather", what + " matched",
                            dyngather2.matched_gather(win, rel, layout),
                            plain, dt)
                got = dyngather.window_gather(win, bad, layout)
                keep = torch.ones(t, dtype=torch.bool, device=dev)
                keep[[5, 9]] = False
                check_same("probe_window_gather", what, "row ids w + 3 and "
                           "-1 outside the window: zero rows, the other rows "
                           "bitwise win[rel]",
                           not got[~keep].any().item()
                           and torch.equal(got[keep], plain[keep]),
                           body=str(dt)[6:])
            if dt == f32:
                require(np.array_equal(plain.cpu().numpy(), want),
                        "window_gather_plain != numpy's win[rel]")
    win_np, rel_np, _ = dyngather.probe_inputs()
    win = torch.from_numpy(win_np).to(dev)
    rel = torch.from_numpy(rel_np).to(dev)
    nb = (dyngather.W + dyngather.T) * dyngather.C * 4 + dyngather.T * 4
    for layout in (0, 1):
        table.time("probe_window_gather", f"W=384 T=256 C=128 layout "
                   f"{layout}", lambda: dyngather.window_gather(win, rel,
                                                                layout),
                   lambda: dyngather.window_gather_plain(win, rel),
                   count=1 - layout, nbytes=nb, flops=0, dtype=f32,
                   fn_library=lambda: torch.index_select(win, 0, rel),
                   graph=True)

    # probe_gather_accum: the three modes against the plain version, against
    # each other, against a float64 sum of the same window values, and
    # against themselves, at the scripts' timing geometry
    k, n_tiles = 9, 352
    for dt, w in ((bf16, 384), (f32, 384), (f32, 256)):
        rows, win = dyngather.timing_inputs(w, dyngather.T, dyngather.C,
                                            n_tiles, k, dt, dev)
        rows[1, :9] = -1          # row ids outside the window add nothing
        rows[5, 100:140] = w
        rows[k + 2, ::7] = w + 1000
        plain = dyngather.gather_accum_plain(rows, win, k)
        ref64 = dyngather.gather_accum_plain(rows, win.double(), k)
        outs = {}
        for mode in dyngather.MODES:
            outs[mode] = dyngather.gather_accum(rows, win, k, mode)
            # the accumulation itself is f32 in every mode and type
            table.check("probe_gather_accum", f"{mode} W={w} "
                        f"{str(dt)[6:]} window", outs[mode], plain, f32)
            body = (f"{str(dt)[6:]} window, "
                    f"{'tensor cores' if mode == 'onehot' else 'CUDA cores'}")
            check_f64(table, "probe_gather_accum", f"{mode} W={w}",
                      outs[mode], ref64, PROBE_F64_TOL, body=body)
            check_same("probe_gather_accum", f"{mode} W={w}",
                       "repeat: bitwise equal", torch.equal(
                           dyngather.gather_accum(rows, win, k, mode),
                           outs[mode]), body=body)
        for mode in ("onehot", "smem"):
            table.check("probe_gather_accum", f"{mode} vs global W={w} "
                        f"{str(dt)[6:]} window", outs[mode], outs["global"],
                        f32)
        del outs, plain, ref64
        es = win.element_size()
        gather_b = rows.numel() * 4 + w * dyngather.C * es \
            + n_tiles * dyngather.T * dyngather.C * 4
        # the function is K gathered rows added per output row: one
        # bound for every mode, whatever the mode computes on the way
        accum_f = n_tiles * k * dyngather.T * dyngather.C
        bags = rows.reshape(n_tiles, k, -1).transpose(1, 2).reshape(
            -1, k).clamp(0, w - 1).contiguous().long()
        win32 = win.float()
        for mode in dyngather.MODES:
            # the JSON line sums the three modes with the bf16 window
            table.time("probe_gather_accum", f"{mode} W={w} "
                       f"{str(dt)[6:]} window, {n_tiles} tiles x {k} offsets",
                       lambda: dyngather.gather_accum(rows, win, k, mode),
                       lambda: dyngather.gather_accum_plain(rows, win, k),
                       count=int(dt == bf16), reps=3, nbytes=gather_b,
                       flops=accum_f, dtype=f32,
                       fn_library=lambda: F.embedding_bag(bags, win32,
                                                          mode="sum"),
                       graph=True)
        del bags, win32
    torch.cuda.empty_cache()

    check_probe_edges(dev, table)

    # probe_slot_load: every variant, bit for bit. out depends on x's first
    # 8 rows and 128 columns only: the bound reads those 4 KB once and
    # writes out's 4 KB once, in every variant
    slot_b = 2 * 8 * 128 * 4
    for v, (name, shape, _) in iw_bwd.VARIANTS.items():
        x = torch.from_numpy(iw_bwd.probe_input(v)).to(dev) * 3.0
        plain = iw_bwd.slot_load_plain(v, x)
        table.check("probe_slot_load", name, iw_bwd.slot_load(v, x), plain,
                    f32, exact=True)
        require(float(plain.abs().max()) > 1.0, f"slot probe {v}: dead load")
        table.time("probe_slot_load", name, lambda: iw_bwd.slot_load(v, x),
                   lambda: iw_bwd.slot_load_plain(v, x),
                   nbytes=slot_b, flops=0, dtype=f32,
                   graph=True)
    # the launch floor: the slot loads' byte bound (0.0000024 ms) lies below
    # the device time of any launch
    floor = graph_ms(kernels.empty_launch)
    print(f"[time] launch floor: an empty kernel (1 block of 32 threads) "
          f"{floor:.4f} ms a launch (device, CUDA graph of 20 launches); "
          f"probe_slot_load's bound per variant "
          f"{slot_b / HBM_BYTES_S * 1e3:.7f} ms (bytes) "
          f"(not in the kernel line)")
    # what ptxas makes of the slot loads' kernels
    for kern, regs, st, ld, smem in conv_ab.registers(
            kernels.CSRC.parents[1], sources=("probe_slots.cu",)):
        print(f"[ptxas] {kern}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads, {smem} bytes static shared memory")


def check_probe_edges(dev, table):
    """The gather probes off the scripts' shapes: more offsets than a gather
    lane holds at once (K = 27: the sums continue from the output), tiles
    that split a 32-row group (T = 264), a window whose rows are no multiple
    of 16 (the one-hot product's zero rows), channels that leave a part
    one-hot item and a part slab (C = 48), a tiny call; each mode and both
    window types against the plain version, row ids outside the window
    mixed in."""
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(SEED)
    for n_tiles, k, t, w, c in ((40, 27, 256, 384, 128), (37, 9, 264, 250, 48),
                                (3, 5, 8, 20, 16)):
        rows_np = rng.integers(-2, w + 3, size=(n_tiles * k, t))
        win_np = rng.normal(size=(w, c))
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        for dt in (f32, bf16):
            win = torch.from_numpy(win_np.astype(np.float32)).to(dev, dt)
            plain = dyngather.gather_accum_plain(rows, win, k)
            for mode in dyngather.MODES:
                table.check("probe_gather_accum", f"edges {mode} {n_tiles} "
                            f"tiles x {k} offsets, T={t} W={w} C={c} "
                            f"{str(dt)[6:]} window",
                            dyngather.gather_accum(rows, win, k, mode), plain,
                            f32)
    for w, t, c in ((250, 100, 48), (255, 300, 16)):
        rel = torch.from_numpy(rng.integers(-2, w + 3, size=t).astype(
            np.int32)).to(dev)
        valid = (rel >= 0) & (rel < w)
        win_np = rng.normal(size=(w, c)).astype(np.float32)
        for dt in (f32, bf16):
            win = torch.from_numpy(win_np).to(dev, dt)
            want = torch.where(valid[:, None], win[rel.clamp(0, w - 1).long()],
                               torch.zeros((), dtype=dt, device=dev))
            for layout in (0, 1):
                got = dyngather.window_gather(win, rel, layout)
                check_same("probe_window_gather", f"edges W={w} T={t} C={c} "
                           f"layout {layout}", f"{int((~valid).sum())} row "
                           f"ids outside the window: bitwise the plain "
                           f"gather with zero rows", torch.equal(got, want),
                           body=str(dt)[6:])


def family_spec(name):
    """(class, pyramid spec) of a model family at the protocol's sizes."""
    cls = load_model(name)
    return cls, pipeline.pyramid_spec_for_model(
        cls, num_points=P, voxel_size=VOXEL, conv1_kernel_size=STEM_K,
        level0_cap=LEVEL0_CAP, shrink=SHRINK)


def family_batches(name, dev, n_shapes, seed):
    """(class, spec, one device batch of n_shapes shapes) of a plain
    segmentation family at the protocol's sizes."""
    cls, spec = family_spec(name)
    rng = np.random.default_rng(seed)
    hb = pipeline.collate_shapes(
        [make_surface_shape(rng, P) for _ in range(n_shapes)], spec, rng=rng)
    print(f"[batch] {name}: level caps {spec.level_caps}, occupied voxels "
          f"per shape and level (max) "
          f"{[int(n.max()) for n in hb.num_voxels]}, dropped {hb.dropped}, "
          f"{len(spec.maps)} maps")
    return cls, spec, to_torch(hb, dev)


def check_family_convs(dev, table, g):
    """Phase 3 on the new families' convs. Returns Res16UNet34C's number of
    convs."""
    n_unet = 0
    for name, n_shapes, timed in (("Res16UNet34C", B, True),
                                  ("ResUNet14", 2, False),
                                  ("ResNet14", 2, False)):
        cls, _, tb = family_batches(name, dev, n_shapes, SEED + 50)
        n = check_convs(make_model(cls, "bfloat16", 0.0), tb, dev, table, g,
                        timed=timed)
        print(f"[check] {name}: {n} sparse convs, every (map, Cin, Cout) "
              f"family checked in f32 and bf16"
              f"{', and timed in bf16' if timed else ''}")
        if timed:
            n_unet = n
        del tb
        torch.cuda.empty_cache()
    return n_unet


def forward_vs_cpu(name, dev):
    """A full-width f32 forward (B=2, eval mode) through the kernels against
    the plain forward on the CPU."""
    cls, _, tb = family_batches(name, dev, 2, SEED + 60)
    model = make_model(cls, "float32", 0.0).eval().to(dev)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(tb).cpu()
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        require_no_cuda_core_f32(name, model, launched, False)
        t0 = time.perf_counter()
        ref = model.cpu()(tb.to("cpu"))
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[families] {name} f32 forward B=2, logits {tuple(got.shape)}: "
          f"kernels on the GPU {launched} vs plain on the CPU "
          f"({time.perf_counter() - t0:.1f} s): max_abs_err {err:.3e} tol "
          f"{1e-3 * scale:.3e} (max|ref| {scale:.3e})")
    require(bool(torch.isfinite(got).all()) and scale > 0
            and err <= 1e-3 * scale,
            f"{name} f32 forward: kernels disagree with plain")


UNET = "Res16UNet34C"


def unet_slice(dev, n_convs, log_dir):
    """Phase 9, first part: the Res16UNet34C trainer. Returns the launch
    counts summed over the train iterations."""
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = Config(
        model=UNET, partnet_category="Chair", conv1_kernel_size=STEM_K,
        batch_size=B, val_batch_size=B, test_batch_size=B, num_points=P,
        level0_cap=LEVEL0_CAP, level_shrink=SHRINK, compute_dtype="bfloat16",
        optimizer="SGD", lr=LR, scheduler="StepLR", max_epoch=TR_EPOCHS,
        stat_freq=1, log_dir=log_dir, seed=SEED, device=str(dev)).normalized()
    trainer = main_seg.build_trainer(cfg, datasets=(train_ds, val_ds))
    require(type(trainer.model).__name__ == UNET
            and trainer.spec.num_levels == 5, "phase 9: wrong model or spec")
    iters, losses = [], []
    spy_launches(trainer, "_train_iter", iters)
    update = trainer.losses.update
    trainer.losses.update = lambda v, n=1: (losses.append(v), update(v, n))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val = trainer.train()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iters = TR_EPOCHS * (TR_TRAIN // B)
    require(len(iters) == n_iters and all(np.isfinite(losses))
            and all(np.isfinite(val)),
            f"unet trainer: {len(iters)} iterations, losses {losses}, "
            f"validation {val}")
    expect = {"sparse_conv_fwd": 2 * n_convs - 1, "sparse_conv_dw": n_convs,
              "interp_fwd": 1, "interp_bwd": 1}
    total = {k: 0 for k in kernels.LAUNCHES}
    for counts, _, _ in iters:
        for name, got in counts.items():
            require(got == expect.get(name, 0),
                    f"unet trainer: {name} {got} launches in a train "
                    f"iteration, expected {expect.get(name, 0)}")
            total[name] += got
    it_ms = [1e3 * sec for _, sec, _ in iters]
    print(f"[unet] {UNET} train(): {n_iters} iterations of B={B} over "
          f"{TR_EPOCHS} epochs in {train_s:.1f} s with 2 validations; losses "
          f"{[round(v, 4) for v in losses]}; final validation loss "
          f"{val[0]:.4f}, part IoU {val[2]:.2f}, shape IoU {val[3]:.2f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB; launches per iteration "
          f"{ {k: n for k, n in iters[0][0].items() if n} }; ms per "
          f"iteration inside train() {[round(t, 1) for t in it_ms]}")
    reqs = []
    spy_launches(trainer, "_eval_forward", reqs)
    res = trainer.test_on(test_ds)
    require(all(np.isfinite(res)), f"unet test_on: {res}")
    preds = torch.cat([out[2].cpu() for _, _, out in reqs])
    require(int(preds.min()) >= 1 and int(preds.max()) <= NUM_CLASSES - 1,
            f"unet test_on: predictions outside [1, {NUM_CLASSES - 1}]")
    for counts, _, _ in reqs:
        for name, n in counts.items():
            want = {"sparse_conv_fwd": n_convs, "interp_fwd": 1}.get(name, 0)
            require(n == want, f"unet test_on: {name} {n} launches in a "
                    f"request, expected {want}")
    print(f"[unet] test_on: loss {res[0]:.4f}, part IoU {res[2]:.3f}, shape "
          f"IoU {res[3]:.3f}; predictions in [{int(preds.min())}, "
          f"{int(preds.max())}]; launches per request "
          f"{ {k: n for k, n in reqs[0][0].items() if n} }")

    # the step and the eval request on a batch held fixed, in both forms
    qb, keys = trainer._fetch_data()
    trainer._close_prefetch()
    gen = torch.Generator().manual_seed(SEED)
    for mode in (None, 2):
        with window_conv.dyng(mode):
            tag = f"B={B}, bf16, CSN_DYNG={mode}, batch held fixed"
            time_steps("unet train", lambda: train_step(
                trainer.model, trainer.optimizer, qb, keys, gen), tag,
                timed_steps=5)
            time_steps("unet eval", lambda: eval_step(trainer.model, qb,
                                                      keys), tag,
                       timed_steps=5)
    return total


MF_CAT, MF_CHAIN_K = "Bed", 1   # a category of the launcher's table: 15 classes


def check_kmeans():
    """`kmeans_candidate_indices` (the big categories' candidate pruning,
    the port's own k-means) on descriptors with a known answer: 40 clusters
    of 10 shapes, far apart, each a shape at its center and 9 around it
    whose offsets sum to zero, so the nearest shape to each center is the
    central one."""
    rng = np.random.default_rng(SEED)
    n_cl, per, d = 40, 10, D_MODEL
    centers = rng.normal(size=(n_cl, d)) * 10.0
    off = rng.normal(size=(n_cl, per - 1, d)) * 0.1
    off -= off.mean(axis=1, keepdims=True)
    x = np.concatenate([centers[:, None], centers[:, None] + off], axis=1)
    perm = rng.permutation(n_cl * per)
    x = x.reshape(-1, d)[perm].astype(np.float32)
    want = np.sort(np.argsort(perm)[np.arange(n_cl) * per])
    t0 = time.perf_counter()
    got = np.sort(retrieval_graph.kmeans_candidate_indices(x))
    sec = time.perf_counter() - t0
    require(np.array_equal(got, want),
            f"kmeans_candidate_indices: {got} vs {want}")
    print(f"[chain] kmeans_candidate_indices on {n_cl * per} descriptors of "
          f"{d}: the {n_cl} cluster centres' shapes, in {sec:.2f} s")


def chain_slice(dev, base):
    """Phase 9, second part: HRNetSeg3S extractor -> fc_1 dumps -> SSA ->
    kNN graphs -> CSA -> get_csa_pred. Returns the launch counts of the
    whole chain."""
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = Config(
        model="HRNetSeg3S", partnet_category="Chair",
        conv1_kernel_size=STEM_K, d_model=D_MODEL, batch_size=B,
        val_batch_size=B, test_batch_size=B, num_points=P,
        level0_cap=LEVEL0_CAP, level_shrink=SHRINK, compute_dtype="bfloat16",
        optimizer="SGD", lr=LR, scheduler="StepLR", max_epoch=1, stat_freq=1,
        log_dir=os.path.join(base, "seg_logs"), seed=SEED,
        device=str(dev)).normalized()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = main_seg.build_trainer(cfg, datasets=(train_ds, val_ds))
    val = trainer.train()
    require(all(np.isfinite(val)), f"extractor training: {val}")
    feats = os.path.join(base, "features")
    counts = {}
    for split, ds in (("train", train_ds), ("test", test_ds)):
        counts[split] = extraction.extract_split(
            trainer.model, ds, trainer.spec,
            os.path.join(feats, split, MF_CAT), batch_size=B)
    torch.cuda.synchronize()
    require(counts == {"train": TR_TRAIN, "test": TR_TEST},
            f"extract_split wrote {counts}")
    f0 = np.load(os.path.join(feats, "train", MF_CAT, "fc_1", "00000.npy"))
    l0 = np.load(os.path.join(feats, "train", MF_CAT, "point_labels",
                              "00000.npy"))
    require(f0.shape == (1, D_MODEL, P, 1) and l0.shape == (P,)
            and bool(np.isfinite(f0).all()),
            f"extract_split: fc_1 {f0.shape}, labels {l0.shape}")
    require(kernels.LAUNCHES["interp_fwd"] >= 2 * (TR_TRAIN + TR_TEST) // B,
            "extract_split did not run the readout kernel")
    print(f"[chain] HRNetSeg3S trained 1 epoch (validation loss "
          f"{val[0]:.4f}) and {counts} shapes extracted (fc_1 "
          f"{f0.shape}, 4 npy directories per split) in "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer
    torch.cuda.empty_cache()

    logs = os.path.join(base, "logs")
    k = run_training.NAMES.index(MF_CAT)
    common = ["--data_root", feats, "--logs_root", logs, "--start", str(k),
              "--end", str(k), "--testing", "--d_model", str(D_MODEL),
              "--num_points", str(P), "--chunk_size", str(MF_CHUNK),
              "--n_heads", str(MF_HEADS), "--K", str(MF_CHAIN_K),
              "--batch_size", "2", "--device", str(dev)]
    for at in ("ssa", "save_knn", "csa"):
        t0 = time.perf_counter()
        ious = run_training.main(common + ["--attention_type", at])
        torch.cuda.synchronize()
        print(f"[chain] run_training {at}: {ious} in "
              f"{time.perf_counter() - t0:.1f} s")
    graph_dir = os.path.join(logs, "knn_graphs", f"n_heads_{MF_HEADS}",
                             MF_CAT)
    tr_graph = np.load(os.path.join(graph_dir, "train.npy"))
    require(tr_graph.shape == (TR_TRAIN, MF_CHAIN_K + 1)
            and bool((tr_graph[:, 0] == np.arange(TR_TRAIN)).all()),
            f"chain: train graph {tr_graph.shape}, {tr_graph[:, 0]}")
    check_kmeans()
    ckpt = os.path.join(logs, f"sgd_csa_n_heads_{MF_HEADS}_K_{MF_CHAIN_K}",
                        "run_1", MF_CAT, CHECKPOINT_NAME)
    require(os.path.isfile(ckpt), f"chain: {ckpt} missing")
    launches = dict(kernels.LAUNCHES)
    require(launches["flash_attn_fwd"] > 0 and launches["flash_attn_bwd"] > 0,
            f"chain: the MID-FC training launched no flash kernel: "
            f"{launches}")

    # get_csa_pred pins f32 and takes the attention of its device: the f32
    # flash kernels on the card, held to the plain attention of a CPU run
    pred_args = [
        "--data_root", feats, "--partname", MF_CAT, "--num_classes",
        str(run_training.SEG_NUM[k]), "--n_heads", str(MF_HEADS), "--K",
        str(MF_CHAIN_K), "--chunk_size", str(MF_CHUNK), "--d_model",
        str(D_MODEL), "--num_points", str(P), "--batch_size", "2", "--ckpt",
        ckpt, "--knn_graph_dir", graph_dir]
    kernels.reset_launches()
    t0 = time.perf_counter()
    iou = get_csa_pred.main(pred_args + [
        "--logs_dir", os.path.join(base, "csa_pred"), "--save_pred_dir",
        os.path.join(base, "pred_gpu"), "--device", str(dev)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    pred_launches = dict(kernels.LAUNCHES)
    # chunked eval: one flash launch per attention layer of a batch
    require(0.0 <= iou <= 1.0 and pred_launches["flash_attn_fwd"] > 0
            and os.path.isfile(os.path.join(base, "csa_pred",
                                            "part_IoU_summaries.csv")),
            f"get_csa_pred: IoU {iou}, launches {pred_launches}")
    t0 = time.perf_counter()
    iou_cpu = get_csa_pred.main(pred_args + [
        "--logs_dir", os.path.join(base, "csa_pred_cpu"), "--save_pred_dir",
        os.path.join(base, "pred_cpu"), "--device", "cpu"])
    require(kernels.LAUNCHES == pred_launches,
            "get_csa_pred --device cpu launched a kernel")
    sub = f"midfc_csa_K_{MF_CHAIN_K}"
    agree = float(np.mean([
        (np.load(os.path.join(base, "pred_gpu", sub, f"shape_{i}.npy"))
         == np.load(os.path.join(base, "pred_cpu", sub, f"shape_{i}.npy"))
         ).mean() for i in range(TR_TEST)]))
    print(f"[chain] get_csa_pred on {TR_TEST} test shapes: part IoU "
          f"{100 * iou:.4f} in {sec:.1f} s (f32 flash kernels, launches "
          f"{ {n: c for n, c in pred_launches.items() if c} }) vs "
          f"{100 * iou_cpu:.4f} with --device cpu (plain attention, "
          f"{time.perf_counter() - t0:.1f} s): IoUs within "
          f"{abs(iou - iou_cpu):.2e} (<= {CACHED_IOU_TOL}), predictions "
          f"equal on {100 * agree:.3f} % of points (>= "
          f"{100 * CACHED_AGREE} %)")
    require(abs(iou - iou_cpu) <= CACHED_IOU_TOL and agree >= CACHED_AGREE,
            "get_csa_pred on the card disagrees with its CPU run")
    cat_dir = os.path.join(logs, "pretrained_models", "run_1", MF_CAT)
    os.makedirs(cat_dir)
    shutil.copy(ckpt, cat_dir)
    shutil.copytree(graph_dir, os.path.join(
        logs, "pretrained_models", "knn_graphs", f"n_heads_{MF_HEADS}",
        MF_CAT))
    kernels.reset_launches()
    ious = run_training.main(common + ["--attention_type", "pred"])
    # the call above went over the test set twice (validation, then the
    # prediction dump); `pred` validates only
    require(abs(ious[MF_CAT] - 100 * iou) < 1e-9
            and 2 * kernels.LAUNCHES["flash_attn_fwd"]
            == pred_launches["flash_attn_fwd"],
            f"run_training pred: {ious} vs get_csa_pred {100 * iou}, "
            f"launches {kernels.LAUNCHES}")
    print(f"[chain] run_training pred: {ious}, "
          f"{kernels.LAUNCHES['flash_attn_fwd']} flash_attn_fwd launches")
    for name in launches:
        launches[name] += pred_launches[name] + kernels.LAUNCHES[name]
    return launches


def probes_slice(dev):
    """Phase 9, last part: the probes' own entry points. Returns the launch
    counts."""
    kernels.reset_launches()
    times = dyngather.main(["--device", str(dev)])
    times2 = dyngather2.main(["--device", str(dev)])
    errs = iw_bwd.main(["--device", str(dev), "--extra"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(all(e == 0.0 for e in errs.values()) and len(errs) == 7,
            f"slot probes differ from their plain versions: {errs}")
    require(all(np.isfinite(t) and t > 0 for t in (*times.values(),
                                                   *times2.values())),
            f"probe timings: {times}, {times2}")
    print(f"[probes] launches of the three entry points: "
          f"{ {k: n for k, n in launches.items() if n} }")
    return launches


def families_slice(dev, n_convs):
    """Phase 9. Returns the launch counts of its main paths, summed."""
    base = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        total = unet_slice(dev, n_convs, os.path.join(base, "unet_logs"))
        cls, spec = family_spec(UNET)
        for mode in (None, 2):
            f32_step_check(cls, spec, dev, "unet", mode=mode)
        for name in ("ResUNet14", "ResNet14"):
            forward_vs_cpu(name, dev)
        chain = chain_slice(dev, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    probes = probes_slice(dev)
    return {k: total[k] + chain[k] + probes[k] for k in total}


# ---------------------------------------------------------------------------
# phase 10: the multi-device trainers on one card
# ---------------------------------------------------------------------------

DP_ITERS = 3
CP_B, CP_TIMEOUT_S = 2, 300


def dp_trainer_run(dev, log_dir, tag):
    """Phase 10 (a): one drive of the HRNet trainer at the protocol (K1
    form, bf16), inside or outside a world: random pairs, DP_ITERS train
    iterations (their launch counts, losses and every model tensor after
    each), a graph rebuild (SSA descriptors, `_measure`), `test_on` with
    `cached_eval`, and the step alone on a fixed batch. The same sequence
    on both sides, so the shared generators make the same draws."""
    train_ds, val_ds, test_ds = trainer_datasets()
    t = main_csn.build_trainer(trainer_config(log_dir, dev),
                               datasets=(train_ds, val_ds))
    t.initialize()
    t.construct_shape_graph(recalculate=False)
    iters, losses, params = [], [], []
    spy_launches(t, "_train_iter", iters)
    update = t.losses.update
    t.losses.update = lambda v, n=1: (losses.append(v), update(v, n))
    for _ in range(DP_ITERS):
        t._train_iter()
        params.append({k: v.detach().cpu().clone()
                       for k, v in t.model.state_dict().items()})
    t._close_prefetch()
    res = dict(losses=losses, params=params,
               launches=[counts for counts, _, _ in iters],
               iter_s=[s_ for _, s_, _ in iters])
    desc, masks = t._all_ssa_descriptors(train_ds)
    t0 = time.perf_counter()
    res["measure"] = t._measure(desc, masks, desc, masks)
    res["measure_s"] = time.perf_counter() - t0
    if t.world is not None:
        res["plain_measure"] = retrieval_graph.retrieval_measure(
            desc, masks, desc, masks, device=dev)
    t.construct_shape_graph(recalculate=True)
    res["graph"] = (list(t.train_dataset.neighbors),
                    list(t.val_dataset.neighbors))
    t.construct_test_graph(test_ds)
    t.config.cached_eval = True
    t0 = time.perf_counter()
    res["test_on"] = t.test_on(test_ds)
    res["test_on_s"] = time.perf_counter() - t0
    qb, keys = t._fetch_data()
    gen = torch.Generator().manual_seed(SEED)
    if t.world is None:
        def step():
            train_step(t.model, t.optimizer, qb, keys, gen)
    else:
        dp_step = dp.make_dp_train_step(t.model, t.optimizer, t.world)

        def step():
            dp_step(qb, keys, gen)
    res["step_ms"] = time_steps(
        tag, step, f"B={B}, K={K_NEIGHBORS}, bf16, batch held fixed")
    if t.world is not None:
        # what the world adds to a step: the gradients' and the BatchNorm
        # statistics' all-reduces (device time)
        res["reduce_ms"] = median_ms(lambda: (
            dp.average_grads(t.model, t.world),
            dp.average_buffers(t.model, t.world)))
    del t, qb, keys
    torch.cuda.empty_cache()
    return res


def dp_of_one_slice(dev):
    """Phase 10 (a): the trainer built inside an NCCL world of one rank
    against the same trainer without a world. Returns the launch counts of
    the data-parallel train iterations."""
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        ref = dp_trainer_run(dev, os.path.join(log_dir, "single"),
                             "dp single-device step")
        dist.init_process_group("nccl", init_method=free_tcp_addr(),
                                world_size=1, rank=0)
        try:
            got = dp_trainer_run(dev, os.path.join(log_dir, "dp"),
                                 "dp world-of-one step")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    require(got["losses"] == ref["losses"],
            f"dp: losses {got['losses']} != single-device {ref['losses']}")
    for i, (a, b) in enumerate(zip(got["params"], ref["params"])):
        bad = [k for k in b if not torch.equal(a[k], b[k])]
        require(not bad, f"dp: after iteration {i + 1}, {len(bad)} model "
                f"tensors differ from the single-device trainer's, e.g. "
                f"{bad[:3]}")
    require(got["launches"] == ref["launches"],
            f"dp: launches {got['launches']} != {ref['launches']}")
    total = {k: 0 for k in kernels.LAUNCHES}
    for counts in got["launches"]:
        for k, n in counts.items():
            total[k] += n
    print(f"[dp] world of one (NCCL) vs the single-device trainer: "
          f"{DP_ITERS} iterations of B={B}, K={K_NEIGHBORS}, bf16, losses "
          f"{[round(v, 6) for v in got['losses']]} bitwise equal, "
          f"{len(ref['params'][0])} model tensors bitwise equal after each "
          f"iteration; launches per iteration equal: "
          f"{ {k: n for k, n in got['launches'][0].items() if n} }")
    err = float(np.abs(got["measure"] - got["plain_measure"]).max())
    require(err <= 1e-5, f"dp: sharded_retrieval_measure off by {err:.3e}")
    require(np.array_equal(got["measure"], ref["measure"]),
            "dp: the sharded measure differs from the single-device one")
    require(got["graph"] == ref["graph"], "dp: retrieved graphs differ")
    print(f"[dp] sharded_retrieval_measure [{TR_TRAIN}x{TR_TRAIN}]: max abs "
          f"diff {err:.3e} to retrieval_measure (tol 1e-5), bitwise equal to "
          f"the single-device trainer's ({got['measure_s']:.2f} s vs "
          f"{ref['measure_s']:.2f} s); rebuilt graphs equal")
    require(got["test_on"] == ref["test_on"],
            f"dp: cached test_on {got['test_on']} != {ref['test_on']}")
    print(f"[dp] test_on cached_eval through shard_collection / "
          f"exchange_rows: loss {got['test_on'][0]:.6f}, part IoU "
          f"{got['test_on'][2]:.3f}, shape IoU {got['test_on'][3]:.3f}, "
          f"equal to the single-device cached eval ({got['test_on_s']:.2f} s "
          f"vs {ref['test_on_s']:.2f} s)")
    print(f"[dp] step on a fixed batch: world of one {got['step_ms']:.3f} "
          f"ms, single-device {ref['step_ms']:.3f} ms "
          f"({100 * (got['step_ms'] / ref['step_ms'] - 1):+.1f} %); of it "
          f"the gradients' and BatchNorm statistics' all-reduces "
          f"{got['reduce_ms']:.3f} ms device time; ms per iteration with "
          f"the batch wait: world of one "
          f"{[round(1e3 * s_, 1) for s_ in got['iter_s']]}, single-device "
          f"{[round(1e3 * s_, 1) for s_ in ref['iter_s']]}")
    return total


def cp_rank(rank: int, addr: str, out: str) -> int:
    """Phase 10 (b), one of two rank processes sharing the card: a (1, 2)
    collection grid over gloo at full width, B=CP_B per member, K=1."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=addr, world_size=2,
                            rank=rank)
    try:
        cls, spec = family_spec("HRNetSimCSN3S")
        (qb, keys), = build_requests(spec, dev, n_shapes=CP_B, n_requests=1,
                                     seed=SEED + 17)
        grid = cp.make_cp_grid(1, 2, dev)
        lb = (qb, keys[0])[grid.col_index]
        res = {}
        m32 = make_model(cls, "float32", ATTN_DROPOUT).to(dev)
        steps32 = cp.make_cp_trainer_steps(m32, grid, k_neighbors=1)
        kernels.reset_launches()
        loss, plog, _ = steps32.eval_step(lb)
        torch.cuda.synchronize()
        res["eval_launches"] = dict(kernels.LAUNCHES)
        res["eval_loss"] = float(loss)
        if rank == 0:   # the single-process combined pass, same weights
            with torch.no_grad():
                ref = interp.interp_batch(m32.eval()(qb, keys), qb)
            res["err"] = float((plog - ref).abs().max())
            res["scale"] = float(ref.abs().max())
        del m32, steps32
        model = make_model(cls, "bfloat16", ATTN_DROPOUT).to(dev)
        opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR)
        steps = cp.make_cp_trainer_steps(model, grid, k_neighbors=1)
        gen = dp.rank_generator(SEED, rank)

        def step():
            opt.zero_grad(set_to_none=True)
            out = steps.grad_step(lb, gen)
            steps.reduce_grads()
            opt.step()
            return out

        kernels.reset_launches()
        loss, _ = step()
        torch.cuda.synchronize()
        res["train_launches"] = dict(kernels.LAUNCHES)
        res["train_loss"] = float(loss)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        both = collectives.all_gather(flat, rank, 2)
        res["params_equal"] = bool(torch.equal(both[0], both[1]))
        res["n_params"] = int(flat.numel())
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        res["step_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        # of it, the gradient all-reduce over gloo (host clock: gloo moves
        # CUDA tensors through host memory; the sums are not used after)
        t0 = time.perf_counter()
        for _ in range(3):
            steps.reduce_grads()
        torch.cuda.synchronize()
        res["reduce_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def cp_two_ranks_slice():
    """Phase 10 (b): two rank processes of this script sharing the card
    over gloo (NCCL refuses two ranks on one GPU): the f32 eval against the
    single-process combined pass, one bf16 train step (finite loss, the
    parameters bitwise equal on both ranks) and its time."""
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_cp_"), "rank")
    addr = free_tcp_addr()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cp-rank", str(r), addr,
         out], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=CP_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:   # leave nothing running
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        require(p.returncode == 0,
                f"cp rank {r} exited {p.returncode}:\n{err[-3000:]}")
    res = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            res.append(json.load(f))
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    r0 = res[0]
    tol = 1e-3 * r0["scale"]
    print(f"[cp] (1 data x 2 col) grid, two rank processes on the card over "
          f"gloo, HRNetSimCSN3S, B={CP_B} per member, K=1, "
          f"{time.perf_counter() - t0:.1f} s with start-up: f32 eval logits "
          f"vs the single-process combined pass: max_abs_err "
          f"{r0['err']:.3e} tol {tol:.3e} (max|ref| {r0['scale']:.3e}); "
          f"eval launches per rank "
          f"{[nonzero(x['eval_launches']) for x in res]}")
    require(r0["err"] <= tol, "cp: eval logits disagree with the combined "
            "pass")
    for r, x in enumerate(res):
        require(np.isfinite(x["train_loss"]) and x["params_equal"],
                f"cp rank {r}: loss {x['train_loss']}, parameters equal "
                f"{x['params_equal']}")
    require(res[0]["train_loss"] == res[1]["train_loss"],
            "cp: the ranks report different losses")
    print(f"[cp] bf16 train step: loss {r0['train_loss']:.6f} on both ranks, "
          f"{r0['n_params']} parameters bitwise equal on both after the step; "
          f"{r0['step_ms']:.1f} / {res[1]['step_ms']:.1f} ms per step (ranks "
          f"0 / 1, two processes time-sharing the card), of it the gradient "
          f"all-reduce {r0['reduce_ms']:.1f} / {res[1]['reduce_ms']:.1f} ms; "
          f"train launches per rank "
          f"{[nonzero(x['train_launches']) for x in res]}")


def flash_dims_spy(seen):
    """Wrap the K2 wrappers so that each call adds its (kernel, dtype, head
    dim) to the Counter `seen`; returns the function that undoes it."""
    inner = {name: getattr(flash, name) for name in
             ("flash_attention", "flash_attention_bwd")}

    def wrap(name, fn):
        tag = "flash_attn_fwd" if name == "flash_attention" \
            else "flash_attn_bwd"

        def wrapped(q, *args, **kwargs):
            seen[(tag, str(q.dtype)[6:], q.shape[-1])] += 1
            return fn(q, *args, **kwargs)
        return wrapped

    for name, fn in inner.items():
        setattr(flash, name, wrap(name, fn))

    def undo():
        for name, fn in inner.items():
            setattr(flash, name, fn)
    return undo


def eval_iou_check(trainer, dev):
    """One eval request of the trained CSN model (the first train shapes
    and their retrieved keys): `batch_intersection_union` on its CUDA
    predictions against the same call on the CPU (equal counts), and
    `mink_metrics_from_iu` against the host's per-shape `calculate_iou`
    with `calculate_part_iou` / `calculate_shape_iou` (equal)."""
    ds = trainer.train_dataset
    idxs = list(range(trainer.config.batch_size))
    host = build_batch_from_dataset(ds, idxs, trainer.spec, trainer.rng,
                                    augment=False)
    with torch.no_grad():
        _, _, pred = trainer._eval_forward(ds, idxs, trainer._to_device(host))
    C = trainer.num_labels
    labels = torch.as_tensor(np.asarray(host.labels)).to(dev)
    mask = torch.as_tensor(np.asarray(host.point_mask)).to(dev)
    inter, union = metrics.batch_intersection_union(pred, labels, mask, C)
    c_inter, c_union = metrics.batch_intersection_union(
        pred.cpu(), labels.cpu(), mask.cpu(), C)
    same = torch.equal(inter.cpu(), c_inter) and \
        torch.equal(union.cpu(), c_union)
    pred_np = pred.cpu().numpy()
    ious = {b: metrics.calculate_iou(host.labels[b][host.point_mask[b]],
                                     pred_np[b][host.point_mask[b]], C)
            for b in range(len(idxs))}
    part, shape = metrics.mink_metrics_from_iu(inter.cpu().numpy(),
                                               union.cpu().numpy(), C)
    host_ok = part == metrics.calculate_part_iou(ious, C) and \
        shape == metrics.calculate_shape_iou(ious)
    print(f"[learning] csn eval request, B={len(idxs)}, {C} labels: "
          f"batch_intersection_union on the card vs the CPU: counts "
          f"{'equal' if same else 'DIFFER'} (intersections "
          f"{int(inter.sum())}, unions {int(union.sum())}); "
          f"mink_metrics_from_iu part IoU {part:.6f} shape IoU "
          f"{shape:.6f} vs the host's calculate_iou: "
          f"{'equal' if host_ok else 'DIFFER'} "
          f"{'ok' if same and host_ok else 'FAIL'}")
    require(same and host_ok, "batch_intersection_union: the card's counts "
            "or the metrics from them disagree")


def learning_slice(dev):
    """Phase 11: the learning check (`tasks/learning_check.py`, the JAX
    package's `scripts/learning_check.py` at its defaults) on the card in
    the K1 form: csn (HRNetSimCSN2S, d_model 64 in 2 heads: the bf16 D=32
    tensor-core bodies of K2 and its backward), seg (HRNetSeg2S) and midfc
    (the MID-FC CSA runner, f32). A task whose loss does not fall fails the
    run. The csn task ends with `eval_iou_check`. Returns the launch counts
    of the three tasks' training."""
    total = {k: 0 for k in kernels.LAUNCHES}
    for task in LC_TASKS:
        args = learning_check.build_parser().parse_args(["--task", task])
        seen = collections.Counter()
        counts, calls = {}, {}

        def inspect(obj):   # the training's counts, before any eval
            torch.cuda.synchronize()
            counts.update(kernels.LAUNCHES)
            calls.update(seen)
            if task == "csn":
                eval_iou_check(obj, dev)

        torch.cuda.synchronize()
        kernels.reset_launches()
        undo = flash_dims_spy(seen)
        t0 = time.perf_counter()
        try:
            res = learning_check.run(args, inspect)
        finally:
            undo()
        secs = time.perf_counter() - t0
        for k, n in counts.items():
            total[k] += n
        print(f"[learning] task {task} ({res['dtype']}): first loss "
              f"{res['first']:.4f}, last {res['last']:.4f} (must be below "
              f"{0.8 * res['first']:.4f}); {secs:.1f} s with set-up; "
              f"training launches {nonzero(counts)}; K2 wrapper calls by "
              f"(kernel, dtype, head dim) {calls}")
        require(res["passed"], f"learning check {task}: the train loss did "
                f"not fall substantially ({res['first']:.3f} -> "
                f"{res['last']:.3f})")
        if task == "csn":
            want = {("flash_attn_fwd", "bfloat16", 32),
                    ("flash_attn_bwd", "bfloat16", 32)}
            require(set(calls) == want and counts["flash_attn_fwd"] > 0
                    and counts["flash_attn_bwd"] > 0,
                    f"learning check csn: K2 calls {calls}, expected "
                    f"bf16 at head dim 32 only")
        torch.cuda.empty_cache()
    return total


def main() -> int:
    do_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs a GPU",
              file=sys.stderr)
        return 1
    if "--cp-rank" in sys.argv:   # a rank process of phase 10 (b)
        i = sys.argv.index("--cp-rank")
        return cp_rank(int(sys.argv[i + 1]), *sys.argv[i + 2:i + 4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 3-7 run the K1 form whatever the caller's environment says;
    # phase 8 sets the im2col form for its own block
    os.environ.pop("CSN_DYNG", None)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(msg):
        print(f"[phase] {msg} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"C++ host engine loaded: {native.available()}")

    # 2. build
    t0 = time.perf_counter()
    build_s = kernels.build(force=True)
    kernels.library()
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}, "
          f"{len(list(kernels.CSRC.glob('*.cu')))} sources: {build_s:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with loading)")

    cls, spec = family_spec("HRNetSimCSN3S")
    print(f"[batch] level caps {spec.level_caps}, maps {spec.map_names()}")
    t0 = time.perf_counter()
    reqs = build_requests(spec, dev)
    print(f"[batch] {N_REQUESTS} requests x (1 + {K_NEIGHBORS}) batches of "
          f"{B} shapes built and moved in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    phase("3 kernels")
    table = Table()
    model = make_model(cls, "bfloat16", ATTN_DROPOUT)
    qb, (kb,) = reqs[0]
    big = concat_batches([qb, kb])
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n_convs = check_convs(model, big, dev, table, g)
    n_stems = 1   # conv0 reads the raw voxel features: no d_feats
    check_dw_edges(dev, table, g)
    check_k1_edges(dev, table)
    check_im2col_edges(dev, table, g)
    check_attention(qb, kb, big, dev, table, g)
    check_head_dims(qb, kb, big, dev, table)
    check_interp(qb, dev, table, g)
    del big
    for dk in RING_TIMED_DIMS:
        check_ring_kernels(dev, table, g, dk=dk)
    check_ring_padded(dev, table)
    n_unet_convs = check_family_convs(dev, table, g)
    print(f"[check] sparse_conv_dw bfloat16 (tensor cores) vs float64: "
          f"worst {max(table.dw_f64):.3e} of max|ref| over "
          f"{len(table.dw_f64)} lines (tol {DW_F64_TOL:.0e}) ok")
    print("[time] im2col pair f32 (split TF32) over one train step of "
          "HRNetSimCSN3S and one of Res16UNet34C (device, CUDA graphs, warm "
          "L2 / plain, one call each / bound): " + ", ".join(
              f"{d} {table.ms[n]:.3f} / {table.plain_ms[n]:.3f} / "
              f"{table.bound_ms[n]:.3f} ms" for d, n in (
                  ("forward", "sparse_conv_im2col_fwd_tf32"),
                  ("backward", "sparse_conv_im2col_bwd_tf32"))))
    for name, errs in table.tf32_f64.items():
        print(f"[check] {name} float32 (split TF32) vs float64: worst "
              f"{max(errs):.3e} of max|ref| over {len(errs)} lines (tol "
              f"{TF32_F64_TOL:.0e}) ok")
    for kind, tol in (("out", K1_F64_TOL), ("dW", DW_F64_TOL)):
        errs = table.im2col_f64[kind]
        print(f"[check] im2col pair bfloat16 (tensor cores) {kind} vs "
              f"float64: worst {max(errs):.3e} of max|ref| over {len(errs)} "
              f"lines (tol {tol:.0e}) ok")
    check_probes(dev, table)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. the eval slice
    phase("4 eval slice")
    eval_slice(cls, reqs, dev, n_convs, do_profile)

    # 5. the train slice
    phase("5 train slice")
    launches = train_slice(cls, spec, reqs, dev, n_convs, n_stems,
                           do_profile)
    # f32, in the K1 form and in the im2col form (CSN_DYNG=2)
    f32_ms = {}
    for mode in (None, 2):
        launches_f32, *ms = f32_slice(cls, reqs, dev, do_profile, mode)
        f32_ms[mode] = ms
        launches = {k: n + launches_f32[k] for k, n in launches.items()}
    print(f"[f32] ms/step, eval / train (B={B}, K={K_NEIGHBORS}, f32): K1 "
          f"form {f32_ms[None][0]:.3f} / {f32_ms[None][1]:.3f}, im2col form "
          f"(CSN_DYNG=2) {f32_ms[2][0]:.3f} / {f32_ms[2][1]:.3f}")
    # bf16 at d_model 256 in heads of 128
    phase("5b train slice, heads of 128")
    eval_slice(cls, reqs, dev, n_convs, do_profile, WIDE_HEADS)
    launches_w = train_slice(cls, spec, reqs, dev, n_convs, n_stems,
                             do_profile, WIDE_HEADS)
    launches = {k: n + launches_w[k] for k, n in launches.items()}
    # f32 at d_model 256 in heads of 128
    phase("5c f32 slice, heads of 128")
    launches_w = f32_slice(cls, reqs, dev, do_profile, None, WIDE_HEADS)[0]
    launches = {k: n + launches_w[k] for k, n in launches.items()}
    f32_step_check(cls, spec, dev, "f32 heads of 128", n_head=WIDE_HEADS)
    del reqs
    torch.cuda.empty_cache()

    # 6. MID-FC, chunked attention
    phase("6 MID-FC chunked")
    launches_6 = midfc_chunked_slice(dev, do_profile)
    phase("6b MID-FC chunked, bf16")
    launches_6b = midfc_chunked_slice(dev, do_profile, "bfloat16")
    launches_6 = {k: n + launches_6b[k] for k, n in launches_6.items()}

    # 7. MID-FC, full attention through the ring, in f32 and bf16
    phase("7 MID-FC ring")
    launches_7 = midfc_ring_slice(dev, do_profile)
    phase("7b MID-FC ring, bf16")
    launches_7b = midfc_ring_slice(dev, do_profile, "bfloat16")
    launches_7 = {k: n + launches_7b[k] for k, n in launches_7.items()}
    # the ring at d_model 128 and 64: 8 heads of 128 or 64, f32 and bf16
    for part, d_model in (("7c", 128), ("7d", 64)):
        phase(f"{part} MID-FC ring, d_model {d_model}")
        for dtype in ("float32", "bfloat16"):
            launches_d = midfc_ring_slice(dev, do_profile, dtype, d_model)
            launches_7 = {k: n + launches_d[k] for k, n in launches_7.items()}

    # 8. the trainer and the eval CLI's path under CSN_DYNG=2
    phase("8 trainer")
    launches_8 = trainer_slice(dev, n_convs, do_profile)
    f32_step_check(cls, spec, dev, "trainer", mode=2)

    # 9. the other model families, the MID-FC chain, the probes
    phase("9 families, chain, probes")
    launches_9 = families_slice(dev, n_unet_convs)
    torch.cuda.empty_cache()

    # 10. the multi-device trainers, as far as one card runs them
    phase("10 multi-device")
    launches_10 = dp_of_one_slice(dev)
    torch.cuda.empty_cache()
    cp_two_ranks_slice()

    # 11. the learning check, the device-side IoU
    phase("11 learning check")
    launches_11 = learning_slice(dev)
    phase("done")

    total = {k: launches[k] + launches_6[k] + launches_7[k] + launches_8[k]
             + launches_9[k] + launches_10[k] + launches_11[k]
             for k in KERNELS}
    for name, n in total.items():
        require(n > 0, f"{name} was launched on no main path")
    rows = []
    for name, (src, rep) in KERNELS.items():
        bound_ms, bound_by = table.bound(name)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": total[name],
                     "max_abs_err": table.err[name], "ms": table.ms[name],
                     "plain_ms": table.plain_ms[name], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": table.library_ms[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

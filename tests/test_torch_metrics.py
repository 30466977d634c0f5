"""Port: the device-side batched I/U counts (`csn_tpu_torch.train.metrics`
`batch_intersection_union`, torch) and their aggregation
(`mink_metrics_from_iu`, numpy) against the JAX package's functions, on the
same seeded numpy inputs: targets with 0 (unlabeled: the prediction is
forced to 0 there) and 255 (ignored), masks, several label counts. Counts
and IoUs exactly equal, as `tests/test_metrics.py` holds the JAX pair to the
numpy per-shape path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csn_tpu.train import metrics as jM
from csn_tpu_torch.train import metrics as M

torch.set_num_threads(1)


def _inputs(seed, B, P, L):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, L, size=(B, P)).astype(np.int32)
    target[rng.random((B, P)) < 0.1] = 255   # ignored points
    pred = rng.integers(0, L, size=(B, P)).astype(np.int32)
    agree = rng.random((B, P)) < 0.4   # some correct points
    pred = np.where(agree & (target != 255), target, pred)
    mask = rng.random((B, P)) < 0.9
    mask[0] &= target[0] != 255    # shape 0 masks its ignored points
    mask[-1, P // 2:] = False      # a padded shape
    return pred, target, mask


@pytest.mark.parametrize("num_labels", [2, 4, 15, 39])
def test_batch_intersection_union_matches_jax(num_labels):
    pred, target, mask = _inputs(num_labels, 3, 500, num_labels)
    ref = [np.asarray(x) for x in jM.batch_intersection_union(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
        num_labels)]
    got = M.batch_intersection_union(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(mask), num_labels)
    for g, r in zip(got, ref):
        assert g.shape == (3, num_labels) and not g.is_floating_point()
        np.testing.assert_array_equal(g.numpy(), r)
    # an int64 prediction (argmax) and a uint8 mask count the same
    got64 = M.batch_intersection_union(
        torch.from_numpy(pred).long(), torch.from_numpy(target),
        torch.from_numpy(mask.astype(np.uint8)), num_labels)
    for g, r in zip(got64, ref):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("num_labels", [4, 15, 39])
def test_mink_metrics_from_iu_matches_jax_and_the_host_path(num_labels):
    pred, target, mask = _inputs(100 + num_labels, 4, 300, num_labels)
    inter, union = M.batch_intersection_union(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(mask), num_labels)
    got = M.mink_metrics_from_iu(inter.numpy(), union.numpy(), num_labels)
    ref = jM.mink_metrics_from_iu(inter.numpy(), union.numpy(), num_labels)
    assert got == ref
    ious = {b: M.calculate_iou(target[b][mask[b]], pred[b][mask[b]],
                               num_labels) for b in range(4)}
    assert got == (M.calculate_part_iou(ious, num_labels),
                   M.calculate_shape_iou(ious))


def test_batch_intersection_union_forces_pred_zero_on_unlabeled():
    """Hand-computed: pred at a target-0 point counts as label 0, and
    masked points count nowhere."""
    target = torch.tensor([[0, 1, 1, 2, 2, 2, 1]])
    pred = torch.tensor([[1, 1, 2, 2, 2, 0, 1]])
    mask = torch.tensor([[True] * 6 + [False]])
    inter, union = M.batch_intersection_union(pred, target, mask, 3)
    assert inter.tolist() == [[1, 1, 2]]
    assert union.tolist() == [[2, 2, 4]]

"""Port: the retrieval graph (`csn_tpu_torch.retrieval.graph`) against the
JAX package's (`csn_tpu.retrieval.graph`) on the CPU.

* `kmeans_candidate_indices` runs the port's own k-means (numpy: greedy
  k-means++ seeding, Lloyd iterations, 10 seedings, the lowest inertia
  kept) where the JAX package calls scikit-learn's `KMeans`. The two draw
  different random numbers, so they are held to each other by what does not
  depend on them: on well-separated clusters the same candidate set, and on
  overlapping data an inertia within 5 % of scikit-learn's (measured: 1.3 %
  below to 0.01 % above on the cases here).
* `retrieval_measure` on f16 descriptors: rows normalized in f16, products
  accumulated in f32, in both packages. The two normalize in f16 with their
  own rounding, so the measures agree to 2e-3 (the measure is a mean of
  cosines in [-1, 1]; f16 keeps 11 bits) and a kNN list may differ only
  where two neighbours' measures lie within that of each other.

Nothing under `csn_tpu_torch/` imports scikit-learn, which is not a
dependency of the port: `tests/test_torch_cli.py::
test_port_imports_nothing_of_the_jax_package` bans it with the JAX package.
"""

import numpy as np
import pytest
from sklearn.cluster import KMeans

from csn_tpu.retrieval import graph as j_graph
from csn_tpu_torch.retrieval import graph

MEASURE_TOL = 2e-3
INERTIA_RATIO = 1.05


def _clusters(seed, n, d, k, spread):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 5.0
    x = np.repeat(centers, n // k, axis=0) + rng.normal(size=(n, d)) * spread
    return x[rng.permutation(n)].astype(np.float32)


@pytest.mark.parametrize("seed,n,d", [(0, 40, 8), (1, 200, 32),
                                      (2, 120, 256)])
def test_kmeans_candidates_equal_sklearn_on_separated_clusters(seed, n, d):
    x = _clusters(seed, n, d, n // 10, 0.05)
    got = graph.kmeans_candidate_indices(x)
    ref = j_graph.kmeans_candidate_indices(x)
    assert got.shape == ref.shape == (n // 10,)
    np.testing.assert_array_equal(np.sort(got), np.sort(ref))
    assert len(set(got.tolist())) == n // 10   # one shape per cluster


@pytest.mark.parametrize("seed,n,d,k", [(0, 40, 8, 4), (1, 300, 16, 30),
                                        (2, 500, 256, 50)])
def test_kmeans_inertia_close_to_sklearn(seed, n, d, k):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    centers, inertia = graph.kmeans(x, k, seed=0)
    ref = KMeans(n_clusters=k, random_state=0, n_init=10).fit(x).inertia_
    assert centers.shape == (k, d)
    assert inertia <= INERTIA_RATIO * ref
    # the inertia returned is the one of the centers returned
    d2 = ((x[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    assert abs(d2.min(axis=1).sum() - inertia) <= 1e-9 * inertia


def test_kmeans_is_fixed_by_its_seed():
    x = np.random.default_rng(3).normal(size=(100, 8)).astype(np.float32)
    a = graph.kmeans_candidate_indices(x, seed=7)
    np.testing.assert_array_equal(a, graph.kmeans_candidate_indices(x, seed=7))
    assert a.shape == (10,) and a.min() >= 0 and a.max() < 100


def _f16_descriptors(seed, n, p, d):
    """Shapes drawn around a few prototypes, so the kNN lists mean
    something, with a ragged point mask."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(4, p, d))
    x = protos[rng.integers(0, 4, size=n)] + rng.normal(size=(n, p, d))
    mask = np.ones((n, p), dtype=bool)
    for i in range(n):
        mask[i, rng.integers(p // 2, p + 1):] = False
    return x.astype(np.float16), mask


@pytest.mark.parametrize("K", [1, 3])
def test_retrieval_measure_f16_matches_jax(K):
    f, m = _f16_descriptors(4, 24, 48, 32)
    got = graph.retrieval_measure(f, m, f, m, device="cpu")
    ref = np.asarray(j_graph.retrieval_measure(f, m, f, m))
    assert got.dtype == np.float32 and got.shape == ref.shape == (24, 24)
    assert np.abs(got - ref).max() <= MEASURE_TOL
    rows = graph.knn_graph_topk_rows(got, K)
    j_rows = j_graph.knn_graph_topk_rows(ref, K)
    differ = [q for q in range(24) if set(rows[q]) != set(j_rows[q])]
    # a list may differ only at a near-tie: the reference's values of the
    # two choices agree within twice the measure tolerance
    for q in differ:
        a = np.sort(ref[q, rows[q]])
        b = np.sort(ref[q, j_rows[q]])
        assert np.abs(a - b).max() <= 2 * MEASURE_TOL, q
    assert len(differ) <= 1


def test_retrieval_measure_f16_key_blocks_in_input_dtype():
    """The streamed key block is sized by the input dtype and the result
    does not depend on how the keys are blocked."""
    f, m = _f16_descriptors(5, 20, 32, 16)
    per = 32 * 16 * 2                      # one f16 key shape
    assert graph._key_block_size(f, 4, 8 * per) == 8
    one = graph.retrieval_measure(f, m, f, m, device="cpu")
    blocked = graph.retrieval_measure(f, m, f, m, device="cpu",
                                      key_bytes_budget=8 * per, key_chunk=4)
    np.testing.assert_array_equal(one, blocked)

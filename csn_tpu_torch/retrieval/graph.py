"""kNN shape-compatibility graph construction.

Counterpart of `csn_tpu/retrieval/graph.py`. The retrieval measure is the
mean-of-max cosine between the per-point SSA features of two shapes, the
same in both reference branches (`MinkowskiNet/models/hrnet.py:472-490`,
`MID-FC/csa_models.py:244-267`): normalize rows, all-pairs cosine
[P_q, P_k], max over key points, mean over query points.

`retrieval_measure` runs on the device as blocked `[bq*P, d] @ [d, c*P]`
products (plain `torch.matmul`, as the JAX package leaves them to XLA),
chunked over keys; keys stream from the host in blocks bounded by a byte
budget, so a category whose key set does not fit device memory still runs.
Masks handle per-shape padding. Its inputs and result are numpy, as in the
JAX package.

Also here, as the port's own numpy copies: random-pair initialization
(`csn_utils.py:31-43`), top-(K+1) self-excluding selection
(`csn_utils.py:90-96`, `csa_models.py:270-280`), and the KMeans candidate
pruning used for big categories (`csa_models.py:302-332`) with the port's
own k-means (numpy; the JAX package calls scikit-learn's, which is not a
dependency of the port).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def random_pairs(n_query: int, n_key: int, K: int, is_same: bool,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[Tuple[int, List[int]]]:
    """`csn_utils.py:31-43`: K distinct random neighbors per query, excluding
    self when query and key collections coincide."""
    rng = rng or np.random.default_rng()
    out = []
    for idx in range(n_query):
        indices = rng.choice(n_key, K, replace=False)
        if is_same:
            while idx in indices:
                indices = rng.choice(n_key, K, replace=False)
        out.append((idx, indices.tolist()))
    return out


def _retrieval_block(q_feats: torch.Tensor, q_mask: torch.Tensor,
                     k_feats: torch.Tensor, k_mask: torch.Tensor,
                     key_chunk: int = 8) -> torch.Tensor:
    """Mean-of-max cosine of every query shape in the block [BQ, P, d]
    against every key shape [NK, P, d]. Returns [BQ, NK] f32. As the JAX
    package's: rows normalized in the input dtype, products of the
    input-dtype values accumulated in f32 (the operands are widened one key
    chunk at a time, exactly, so the key block stays in the input dtype)."""
    qn = torch.nn.functional.normalize(q_feats, dim=-1, eps=1e-12).float()
    kn = torch.nn.functional.normalize(k_feats, dim=-1, eps=1e-12)
    denom = q_mask.sum(dim=-1).clamp(min=1)[:, None]
    cols = []
    for c0 in range(0, kn.shape[0], key_chunk):
        k_blk, km_blk = kn[c0:c0 + key_chunk], k_mask[c0:c0 + key_chunk]
        sim = torch.einsum("qpd,ckd->qcpk", qn,
                           k_blk.float())            # [BQ, C, Pq, Pk]
        sim = sim.masked_fill(~km_blk[None, :, None, :], float("-inf"))
        mx = sim.amax(dim=-1)                               # [BQ, C, Pq]
        mx = torch.where(q_mask[:, None, :], mx, torch.zeros_like(mx))
        cols.append(mx.sum(dim=-1) / denom)                 # [BQ, C]
    return torch.cat(cols, dim=1)


KEY_BYTES_BUDGET = 2 << 30   # device bytes for the resident key block


def _key_block_size(k_feats, key_chunk: int, budget: int) -> int:
    """Key shapes per streamed device block, bounded by `budget` bytes: the
    big categories' full key set does not fit device memory (the reference
    caches key features on the CPU for the same reason,
    `lib/csn_utils.py:66-83`)."""
    per = int(np.prod(k_feats.shape[1:])) * k_feats.dtype.itemsize
    blk = max(int(budget // max(per, 1)), key_chunk)
    return -(-min(blk, k_feats.shape[0]) // key_chunk) * key_chunk


@torch.no_grad()
def retrieval_measure(
    q_feats: np.ndarray, q_mask: np.ndarray,
    k_feats: np.ndarray, k_mask: np.ndarray,
    query_block: int = 4, key_chunk: int = 8,
    key_bytes_budget: int = KEY_BYTES_BUDGET,
    device="cuda",
) -> np.ndarray:
    """Full [N_q, N_k] mean-of-max cosine matrix (numpy f32), computed on
    `device` in blocks of `query_block` query shapes against key blocks of
    at most `key_bytes_budget` bytes."""
    nq, nk = q_feats.shape[0], k_feats.shape[0]
    kb = _key_block_size(k_feats, key_chunk, key_bytes_budget)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    col_blocks = []
    for ks in range(0, nk, kb):
        k_dev = put(k_feats[ks:ks + kb])
        km_dev = put(np.asarray(k_mask[ks:ks + kb], dtype=bool))
        rows = [_retrieval_block(put(q_feats[s:s + query_block]),
                                 put(np.asarray(q_mask[s:s + query_block],
                                                dtype=bool)),
                                 k_dev, km_dev, key_chunk)
                for s in range(0, nq, query_block)]
        col_blocks.append(torch.cat(rows, dim=0).cpu().numpy())
    return np.concatenate(col_blocks, axis=1)


def knn_graph_from_measure(measure: np.ndarray, K: int,
                           is_same: bool) -> List[Tuple[int, List[int]]]:
    """Top-K neighbors per query with self-exclusion via top-(K+1)
    (`csn_utils.py:90-96`)."""
    out = []
    for q in range(measure.shape[0]):
        order = np.argsort(-measure[q])
        picks = []
        for idx in order:
            if is_same and idx == q:
                continue
            picks.append(int(idx))
            if len(picks) == K:
                break
        out.append((q, picks))
    return out


def knn_graph_topk_rows(measure: np.ndarray, K: int) -> np.ndarray:
    """MID-FC style raw top-(K+1) rows *including* self
    (`csa_models.py:270-280`); the dataset skips the self entry when
    assembling neighbors (`features_data_loader.py:124-131`)."""
    idx = np.argsort(-measure, axis=1)[:, : K + 1]
    return idx


def _sq_dists(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """[n, k] squared Euclidean distances between the rows of x and c."""
    d = ((x * x).sum(1)[:, None] - 2.0 * (x @ c.T)
         + (c * c).sum(1)[None, :])
    return np.maximum(d, 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator
               ) -> np.ndarray:
    """Greedy k-means++ seeding (Arthur & Vassilvitskii 2007, with
    2 + log k candidates per center as scikit-learn draws them): each new
    center is the candidate, sampled in proportion to the squared distance
    to the nearest center so far, that lowers the potential most."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.integers(n)]
    closest = _sq_dists(x, centers[:1])[:, 0]
    for c in range(1, k):
        pot = closest.sum()
        cand = np.searchsorted(np.cumsum(closest), rng.random(trials) * pot)
        cand = np.minimum(cand, n - 1)
        d = np.minimum(closest[None, :], _sq_dists(x, x[cand]).T)
        best = int(np.argmin(d.sum(1)))
        centers[c] = x[cand[best]]
        closest = d[best]
    return centers


# scikit-learn's KMeans defaults, which the JAX package runs with
KMEANS_INIT, KMEANS_MAX_ITER, KMEANS_TOL = 10, 300, 1e-4


def kmeans(x: np.ndarray, k: int, seed: int = 0
           ) -> Tuple[np.ndarray, float]:
    """Lloyd's k-means from KMEANS_INIT k-means++ seedings of one seeded
    generator; returns the (centers [k, d], inertia) of the run with the
    lowest inertia (the sum of squared distances to the nearest center).
    A run stops when the centers move by at most KMEANS_TOL x the mean
    variance of the features (squared, summed over centers), as
    scikit-learn's `KMeans` does; an emptied cluster keeps its center. In
    float64."""
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    stop = KMEANS_TOL * float(np.mean(np.var(x, axis=0)))
    best = (None, np.inf)
    for _ in range(KMEANS_INIT):
        centers = _kmeans_pp(x, k, rng)
        for _ in range(KMEANS_MAX_ITER):
            lab = np.argmin(_sq_dists(x, centers), axis=1)
            sums = np.zeros_like(centers)
            np.add.at(sums, lab, x)
            cnt = np.bincount(lab, minlength=k)[:, None]
            new = np.where(cnt > 0, sums / np.maximum(cnt, 1), centers)
            shift = float(((new - centers) ** 2).sum())
            centers = new
            if shift <= stop:
                break
        inertia = float(_sq_dists(x, centers).min(axis=1).sum())
        if inertia < best[1]:
            best = (centers, inertia)
    return best


def kmeans_candidate_indices(global_feats: np.ndarray, n_centers: int = 0,
                             seed: int = 0) -> np.ndarray:
    """KMeans pruning for big categories (`csa_models.py:302-332`): cluster
    max-pooled SSA descriptors into N/10 centers (`kmeans`, k-means++ and
    Lloyd, 10 seedings, where the JAX package calls scikit-learn's
    `KMeans`), return the index of the shape nearest to each center."""
    n = global_feats.shape[0]
    if n_centers <= 0:
        n_centers = max(n // 10, 1)
    centers, _ = kmeans(global_feats, n_centers, seed=seed)
    d = _sq_dists(np.asarray(global_feats, dtype=np.float64), centers)
    return np.argmin(d, axis=0)

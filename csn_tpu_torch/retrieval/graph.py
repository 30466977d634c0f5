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
pruning used for big categories (`csa_models.py:302-332`).
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
    against every key shape [NK, P, d]. Returns [BQ, NK] f32."""
    qn = torch.nn.functional.normalize(q_feats.float(), dim=-1, eps=1e-12)
    kn = torch.nn.functional.normalize(k_feats.float(), dim=-1, eps=1e-12)
    denom = q_mask.sum(dim=-1).clamp(min=1)[:, None]
    cols = []
    for c0 in range(0, kn.shape[0], key_chunk):
        k_blk, km_blk = kn[c0:c0 + key_chunk], k_mask[c0:c0 + key_chunk]
        sim = torch.einsum("qpd,ckd->qcpk", qn, k_blk)  # [BQ, C, Pq, Pk]
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


def kmeans_candidate_indices(global_feats: np.ndarray, n_centers: int = 0,
                             seed: int = 0) -> np.ndarray:
    """KMeans pruning for big categories (`csa_models.py:302-332`): cluster
    max-pooled SSA descriptors into N/10 centers, return the index of the
    shape nearest to each center."""
    n = global_feats.shape[0]
    if n_centers <= 0:
        n_centers = max(n // 10, 1)
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=n_centers, random_state=seed, n_init=10)
    km.fit(global_feats)
    centers = km.cluster_centers_[:, None, :]
    d = ((centers - global_feats[None, :, :]) ** 2).sum(-1)
    return np.argmin(d, axis=-1)

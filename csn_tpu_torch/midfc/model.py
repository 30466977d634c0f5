"""MID-FC CrossShapeAt head: SSA/CSA over precomputed O-CNN HRNet features.

Counterpart of `csn_tpu/midfc/model.py` (port of `MID-FC/csa_models.py:
146-242`, the used `after_fc=True` configs `backbone_fc_{ssa,csa}_logit`,
d_model=256, d_k=d_v=256): the input is the `fc_1` 256-d per-point feature
map extracted by the O-CNN MID-FC network, padded to 10000 points by prefix
repetition.

Faithful quirk: the reference MHA runs on fixed 500-point chunks: each point
attends only to its own chunk of 500, in both SSA and CSA
(`csa_models.py:81-125`). `chunk_size=500` reproduces that block-diagonal
attention exactly (required for checkpoint-eval parity); `chunk_size=None`
gives full attention over the point set.

Compatibility (`csa_models.py:209-230`): mean-pooled SSA features ->
Linear(256, 256, with bias) q/k -> L2 normalize -> plain cosine (temperature
1) -> softmax over [self]+K, per shape.

Module attributes follow the flax names (`attention.mha.w_qs`, `logit`,
`compatibility_q`, `fc_1`, `fc_1_bn`) so `midfc/convert.py` maps the JAX
package's parameters one to one. Train mode is `self.training`; the dropout
draws come from the CPU `generator` passed to `forward`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.models.layers import MaskedBatchNorm
from csn_tpu_torch.ops.attention import MultiHeadAttention, ring_size

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ChunkedMHA(nn.Module):
    """MHA applied independently per contiguous chunk of `chunk_size` points.
    `chunk_size=None` is a single full-attention call (a ring over
    `ring_group` when the point axis is sharded)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1, chunk_size: Optional[int] = 500,
                 use_flash: Optional[bool] = None, ring_group=None):
        super().__init__()
        if chunk_size is not None and ring_group is not None:
            # ringing per-chunk blocks would attend each local chunk to the
            # union of same-index chunks on every rank: neither chunked nor
            # full attention. A ring is the chunk_size=None sharded form.
            raise ValueError(
                "ring_group requires chunk_size=None (full attention); "
                "chunked attention is block-diagonal and point shards are "
                "independent: no ring needed")
        self.chunk_size = chunk_size
        self.mha = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                      dropout=dropout, use_flash=use_flash,
                                      ring_group=ring_group)

    def forward(self, q, k, v, generator: Optional[torch.Generator] = None):
        if self.chunk_size is None:
            return self.mha(q, k, v, generator=generator)
        b, p, d = q.shape
        c = self.chunk_size
        if p % c:
            raise ValueError(f"points {p} not divisible by chunk {c}")
        n = p // c
        out = self.mha(q.reshape(b * n, c, d), k.reshape(b * n, c, d),
                       v.reshape(b * n, c, d), generator=generator)
        return out.reshape(b, p, d)


class CrossShapeAt(nn.Module):
    """`csa_models.py:146-242`. Inputs are [B, P, C] point features.

    `compute_dtype` is the activation dtype of the attention stack (the
    classifier head always computes in f32). `seq_group`, when set, is the
    `torch.distributed` process group over whose ranks the POINT axis is
    sharded in equal slices: chunked (block-diagonal) attention is then
    point-parallel as it is, full attention (`chunk_size=None`) becomes a
    ring over the group, and the mean-pooled compatibility descriptors are
    completed by an all-reduce (the mean of equal-size local means is the
    global mean). `in_channels` is the width of the backbone features when
    `after_fc=False` (928 in the reference)."""

    def __init__(self, num_classes: int, d_model: int = 256,
                 n_heads: int = 8, K: int = 0, d_k: int = 256,
                 d_v: int = 256, attention_type: str = "ssa",
                 after_fc: bool = True, chunk_size: Optional[int] = 500,
                 use_flash: Optional[bool] = None, bn_momentum: float = 0.1,
                 dropout: float = 0.1, compute_dtype: str = "float32",
                 seq_group=None, in_channels: int = 928):
        super().__init__()
        if attention_type not in ("ssa", "csa"):
            raise AttributeError(f"{attention_type} not supported")
        if not after_fc and seq_group is not None:
            raise ValueError(
                "seq_group sharding is only supported with after_fc=True "
                "(the fc_1 BatchNorm would need cross-shard statistics; "
                "every shipped MID-FC config is after_fc=True)")
        self.num_classes, self.d_model, self.K = num_classes, d_model, K
        self.attention_type, self.after_fc = attention_type, after_fc
        self.chunk_size = chunk_size
        self.compute_dtype = _DTYPES[compute_dtype]
        self.seq_group = seq_group
        # fc_1: conv1x1 (no bias) + BN + ReLU; only with after_fc=False
        # (backbone-feature input), `csa_models.py:150,191-202`
        if not after_fc:
            self.fc_1 = nn.Linear(in_channels, 256, bias=False)
            self.fc_1_bn = MaskedBatchNorm(256, momentum=bn_momentum)
        # logit: conv1x1 to the classes, xavier-uniform, no bias
        self.logit = nn.Linear(d_model, num_classes, bias=False)
        ring = seq_group if chunk_size is None else None
        self.attention = ChunkedMHA(n_heads, d_model, d_k, d_v,
                                    dropout=dropout, chunk_size=chunk_size,
                                    use_flash=use_flash, ring_group=ring)
        if attention_type == "csa":
            # the reference hard-codes 256 == d_model
            self.compatibility_q = nn.Linear(d_model, d_model, bias=True)
            self.compatibility_k = nn.Linear(d_model, d_model, bias=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's distributions: lecun-variance
        uniform for the projections, xavier-uniform for `logit`, zero
        biases, identity norms."""
        self.attention.mha.reset_parameters(generator)
        with torch.no_grad():
            s = (6.0 / (self.logit.in_features
                        + self.logit.out_features)) ** 0.5
            self.logit.weight.uniform_(-s, s, generator=generator)
            lins = []
            if self.attention_type == "csa":
                lins += [self.compatibility_q, self.compatibility_k]
            if not self.after_fc:
                lins.append(self.fc_1)
                self.fc_1_bn.reset_parameters(generator)
            for lin in lins:
                s = (3.0 / lin.in_features) ** 0.5
                lin.weight.uniform_(-s, s, generator=generator)
                if lin.bias is not None:
                    lin.bias.zero_()

    def shard_points(self, seq_group) -> None:
        """Make the module seq-aware in place (same parameters): the point
        axis of its inputs is from now on this rank's slice of the ranks of
        `seq_group` (see the class docstring)."""
        if not self.after_fc:
            raise ValueError(
                "seq_group sharding is only supported with after_fc=True")
        self.seq_group = seq_group
        if self.chunk_size is None:
            self.attention.mha.ring_group = seq_group

    def _maybe_fc(self, x):
        if self.after_fc:
            return x
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        return F.relu(self.fc_1_bn(self.fc_1(x), mask))

    def get_ssa_feats(self, x, generator: Optional[torch.Generator] = None):
        """`csa_models.py:204-207`. x: [B, P, d_model] -> [B, P, d_model],
        in `compute_dtype`."""
        x = x.to(self.compute_dtype)
        return self.attention(x, x, x, generator=generator)

    def _pool(self, ssa):
        """Mean over points; an all-reduce over `seq_group` completes the
        global mean when the point axis is sharded (equal-size shards)."""
        pooled = ssa.mean(dim=1)
        n = ring_size(self.seq_group)
        if n > 1:
            pooled = _AllReduceMean.apply(pooled, self.seq_group, n)
        return pooled

    def get_csa_feats(self, x, neighbors,
                      generator: Optional[torch.Generator] = None):
        """`csa_models.py:209-242`. neighbors: [B, K+1, P, d] with self at
        index 0 (only indices 1..K are attended). One SSA pass serves both
        the pooled compatibility descriptor and the self CSA term, as in the
        JAX package."""
        kplus1 = neighbors.shape[1]
        ssa_q = self.get_ssa_feats(x, generator)
        y_q = self._pool(ssa_q)                                   # [B, d]
        pools = [y_q]
        for k in range(1, kplus1):
            pools.append(self._pool(
                self.get_ssa_feats(neighbors[:, k], generator)))
        w = self.compatibility_q.weight.dtype
        u_q = F.normalize(self.compatibility_q(y_q.to(w)), dim=-1, eps=1e-12)
        u_k = F.normalize(self.compatibility_k(
            torch.stack(pools, dim=1).to(w)), dim=-1, eps=1e-12)
        # [B, K+1], f32: the weighted sum below promotes to f32, as in the
        # JAX package
        comp = torch.softmax(torch.einsum("bd,bkd->bk", u_q, u_k), dim=-1)

        csa = comp[:, 0, None, None] * ssa_q
        for k in range(1, kplus1):
            xk = neighbors[:, k]
            csa = csa + comp[:, k, None, None] * self.attention(
                x, xk, xk, generator=generator)
        return csa

    def forward(self, x, neighbors=None,
                generator: Optional[torch.Generator] = None):
        """x: [B, P, C_in]; returns f32 logits [B, P, num_classes]."""
        x = self._maybe_fc(x).to(self.compute_dtype)
        if self.attention_type == "ssa":
            feats = self.get_ssa_feats(x, generator)
        else:
            if neighbors is None:
                raise ValueError("csa needs the neighbor features")
            feats = self.get_csa_feats(
                x, neighbors.to(self.compute_dtype), generator)
        return self.logit(feats.float())


class _AllReduceMean(torch.autograd.Function):
    """Mean over the ranks of a group (the JAX package's `pmean`), with the
    transpose rule of `pmean` as its backward: the cotangents are averaged
    over the group too."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def get_model(attention_type: str, num_classes: int, n_heads: int,
              K: Optional[int] = None, chunk_size: Optional[int] = 500,
              use_flash: Optional[bool] = None, d_model: int = 256,
              compute_dtype: str = "float32", dropout: float = 0.1,
              seq_group=None) -> CrossShapeAt:
    """`csa_models.py:426-432` factory (after_fc=True; the reference uses
    d_k = d_v = d_model whatever n_heads, `csa_models.py:147`)."""
    if attention_type not in ("ssa", "csa"):
        raise AttributeError(f"{attention_type} not supported")
    return CrossShapeAt(
        num_classes=num_classes, d_model=d_model, d_k=d_model, d_v=d_model,
        n_heads=n_heads, K=(K or 0) if attention_type == "csa" else 0,
        attention_type=attention_type, after_fc=True, chunk_size=chunk_size,
        use_flash=use_flash, dropout=dropout, compute_dtype=compute_dtype,
        seq_group=seq_group)

"""Sparse HRNet backbone with the plain segmentation head (HRNetSeg) and
the SSA/CSA cross-shape head (HRNetSimCSN).

Counterpart of `csn_tpu/models/hrnet.py`: multi-resolution branches on the
voxel-pyramid levels, exchange chains of strided / transposed sparse convs,
final transitions up to level 0, then self-shape attention (SSA) within each
shape and, with K retrieved key shapes, cross-shape attention (CSA) mixed by
the compatibility softmax over [self]+K. The query and key batches run one
combined (K+1)*B backbone + SSA pass, as in the JAX package, so train-mode
BatchNorm statistics cover query and key shapes together.

Train mode is `self.training` (the JAX `train` flag): BatchNorm on batch
statistics and attention dropout `attn_dropout`, whose draws come from the
CPU `generator` passed to `forward`.

Module attributes follow the flax names (`stages[i][j][b]` for
`stages_i_j_b`, `exchange[i][j][k][s].conv` / `.norm` for
`exchange_i_j_k_s_0` / `_1`, ...) so `models/convert.py` maps a flax
checkpoint one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.core.pyramid import MapSpec, concat_batches
from csn_tpu_torch.models.blocks import BasicBlock
from csn_tpu_torch.models.layers import (
    Conv1x1, MaskedBatchNorm, MaskedInstanceNorm, Norm, NormType, SparseConv,
    SparseLayerNorm, global_avg_pool, relu_masked,
)
from csn_tpu_torch.ops.attention import (
    MultiHeadAttention, compatibility_softmax,
)
from csn_tpu_torch.parallel import collectives

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _ConvNorm(nn.Module):
    """One (conv, norm) step of an exchange chain or final transition."""

    def __init__(self, cin: int, cout: int, map_name: str,
                 norm_type: NormType):
        super().__init__()
        self.conv = SparseConv(cin, cout, map_name)
        self.norm = Norm(norm_type, cout)

    def forward(self, batch, x, level: int):
        mask = batch.masks[level]
        return self.norm(self.conv(batch, x, mask.shape), mask)


class HRNetBase(nn.Module):
    """Backbone (`models/hrnet.py:16-163` of the reference); its norms are
    of `norm_type`, masked BatchNorm by default."""

    NUM_STAGES = 1
    NUM_BLOCKS = 3
    INIT_DIM = 32
    FEAT_FACTOR = 1

    def __init__(self, out_channels: int, conv1_kernel_size: int = 5,
                 d_model: int = 256, n_head: int = 4, k_neighbors: int = 0,
                 compute_dtype: str = "float32", in_channels: int = 3,
                 attn_dropout: float = 0.1,
                 norm_type: NormType = NormType.BATCH_NORM):
        super().__init__()
        self.norm_type = nt = norm_type
        self.out_channels = out_channels
        self.d_model, self.n_head = d_model, n_head
        self.attn_dropout = attn_dropout
        self.k_neighbors = k_neighbors
        self.compute_dtype = _DTYPES[compute_dtype]
        S, isd = self.NUM_STAGES, self._init_stage_dims()

        self.conv0 = SparseConv(in_channels, self.INIT_DIM,
                                f"same0k{conv1_kernel_size}")
        self.norm0 = Norm(nt, self.INIT_DIM)
        self.conv1 = SparseConv(self.INIT_DIM, isd, "same0k3")
        self.norm1 = Norm(nt, isd)

        self.stages = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleList(BasicBlock(isd * 2 ** j, j, norm_type=nt)
                              for _ in range(self.NUM_BLOCKS))
                for j in range(i + 1))
            for i in range(S))

        # exchange[i][j][k]: chain moving branch j (level j) to level k
        # after stage i
        def chain(j, k):
            ch = isd * 2 ** j
            if j < k:
                return nn.ModuleList(
                    _ConvNorm(ch * 2 ** s, ch * 2 ** (s + 1),
                              f"down{j + s}k3", nt)
                    for s in range(k - j))
            return nn.ModuleList(
                _ConvNorm(ch // 2 ** s, ch // 2 ** (s + 1), f"up{j - s - 1}k3",
                          nt)
                for s in range(j - k))

        self.exchange = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleList(chain(j, k) for k in range(i + 2))
                for j in range(i + 1))
            for i in range(S - 1))

    @classmethod
    def num_levels(cls) -> int:
        return cls.NUM_STAGES

    @classmethod
    def pyramid_requirements(cls, conv1_kernel_size: int = 5
                             ) -> Tuple[MapSpec, ...]:
        S = cls.NUM_STAGES
        maps = [MapSpec("same", 0, conv1_kernel_size)]
        maps += [MapSpec("same", l, 3) for l in range(S)]
        maps += [MapSpec("down", l, 3) for l in range(S - 1)]
        maps += [MapSpec("up", l, 3) for l in range(S - 1)]
        return tuple(dict.fromkeys(maps))  # a k3 stem repeats same0k3

    @classmethod
    def _init_stage_dims(cls) -> int:
        return cls.INIT_DIM * cls.FEAT_FACTOR

    def set_bn_momentum(self, momentum: float) -> None:
        """The running-statistics momentum of every BatchNorm (`--bn_momentum`)."""
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.momentum = momentum

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init of every parameter and running statistic."""
        for m in self.modules():
            if isinstance(m, (SparseConv, Conv1x1, MaskedBatchNorm,
                              MaskedInstanceNorm, SparseLayerNorm,
                              MultiHeadAttention)):
                m.reset_parameters(generator)

    def _apply_chain(self, batch, chain, x, src_level: int, direction: int):
        """(conv, norm) steps with a ReLU before every conv but the first."""
        lvl = src_level
        for idx, step in enumerate(chain):
            if idx > 0:
                x = relu_masked(x, batch.masks[lvl])
            lvl += direction
            x = step(batch, x, lvl)
        return x

    def forward_backbone(self, batch):
        """Returns (out_init [B, L0, INIT_DIM], per-level stage outputs)."""
        S = self.NUM_STAGES
        m0 = batch.masks[0]
        x = batch.vox_feats.to(self.compute_dtype)
        out_init = relu_masked(self.norm0(self.conv0(batch, x, m0.shape), m0),
                               m0)
        out = relu_masked(
            self.norm1(self.conv1(batch, out_init, m0.shape), m0), m0)

        stage_input = [out]
        stage_output = []
        for i in range(S):
            stage_output = []
            for j in range(i + 1):
                y = stage_input[j]
                for blk in self.stages[i][j]:
                    y = blk(batch, y)
                stage_output.append(y)
            if i == S - 1:
                break
            # branch j's chains in the JAX package's order (j outer), so the
            # two run their masked ReLUs in one order
            nxt = [[] for _ in range(i + 2)]
            for j in range(i + 1):
                for k in range(i + 2):
                    nxt[k].append(stage_output[j] if j == k else
                                  self._apply_chain(
                                      batch, self.exchange[i][j][k],
                                      stage_output[j], j, 1 if j < k else -1))
            stage_input = [relu_masked(sum(ys[1:], ys[0]), batch.masks[k])
                           for k, ys in enumerate(nxt)]
        return out_init, tuple(stage_output)


class _FinalTransitions(nn.Module):
    """Upsample every lower-resolution branch to level 0 and concatenate."""

    def __init__(self, num_stages: int, init_stage_dims: int,
                 norm_type: NormType):
        super().__init__()
        self.num_stages = num_stages
        self.trans = nn.ModuleList(
            nn.ModuleList(
                _ConvNorm(init_stage_dims * 2 ** i, init_stage_dims * 2 ** i,
                          f"up{i - s - 1}k3", norm_type)
                for s in range(i))
            for i in range(1, num_stages))

    def forward(self, batch, stage_outputs, out_init):
        outs = [out_init, stage_outputs[0]]
        for i in range(1, self.num_stages):
            x, lvl = stage_outputs[i], i
            for step in self.trans[i - 1]:
                lvl -= 1
                x = relu_masked(step(batch, x, lvl), batch.masks[lvl])
            outs.append(x)
        return torch.cat(outs, dim=-1)


class HRNetSimCSN(HRNetBase):
    """SSA/CSA cross-shape head (`models/hrnet.py:296-490` of the reference).

    forward(query_batch, key_batches, return_ssa, generator):
      * return_ssa=True -> [B, L0, d_model] f32 SSA features;
      * no keys         -> SSA-only logits [B, L0, out_channels] f32;
      * K keys          -> logits from the compatibility-weighted mix of SSA
                           and the K cross attentions.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        S, isd, d = self.NUM_STAGES, self._init_stage_dims(), self.d_model
        self.final_transitions = _FinalTransitions(S, isd, self.norm_type)
        cat_ch = self.INIT_DIM + sum(isd * 2 ** i for i in range(S))
        self.fc1 = Conv1x1(cat_ch, d)
        self.fc1_norm = Norm(self.norm_type, d)
        self.mha = MultiHeadAttention(self.n_head, d, d // self.n_head,
                                      d // self.n_head, self.attn_dropout)
        self.out_head = Conv1x1(2 * d, self.out_channels, f32=True)
        if self.k_neighbors > 0:
            self.linear_q = nn.Linear(d, d, bias=False)
            self.linear_k = nn.Linear(d, d, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """HRNetBase's init, plus linear_q/k at uniform(+-sqrt(3/fan_in))
        (the variance of flax's lecun_normal)."""
        super().reset_parameters(generator)
        if self.k_neighbors > 0:
            s = (3.0 / self.d_model) ** 0.5
            with torch.no_grad():
                self.linear_q.weight.uniform_(-s, s, generator=generator)
                self.linear_k.weight.uniform_(-s, s, generator=generator)

    def _features(self, batch) -> torch.Tensor:
        """backbone + final transitions + FC to d_model."""
        out_init, stage_outputs = self.forward_backbone(batch)
        out = self.final_transitions(batch, stage_outputs, out_init)
        m0 = batch.masks[0]
        return relu_masked(self.fc1_norm(self.fc1(out), m0), m0)

    def _ssa(self, feats, mask, generator) -> torch.Tensor:
        y = self.mha(feats, feats, feats, mask, mask, generator)
        return torch.where(mask[..., None], y,
                           torch.zeros((), dtype=y.dtype, device=y.device))

    def _unit_linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, lin.weight)
        return y / torch.linalg.vector_norm(y, dim=-1,
                                            keepdim=True).clamp(min=1e-12)

    def forward(self, batch, keys: Sequence = (), return_ssa: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.training and self.attn_dropout > 0.0 and generator is None:
            raise ValueError("training with attention dropout needs a CPU "
                             "torch.Generator (forward(..., generator=))")
        K = len(keys)
        if K == 0:
            qmask = batch.masks[0]
            q_out = self._features(batch)
            q_ssa = self._ssa(q_out, qmask, generator)
            if return_ssa:
                return q_ssa.float()
            return self.out_head(torch.cat([q_out, q_ssa], dim=-1)).float()

        # ONE combined (K+1)*B backbone + SSA pass over query and keys
        B = batch.masks[0].shape[0]
        big = concat_batches([batch, *keys])
        bmask = big.masks[0]                       # [(K+1)B, L0]
        feats = self._features(big)                # [(K+1)B, L0, d]
        ssa = self._ssa(feats, bmask, generator)
        L0, d = bmask.shape[1], self.d_model
        q_out, qmask, q_ssa = feats[:B], bmask[:B], ssa[:B]
        if return_ssa:
            return q_ssa.float()

        pools = global_avg_pool(ssa, bmask).reshape(K + 1, B, d)
        return self._csa_head(q_out, qmask, q_ssa, pools.transpose(0, 1),
                              feats[B:].reshape(K * B, L0, d), bmask[B:],
                              generator)

    def cp_forward(self, batch, col_index: int, n_col: int, col_group=None,
                   generator: Optional[torch.Generator] = None):
        """Collection-parallel CSA forward (`csn_tpu/models/hrnet.py:361`):
        this rank owns ONE member of the [self]+K collection, position 0 of
        its col group the query batch and position k the k-th neighbour
        batch, and runs backbone + SSA on it alone. The cross-shape head is
        assembled with three collectives over `col_group`:

          * the pooled SSA descriptors [B, d] gathered in col order, the
            combined pass's concat order [query, key_0, ...];
          * the query's features and mask from position 0 (a masked sum);
          * the sum of the compatibility-weighted contributions: position 0
            its own SSA, a key position the cross attention of the query
            against its local K/V.

        Every rank computes both contributions and keeps its own, so that
        all ranks run one autograd graph and meet the same collectives in
        the backward pass. Train-mode BatchNorm normalises each member with
        its own statistics (the combined pass: query and keys together);
        instance or layer norms and eval mode are exact."""
        if self.k_neighbors == 0:
            raise ValueError("cp_forward needs k_neighbors > 0 (the col "
                             "group is the [self]+K collection)")
        if self.training and self.attn_dropout > 0.0 and generator is None:
            raise ValueError("training with attention dropout needs a CPU "
                             "torch.Generator (cp_forward(..., generator=))")
        is_q = col_index == 0
        mask = batch.masks[0]
        feats = self._features(batch)                 # [B, L0, d] own member
        ssa = self._ssa(feats, mask, generator)
        q_out = collectives.broadcast_from(feats, is_q, col_group)
        qmask = collectives.broadcast_from(mask.int(), is_q, col_group) > 0

        pools = collectives.all_gather(global_avg_pool(ssa, mask), col_index,
                                       n_col, col_group)   # [K+1, B, d]
        q_glob = self._unit_linear(self.linear_q, pools[0])
        k_glob = self._unit_linear(self.linear_k, pools.transpose(0, 1))
        comp = compatibility_softmax(q_glob, k_glob,
                                     float(self.d_model) ** 0.5)  # [B, K+1]

        cross = self.mha(q_out, feats, feats, mask, qmask, generator).float()
        zero = torch.zeros((), device=cross.device)
        cross = torch.where(qmask[..., None], cross, zero)
        own = torch.where(torch.tensor(is_q, device=cross.device),
                          ssa.float(), cross)
        csa = collectives.all_reduce(comp[:, col_index, None, None] * own,
                                     col_group)           # [B, L0, d] f32
        out = torch.cat([q_out, csa.to(q_out.dtype)], dim=-1)
        return self.out_head(out).float()

    def _csa_head(self, q_out, qmask, q_ssa, pools, k_out, k_mask, generator):
        """Logits from the query's features and SSA, the pooled SSA
        descriptors of [self]+K `pools` [B, K+1, d] f32, and the K key
        feature batches laid out K-major, `k_out` [K*B, L0, d] with
        `k_mask` [K*B, L0]."""
        B, L0 = qmask.shape
        d = self.d_model
        K = pools.shape[1] - 1
        # compatibility softmax over [self]+K
        q_glob = self._unit_linear(self.linear_q, pools[:, 0])
        k_glob = self._unit_linear(self.linear_k, pools)
        comp = compatibility_softmax(q_glob, k_glob, float(d) ** 0.5)

        # all K cross attentions in one batched MHA call (query replicated)
        q_rep = q_out[None].expand(K, *q_out.shape).reshape(K * B, L0, d)
        q_rep_mask = qmask[None].expand(K, *qmask.shape).reshape(K * B, L0)
        cross = self.mha(q_rep, k_out, k_out, k_mask, q_rep_mask, generator)
        cross = cross.reshape(K, B, L0, d).float()
        cross = torch.where(qmask[None, ..., None], cross,
                            torch.zeros((), device=cross.device))
        csa = comp[:, 0, None, None] * q_ssa.float() + torch.einsum(
            "bk,kbld->bld", comp[:, 1:], cross)
        out = torch.cat([q_out, csa.to(q_out.dtype)], dim=-1)
        return self.out_head(out).float()

    def cache_features(self, batch, generator=None):
        """Per-shape cache for the cached-collection CSA evaluation: (fc
        feats [B, L0, d] in the activation dtype, pooled SSA [B, d] f32),
        the two per-key quantities `forward` derives from a key batch."""
        mask = batch.masks[0]
        feats = self._features(batch)
        ssa = self._ssa(feats, mask, generator)
        return feats, global_avg_pool(ssa, mask)

    def csa_from_cache(self, batch, key_feats, key_pools, key_masks,
                       generator=None):
        """CSA forward on precomputed neighbor features: key_feats
        [B, K, L0, d], key_pools [B, K, d] f32, key_masks [B, K, L0] bool,
        per-query rows of a `cache_features` cache. Matches
        `forward(batch, keys)` in eval mode, without the K key backbone
        passes."""
        qmask = batch.masks[0]
        B, L0 = qmask.shape
        K = key_feats.shape[1]
        q_out = self._features(batch)
        q_ssa = self._ssa(q_out, qmask, generator)
        q_pool = global_avg_pool(q_ssa, qmask)
        pools = torch.cat([q_pool[:, None], key_pools.float()], dim=1)
        k_out = key_feats.to(q_out.dtype).transpose(0, 1).reshape(
            K * B, L0, self.d_model)
        k_mask = key_masks.transpose(0, 1).reshape(K * B, L0)
        return self._csa_head(q_out, qmask, q_ssa, pools, k_out, k_mask,
                              generator)


class HRNetSeg(HRNetBase):
    """Plain segmentation head: final transitions, then a 2-layer 1x1-conv
    MLP whose hidden activation `fc1` [B, L0, d_model] is returned with
    `return_fc1=True`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        S, isd = self.NUM_STAGES, self._init_stage_dims()
        self.final_transitions = _FinalTransitions(S, isd, self.norm_type)
        cat_ch = self.INIT_DIM + sum(isd * 2 ** i for i in range(S))
        self.fc1 = Conv1x1(cat_ch, self.d_model)
        self.fc1_norm = Norm(self.norm_type, self.d_model)
        self.fc2 = Conv1x1(self.d_model, self.out_channels, f32=True)

    def forward(self, batch, keys: Sequence = (), return_fc1: bool = False,
                generator: Optional[torch.Generator] = None):
        if len(keys):
            raise ValueError("HRNetSeg takes no key batches")
        out_init, stage_outputs = self.forward_backbone(batch)
        out = self.final_transitions(batch, stage_outputs, out_init)
        m0 = batch.masks[0]
        fc1 = relu_masked(self.fc1_norm(self.fc1(out), m0), m0)
        logits = self.fc2(fc1).float()
        if return_fc1:
            return logits, fc1.float()
        return logits


class HRNetSeg2S(HRNetSeg):
    FEAT_FACTOR = 2
    NUM_STAGES = 2


class HRNetSeg3S(HRNetSeg):
    FEAT_FACTOR = 2
    NUM_STAGES = 3


class HRNetSeg4S(HRNetSeg):
    FEAT_FACTOR = 2
    NUM_STAGES = 4


class HRNetSimCSN2S(HRNetSimCSN):
    FEAT_FACTOR = 4
    NUM_STAGES = 2


class HRNetSimCSN3S(HRNetSimCSN):
    FEAT_FACTOR = 2
    NUM_STAGES = 3


class HRNetSimCSN4S(HRNetSimCSN):
    FEAT_FACTOR = 2
    NUM_STAGES = 4

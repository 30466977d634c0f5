"""Self-/cross-shape attention primitives.

Counterpart of `csn_tpu/ops/attention.py`: post-norm residual multi-head
attention with no-bias q/k/v/out projections, temperature sqrt(d_k),
dropout on the attention weights and on the output projection in train
mode, a residual add and LayerNorm(eps=1e-6) in f32, over padded point sets
`[B, L, d]` with bool masks.

The attention core runs `FlashAttentionFn` (kernel K2 and its backward,
ops/flash.py) for CUDA tensors and a plain version, differentiated by
autograd, for CPU tensors: `scaled_dot_product_attention` (dense) or
`online_attention` (blocked online softmax, the plain version of the carry
kernel's chain). All drop the same attention weights for the same seed.

With the point axis sharded over the ranks of a `torch.distributed` process
group, `ring_attention` (plain) and `ring_flash_attention` (the carry kernel
and the block backward, one `autograd.Function` over the whole ring) pass
the K/V blocks around the ring and compute exact full attention over the
global key set. The dropout mask is keyed by absolute (row, column), so the
ring at any world size drops exactly the entries of the unsharded mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from csn_tpu_torch.ops.flash import (
    NEG_INF, RING_HEAD_DIMS, FlashAttentionFn, dropout_keep_mask,
    flash_block_backward, flash_carry_finalize, flash_carry_init,
    flash_forward_carry, pad_head, padded_head_dim,
)

# f32 elements of one plain score block: the plain version walks the batch
# in chunks so that [b, H, Lq, Lk] stays near 1 GiB at the main path's
# [16, 4, 5632, 5632]
_SCORE_BLOCK = 1 << 28


def scaled_dot_product_attention(
    q: torch.Tensor,                          # [B, H, Lq, Dk]
    k: torch.Tensor,                          # [B, H, Lk, Dk]
    v: torch.Tensor,                          # [B, H, Lk, Dv]
    kv_mask: Optional[torch.Tensor] = None,   # [B, Lk] bool
    temperature: Optional[float] = None,
    *,
    dropout: float = 0.0,
    seed: Optional[int] = None,
    return_lse: bool = False,
):
    """Plain masked softmax attention: scores of (q / temperature) and k in
    f32, masked keys at NEG_INF, softmax, with dropout > 0 the probabilities
    dropped by the mask of `seed` (`ops.flash.dropout_keep_mask`) and the
    kept ones scaled by 1/keep (torch's dropout(softmax(s))), probabilities
    in v's dtype times v accumulated in f32. Returns [B, H, Lq, Dv] in v's
    dtype, and with `return_lse` also the (undropped) f32 log-sum-exp rows
    [B, H, Lq]. Differentiable by autograd."""
    if temperature is None:
        temperature = float(q.shape[-1]) ** 0.5
    if dropout > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    chunk = max(1, _SCORE_BLOCK // max(1, H * Lq * Lk))
    outs, lses = [], []
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        scores = torch.matmul((q[sl] / temperature).float(),
                              k[sl].float().transpose(-1, -2))
        if kv_mask is not None:
            scores = scores.masked_fill(~kv_mask[sl, None, None, :], NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        if dropout > 0.0:
            keep = dropout_keep_mask(seed, dropout, tuple(attn.shape),
                                     attn.device, batch_offset=b0)
            attn = torch.where(keep, attn * (1.0 / (1.0 - dropout)),
                               torch.zeros((), device=attn.device))
            del keep
        outs.append(torch.matmul(attn.to(v.dtype).float(), v[sl].float())
                    .to(v.dtype))
        if return_lse:
            lses.append(torch.logsumexp(scores, dim=-1))
        del scores, attn
    out = torch.cat(outs, dim=0)
    return (out, torch.cat(lses, dim=0)) if return_lse else out


def online_block_update(carry, qt, k_b, v_b, msk_b, dropout: float = 0.0,
                        seed: Optional[int] = None, row_offset: int = 0,
                        col_offset: int = 0):
    """One online-softmax update of `carry` = (m, l, acc) over the key block
    (k_b, v_b, msk_b): the plain version of the carry kernel and the shared
    arithmetic of `online_attention` and `ring_attention`. `qt` is the
    scaled query (q / temperature) in f32. Dropout uses the flash identity
    (numerator dropped and scaled by 1/keep, denominator undropped, which is
    torch's dropout(softmax(s)) @ v), with the mask of `seed` at this
    block's place (`row_offset`, `col_offset`) in the global score matrix."""
    m_run, denom, acc = carry
    s = torch.matmul(qt, k_b.float().transpose(-1, -2))
    s = s.masked_fill(~msk_b[:, None, None, :], NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    scale = torch.exp(m_run - m_new)
    e = torch.exp(s - m_new[..., None])
    denom = denom * scale + e.sum(dim=-1)
    if dropout > 0.0:
        keep = dropout_keep_mask(seed, dropout, tuple(e.shape), e.device,
                                 row_offset=row_offset,
                                 col_offset=col_offset)
        e = torch.where(keep, e * (1.0 / (1.0 - dropout)),
                        torch.zeros((), device=e.device))
    acc = acc * scale[..., None] + torch.matmul(e, v_b.float())
    return m_new, denom, acc


def online_attention(q, k, v, kv_mask=None, temperature=None, *,
                     dropout: float = 0.0, seed: Optional[int] = None,
                     kv_block: int = 1024):
    """Blocked online-softmax attention without the [Lq, Lk] score matrix:
    `online_block_update` chained over key blocks of `kv_block`. Equal to
    `scaled_dot_product_attention` (same dropout mask for the same seed);
    differentiable by autograd. Returns [B, H, Lq, Dv] in v's dtype."""
    if temperature is None:
        temperature = float(q.shape[-1]) ** 0.5
    if dropout > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    if kv_mask is None:
        kv_mask = torch.ones((b, lk), dtype=torch.bool, device=q.device)
    qt = (q / temperature).float()
    carry = flash_carry_init(b, h, lq, v.shape[-1], q.device)
    for c0 in range(0, lk, kv_block):
        sl = slice(c0, c0 + kv_block)
        carry = online_block_update(carry, qt, k[:, :, sl], v[:, :, sl],
                                    kv_mask[:, sl], dropout, seed,
                                    col_offset=c0)
    return flash_carry_finalize(carry)[0].to(v.dtype)


# ---------------------------------------------------------------------------
# ring attention over a torch.distributed process group
# ---------------------------------------------------------------------------

def ring_size(group) -> int:
    """Ranks of the ring: 1 without a group or without torch.distributed."""
    if group is None or not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _ring_shift(tensors, group, reverse: bool = False):
    """Every rank sends `tensors` one hop forward around the ring (to rank
    + 1, or to rank - 1 with `reverse`) and returns what it receives. A ring
    of one returns its input."""
    n = ring_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    step = -1 if reverse else 1
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    send = [t.to(torch.uint8) if t.dtype == torch.bool else t
            for t in tensors]
    send = [t.contiguous() for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in send]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(torch.bool) if t.dtype == torch.bool else r
            for r, t in zip(recv, tensors)]


class _RingShiftFn(torch.autograd.Function):
    """One differentiable hop of a tensor around the ring: the backward
    sends the cotangent one hop the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_shift([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return _ring_shift([g], ctx.group, reverse=True)[0], None


def ring_attention(q, k, v, kv_mask, group, temperature=None, *,
                   dropout: float = 0.0, seed: Optional[int] = None):
    """Exact FULL attention over a point axis sharded in equal slices over
    the ranks of `group`, in plain torch: q [B, H, Lq_local, D] are this
    rank's queries, k / v / kv_mask its key shard. Each of the n steps
    updates the online-softmax state with the block currently held
    (`online_block_update`), then passes the block and its mask one hop
    around the ring; the ring makes n - 1 hops. Differentiable by autograd
    (`_RingShiftFn`). `seed` must be the same on every rank: the mask is
    that of the unsharded attention."""
    if temperature is None:
        temperature = float(q.shape[-1]) ** 0.5
    if dropout > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    n = ring_size(group)
    me = dist.get_rank(group) if n > 1 else 0
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    if kv_mask is None:
        kv_mask = torch.ones((b, lk), dtype=torch.bool, device=q.device)
    qt = (q / temperature).float()
    carry = flash_carry_init(b, h, lq, v.shape[-1], q.device)
    k_b, v_b, m_b = k, v, kv_mask
    for step in range(n):
        if step:  # receive before compute: the block of rank (me - step)
            k_b = _RingShiftFn.apply(k_b, group)
            v_b = _RingShiftFn.apply(v_b, group)
            m_b, = _ring_shift([m_b], group)
        origin = (me - step) % n
        carry = online_block_update(carry, qt, k_b, v_b, m_b, dropout, seed,
                                    row_offset=me * lq,
                                    col_offset=origin * lk)
    return flash_carry_finalize(carry)[0].to(v.dtype)


class RingFlashAttentionFn(torch.autograd.Function):
    """`ring_attention` on the carry kernel and the block backward, as one
    differentiable op over the whole ring (the custom VJP of the JAX
    package's `_ring_flash`). Forward: the K/V blocks hop around the ring,
    `flash_forward_carry` per block, one finalize; saves the global `out`
    and `lse`. Backward: the blocks ring once more; each hop runs
    `flash_block_backward` against the global (lse, delta, dout); dQ adds
    up locally in f32, and each block's (dK, dV) cotangent travels with its
    block and is home after the n-th hop. No forward recompute. A head dim
    outside `RING_HEAD_DIMS` (up to 256) is zero-padded once, here, to the
    next: the blocks travel and the carry accumulates at that width, `out`
    is cut after the finalize and the gradients after the last hop (the
    caller's temperature is the true d_k's)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, temperature: float,
                dropout: float, seed: Optional[int]):
        n = ring_size(group)
        me = dist.get_rank(group) if n > 1 else 0
        b, h, lq, d = q.shape
        lk = k.shape[2]
        width = padded_head_dim(d, RING_HEAD_DIMS)
        q, k, v = (pad_head(x.contiguous(), width) for x in (q, k, v))
        carry = flash_carry_init(b, h, lq, v.shape[-1], q.device)
        k_b, v_b, m_b = k, v, kv_mask
        for step in range(n):
            if step:
                k_b, v_b, m_b = _ring_shift([k_b, v_b, m_b], group)
            carry = flash_forward_carry(
                q, k_b, v_b, m_b, None, carry, temperature, dropout, seed,
                row_offset=me * lq, col_offset=((me - step) % n) * lk)
        out, lse = flash_carry_finalize(carry)
        out = out.to(v.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (group, temperature, dropout, seed, d)
        return out[..., :d].contiguous() if width != d else out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        group, temperature, dropout, seed, d = ctx.args
        n = ring_size(group)
        me = dist.get_rank(group) if n > 1 else 0
        lq, lk = q.shape[2], k.shape[2]
        g = pad_head(g.contiguous(), q.shape[3])
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_b, v_b, m_b = k, v, kv_mask
        for step in range(n):
            dq_c, dk_c, dv_c = flash_block_backward(
                q, k_b, v_b, m_b, out, lse, g, temperature, dropout, seed,
                row_offset=me * lq, col_offset=((me - step) % n) * lk,
                delta=delta)
            dq += dq_c
            dk_acc += dk_c.float()
            dv_acc += dv_c.float()
            # the block and its cotangent move one hop together; after n
            # hops the cotangents sit on the block's origin rank
            if step < n - 1:
                k_b, v_b, m_b, dk_acc, dv_acc = _ring_shift(
                    [k_b, v_b, m_b, dk_acc, dv_acc], group)
            else:
                dk_acc, dv_acc = _ring_shift([dk_acc, dv_acc], group)
        return (dq[..., :d].to(q.dtype), dk_acc[..., :d].to(k.dtype),
                dv_acc[..., :d].to(v.dtype), None, None, None, None, None)


def ring_flash_attention(q, k, v, kv_mask, group, temperature=None, *,
                         dropout: float = 0.0, seed: Optional[int] = None):
    """`ring_attention` with the per-block compute on the carry kernel and
    the block backward (CUDA tensors; CPU tensors take their plain
    versions): exact full attention over the sharded point axis."""
    if temperature is None:
        temperature = float(q.shape[-1]) ** 0.5
    if dropout > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool,
                             device=q.device)
    return RingFlashAttentionFn.apply(q, k, v, kv_mask, group, temperature,
                                      dropout, seed)


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from a CPU generator: a host draw, no device sync."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


class MultiHeadAttention(nn.Module):
    """Post-norm residual MHA (`MultiHeadAttention` of the JAX package).
    `nn.Linear` weights are `[out, in]`: the converter transposes the flax
    `[in, out]` kernels. Projections run in the activation dtype, the
    LayerNorm in f32; the result is cast back. Padded query rows are junk;
    callers mask them.

    The attention core is K2 for CUDA tensors. For CPU tensors it is the
    plain version `attn_impl`: 'dense', 'online' (blocks of `kv_block`
    keys), or 'auto' (dense up to `dense_max_kv` keys, online beyond).
    With `ring_group` set (a `torch.distributed` process group over which
    the POINT axis of q/k/v is sharded in equal slices; `None` or a group
    of one rank is a ring of one) the core is a ring of K/V blocks
    computing exact full attention over the global key set:
    `ring_flash_attention` (the carry kernel and the block backward) for
    CUDA tensors or with `use_flash`, the plain `ring_attention` for CPU
    tensors otherwise. `use_flash` None decides by the device, True asks
    for the kernels' wrappers, False for the plain versions (CPU only).

    In train mode with `dropout` > 0 the call needs a CPU `generator`: it
    draws one seed for the attention-weight dropout (in the kernel, or the
    plain version on the CPU) and one that seeds, on the output's device,
    the generator of the output-projection dropout. Under a ring every rank
    must draw the same attention seed (the mask is the unsharded one)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1, use_flash: Optional[bool] = None,
                 attn_impl: str = "auto", dense_max_kv: int = 1024,
                 kv_block: int = 1024, ring_group=None):
        super().__init__()
        if attn_impl not in ("auto", "dense", "online"):
            raise ValueError(f"attn_impl {attn_impl!r} not supported")
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.use_flash = use_flash
        self.attn_impl, self.dense_max_kv = attn_impl, dense_max_kv
        self.kv_block = kv_block
        self.ring_group = ring_group
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Projections at uniform(+-sqrt(3/fan_in)) (the variance of flax's
        lecun_normal), LayerNorm at identity."""
        with torch.no_grad():
            for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
                s = (3.0 / lin.in_features) ** 0.5
                lin.weight.uniform_(-s, s, generator=generator)
            self.layer_norm.reset_parameters()

    def forward(self, q, k, v, kv_mask=None, q_mask=None,
                generator: Optional[torch.Generator] = None):
        b, lq, _ = q.shape
        adt = q.dtype
        residual = q
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("MultiHeadAttention in train mode with dropout "
                             "needs a generator")

        def proj(lin, x, n, d):
            return F.linear(x, lin.weight.to(adt)).reshape(
                b, x.shape[1], n, d).transpose(1, 2)

        qh = proj(self.w_qs, q, self.n_head, self.d_k)
        kh = proj(self.w_ks, k, self.n_head, self.d_k)
        vh = proj(self.w_vs, v, self.n_head, self.d_v)
        seed = draw_seed(generator) if drop > 0.0 else None
        temp = float(self.d_k) ** 0.5
        use_flash = self.use_flash
        if use_flash is None:
            use_flash = q.is_cuda
        if not use_flash and q.is_cuda:
            raise ValueError("the plain attention versions run on the CPU "
                             "only: CUDA tensors take the kernels")
        if self.ring_group is not None:
            ring = ring_flash_attention if use_flash else ring_attention
            out = ring(qh, kh, vh, kv_mask, self.ring_group, temp,
                       dropout=drop, seed=seed)
        elif use_flash:
            out = FlashAttentionFn.apply(
                qh.contiguous(), kh.contiguous(), vh.contiguous(), kv_mask,
                q_mask, temp, drop, seed)
        else:
            impl = self.attn_impl
            if impl == "auto":
                impl = "dense" if k.shape[1] <= self.dense_max_kv \
                    else "online"
            if impl == "online":
                out = online_attention(qh, kh, vh, kv_mask, temp,
                                       dropout=drop, seed=seed,
                                       kv_block=self.kv_block)
            else:
                out = scaled_dot_product_attention(
                    qh, kh, vh, kv_mask, temp, dropout=drop, seed=seed)
        out = out.transpose(1, 2).reshape(b, lq, self.n_head * self.d_v)
        out = F.linear(out, self.fc.weight.to(adt))
        if drop > 0.0:  # output-projection dropout, plain torch
            g = torch.Generator(device=out.device)
            # a ring's ranks share the generator's stream (one attention
            # mask); their output masks, over different points, must differ
            rank = dist.get_rank(self.ring_group) \
                if ring_size(self.ring_group) > 1 else 0
            g.manual_seed((draw_seed(generator) + rank * 0x9E3779B97F4A7C15)
                          % (2 ** 62))
            keep = torch.rand(out.shape, generator=g,
                              device=out.device) < 1.0 - drop
            out = torch.where(keep, out / (1.0 - drop),
                              torch.zeros((), dtype=adt, device=out.device))
        out = out + residual
        out = F.layer_norm(out.float(), (out.shape[-1],),
                           self.layer_norm.weight, self.layer_norm.bias,
                           self.layer_norm.eps)
        return out.to(adt)


def compatibility_softmax(query_glob: torch.Tensor, keys_glob: torch.Tensor,
                          temperature: float = 1.0) -> torch.Tensor:
    """Softmax over [self]+K of the similarities of query_glob [B, D] with
    keys_glob [B, K+1, D], divided by `temperature`. Returns [B, K+1]."""
    sim = torch.einsum("bd,bkd->bk", query_glob, keys_glob) / temperature
    return torch.softmax(sim, dim=-1)

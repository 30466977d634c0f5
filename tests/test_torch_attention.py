"""Port: attention (`csn_tpu_torch.ops`) against the JAX package.

* the plain attention against JAX `scaled_dot_product_attention` with a key
  mask: max abs <= 1e-5 (f32 both sides);
* the plain attention against the Pallas `_flash_forward` run in interpret
  mode, on valid query rows, with query and key masks: max abs <= 3e-2,
  because the TPU kernel rounds q, k, v and the probabilities to bf16;
* `MultiHeadAttention` in eval against the flax module, with weights
  converted by `flax_to_torch`: max abs <= 1e-5;
* `compatibility_softmax`: max abs <= 1e-6;
* the plain attention's backward (autograd) at dropout 0 against `jax.vjp`
  of JAX `scaled_dot_product_attention`: max abs <= 1e-5, and against the
  Pallas `_flash_backward` in interpret mode with masks: max abs <= 3e-2
  (bf16 rounding inside the TPU kernel); the same in bf16 at head dims 128
  and 256, forward and backward, max abs <= 3e-2;
* dropout, which cannot be compared with the TPU's own random bits (its
  PRNG has no CPU lowering): the torch Philox4x32-10 against an independent
  pure-Python-int version and the Random123 known-answer vectors (exact),
  the keep fraction over 10^6 draws (0.9 +- 0.005), a plain version that
  does not depend on its chunking (exact), and seeds that decide the output.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csn_tpu.ops import attention as jattn
from csn_tpu.ops import flash as jflash
from csn_tpu_torch import kernels
from csn_tpu_torch.models.convert import flax_to_torch
from csn_tpu_torch.ops import attention, flash

torch.set_num_threads(1)


def _qkv(rng, b, h, lq, lk, d):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))]


def _masks(rng, b, lq, lk):
    kv = rng.random((b, lk)) > 0.3
    kv[1, lk // 2:] = False            # a shape that fills half the cap
    q = rng.random((b, lq)) > 0.2
    q[0, :80] = False                  # a fully padded 64-row query block
    return kv, q


def test_plain_attention_matches_jax_dense():
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 3, 50, 70, 16)
    kv, _ = _masks(rng, 2, 50, 70)
    ref = np.asarray(jattn.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(kv), temperature=4.0))
    got = attention.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(kv),
        temperature=4.0).numpy()
    assert np.abs(got - ref).max() <= 1e-5


def test_plain_attention_matches_pallas_flash_interpret():
    rng = np.random.default_rng(1)
    b, h, lq, lk, d = 2, 2, 300, 260, 32
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    kv, qm = _masks(rng, b, lq, lk)
    with jflash.interpret_mode():
        ref, ref_lse = jflash._flash_forward(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(kv), jnp.asarray(qm),
            float(d) ** 0.5, block_q=64, block_k=128)
    got, got_lse = attention.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(kv),
        float(d) ** 0.5, return_lse=True)
    valid = qm[:, None, :]
    err = np.abs(np.where(valid[..., None], got.numpy() - np.asarray(ref),
                          0.0)).max()
    lse_err = np.abs(np.where(valid, got_lse.numpy() - np.asarray(ref_lse),
                              0.0)).max()
    assert err <= 3e-2, err
    assert lse_err <= 3e-2, lse_err


def test_mha_eval_matches_flax_with_converted_weights():
    rng = np.random.default_rng(2)
    b, lq, lk, dm, nh = 2, 40, 56, 32, 2
    x = rng.normal(size=(b, lq, dm)).astype(np.float32)
    y = rng.normal(size=(b, lk, dm)).astype(np.float32)
    kv, qm = _masks(rng, b, lq, lk)
    fm = jattn.MultiHeadAttention(n_head=nh, d_model=dm, d_k=dm // nh,
                                  d_v=dm // nh, dropout=0.1)
    variables = fm.init(jax.random.PRNGKey(0), x, y, y, kv, qm)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # a LayerNorm away from identity, so the converter's mapping shows
    params["LayerNorm_0"]["scale"] = rng.uniform(0.5, 1.5, dm).astype(
        np.float32)
    params["LayerNorm_0"]["bias"] = rng.normal(size=dm).astype(np.float32)
    ref = np.asarray(fm.apply({"params": params}, x, y, y, kv, qm,
                              train=False))
    tm = attention.MultiHeadAttention(nh, dm, dm // nh, dm // nh)
    tm.load_state_dict(flax_to_torch(params, {}), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, y, y, kv, qm))).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert kernels.LAUNCHES["flash_attn_fwd"] == 0


def test_compatibility_softmax_matches_jax():
    rng = np.random.default_rng(3)
    qg = rng.normal(size=(4, 16)).astype(np.float32)
    kg = rng.normal(size=(4, 3, 16)).astype(np.float32)
    ref = np.asarray(jattn.compatibility_softmax(jnp.asarray(qg),
                                                 jnp.asarray(kg), 4.0))
    got = attention.compatibility_softmax(torch.from_numpy(qg),
                                          torch.from_numpy(kg), 4.0).numpy()
    assert np.abs(got - ref).max() <= 1e-6


def test_k2_launcher_refuses_cpu_tensors_and_dropout():
    """K2 takes dropout now; it still refuses CPU tensors, with dropout or
    without, and a dropout without a seed."""
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, q, q, dropout=0.1, seed=7)
    with pytest.raises(ValueError, match="seed"):
        flash.flash_attention(q, q, q, dropout=0.1)


def _py_philox(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) % 2 ** 32, (k1 + 0xBB67AE85) % 2 ** 32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) % 2 ** 32, p1 % 2 ** 32,
             ((p0 >> 32) ^ c[3] ^ k1) % 2 ** 32, p0 % 2 ** 32]
    return c


def test_philox_matches_python_ints_and_known_answers():
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((2 ** 32 - 1,) * 4, (2 ** 32 - 1,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = flash.philox4x32([torch.tensor(c) for c in ctr], key)
        assert tuple(int(x) for x in got) == want
        assert tuple(_py_philox(ctr, key)) == want
    rng = np.random.default_rng(4)
    ctrs = rng.integers(0, 2 ** 32, size=(300, 4), dtype=np.int64)
    key = (int(rng.integers(0, 2 ** 32)), int(rng.integers(0, 2 ** 32)))
    got = torch.stack(flash.philox4x32(
        [torch.from_numpy(ctrs[:, i]) for i in range(4)], key), 1).numpy()
    for row, out in zip(ctrs, got):
        assert _py_philox([int(x) for x in row], key) == out.tolist()


def test_dropout_mask_is_the_documented_function():
    seed, p = 0x123456789AB, 0.1
    mask = flash.dropout_keep_mask(seed, p, (2, 3, 5, 9), batch_offset=4)
    thresh = flash.keep_threshold(p)
    assert thresh == int(0.9 * 2 ** 32)
    for b, h, r, c in [(0, 0, 0, 0), (1, 2, 4, 8), (0, 1, 3, 5), (1, 0, 2, 7)]:
        words = _py_philox((c // 4, r, (4 + b) * 3 + h, 0),
                           (seed % 2 ** 32, seed >> 32))
        assert bool(mask[b, h, r, c]) == (words[c % 4] < thresh)


def test_dropout_keep_fraction():
    mask = flash.dropout_keep_mask(2024, 0.1, (4, 4, 250, 250))
    assert mask.numel() == 10 ** 6
    assert abs(mask.float().mean().item() - 0.9) <= 0.005


def test_plain_dropout_mask_independent_of_chunking(monkeypatch):
    rng = np.random.default_rng(6)
    q, k, v = map(torch.from_numpy, _qkv(rng, 3, 2, 40, 48, 16))
    kv = torch.from_numpy(_masks(rng, 3, 40, 48)[0])
    whole = attention.scaled_dot_product_attention(q, k, v, kv, 4.0,
                                                   dropout=0.1, seed=99)
    monkeypatch.setattr(attention, "_SCORE_BLOCK", 2 * 40 * 48)
    chunked = attention.scaled_dot_product_attention(q, k, v, kv, 4.0,
                                                     dropout=0.1, seed=99)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    undropped = attention.scaled_dot_product_attention(q, k, v, kv, 4.0)
    assert (whole - undropped).abs().max() > 1e-2


def test_dropout_seed_decides_the_output():
    rng = np.random.default_rng(7)
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 2, 30, 30, 16))
    a = attention.scaled_dot_product_attention(q, k, v, None, 4.0,
                                               dropout=0.1, seed=1)
    b = attention.scaled_dot_product_attention(q, k, v, None, 4.0,
                                               dropout=0.1, seed=1)
    c = attention.scaled_dot_product_attention(q, k, v, None, 4.0,
                                               dropout=0.1, seed=2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_plain_attention_backward_matches_jax_vjp():
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 3, 50, 70, 16)
    kv, _ = _masks(rng, 2, 50, 70)
    g = rng.normal(size=(2, 3, 50, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.scaled_dot_product_attention(
        a, b, c, jnp.asarray(kv), temperature=4.0), *map(jnp.asarray,
                                                         (q, k, v)))
    refs = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    attention.scaled_dot_product_attention(
        tq, tk, tv, torch.from_numpy(kv), 4.0).backward(torch.from_numpy(g))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), refs):
        assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_plain_attention_backward_matches_pallas_flash_interpret():
    rng = np.random.default_rng(9)
    b, h, lq, lk, d = 2, 2, 300, 260, 32
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    kv, qm = _masks(rng, b, lq, lk)
    # padded query rows carry no gradient (the model masks them)
    g = (rng.normal(size=(b, h, lq, d)) * qm[:, None, :, None]
         ).astype(np.float32)
    temp = float(d) ** 0.5
    jq, jk, jv, jkv, jqm = map(jnp.asarray, (q, k, v, kv, qm))
    with jflash.interpret_mode():
        out, lse = jflash._flash_forward(jq, jk, jv, jkv, jqm, temp,
                                         block_q=64, block_k=128)
        refs = jflash._flash_backward(jq, jk, jv, jkv, jqm, out, lse,
                                      jnp.asarray(g), temp, block_q=64,
                                      block_k=128)
    refs = [np.asarray(x) for x in refs]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    attention.scaled_dot_product_attention(
        tq, tk, tv, torch.from_numpy(kv), temp).backward(torch.from_numpy(g))
    dq_err = np.abs(np.where(qm[:, None, :, None],
                             tq.grad.numpy() - refs[0], 0.0)).max()
    assert dq_err <= 3e-2, dq_err
    for got, ref in zip((tk.grad, tv.grad), refs[1:]):
        err = np.abs(got.numpy() - ref).max()
        assert err <= 3e-2, err


@pytest.mark.parametrize("d", [128, 256])
def test_plain_bf16_attention_matches_pallas_flash_interpret_wide(d):
    """The port's plain attention in bf16 (what the card's checks hold the
    bf16 kernels at head dims 128 and 256 to) and its autograd against the
    Pallas `_flash_forward` and `_flash_backward` run in interpret mode at
    those head dims, with query and key masks, on the same bf16 values:
    out and lse on valid query rows, dq on valid rows, dk and dv, each
    within a share of its reference's max abs on those entries: 2e-2 for
    out, dq, dk and dv (the bf16 tolerance of the card's checks; measured
    below 5e-3 of max|ref| here), 1e-5 for lse, an f32 log-sum-exp of the
    same bf16 scores in both (measured about 1e-7). The TPU kernel rounds
    q, k, v and the probabilities to bf16; the port rounds q / T, the
    probabilities and its bf16 outputs."""
    rng = np.random.default_rng(20 + d)
    b, h, lq, lk = 2, 1, 150, 130
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf) for x in _qkv(rng, b, h, lq, lk, d))
    kv, qm = _masks(rng, b, lq, lk)
    g = (torch.from_numpy(rng.normal(size=(b, h, lq, d)).astype(np.float32))
         * torch.from_numpy(qm)[:, None, :, None]).to(bf)
    temp = float(d) ** 0.5
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy()) for x in (q, k, v, g))
    jkv, jqm = jnp.asarray(kv), jnp.asarray(qm)
    with jflash.interpret_mode():
        ref, ref_lse = jflash._flash_forward(jq, jk, jv, jkv, jqm, temp,
                                             block_q=64, block_k=128)
        refs = jflash._flash_backward(jq, jk, jv, jkv, jqm, ref, ref_lse, jg,
                                      temp, block_q=64, block_k=128)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got, got_lse = attention.scaled_dot_product_attention(
        *leaves, torch.from_numpy(kv), temp, return_lse=True)
    grads = torch.autograd.grad(got, leaves, g)
    valid = qm[:, None, :]
    for name, a, r, vm in (
            ("out", got, ref, valid[..., None]),
            ("lse", got_lse, ref_lse, valid),
            ("dq", grads[0], refs[0], valid[..., None]),
            ("dk", grads[1], refs[1], None), ("dv", grads[2], refs[2], None)):
        r = np.asarray(r, dtype=np.float32)
        diff = a.detach().float().numpy() - r
        if vm is not None:
            diff, r = np.where(vm, diff, 0.0), np.where(vm, r, 0.0)
        err, scale = float(np.abs(diff).max()), float(np.abs(r).max())
        tol = (1e-5 if name == "lse" else 2e-2) * scale
        assert err <= tol, f"{name} at D={d}: max abs err {err:.3e}, " \
            f"tol {tol:.3e} (max|ref| {scale:.3e})"


def test_mha_train_mode_dropout_needs_generator_and_is_deterministic():
    rng = np.random.default_rng(10)
    b, lq, dm, nh = 2, 24, 32, 2
    x = torch.from_numpy(rng.normal(size=(b, lq, dm)).astype(np.float32))
    mask = torch.from_numpy(_masks(rng, b, lq, lq)[0])
    tm = attention.MultiHeadAttention(nh, dm, dm // nh, dm // nh, 0.1)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        tm(x, x, x, mask, mask)
    y1 = tm(x, x, x, mask, mask, torch.Generator().manual_seed(5))
    y2 = tm(x, x, x, mask, mask, torch.Generator().manual_seed(5))
    y3 = tm(x, x, x, mask, mask, torch.Generator().manual_seed(6))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    tm.eval()
    assert torch.equal(tm(x, x, x, mask, mask), tm(x, x, x, mask, mask))


def test_k2_bwd_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, q, q, q, lse, lse)


@pytest.mark.parametrize("d", [16, 24, 32, 64, 96, 128, 256])
def test_k2_wrappers_take_wide_heads_and_refuse_cpu_tensors(d):
    """Head dims 1..256 (the kernels' own 16, 32, 64, 128, 256 and padded
    ones between) pass the wrappers' shape checks (forward and backward)
    and then meet the CUDA-only refusal: a CPU tensor never reaches a
    kernel, and nothing falls back."""
    q = torch.zeros(2, 2, 9, d)
    k = torch.zeros(2, 2, 11, d)
    lse = torch.zeros(2, 2, 9)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, k, k, q, lse, lse)
    with pytest.raises(ValueError, match="masks"):
        flash.flash_attention(q, k, k, torch.ones(2, 9, dtype=torch.bool))
    with pytest.raises(ValueError, match="dout"):
        flash.flash_attention_bwd(q, k, k, k, lse, lse)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(q, k, k, q, lse[..., :4], lse)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("d", [257, 512])
def test_k2_wrappers_refuse_other_head_dims(d):
    """Above 256 no kernel body is built: the wrappers refuse with the
    reason, before any device check."""
    q = torch.zeros(1, 1, 8, d)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 8),
                                  torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="q \\[B, H, Lq, D\\]"):
        flash.flash_attention(q, q, q[..., :16])


@pytest.mark.parametrize("impl", ["dense", "online", "auto"])
def test_mha_any_dk_matches_flax_dense_and_online(impl):
    """d_k = d_v = d_model per head (the MID-FC geometry, here 32 with 2
    heads) with the plain cores `attn_impl` dense and online (blocks of 16
    keys; 'auto' switches at dense_max_kv = 24 < 56 keys) against the flax
    module with the same options: max abs <= 1e-5."""
    rng = np.random.default_rng(7)
    b, lq, lk, dm, nh = 2, 40, 56, 32, 2
    x = rng.normal(size=(b, lq, dm)).astype(np.float32)
    y = rng.normal(size=(b, lk, dm)).astype(np.float32)
    kv, qm = _masks(rng, b, lq, lk)
    kw = dict(attn_impl=impl, dense_max_kv=24, kv_block=16)
    fm = jattn.MultiHeadAttention(n_head=nh, d_model=dm, d_k=dm, d_v=dm,
                                  dropout=0.1, **kw)
    variables = fm.init(jax.random.PRNGKey(0), x, y, y, kv, qm)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    ref = np.asarray(fm.apply({"params": params}, x, y, y, kv, qm,
                              train=False))
    tm = attention.MultiHeadAttention(nh, dm, dm, dm, **kw)
    tm.load_state_dict(flax_to_torch(params, {}), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, y, y, kv, qm))).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    with pytest.raises(ValueError, match="attn_impl"):
        attention.MultiHeadAttention(nh, dm, dm, dm, attn_impl="sparse")


def test_mha_use_flash_asks_for_the_kernels():
    """use_flash=True goes to the kernels' wrappers whatever the device, so
    on CPU tensors it meets K2's refusal; the default decides by device."""
    tm = attention.MultiHeadAttention(2, 16, 64, 64, use_flash=True).eval()
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tm(x, x, x)
    tm.use_flash = None
    assert tm(x, x, x).shape == (1, 8, 16)


def _parts_product(a, b, parts):
    """a @ b^T in f32 as the split bodies sum it: `parts` partial products
    over equal slices of the last dim (a warp's quarter of D), added from
    zero in slice order."""
    w = a.shape[-1] // parts
    out = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    for j in range(parts):
        sl = slice(j * w, (j + 1) * w)
        out = out + a[..., sl] @ b[..., sl].transpose(-1, -2)
    return out


def _tc_rounding(q, k, v, dout, kv_mask, temp, dropout, seed, fwd_parts=1,
                 bwd_parts=1):
    """The bf16 tensor-core kernels' arithmetic in plain torch: bf16
    operands, f32 scores times 1/temperature, f32 softmax statistics; the
    forward rounds the (dropped) unnormalized probabilities to bf16 before
    P V and divides by the f32 denominator at the end; the backward rounds
    m P / keep and dS to bf16 before dV, dK and dQ, every product
    accumulated in f32. The split bodies (D = 256 forward, D = 128 and 256
    backward) sum S, and in the backward dP, over D's quarters in one
    fixed order (`fwd_parts`, `bwd_parts` = 4; 1: one product over all of
    D). Returns (out bf16, dq, dk, dv f32)."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    s = _parts_product(qf, kf, fwd_parts) / temp
    s = s.masked_fill(~kv_mask[:, None, None, :], flash.NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    den = e.sum(dim=-1, keepdim=True)
    lse = mx + torch.log(den)
    keep = torch.ones_like(s, dtype=torch.bool)
    inv_keep = 1.0
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(s.shape))
        inv_keep = 1.0 / (1.0 - dropout)
    bf = torch.bfloat16
    num = torch.where(keep, e * inv_keep, 0.0).to(bf).float()
    out = ((num @ vf) / den).to(bf)
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    if bwd_parts != fwd_parts:
        s = _parts_product(qf, kf, bwd_parts) / temp
        s = s.masked_fill(~kv_mask[:, None, None, :], flash.NEG_INF)
    p = torch.exp(s - lse)
    dp = torch.where(keep, _parts_product(gf, vf, bwd_parts) * inv_keep, 0.0)
    ds = (p * (dp - delta)).to(bf).float()
    pd = torch.where(keep, p * inv_keep, 0.0).to(bf).float()
    dv = pd.transpose(-1, -2) @ gf
    dk = ds.transpose(-1, -2) @ qf / temp
    dq = ds @ kf / temp
    return out, dq, dk, dv


# the partial products whose f32 sums S (forward, backward) the bf16 bodies
# add up, by head dim: one product over D (`csrc/flash_tc.cuh`), or D's four
# quarters (`csrc/flash_bf16_wide_*.cuh`)
TC_PARTS = {64: (1, 1), 128: (1, 4), 256: (4, 4)}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_tensor_core_rounding_points_hold_the_bf16_tolerance(dropout, d):
    """Before the card: the rounding points of the bf16 tensor-core kernels
    (`csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`) at D = 64, 128 and
    256, with the split bodies' sums over D's quarters (`TC_PARTS`),
    emulated in plain torch, stay within chip_smoke's bf16 tolerance,
    2e-2 x max|ref|, of the plain attention and its autograd (which round
    only the normalized probabilities before P V), at a ragged shape with
    masks."""
    rng = np.random.default_rng(11)
    b, h, lq, lk = 2, 2, 100, 77
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(rng, b, h, lq, lk, d))
    kv, qm = _masks(rng, b, lq, lk)
    kv, qm = torch.from_numpy(kv), torch.from_numpy(qm)
    dout = (torch.from_numpy(rng.normal(size=(b, h, lq, d)))
            * qm[:, None, :, None]).to(torch.bfloat16)
    temp, seed = float(d) ** 0.5, 0x5EED
    out, dq, dk, dv = _tc_rounding(q, k, v, dout, kv, temp, dropout, seed,
                                   *TC_PARTS[d])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = attention.scaled_dot_product_attention(
        *leaves, kv, temp, dropout=dropout, seed=seed if dropout else None)
    refs = torch.autograd.grad(ref, leaves, dout)
    valid = qm[:, None, :, None]
    for got, want, vm in ((out, ref, valid), (dq, refs[0], valid),
                          (dk, refs[1], None), (dv, refs[2], None)):
        got, want = got.float(), want.detach().float()
        if vm is not None:
            got, want = got * vm, want * vm
        scale = want.abs().max().item()
        assert scale > 0
        assert (got - want).abs().max().item() <= 2e-2 * scale


def _tf32(x):
    """x rounded to TF32 as `cvt.rn.tf32.f32` does: to nearest, ties to
    even, 10 stored mantissa bits kept (on the int32 view: add just under
    half of the dropped 13 bits, plus the lowest kept bit, to the magnitude,
    then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(
        torch.float32)


def _tf32_trunc(x):
    """x as a TF32 operand of `mma.sync` reads it: the 13 low mantissa bits
    dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the split-TF32 kernels compute it: a = a_hi + a_lo with
    a_hi = tf32(a) (`cvt.rn`) and a_lo = a - a_hi, of which the product
    reads the top 10 mantissa bits (b the same), and a_lo b_hi + a_hi b_lo
    + a_hi b_hi accumulated in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding_known_answers():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12,
                      one + 3 * 2.0 ** -12, one + 2.0 ** -10,
                      one + 2.0 ** -11 + 2.0 ** -23, 3.0,
                      one + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    want = torch.tensor([one, one, one + 2.0 ** -10,
                         one + 2.0 ** -10, one + 2.0 ** -10, 3.0,
                         one + 2.0 ** -9],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32(-x), -want)   # ties to even, mirrored
    # the operand read of the remainder drops its low bits toward zero
    assert torch.equal(_tf32_trunc(x), torch.tensor(
        [one, one, one, one + 2.0 ** -10, one, 3.0, one + 2.0 ** -10]))
    # the split keeps ~21 bits: hi + lo is within 2^-21 relative of x
    y = torch.from_numpy(np.random.default_rng(12).normal(
        size=1000).astype(np.float32))
    hi = _tf32(y)
    lo = _tf32_trunc(y - hi)
    assert (hi != y).any()
    assert ((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all()


def _split_tf32_block_backward(q, k, v, dout, kv_mask, lse, delta, temp,
                               dropout, seed, row_offset=0, col_offset=0):
    """The f32 head-dim-256 backward passes (`csrc/flash_tf32_bwd.cuh`) on
    one key block in plain torch: every product (S = Q K^T, dP = dO V^T,
    dV, dK, dQ) as three TF32 products (`_mm3`), p = exp(S / T - lse) from
    the GLOBAL lse, the dropout mask at the block's offsets in the global
    score matrix, dS = p (m dP / keep - delta) in f32, dK and dQ times 1/T
    at the end. Over all keys at offsets 0 it is the full backward."""
    s = _mm3(q, k.transpose(-1, -2))
    s = s.masked_fill(~kv_mask[:, None, None, :], flash.NEG_INF)
    p = torch.exp(s / temp - lse[..., None])
    dp = _mm3(dout, v.transpose(-1, -2))
    pd = p
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(p.shape),
                                       row_offset=row_offset,
                                       col_offset=col_offset)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
        pd = torch.where(keep, p / (1.0 - dropout), 0.0)
    ds = p * (dp - delta[..., None])
    dv = _mm3(pd.transpose(-1, -2), dout)
    dk = _mm3(ds.transpose(-1, -2), q) / temp
    dq = _mm3(ds, k) / temp
    return dq, dk, dv


def _split_tf32_probs(q, k, v, dout, kv_mask, lse, delta, temp, dropout,
                      seed, col_offset=0):
    """m p / keep and dS of the f32 D=64 backward's passes on keys
    col_offset .. (k's rows): S = Q K^T and dP = dO V^T as three TF32
    products each, p = exp(S / T - lse), dS = p (m dP / keep - delta)."""
    s = _mm3(q, k.transpose(-1, -2))
    s = s.masked_fill(~kv_mask[:, None, None, :], flash.NEG_INF)
    p = torch.exp(s / temp - lse[..., None])
    dp = _mm3(dout, v.transpose(-1, -2))
    pd = p
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(p.shape),
                                       col_offset=col_offset)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
        pd = torch.where(keep, p / (1.0 - dropout), 0.0)
    return pd, p * (dp - delta[..., None])


def _split_tf32_d64_backward(q, k, v, dout, kv_mask, lse, delta, temp,
                             dropout, seed):
    """The f32 head-dim-64 backward passes (`csrc/flash_tf32_d64_bwd.cuh`)
    in plain torch. dkdv: over 32-query tiles, each tile's dV = (m P /
    keep)^T dO and dK = dS^T Q as three TF32 products summed from zero and
    added to the running sums in f32. dq: over 64-key tiles, S, dP and dS
    recomputed from Q, K, V, dO (no scratch), each tile's dS K summed from
    zero and added in f32. dK and dQ times 1/T at the end."""
    pd, ds = _split_tf32_probs(q, k, v, dout, kv_mask, lse, delta, temp,
                               dropout, seed)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, q.shape[2], 32):
        rows = slice(r0, r0 + 32)
        dv = dv + _mm3(pd[:, :, rows].transpose(-1, -2), dout[:, :, rows])
        dk = dk + _mm3(ds[:, :, rows].transpose(-1, -2), q[:, :, rows])
    dq = torch.zeros_like(q)
    for c0 in range(0, k.shape[2], 64):
        cols = slice(c0, c0 + 64)
        _, ds_t = _split_tf32_probs(q, k[:, :, cols], v[:, :, cols], dout,
                                    kv_mask[:, cols], lse, delta, temp,
                                    dropout, seed, col_offset=c0)
        dq = dq + _mm3(ds_t, k[:, :, cols])
    return dq / temp, dk / temp, dv


def _mm3_quarters(a, b):
    """a @ b^T over a 128-long last dim as the f32 D=128 backward's phase 1
    and 2 sum it: four warps' three TF32 products over 32 dims each, added
    in f32 in a fixed order (dims 0-31 first)."""
    return sum(_mm3(a[..., 32 * j:32 * j + 32],
                    b[..., 32 * j:32 * j + 32].transpose(-1, -2))
               for j in range(4))


def _split_tf32_d128_backward(q, k, v, dout, kv_mask, lse, delta, temp,
                              dropout, seed):
    """The f32 head-dim-128 backward passes (`csrc/flash_tf32_bwd.cuh` at
    128) in plain torch. dkdv: S = Q K^T and dP = dO V^T as the sums of
    four 32-dim quarters (`_mm3_quarters`), p = exp(S / T - lse), dS = p
    (m dP / keep - delta) in f32 (into the dS^T scratch), then over 32-query
    tiles each tile's dV = (m P / keep)^T dO and dK = dS^T Q summed from
    zero and added to the running sums in f32. dq: over 32-key tiles, each
    tile's dS K from the scratch's dS, summed from zero and added in f32.
    dK and dQ times 1/T at the end."""
    s = _mm3_quarters(q, k)
    s = s.masked_fill(~kv_mask[:, None, None, :], flash.NEG_INF)
    p = torch.exp(s / temp - lse[..., None])
    dp = _mm3_quarters(dout, v)
    pd = p
    if dropout:
        keep = flash.dropout_keep_mask(seed, dropout, tuple(p.shape))
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
        pd = torch.where(keep, p / (1.0 - dropout), 0.0)
    ds = p * (dp - delta[..., None])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, q.shape[2], 32):
        rows = slice(r0, r0 + 32)
        dv = dv + _mm3(pd[:, :, rows].transpose(-1, -2), dout[:, :, rows])
        dk = dk + _mm3(ds[:, :, rows].transpose(-1, -2), q[:, :, rows])
    dq = torch.zeros_like(q)
    for c0 in range(0, k.shape[2], 32):
        cols = slice(c0, c0 + 32)
        dq = dq + _mm3(ds[..., cols], k[:, :, cols])
    return dq / temp, dk / temp, dv


def _split_tf32_backward(q, k, v, dout, kv_mask, temp, dropout, seed):
    """The f32 backward of the split-TF32 body of q's head dim (64, 128 or
    256) over all keys, from the f32 forward's lse and delta = rowsum(dO o
    O)."""
    out, lse = attention.scaled_dot_product_attention(
        q, k, v, kv_mask, temp, dropout=dropout, seed=seed, return_lse=True)
    delta = (dout * out).sum(dim=-1)
    body = {64: _split_tf32_d64_backward, 128: _split_tf32_d128_backward,
            256: _split_tf32_block_backward}[q.shape[-1]]
    return body(q, k, v, dout, kv_mask, lse, delta, temp, dropout, seed)


# the split-TF32 bodies' cases: (b, h, Lq, Lk) by head dim, each with a fully
# masked key tile and a query tile all padding of its body's tiles (D=256
# and 128: 32 keys, 32 queries in the backward; D=64: 64 keys, 64 queries)
TF32_SHAPES = {256: (1, 2, 100, 77), 128: (1, 2, 100, 77),
               64: (1, 2, 150, 170)}
TF32_DEAD_KEYS = {256: slice(32, 64), 128: slice(32, 64), 64: slice(64, 128)}
TF32_PAD_QUERIES = {256: slice(64, 96), 128: slice(64, 96),
                    64: slice(64, 128)}


def _bwd_inputs(d):
    """f32 inputs of the split-TF32 backward cases at head dim d: q, k, v,
    the key mask, dO (zero on padding rows)."""
    rng = np.random.default_rng(13)
    b, h, lq, lk = TF32_SHAPES[d]
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    kv = rng.random((b, lk)) > 0.3
    kv[0, TF32_DEAD_KEYS[d]] = False          # a fully masked key tile
    qm = rng.random((b, lq)) > 0.2
    qm[0, TF32_PAD_QUERIES[d]] = False        # a query tile all padding
    g = (rng.normal(size=(b, h, lq, d)) * qm[:, None, :, None]
         ).astype(np.float32)
    return q, k, v, kv, g


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_split_tf32_backward_holds_the_f32_tolerance(dropout, d):
    """Before the card: the split-TF32 arithmetic of the f32 backward at
    D=256, 128 and 64 (each body's own rounding points: D=64 and 128 add
    each tile's dK, dV and dQ in f32, D=64 recomputes dS in its dQ pass,
    D=128 sums S and dP over four quarters of D), emulated,
    stays within chip_smoke's f32 tolerance, 1e-4 x max|ref|, at a ragged
    masked shape with a fully masked key tile and a query tile all padding:
    at dropout 0 of `jax.vjp` of the JAX package's dense attention (not the
    Pallas body, which rounds to bf16); at 0.1 of autograd of the port's
    plain attention (the TPU's random bits have no CPU lowering)."""
    q, k, v, kv, g = _bwd_inputs(d)
    temp, seed = float(d) ** 0.5, 0x5EED
    tq, tk, tv, tg, tkv = map(torch.from_numpy, (q, k, v, g, kv))
    got = _split_tf32_backward(tq, tk, tv, tg, tkv, temp, dropout,
                               seed if dropout else None)
    if dropout == 0.0:
        _, vjp = jax.vjp(lambda a, b_, c: jattn.scaled_dot_product_attention(
            a, b_, c, jnp.asarray(kv), temperature=temp),
            *map(jnp.asarray, (q, k, v)))
        refs = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g))]
    else:
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = attention.scaled_dot_product_attention(
            *leaves, tkv, temp, dropout=dropout, seed=seed)
        refs = torch.autograd.grad(out, leaves, tg)
    for gk, ref in zip(got, refs):
        scale = ref.abs().max().item()
        assert scale > 0
        assert (gk - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("d", [64, 128, 256])
def test_single_tf32_pass_misses_the_f32_tolerance(monkeypatch, d):
    """Why three products: the same backward (D=256's, 128's, 64's) with one
    TF32 product per product (both operands rounded once) misses 1e-4 x
    max|ref| of the float64 gradient on the inputs where the split version
    holds it."""
    rng = np.random.default_rng(13)
    b, h, lq, lk = TF32_SHAPES[d]
    q, k, v = map(torch.from_numpy, _qkv(rng, b, h, lq, lk, d))
    kv = torch.from_numpy(rng.random((b, lk)) > 0.3)
    g = torch.from_numpy(rng.normal(size=(b, h, lq, d)).astype(np.float32))
    temp = float(d) ** 0.5
    leaves = [x.double().requires_grad_(True) for x in (q, k, v)]
    s = torch.matmul(leaves[0] / temp, leaves[1].transpose(-1, -2))
    s = s.masked_fill(~kv[:, None, None, :], flash.NEG_INF)
    refs = torch.autograd.grad(torch.softmax(s, dim=-1) @ leaves[2], leaves,
                               g.double())

    def worst(got):
        return max(((a.double() - r).abs().max() / r.abs().max()).item()
                   for a, r in zip(got, refs))

    split = worst(_split_tf32_backward(q, k, v, g, kv, temp, 0.0, None))
    monkeypatch.setitem(globals(), "_mm3",
                        lambda a, b_: _tf32(a) @ _tf32(b_))
    single = worst(_split_tf32_backward(q, k, v, g, kv, temp, 0.0, None))
    assert split <= 1e-5 < 1e-4 < single


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _split_tf32_forward(q, k, v, kv_mask, temp, dropout, seed, carry=None,
                        q_mask=None, row_offset=0, col_offset=0):
    """The f32 forward of the split-TF32 body of q's head dim in plain
    torch (D=256: `csrc/flash_tf32_fwd.cuh`, 32-key tiles; D=128:
    `csrc/flash_tf32_d128_fwd.cuh`, 32-key tiles; D=64:
    `csrc/flash_tf32_d64_fwd.cuh`, 64-key tiles), over key tiles from the
    block's first key: S = Q K^T as three TF32 products (hi and lo of Q and
    K), scores in log2 units (S / T times log2 e), p = 2^(s - m) (masked
    keys 0), the undropped p into the denominator, the dropped p and V
    split again for P V, which each tile sums from zero and adds to O in
    f32 (O <- O alpha + P V).

    Without `carry` it starts from (NEG_INF, 0, 0) and returns (out, lse),
    K2's form. With `carry` = (m, l, acc) in the port's units (m natural, as
    `online_block_update` keeps it) it is the carry form: m enters as
    m log2 e, and (m ln 2, l, O) leave raw; rows whose `q_mask` is false,
    and every row when no key of the block is valid, keep the carry as it
    came in. `row_offset` / `col_offset` place the rows and keys in the
    dropout mask."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    keep = (flash.dropout_keep_mask(seed, dropout, (b, h, lq, lk),
                                    row_offset=row_offset,
                                    col_offset=col_offset)
            if dropout else None)
    if carry is None:
        m = torch.full((b, h, lq, 1), flash.NEG_INF)
        l, o = torch.zeros(b, h, lq, 1), torch.zeros(b, h, lq, d)
    else:
        m, l, o = carry[0][..., None] * LOG2E, carry[1][..., None], carry[2]
    sc = LOG2E / temp
    tile = 64 if d == 64 else 32
    for c0 in range(0, lk, tile):
        c1 = min(c0 + tile, lk)
        ok = kv_mask[:, None, None, c0:c1]
        s = _mm3(q, k[:, :, c0:c1].transpose(-1, -2)) * sc
        s = s.masked_fill(~ok, flash.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if dropout:
            p = torch.where(keep[..., c0:c1], p / (1.0 - dropout), 0.0)
        o = o * alpha + _mm3(p, v[:, :, c0:c1])
        m = m_new
    if carry is None:
        den = l.clamp(min=1e-30)
        return o / den, (m * LN2 + torch.log(den))[..., 0]
    live = kv_mask.any(dim=1)[:, None, None]       # [B, 1, 1]
    if q_mask is not None:
        live = live & q_mask[:, None, :]
    new = (m[..., 0] * LN2, l[..., 0], o)
    return tuple(torch.where(live if n.dim() == 3 else live[..., None], n, c)
                 for n, c in zip(new, carry))


def _fwd_inputs(seed=14, d=256):
    """f32 inputs at head dim d (256: the MID-FC heads; 64 and 128: the
    HRNet heads in 4 and 2): a ragged shape with a fully masked key tile of
    the body
    (TF32_DEAD_KEYS) and a 64-query tile all padding."""
    rng = np.random.default_rng(seed)
    b, h, lq, lk = TF32_SHAPES[d]
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    kv = rng.random((b, lk)) > 0.3
    kv[0, TF32_DEAD_KEYS[d]] = False
    qm = rng.random((b, lq)) > 0.2
    qm[0, 64:128] = False
    return q, k, v, kv, qm, float(d) ** 0.5


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_split_tf32_forward_holds_the_f32_tolerance(dropout, d):
    """Before the card: the rounding points of the f32 forward at D=256,
    128 and 64 (each with its own key tiles), emulated, hold chip_smoke's
    f32 tolerance, 1e-4 x max|ref| on the valid query rows: at dropout 0
    the
    output against the JAX package's dense attention (not the Pallas body,
    which rounds to bf16) and lse against the port's plain version; at 0.1
    both against the port's plain version (the TPU's random bits have no
    CPU lowering)."""
    q, k, v, kv, qm, temp = _fwd_inputs(d=d)
    tq, tk, tv, tkv = map(torch.from_numpy, (q, k, v, kv))
    seed = 0x5EED if dropout else None
    out, lse = _split_tf32_forward(tq, tk, tv, tkv, temp, dropout, seed)
    ref, ref_lse = attention.scaled_dot_product_attention(
        tq, tk, tv, tkv, temp, dropout=dropout, seed=seed, return_lse=True)
    if dropout == 0.0:
        ref = torch.from_numpy(np.array(jattn.scaled_dot_product_attention(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(kv),
            temperature=temp)))
    valid = torch.from_numpy(qm)[:, None, :]
    for got, want, vm in ((out, ref, valid[..., None]),
                          (lse, ref_lse, valid)):
        got, want = got * vm, want * vm
        scale = want.abs().max().item()
        assert scale > 0
        assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("d", [64, 128, 256])
def test_single_tf32_pass_misses_the_f32_tolerance_forward(monkeypatch, d):
    """Why three products in the forward too (D=256's, 128's, 64's): with one
    TF32 product per product the emulated output misses 1e-4 x max|ref| of
    the float64 attention on the inputs where the split version holds
    it."""
    q, k, v, kv, qm, temp = _fwd_inputs(d=d)
    tq, tk, tv, tkv = map(torch.from_numpy, (q, k, v, kv))
    s = torch.matmul(tq.double() / temp, tk.double().transpose(-1, -2))
    s = s.masked_fill(~tkv[:, None, None, :], flash.NEG_INF)
    ref = torch.softmax(s, dim=-1) @ tv.double()
    valid = torch.from_numpy(qm)[:, None, :, None]

    def worst(got):
        return ((got.double() - ref) * valid).abs().max().item() \
            / (ref * valid).abs().max().item()

    split = worst(_split_tf32_forward(tq, tk, tv, tkv, temp, 0.0, None)[0])
    monkeypatch.setitem(globals(), "_mm3",
                        lambda a, b_: _tf32(a) @ _tf32(b_))
    single = worst(_split_tf32_forward(tq, tk, tv, tkv, temp, 0.0, None)[0])
    assert split <= 1e-5 < 1e-4 < single


# the ring's uneven key blocks: they start at columns 1, 3 and 2 mod 4, so a
# Philox group straddles each block edge
RING_CUTS = (0, 25, 51, 62, 77)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_split_tf32_block_backward_holds_the_f32_tolerance(dropout):
    """Before the card: the split-TF32 backward on the ring's key blocks
    (offsets at columns 1, 3, 2 mod 4, and a slice of the query rows at a
    row offset), emulated. At dropout 0 the f32 dQ terms summed and the
    per-block dK, dV hold 1e-4 x max|ref| of `jax.vjp` of the JAX package's
    dense attention, and the JAX `flash_block_backward` (the Pallas body in
    interpret mode, which rounds q, k, v and dO to bf16) per block within
    3e-2 x max|ref|; at 0.1 every block holds 1e-4 x max|ref| of the port's
    `block_backward_plain` at the same offsets."""
    q, k, v, kv, _, temp = _fwd_inputs(seed=15)
    rng = np.random.default_rng(16)
    g = rng.normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tg, tkv = map(torch.from_numpy, (q, k, v, g, kv))
    seed = 0x5EED if dropout else None
    out, lse = attention.scaled_dot_product_attention(
        tq, tk, tv, tkv, temp, dropout=dropout, seed=seed, return_lse=True)
    delta = (tg * out).sum(dim=-1)

    def close(got, want, tol):
        # a fully masked block (keys 51-61) has dK = dV = 0 exactly
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= tol * scale

    blocks = list(zip(RING_CUTS, RING_CUTS[1:]))
    got = [_split_tf32_block_backward(
        tq, tk[:, :, c0:c1], tv[:, :, c0:c1], tg, tkv[:, c0:c1], lse, delta,
        temp, dropout, seed, col_offset=c0) for c0, c1 in blocks]
    if dropout == 0.0:
        _, vjp = jax.vjp(lambda a, b_, c: jattn.scaled_dot_product_attention(
            a, b_, c, jnp.asarray(kv), temperature=temp),
            *map(jnp.asarray, (q, k, v)))
        refs = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g))]
        close(sum(x[0] for x in got), refs[0], 1e-4)
        close(torch.cat([x[1] for x in got], 2), refs[1], 1e-4)
        close(torch.cat([x[2] for x in got], 2), refs[2], 1e-4)
        jq, jg, jout, jlse = map(jnp.asarray, (q, g, out.numpy(),
                                               lse.numpy()))
        with jflash.interpret_mode():
            for (c0, c1), mine in zip(blocks, got):
                jref = jflash.flash_block_backward(
                    jq, jnp.asarray(k[:, :, c0:c1]),
                    jnp.asarray(v[:, :, c0:c1]), jnp.asarray(kv[:, c0:c1]),
                    jout, jlse, jg, temp)
                for a, r in zip(mine, jref):
                    close(a, torch.from_numpy(np.array(r)), 3e-2)
        return
    for (c0, c1), mine in zip(blocks, got):
        want = flash.block_backward_plain(
            tq, tk[:, :, c0:c1], tv[:, :, c0:c1], tkv[:, c0:c1], lse, delta,
            tg, temp, dropout, seed, col_offset=c0)
        for a, r in zip(mine, want):
            close(a, r, 1e-4)
    # a slice of the query rows against one block, both at their offsets
    r0, (c0, c1) = 37, blocks[2]
    rows = slice(r0, None)
    mine = _split_tf32_block_backward(
        tq[:, :, rows], tk[:, :, c0:c1], tv[:, :, c0:c1], tg[:, :, rows],
        tkv[:, c0:c1], lse[:, :, rows], delta[:, :, rows], temp, dropout,
        seed, row_offset=r0, col_offset=c0)
    want = flash.block_backward_plain(
        tq[:, :, rows], tk[:, :, c0:c1], tv[:, :, c0:c1], tkv[:, c0:c1],
        lse[:, :, rows], delta[:, :, rows], tg[:, :, rows], temp, dropout,
        seed, row_offset=r0, col_offset=c0)
    for a, r in zip(mine, want):
        close(a, r, 1e-4)


def _close(got, want, tol):
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_split_tf32_carry_chain_holds_the_f32_tolerance(dropout):
    """Before the card: the carry form of the f32 D=256 forward, emulated,
    chained over the ring's uneven key blocks (starts at columns 1, 3, 2
    mod 4; one block fully masked). The final (m, l, acc) hold 1e-4 x
    max|ref| of the port's `online_block_update` chain at the same offsets;
    at dropout 0 the finalized output holds 1e-4 of the JAX package's dense
    attention, and every block's carry out holds 3e-2 of the JAX
    `flash_forward_carry` (the Pallas body in interpret mode, which rounds
    q, k, v and P to bf16) given the same carry in."""
    q, k, v, kv, _, temp = _fwd_inputs(seed=17)
    tq, tk, tv, tkv = map(torch.from_numpy, (q, k, v, kv))
    seed = 0x5EED if dropout else None
    b, h, lq, d = q.shape
    mine = plain = flash.flash_carry_init(b, h, lq, d)
    hops = []                                   # (c0, c1, carry in, out)
    for c0, c1 in zip(RING_CUTS, RING_CUTS[1:]):
        kb, vb, mb = tk[:, :, c0:c1], tv[:, :, c0:c1], tkv[:, c0:c1]
        new = _split_tf32_forward(tq, kb, vb, mb, temp, dropout, seed,
                                  carry=mine, col_offset=c0)
        hops.append((c0, c1, mine, new))
        mine = new
        plain = attention.online_block_update(plain, tq / temp, kb, vb, mb,
                                              dropout, seed, col_offset=c0)
    for a, r in zip(mine, plain):
        _close(a, r, 1e-4)
    if dropout:
        return
    ref = torch.from_numpy(np.array(jattn.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(kv), temperature=temp)))
    _close(flash.flash_carry_finalize(mine)[0], ref, 1e-4)
    with jflash.interpret_mode():
        for c0, c1, c_in, c_out in hops:
            jref = jflash.flash_forward_carry(
                jnp.asarray(q), jnp.asarray(k[:, :, c0:c1]),
                jnp.asarray(v[:, :, c0:c1]), jnp.asarray(kv[:, c0:c1]), None,
                tuple(jnp.asarray(c.numpy()) for c in c_in), temp)
            for a, r in zip(c_out, jref):
                _close(a, torch.from_numpy(np.array(r)), 3e-2)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_split_tf32_carry_passes_rows_through(dropout):
    """The carry form's pass-through, emulated, against the plain version
    (`flash_forward_carry` on CPU tensors): padding query rows scattered
    inside a live 64-row tile, a partial tile of padding, and a block with
    no valid key keep the carry bit for bit; the live rows hold 1e-4 x
    max|ref| at a block that starts at column 25 (1 mod 4)."""
    q, k, v, kv, _, temp = _fwd_inputs(seed=18)
    tq, tk, tv, tkv = map(torch.from_numpy, (q, k, v, kv))
    seed = 0x5EED if dropout else None
    b, h, lq, d = q.shape
    c_in = _split_tf32_forward(tq, tk[:, :, :25], tv[:, :, :25], tkv[:, :25],
                               temp, dropout, seed,
                               carry=flash.flash_carry_init(b, h, lq, d))
    qm = torch.ones(b, lq, dtype=torch.bool)
    qm[0, [3, 17, 40, 41, 63]] = False          # inside the live tile 0-63
    qm[0, 90:] = False
    kb, vb, mb = tk[:, :, 25:], tv[:, :, 25:], tkv[:, 25:]
    got = _split_tf32_forward(tq, kb, vb, mb, temp, dropout, seed,
                              carry=c_in, q_mask=qm, col_offset=25)
    want = flash.flash_forward_carry(tq, kb, vb, mb, qm, c_in, temp, dropout,
                                     seed, col_offset=25)
    pad = ~qm[:, None, :]
    for a, r, c in zip(got, want, c_in):
        p = pad if a.dim() == 3 else pad[..., None]
        assert torch.equal(a[p.expand_as(a)], c[p.expand_as(c)])
        assert torch.equal(r[p.expand_as(r)], c[p.expand_as(c)])
        _close(torch.where(p, 0.0, a), torch.where(p, 0.0, r), 1e-4)
    dead = torch.zeros_like(mb)
    same = _split_tf32_forward(tq, kb, vb, dead, temp, dropout, seed,
                               carry=c_in, col_offset=25)
    assert all(torch.equal(a, c) for a, c in zip(same, c_in))


def test_carry_refuses_a_misaligned_view(monkeypatch):
    """The split-TF32 carry body copies q, k and v 16 bytes at a time with
    cp.async and reads the carry's acc in 8- and 16-byte words:
    `flash_forward_carry` refuses a view of any of them that does not start
    on a 16-byte boundary before the launch (meta tensors through the
    wrapper's checks, the CUDA-device check stubbed out); an aligned call
    gets as far as the library."""
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)

    def no_library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(kernels, "library", no_library)
    b, h, lq, lk, d = 1, 2, 9, 11, 256
    meta = dict(device="meta")

    def shifted(*shape):
        n = int(np.prod(shape))
        t = torch.empty(n + 1, **meta)[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16
        return t

    q = torch.empty(b, h, lq, d, **meta)
    k = torch.empty(b, h, lk, d, **meta)
    kv = torch.ones(b, lk, dtype=torch.bool, **meta)
    carry = (torch.empty(b, h, lq, **meta), torch.empty(b, h, lq, **meta),
             torch.empty(b, h, lq, d, **meta))
    bad_acc = carry[:2] + (shifted(b, h, lq, d),)
    before = dict(kernels.LAUNCHES)
    for args in ((shifted(b, h, lq, d), k, k, carry),
                 (q, shifted(b, h, lk, d), k, carry),
                 (q, k, shifted(b, h, lk, d), carry), (q, k, k, bad_acc)):
        qq, kk, vv, cc = args
        with pytest.raises(ValueError, match="16-byte"):
            flash.flash_forward_carry(qq, kk, vv, kv, None, cc, 16.0)
    with pytest.raises(LookupError, match="reached the launch"):
        flash.flash_forward_carry(q, k, k, kv, None, carry, 16.0)
    assert kernels.LAUNCHES == before


def test_block_backward_refuses_a_misaligned_view(monkeypatch):
    """The split-TF32 passes copy q, k, v and dO 16 bytes at a time with
    cp.async: `flash_block_backward` refuses a view that does not start on
    a 16-byte boundary before the launch, as `flash_attention_bwd` does
    (meta tensors through the wrapper's checks, the CUDA-device check
    stubbed out); an aligned call gets as far as the library."""
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)

    def no_library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(kernels, "library", no_library)
    b, h, lq, lk, d = 1, 2, 9, 11, 256
    meta = dict(device="meta")
    k = torch.empty(b, h, lk, d, **meta)
    lse = torch.empty(b, h, lq, **meta)
    kv = torch.ones(b, lk, dtype=torch.bool, **meta)
    aligned = torch.empty(b, h, lq, d, **meta)
    shifted = torch.empty(b * h * lq * d + 1, **meta)[1:].view(b, h, lq, d)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(kernels.LAUNCHES)
    for q, g in ((shifted, aligned), (aligned, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            flash.flash_block_backward(q, k, k, kv, aligned, lse, g, 16.0,
                                       delta=lse)
    with pytest.raises(LookupError, match="reached the launch"):
        flash.flash_block_backward(aligned, k, k, kv, aligned, lse, aligned,
                                   16.0, delta=lse)
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# which body K2 and its backward run, by dtype and head dim
# ---------------------------------------------------------------------------

# the widths of `K2_HEAD_DIMS` whose K2 and backward run on the tensor
# cores: bf16 at every width (16-64 and the forward at 128:
# csrc/flash_tc_fwd.cuh and csrc/flash_tc_bwd.cuh over csrc/flash_tc.cuh;
# the forward at 256, the backward at 128 and 256:
# csrc/flash_bf16_wide_*.cuh), f32 in split TF32 at every width (64:
# csrc/flash_tf32_d64_*.cuh; 128 and 256: csrc/flash_tf32_*.cuh)
TENSOR_CORE_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
                         torch.float32: (64, 128, 256)}


@pytest.mark.parametrize("source", ["flash_attn.cu", "flash_attn_bwd.cu"])
def test_k2_tensor_core_bodies_match_the_dispatch(source):
    """The C launcher's dispatch: of the (dtype, width) pairs of
    `K2_HEAD_DIMS` it sends exactly those off `TENSOR_CORE_HEAD_DIMS` (none
    left) to the CUDA-core bodies (`CSN_WIDE`), f32 at 64 to the split-TF32
    D=64 body, f32 at 128 to the split-TF32 D=128 forward and to the D=256
    backward's passes at 128, and bf16 at 256 (and in the backward at 128)
    to the split bf16 bodies."""
    text = (kernels.CSRC / source).read_text()
    body = text[text.index('extern "C" int csn_flash_attn'):]
    names = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16}
    wide = {(names[t], int(d)) for t, d in
            re.findall(r"CSN_WIDE\((float|__nv_bfloat16), (\d+)\)", body)}
    assert wide == {(dt, w) for dt, widths in flash.K2_HEAD_DIMS.items()
                    for w in widths
                    if w not in TENSOR_CORE_HEAD_DIMS[dt]}
    assert "dtype == csn::kF32 && D == csn_tf32_d64::D" in body
    assert "csn_tf32_d64::launch_" in body
    split = "launch_fwd_split<256>" if source == "flash_attn.cu" \
        else "launch_bwd_split<128>"
    assert f"csn_tcw::{split}" in body
    tf32 = "csn_tf32_d128::launch_fwd" if source == "flash_attn.cu" \
        else "csn_tf32::launch_bwd_tf32<float, 128>"
    assert tf32 in body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_wide_bodies_count_in_rows_of_their_own(dtype):
    """`k2_bf16_wide`, which names the launch rows: every bf16 head dim that
    K2 runs at width 128 or 256 (65-256, zero-padded up to them) counts in
    the `"_bf16_wide"` rows, and no other (bf16 1-64, f32 at any); `k2_row`
    names each head dim's row. The other `"_bf16_wide"` rows are the
    ring's carry and block backward at 256 (`ring_row`)."""
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        want = dtype == torch.bfloat16 and d > 64
        assert flash.k2_bf16_wide(dtype, d) == want, d
        for what in ("flash_attn_fwd", "flash_attn_bwd"):
            row = flash.k2_row(what, dtype, d)
            assert row in kernels.LAUNCHES
            assert row.endswith("_bf16_wide") == want, (d, row)
            assert row.endswith("_tf32_d64") == (
                dtype == torch.float32 and d <= 64), (d, row)
    assert {k for k in kernels.LAUNCHES if k.endswith("_bf16_wide")} == {
        "flash_attn_fwd_bf16_wide", "flash_attn_bwd_bf16_wide",
        "flash_attn_carry_bf16_wide", "flash_attn_block_bwd_bf16_wide"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_d128_bodies_count_in_rows_of_their_own(dtype):
    """`k2_split_tf32_d128`, which names the launch rows: every f32 head dim
    that K2 runs at width 128 (65-128, zero-padded below 128) is on the
    split-TF32 D=128 bodies and counts in the `"_tf32_d128"` rows, and no
    other (f32 1-64 and 129-256, bf16 at any). The other `"_tf32_d128"`
    rows are the ring's carry and block backward at 128 (`ring_row`)."""
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        want = dtype == torch.float32 and 64 < d <= 128
        assert flash.k2_split_tf32_d128(dtype, d) == want, d
        for what in ("flash_attn_fwd", "flash_attn_bwd"):
            row = flash.k2_row(what, dtype, d)
            assert row in kernels.LAUNCHES
            assert row.endswith("_tf32_d128") == want, (d, row)
    assert {k for k in kernels.LAUNCHES if k.endswith("_tf32_d128")} == {
        "flash_attn_fwd_tf32_d128", "flash_attn_bwd_tf32_d128",
        "flash_attn_carry_tf32_d128", "flash_attn_block_bwd_tf32_d128"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_d64_bodies_count_in_rows_of_their_own(dtype):
    """`k2_split_tf32_d64`, which names the launch rows: every f32 head dim
    that K2 runs at width 64 (1-64, zero-padded below 64) is on the
    split-TF32 D=64 bodies, and no other (f32 65-256, bf16 at any). The
    other `"_tf32_d64"` rows are the ring's carry and block backward at 64
    (`ring_row`), whose carry and block forms those bodies hold."""
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        want = dtype == torch.float32 and d <= 64
        assert flash.k2_split_tf32_d64(dtype, d) == want, d
    assert {k for k in kernels.LAUNCHES if k.endswith("_tf32_d64")} == {
        "flash_attn_fwd_tf32_d64", "flash_attn_bwd_tf32_d64",
        "flash_attn_carry_tf32_d64", "flash_attn_block_bwd_tf32_d64"}


def test_ds_scratch_only_for_the_bodies_that_read_it():
    """The dS^T scratch (B H ceil32(Lk) ceil32(Lq) elements in q's dtype)
    is allocated for the bodies that hand dS^T from their dK/dV pass to
    their dQ pass: the f32 D=256 and D=128 backward (f32; the ring's block
    form at both too) and the bf16 D=128 and 256 backward (bf16; the block
    form likewise; at 64 the block form runs the CUDA-core body, which
    reads none).
    The f32 D=64 body recomputes dS in its dQ pass and gets none (it would
    be 8.1 GB at the HRNet SSA call), nor do bf16 D <= 64."""
    B, H, Lq, Lk = 2, 3, 70, 45
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 64),
                     (torch.bfloat16, 32)):
        q = torch.empty(B, H, Lq, d, dtype=dtype, device="meta")
        assert flash._ds_scratch(q, B, H, Lq, Lk, d) is None
        assert flash._ds_scratch(q, B, H, Lq, Lk, d, "block") is None
    for dtype, d in ((torch.float32, 256), (torch.float32, 128),
                     (torch.bfloat16, 128), (torch.bfloat16, 256)):
        q = torch.empty(B, H, Lq, d, dtype=dtype, device="meta")
        ds_t = flash._ds_scratch(q, B, H, Lq, Lk, d)
        assert ds_t.dtype == dtype and ds_t.numel() == B * H * 64 * 96
        ring = flash._ds_scratch(q, B, H, Lq, Lk, d, "block")
        assert ring.dtype == dtype and ring.numel() == B * H * 64 * 96
    # the SSA call's scratch at D=64, had the body kept it; the f32 and
    # bf16 ones at d_model 256 in 2 heads of 128
    assert 16 * 4 * 5632 * 5632 * 4 / 1e9 > 8.1
    assert 4.0 < 16 * 2 * 5632 * 5632 * 4 / 1e9 < 4.1
    assert 16 * 2 * 5632 * 5632 * 2 / 1e9 < 2.1


def _refuses_a_misaligned_view(monkeypatch, direction, d):
    """`flash_attention` (direction "fwd") or `flash_attention_bwd` ("bwd")
    on f32 meta tensors at head dim d, the CUDA-device check stubbed out:
    a q, k (or dO) view off a 16-byte boundary raises ValueError before any
    launch; an aligned call gets as far as the library."""
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)

    def no_library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(kernels, "library", no_library)
    b, h, lq, lk = 1, 2, 9, 11
    meta = dict(device="meta")
    aligned = torch.empty(b, h, lq, d, **meta)
    shifted = torch.empty(b * h * lq * d + 1, **meta)[1:].view(b, h, lq, d)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    k = torch.empty(b, h, lk, d, **meta)
    lse = torch.empty(b, h, lq, **meta)

    def call(q, kk, g):
        if direction == "fwd":
            return flash.flash_attention(q, kk, kk)
        return flash.flash_attention_bwd(q, kk, kk, g, lse, lse)

    k_shifted = torch.empty(b * h * lk * d + 1, **meta)[1:].view(b, h, lk, d)
    before = dict(kernels.LAUNCHES)
    cases = [(shifted, k, aligned), (aligned, k_shifted, aligned)]
    if direction == "bwd":
        cases.append((aligned, k, shifted))
    for q, kk, g in cases:
        with pytest.raises(ValueError, match="16-byte"):
            call(q, kk, g)
    with pytest.raises(LookupError, match="reached the launch"):
        call(aligned, k, aligned)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_f32_d64_refuses_a_misaligned_view(monkeypatch, direction):
    """The split-TF32 D=64 bodies copy q, k, v and dO 16 bytes at a time
    with cp.async: their wrappers refuse an f32 D=64 view that does not
    start on a 16-byte boundary before any launch."""
    _refuses_a_misaligned_view(monkeypatch, direction, 64)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_f32_d128_refuses_a_misaligned_view(monkeypatch, direction):
    """The split-TF32 D=128 bodies copy q, k, v and dO 16 bytes at a time
    with cp.async as well: their wrappers refuse an f32 D=128 view that
    does not start on a 16-byte boundary before any launch."""
    _refuses_a_misaligned_view(monkeypatch, direction, 128)


# ---------------------------------------------------------------------------
# head dims the kernels are not built for: zero-padded to the next width
# ---------------------------------------------------------------------------

PAD_DIMS = [8, 16, 24, 32, 40]


def _pad_widths(d):
    """Every width a kernel runs head dim d at: bf16 and f32 K2's, the
    ring's."""
    tables = list(flash.K2_HEAD_DIMS.values()) + [flash.RING_HEAD_DIMS]
    return sorted({flash.padded_head_dim(d, t) for t in tables})


@pytest.mark.parametrize("d", PAD_DIMS)
def test_padded_heads_equal_unpadded_plain_attention_and_jax(d):
    """`pad_head` to every width a kernel runs d at, the plain attention at
    that width with the true d's temperature sqrt(d), cut back: the padded
    output columns are exact zeros; the output (dropout 0 and 0.1: the mask
    is keyed by row and column, not by D) and the gradients of q, k, v
    through the padding are within 1e-6 of the unpadded plain version (only
    summation orders differ), and at dropout 0 within 1e-5 of the JAX
    package's `scaled_dot_product_attention` and its `jax.vjp`."""
    rng = np.random.default_rng(40 + d)
    q, k, v = _qkv(rng, 2, 3, 50, 70, d)
    kv, _ = _masks(rng, 2, 50, 70)
    g = torch.from_numpy(rng.normal(size=(2, 3, 50, d)).astype(np.float32))
    temp = float(d) ** 0.5
    jkv = jnp.asarray(kv)
    ref_j, vjp = jax.vjp(lambda a, b, c: jattn.scaled_dot_product_attention(
        a, b, c, jkv, temperature=temp), *map(jnp.asarray, (q, k, v)))
    refs_j = [np.asarray(x) for x in (ref_j,) + vjp(jnp.asarray(g.numpy()))]
    tkv = torch.from_numpy(kv)

    def run(width, drop):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        full = attention.scaled_dot_product_attention(
            *(flash.pad_head(x, width) for x in leaves), tkv, temp,
            dropout=drop, seed=11 if drop else None)
        assert full.shape[-1] == width
        assert torch.equal(full[..., d:], torch.zeros_like(full[..., d:]))
        out = full[..., :d]
        return [out.detach()] + list(torch.autograd.grad(out, leaves, g))

    assert _pad_widths(d)[-1] == 64
    for drop in (0.0, 0.1):
        ref = run(d, drop)
        for width in _pad_widths(d):
            for got, r in zip(run(width, drop), ref):
                assert (got - r).abs().max() <= 1e-6
            if not drop:
                for got, r in zip(run(width, drop), refs_j):
                    assert np.abs(got.numpy() - r).max() <= 1e-5


@pytest.mark.parametrize("d", PAD_DIMS)
def test_padded_heads_match_pallas_flash_interpret(d):
    """The plain attention at the width the card's bf16 K2 runs d at (d
    zero-padded, temperature sqrt(d)), cut back, against the Pallas
    `_flash_forward` and `_flash_backward` at d in interpret mode, with
    query and key masks, on valid query rows: out, lse, dq, dk, dv within
    3e-2 (the TPU kernel rounds to bf16, as in
    `test_plain_attention_matches_pallas_flash_interpret`)."""
    rng = np.random.default_rng(60 + d)
    b, h, lq, lk = 2, 2, 130, 150
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    kv, qm = _masks(rng, b, lq, lk)
    g = (rng.normal(size=(b, h, lq, d)) * qm[:, None, :, None]
         ).astype(np.float32)
    temp = float(d) ** 0.5
    jq, jk, jv, jkv, jqm = map(jnp.asarray, (q, k, v, kv, qm))
    with jflash.interpret_mode():
        out, lse = jflash._flash_forward(jq, jk, jv, jkv, jqm, temp,
                                         block_q=64, block_k=128)
        refs = jflash._flash_backward(jq, jk, jv, jkv, jqm, out, lse,
                                      jnp.asarray(g), temp, block_q=64,
                                      block_k=128)
    refs = [np.asarray(x) for x in (out, lse) + tuple(refs)]
    width = flash.padded_head_dim(d, flash.K2_HEAD_DIMS[torch.bfloat16])
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    full, got_lse = attention.scaled_dot_product_attention(
        *(flash.pad_head(x, width) for x in leaves), torch.from_numpy(kv),
        temp, return_lse=True)
    got = [full[..., :d]]
    got += [got_lse] + list(torch.autograd.grad(got[0], leaves,
                                                torch.from_numpy(g)))
    valid = qm[:, None, :]
    for nm, a, r in zip(("out", "lse", "dq", "dk", "dv"), got, refs):
        a = a.detach().numpy()
        if nm in ("out", "dq"):
            a, r = (np.where(valid[..., None], x, 0.0) for x in (a, r))
        elif nm == "lse":
            a, r = (np.where(valid, x, 0.0) for x in (a, r))
        assert np.abs(a - r).max() <= 3e-2, nm


class _PlainLibrary:
    """K2's C launchers (`csn_flash_attn_fwd`, `csn_flash_attn_bwd`) over
    CPU memory, computed by the plain version at the head dim they are
    handed, which they record: the wrappers' padding and cutting run as on
    the card."""

    def __init__(self, dropout):
        self.dropout, self.calls = dropout, []

    @staticmethod
    def _view(ptr, dtype, shape):
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = (ctypes.c_char * n).from_address(ptr)
        return torch.frombuffer(buf, dtype=dtype).view(*shape)

    def _inputs(self, code, ptrs, B, H, Lq, Lk, D):
        dt = {0: torch.float32, 1: torch.bfloat16}[code]
        q = self._view(ptrs[0], dt, (B, H, Lq, D))
        k, v = (self._view(p, dt, (B, H, Lk, D)) for p in ptrs[1:3])
        return dt, q, k, v

    def csn_flash_attn_fwd(self, code, q, k, v, kvm, qm, out, lse, B, H,
                           Lq, Lk, D, inv_temp, seed, thresh, inv_keep,
                           use_drop, stream):
        dt, qt, kt, vt = self._inputs(code, (q, k, v), B, H, Lq, Lk, D)
        self.calls.append(("fwd", dt, D))
        o, l = attention.scaled_dot_product_attention(
            qt, kt, vt, self._view(kvm, torch.bool, (B, Lk)), 1 / inv_temp,
            dropout=self.dropout if use_drop else 0.0, seed=seed,
            return_lse=True)
        self._view(out, dt, (B, H, Lq, D)).copy_(o)
        self._view(lse, torch.float32, (B, H, Lq)).copy_(l)
        return 0

    def csn_flash_attn_bwd(self, code, q, k, v, dout, lse, delta, kvm, qm,
                           dq, dk, dv, ds_t, B, H, Lq, Lk, D, inv_temp, seed,
                           thresh, inv_keep, use_drop, stream):
        dt, qt, kt, vt = self._inputs(code, (q, k, v), B, H, Lq, Lk, D)
        self.calls.append(("bwd", dt, D))
        leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
        with torch.enable_grad():   # called from autograd's backward
            o = attention.scaled_dot_product_attention(
                *leaves, self._view(kvm, torch.bool, (B, Lk)), 1 / inv_temp,
                dropout=self.dropout if use_drop else 0.0, seed=seed)
            grads = torch.autograd.grad(o, leaves,
                                        self._view(dout, dt, (B, H, Lq, D)))
        for ptr, gr, L in zip((dq, dk, dv), grads, (Lq, Lk, Lk)):
            self._view(ptr, dt, (B, H, L, D)).copy_(gr)
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PAD_DIMS)
def test_flash_fn_pads_heads_to_the_kernels_widths(monkeypatch, d, dtype):
    """`FlashAttentionFn` at head dims 8-40, its launchers stood in for by
    the plain version over the same memory (`_PlainLibrary`; the CUDA
    check stubbed out): each launcher is handed the width of
    `K2_HEAD_DIMS` for the dtype (bf16 16, 32, 64; f32 64), once forward
    and once backward, the launch counts rise by one each (f32: in the
    rows of the D=64 split-TF32 bodies, `"_tf32_d64"`), and the output
    and the gradients, cut back to d, equal the unpadded plain version at
    temperature sqrt(d) and dropout 0.1 (f32 within 1e-5; bf16 within
    2e-2 x max|ref|, as the card's checks)."""
    lib = _PlainLibrary(0.1)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    rng = np.random.default_rng(80 + d)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(rng, 2, 2, 40, 56, d))
    kv = torch.from_numpy(_masks(rng, 2, 40, 56)[0])
    g = torch.from_numpy(rng.normal(size=(2, 2, 40, d)).astype(np.float32)
                         ).to(dtype)
    temp = float(d) ** 0.5

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, g))

    got = run(lambda a, b, c: flash.FlashAttentionFn.apply(
        a, b, c, kv, None, temp, 0.1, 7))
    ref = run(lambda a, b, c: attention.scaled_dot_product_attention(
        a, b, c, kv, temp, dropout=0.1, seed=7))
    width = flash.padded_head_dim(d, flash.K2_HEAD_DIMS[dtype])
    assert lib.calls == [("fwd", dtype, width), ("bwd", dtype, width)]
    row = "_tf32_d64" if dtype == torch.float32 else ""
    assert kernels.LAUNCHES["flash_attn_fwd" + row] == 1
    assert kernels.LAUNCHES["flash_attn_bwd" + row] == 1
    assert sum(kernels.LAUNCHES.values()) == 2
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == dtype
        err = (a.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * scale)


@pytest.mark.parametrize("d", [65, 96, 128, 200, 256])
def test_flash_fn_counts_wide_bf16_heads_in_their_rows(monkeypatch, d):
    """`FlashAttentionFn` at bf16 head dims 65-256, its launchers stood in
    for by the plain version (`_PlainLibrary`): each launcher is handed
    width 128 or 256, the launches count once forward and once backward in
    the `"_bf16_wide"` rows and nowhere else, and the output and gradients,
    cut back to d, equal the unpadded plain version within 2e-2 x
    max|ref| (the card's bf16 tolerance) at dropout 0.1."""
    lib = _PlainLibrary(0.1)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    rng = np.random.default_rng(90 + d)
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(x).to(bf) for x in _qkv(rng, 2, 1, 40, 56, d))
    kv = torch.from_numpy(_masks(rng, 2, 40, 56)[0])
    g = torch.from_numpy(rng.normal(size=(2, 1, 40, d)).astype(np.float32)
                         ).to(bf)
    temp = float(d) ** 0.5

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, g))

    got = run(lambda a, b, c: flash.FlashAttentionFn.apply(
        a, b, c, kv, None, temp, 0.1, 7))
    ref = run(lambda a, b, c: attention.scaled_dot_product_attention(
        a, b, c, kv, temp, dropout=0.1, seed=7))
    width = 128 if d <= 128 else 256
    assert lib.calls == [("fwd", bf, width), ("bwd", bf, width)]
    assert kernels.LAUNCHES["flash_attn_fwd_bf16_wide"] == 1
    assert kernels.LAUNCHES["flash_attn_bwd_bf16_wide"] == 1
    assert sum(kernels.LAUNCHES.values()) == 2
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == bf
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item()

"""Port: attention (`csn_tpu_torch.ops`) against the JAX package.

* the plain attention against JAX `scaled_dot_product_attention` with a key
  mask: max abs <= 1e-5 (f32 both sides);
* the plain attention against the Pallas `_flash_forward` run in interpret
  mode, on valid query rows, with query and key masks: max abs <= 3e-2,
  because the TPU kernel rounds q, k, v and the probabilities to bf16;
* `MultiHeadAttention` in eval against the flax module, with weights
  converted by `flax_to_torch`: max abs <= 1e-5;
* `compatibility_softmax`: max abs <= 1e-6.
"""

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
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="dropout"):
        flash.flash_attention(q, q, q, dropout=0.1)

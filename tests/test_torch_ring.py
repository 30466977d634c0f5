"""Port: the ring's per-block attention (`flash_forward_carry`,
`flash_block_backward`: on the CPU their plain versions), `ring_attention`
and `ring_flash_attention` over a 4-rank `gloo` group, and the
`parallel/midfc.py` steps over ('data', 'seq') grids, against the unsharded
port and against the JAX package (its online ring, and its Pallas carry
kernel in interpret mode on the 4-device virtual CPU mesh).

The ranks are separate processes (one thread each, started together, with
their own time limit); every rank writes what it computed to a file and the
test compares. Tolerances: f32 against f32 <= 1e-5 abs (values of order 1);
against the Pallas kernels in interpret mode, which take bf16 operands,
2e-2; sharded against single-process gradients <= 1e-4·max|ref| + 1e-6.
In bf16 at head dims 256, 128 and 64 (the ring's `_bf16_wide` and
`_bf16_d64` rows on the card): the carry chain against the Pallas carry
<= 3e-2·max|ref|, and one MID-FC full-attention train step through a ring
of one against the JAX step, loss <= 2e-3 relative and every gradient
<= 2e-2·max|ref|. In f32 at head dims 128 and 64 (the `_tf32_d128` and
`_tf32_d64` rows): the carry chain over uneven cuts against the dense
attention and the block backwards summed against its full backward
<= 1e-4·max|ref|, and the train step at d_model 128 and 64 against the JAX
step, loss <= 1e-5 relative and every gradient <= 1e-4·max|ref|.
The wrappers' launch rows, the dS^T scratch, the C dispatch and their
refusals are pinned without a card.
"""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as PS

from csn_tpu.midfc.training import MidfcConfig as JMidfcConfig
from csn_tpu.midfc.training import MidfcRunner as JMidfcRunner
from csn_tpu.ops import attention as j_attention
from csn_tpu.ops import flash as j_flash
from csn_tpu.parallel.midfc import make_midfc_mesh
from csn_tpu_torch import kernels
from csn_tpu_torch.midfc.convert import flax_to_torch_midfc
from csn_tpu_torch.midfc.training import MidfcConfig, MidfcRunner
from csn_tpu_torch.ops import attention, flash
from csn_tpu_torch.parallel.midfc import make_midfc_steps

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240
B, H, L, DK = 2, 3, 64, 8
SEED, DROP = 77, 0.1


def _inputs(seed=3, l=L):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, l, DK)).astype(np.float32)
                  for _ in range(4))
    mask = rng.random((B, l)) > 0.3
    mask[:, :8] = True  # at least one valid key per shard
    return q, k, v, g, mask


def _dense(q, k, v, g, mask, drop):
    """Unsharded plain attention: (out, dq, dk, dv)."""
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = attention.scaled_dot_product_attention(
        *leaves, torch.tensor(mask), dropout=drop,
        seed=SEED if drop else None)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def _chain(q, k, v, mask, cuts, drop, q_mask=None):
    temp = DK ** 0.5
    carry = flash.flash_carry_init(B, H, q.shape[2], DK)
    for a, b in zip(cuts[:-1], cuts[1:]):
        carry = flash.flash_forward_carry(
            q, k[:, :, a:b], v[:, :, a:b], mask[:, a:b], q_mask, carry, temp,
            drop, SEED if drop else None, col_offset=a)
    return carry


@pytest.mark.parametrize("drop", [0.0, DROP])
@pytest.mark.parametrize("cuts", [(0, 16, 32, 48, 64), (0, 13, 27, 50, 64)])
def test_carry_chain_equals_dense(cuts, drop):
    """4 blocks, aligned and not (a block may start at a column that is no
    multiple of the generator's group of 4): same values, same mask."""
    q, k, v, g, mask = _inputs()
    tq, tk, tv, tm = map(torch.tensor, (q, k, v, mask))
    out, lse = flash.flash_carry_finalize(_chain(tq, tk, tv, tm, cuts, drop))
    ref, ref_lse = attention.scaled_dot_product_attention(
        tq, tk, tv, tm, dropout=drop, seed=SEED if drop else None,
        return_lse=True)
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    online = attention.online_attention(tq, tk, tv, tm, dropout=drop,
                                        seed=SEED if drop else None,
                                        kv_block=16)
    assert float((online - ref).abs().max()) <= 1e-5


def test_carry_chain_equals_jax_online_and_pallas_carry():
    q, k, v, g, mask = _inputs()
    tq, tk, tv, tm = map(torch.tensor, (q, k, v, mask))
    cuts = (0, 16, 32, 48, 64)
    out, lse = flash.flash_carry_finalize(_chain(tq, tk, tv, tm, cuts, 0.0))
    ref = np.asarray(j_attention.online_attention(
        *map(jnp.asarray, (q, k, v, mask)), kv_block=16))
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    temp = DK ** 0.5
    carry = j_flash.flash_carry_init(B, H, L, DK)
    with j_flash.interpret_mode():
        for a, b in zip(cuts[:-1], cuts[1:]):
            carry = j_flash.flash_forward_carry(
                jnp.asarray(q), jnp.asarray(k[:, :, a:b]),
                jnp.asarray(v[:, :, a:b]), jnp.asarray(mask[:, a:b]), None,
                carry, temp)
    j_out, j_lse = map(np.asarray, j_flash.flash_carry_finalize(carry))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=2e-2, atol=2e-2)


def test_carry_passes_through_masked_blocks_and_padding_rows():
    q, k, v, g, mask = _inputs()
    tq, tk, tv, tm = map(torch.tensor, (q, k, v, mask))
    temp = DK ** 0.5
    carry = _chain(tq, tk, tv, tm, (0, 32), 0.0)
    dead = torch.zeros(B, 32, dtype=torch.bool)
    same = flash.flash_forward_carry(tq, tk[:, :, 32:], tv[:, :, 32:], dead,
                                     None, carry, temp)
    for a, b in zip(same, carry):
        assert torch.equal(a, b)
    q_mask = torch.ones(B, L, dtype=torch.bool)
    q_mask[0, 40:] = False
    part = flash.flash_forward_carry(tq, tk[:, :, 32:], tv[:, :, 32:],
                                     tm[:, 32:], q_mask, carry, temp)
    full = flash.flash_forward_carry(tq, tk[:, :, 32:], tv[:, :, 32:],
                                     tm[:, 32:], None, carry, temp)
    for p_, f_, c_ in zip(part, full, carry):
        assert torch.equal(p_[0, :, 40:], c_[0, :, 40:])
        assert torch.equal(p_[0, :, :40], f_[0, :, :40])
        assert torch.equal(p_[1], f_[1])
    with pytest.raises(ValueError):
        flash.flash_forward_carry(tq, tk, tv, tm, None, carry[:2] + (
            carry[2][..., :4],), temp)


@pytest.mark.parametrize("drop", [0.0, DROP])
def test_block_backward_sum_equals_full_backward(drop):
    q, k, v, g, mask = _inputs(seed=5)
    ref_out, ref_dq, ref_dk, ref_dv = _dense(q, k, v, g, mask, drop)
    tq, tk, tv, tg, tm = map(torch.tensor, (q, k, v, g, mask))
    cuts = (0, 13, 27, 50, 64)
    temp = DK ** 0.5
    sd = SEED if drop else None
    out, lse = flash.flash_carry_finalize(_chain(tq, tk, tv, tm, cuts, drop))
    dq = torch.zeros(B, H, L, DK)
    dks, dvs = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        dq_c, dk_c, dv_c = flash.flash_block_backward(
            tq, tk[:, :, a:b], tv[:, :, a:b], tm[:, a:b], out, lse, tg, temp,
            drop, sd, col_offset=a)
        assert dq_c.dtype == torch.float32
        dq += dq_c
        dks.append(dk_c)
        dvs.append(dv_c)
    for got, ref in ((dq, ref_dq), (torch.cat(dks, 2), ref_dk),
                     (torch.cat(dvs, 2), ref_dv)):
        assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_dropout_mask_offsets_select_the_global_mask():
    full = flash.dropout_keep_mask(SEED, DROP, (2, 3, 40, 50))
    assert 0.85 < float(full.float().mean()) < 0.95
    for r0, c0, lq, lk in ((0, 0, 40, 50), (8, 12, 10, 20), (5, 13, 7, 9),
                           (39, 49, 1, 1), (0, 3, 40, 2)):
        part = flash.dropout_keep_mask(SEED, DROP, (2, 3, lq, lk),
                                       row_offset=r0, col_offset=c0)
        assert torch.equal(part, full[:, :, r0:r0 + lq, c0:c0 + lk])


@pytest.mark.parametrize("drop", [0.0, DROP])
def test_ring_of_one_equals_dense(drop):
    """Without torch.distributed a group is a ring of one: one carry pass,
    one block backward."""
    q, k, v, g, mask = _inputs(seed=6)
    ref = _dense(q, k, v, g, mask, drop)
    for ring in (attention.ring_attention, attention.ring_flash_attention):
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = ring(*leaves, torch.tensor(mask), None, dropout=drop,
                   seed=SEED if drop else None)
        grads = torch.autograd.grad(out, leaves, torch.tensor(g))
        for got, r in zip([out.detach()] + list(grads), ref):
            assert np.abs(got.numpy() - r).max() <= 1e-5


# ---------------------------------------------------------------------------
# multi-rank: every rank is a process of its own
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    mode, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res = {}
    if mode == "ring":
        from csn_tpu_torch.ops import attention
        inp = np.load(f"{out}/inputs.npz")
        l = inp["q"].shape[2] // world
        sl = slice(rank * l, (rank + 1) * l)
        for name, ring in (("online", attention.ring_attention),
                           ("flash", attention.ring_flash_attention)):
            for drop in (0.0, float(inp["drop"])):
                leaves = [torch.tensor(inp[n][:, :, sl], requires_grad=True)
                          for n in ("q", "k", "v")]
                o = ring(*leaves, torch.tensor(inp["mask"][:, sl]),
                         dist.group.WORLD, dropout=drop,
                         seed=int(inp["seed"]) if drop else None)
                grads = torch.autograd.grad(
                    o, leaves, torch.tensor(inp["g"][:, :, sl]))
                for n, t in zip(("out", "dq", "dk", "dv"),
                                [o.detach()] + list(grads)):
                    res[f"{name}_{drop}_{n}"] = t.numpy()
    else:
        from csn_tpu_torch.midfc.training import MidfcConfig, MidfcRunner
        attention_type, n_data, n_seq, chunk = sys.argv[6:10]
        inp = np.load(f"{out}/inputs.npz")
        cfg = MidfcConfig(
            num_classes=int(inp["classes"]), n_heads=2, K=2,
            batch_size=inp["feats"].shape[0], d_model=inp["feats"].shape[2],
            chunk_size=int(chunk) or None, num_points=inp["feats"].shape[1],
            data_parallel=int(n_data), seq_parallel=int(n_seq))
        runner = MidfcRunner(cfg, attention_type, device="cpu")
        runner.initialize()
        runner.model.attention.mha.dropout = 0.0
        runner.load_state(torch.load(f"{out}/state.pt"))
        nb = inp["neighbors"] if attention_type == "csa" else None
        res["logits"] = runner._eval(inp["feats"], nb).numpy()
        res["ssa"] = runner._ssa_feats(inp["feats"]).numpy()
        loss, grads = runner._grad(inp["feats"], inp["labels"], nb, 7)
        res["loss"] = loss.numpy()
        for n, gr in grads.items():
            res["grad:" + n] = gr.numpy()
        bad = inp["feats"].copy()
        bad[1, 3, :] = np.nan   # poisons one shard; the all-reduce spreads it
        loss, grads = runner._grad(bad, inp["labels"], nb, 7)
        res["nan_loss"] = loss.numpy()
        res["nan_grad_max"] = np.asarray(
            max(float(gr.abs().max()) for gr in grads.values()))
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(mode, world, out, *extra):
    """Start `world` rank processes together and wait for all of them."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, mode, str(r), str(world), str(port),
         str(out), *map(str, extra)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    fails = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                fails.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:   # leave nothing running
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not fails, "\n".join(fails)
    return [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring4")
    q, k, v, g, mask = _inputs(seed=9)
    np.savez(out / "inputs.npz", q=q, k=k, v=v, g=g, mask=mask, seed=SEED,
             drop=DROP)
    ranks = _run_ranks("ring", 4, out)
    return (q, k, v, g, mask), ranks


@pytest.mark.parametrize("drop", [0.0, DROP])
@pytest.mark.parametrize("impl", ["online", "flash"])
def test_ring_over_4_ranks_equals_unsharded(ring4, impl, drop):
    """Values and q/k/v gradients of the 4-hop ring equal the unsharded
    attention; with dropout that holds only if the sharded mask equals the
    single-device mask entry for entry."""
    (q, k, v, g, mask), ranks = ring4
    ref = _dense(q, k, v, g, mask, drop)
    for name, r in zip(("out", "dq", "dk", "dv"), ref):
        got = np.concatenate([rk[f"{impl}_{drop}_{name}"] for rk in ranks],
                             axis=2)
        assert got.shape == r.shape
        assert np.abs(got - r).max() <= 1e-5, (impl, drop, name)


def test_ring_over_4_ranks_equals_jax_ring(ring4):
    (q, k, v, g, mask), ranks = ring4
    if len(jax.devices()) < 4:
        pytest.skip("needs the 4-device virtual CPU mesh")
    mesh = make_midfc_mesh(1, 4)
    specs = dict(mesh=mesh, in_specs=(PS(None, None, "seq", None),) * 3
                 + (PS(None, "seq"),),
                 out_specs=PS(None, None, "seq", None), check_vma=False)
    jin = tuple(map(jnp.asarray, (q, k, v, mask)))
    j_online = np.asarray(jax.shard_map(
        lambda a, b, c, d: j_attention.ring_attention(a, b, c, d, axis="seq"),
        **specs)(*jin))
    with j_flash.interpret_mode():
        j_ring_flash = np.asarray(jax.shard_map(
            lambda a, b, c, d: j_attention.ring_flash_attention(
                a, b, c, d, axis="seq"), **specs)(*jin))
    for impl in ("online", "flash"):
        got = np.concatenate([rk[f"{impl}_0.0_out"] for rk in ranks], axis=2)
        assert np.abs(got - j_online).max() <= 1e-5
        np.testing.assert_allclose(got, j_ring_flash, rtol=2e-2, atol=2e-2)


MF_B, MF_P, MF_D, MF_C = 2, 80, 32, 5


def _midfc_inputs(attention_type, chunk, out):
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(MF_B, MF_P, MF_D)).astype(np.float32)
    neighbors = rng.normal(size=(MF_B, 3, MF_P, MF_D)).astype(np.float32)
    labels = rng.integers(0, MF_C, size=(MF_B, MF_P)).astype(np.int32)
    labels[0, :30] = 0   # valid labels spread unevenly over the shards
    np.savez(out / "inputs.npz", feats=feats, neighbors=neighbors,
             labels=labels, classes=MF_C)
    cfg = MidfcConfig(num_classes=MF_C, n_heads=2, K=2, batch_size=MF_B,
                      d_model=MF_D, chunk_size=chunk, num_points=MF_P)
    single = MidfcRunner(cfg, attention_type, device="cpu")
    single.initialize()
    single.model.attention.mha.dropout = 0.0
    with torch.no_grad():   # biases start at zero: make them count
        for p in single.model.parameters():
            if p.ndim == 1:
                p.add_(torch.tensor(
                    0.1 * rng.normal(size=p.shape).astype(np.float32)))
    torch.save(single.params, out / "state.pt")
    return single, feats, labels, neighbors


@pytest.mark.parametrize("attention_type,n_data,n_seq,chunk", [
    ("csa", 1, 2, 20), ("csa", 2, 1, 20), ("csa", 2, 2, 20),
    ("ssa", 1, 2, 0), ("csa", 2, 2, 0), ("ssa", 2, 1, 0)])
def test_parallel_steps_match_single_process(tmp_path, attention_type,
                                             n_data, n_seq, chunk):
    """(n_data, n_seq) grids, chunked (block-diagonal: shards independent)
    and full attention (chunk 0: a ring over the seq group, of one rank at
    n_seq 1): eval logits,
    SSA features, loss and every gradient equal the single-process step."""
    single, feats, labels, neighbors = _midfc_inputs(
        attention_type, chunk or None, tmp_path)
    nb = neighbors if attention_type == "csa" else None
    ranks = _run_ranks("midfc", n_data * n_seq, tmp_path, attention_type,
                       n_data, n_seq, chunk)
    ref_logits = single._eval(feats, nb).numpy()
    ref_ssa = single._ssa_feats(feats).numpy()
    ref_loss, ref_grads = single._grad(feats, labels, nb, 7)
    for rk in ranks:   # every rank returns the same global result
        assert np.abs(rk["logits"] - ref_logits).max() <= 2e-5
        assert np.abs(rk["ssa"] - ref_ssa).max() <= 2e-5
        assert abs(float(rk["loss"]) - float(ref_loss)) \
            <= 1e-5 * float(ref_loss)
        for name, r in ref_grads.items():
            err = np.abs(rk["grad:" + name] - r.numpy()).max()
            assert err <= 1e-4 * float(r.abs().max()) + 1e-6, name
        assert float(rk["nan_loss"]) == 0.0
        assert float(rk["nan_grad_max"]) == 0.0


def test_parallel_shape_guards():
    from csn_tpu_torch.parallel.midfc import (
        MidfcGrid, _check_shapes, make_midfc_grid,
    )

    grid = MidfcGrid(2, 2, 0, 0, None)
    _check_shapes(grid, np.zeros((4, 80, 8)), 20)
    with pytest.raises(ValueError, match="batch"):
        _check_shapes(grid, np.zeros((3, 80, 8)), 20)
    with pytest.raises(ValueError, match="points"):
        _check_shapes(grid, np.zeros((4, 81, 8)), None)
    with pytest.raises(ValueError, match="chunk_size"):
        _check_shapes(grid, np.zeros((4, 80, 8)), 25)
    with pytest.raises(ValueError, match="torch.distributed"):
        make_midfc_grid(2, 2)   # no initialised world in this process
    with pytest.raises(ValueError, match="chunk_size=None"):
        from csn_tpu_torch.midfc.model import ChunkedMHA

        ChunkedMHA(2, 8, 8, 8, chunk_size=20, ring_group=object())


# ---------------------------------------------------------------------------
# bf16 at head dim 256: the ring's `_bf16_wide` rows
# ---------------------------------------------------------------------------

UNEVEN = (0, 13, 27, 50, 64)   # blocks start at columns 1, 3 and 2 mod 4


def _bf16(x):
    """A numpy f32 array rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16_carry_chain_vs_pallas(d):
    """The bf16 carry chain at head dim `d` through `flash_forward_carry`
    against the JAX Pallas carry in interpret mode (the two tests below)."""
    rng = np.random.default_rng(21)
    b, h = 2, 2
    q, k, v = (_bf16(rng.normal(size=(b, h, L, d)).astype(np.float32))
               for _ in range(3))
    mask = rng.random((b, L)) > 0.3
    mask[:, :8] = True
    temp = d ** 0.5
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tm = torch.from_numpy(mask)
    carry = flash.flash_carry_init(b, h, L, d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    j_carry = j_flash.flash_carry_init(b, h, L, d)
    with j_flash.interpret_mode():
        for a, c in zip(UNEVEN[:-1], UNEVEN[1:]):
            carry = flash.flash_forward_carry(
                tq, tk[:, :, a:c], tv[:, :, a:c], tm[:, a:c], None, carry,
                temp, col_offset=a)
            j_carry = j_flash.flash_forward_carry(
                jq, jk[:, :, a:c], jv[:, :, a:c], jnp.asarray(mask[:, a:c]),
                None, j_carry, temp)
    for nm, got, ref in zip(("m", "l", "acc"), carry, j_carry):
        ref = np.asarray(ref)
        err = float(np.abs(got.numpy() - ref).max())
        scale = float(np.abs(ref).max())
        assert err <= 3e-2 * scale, (
            f"{nm}: max_abs_err {err:.3e} above 3e-2 x max|ref| "
            f"{3e-2 * scale:.3e}")


def test_bf16_carry_chain_matches_jax_pallas_carry():
    """The bf16 chain at head dim 256 through `flash_forward_carry` (its
    plain version on the CPU) over blocks cut at columns 1, 3 and 2 mod 4,
    dropout 0, against the JAX package's `flash_forward_carry` in interpret
    mode chained over the same blocks, both on the same numpy inputs
    rounded to bf16 and held in bf16. m, l and acc each within
    3e-2·max|ref| of the JAX carry's: the Pallas kernel rounds the
    probabilities to bf16 for P V, the plain version keeps them in f32."""
    _bf16_carry_chain_vs_pallas(256)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_d128_carry_chain_matches_jax_pallas_carry(d):
    """The same chain at head dims 128 and 64, the ring's widths at d_model
    128 and 64 (on the card the carry form of `csrc/flash_tc_fwd.cuh`, rows
    `flash_attn_carry_bf16_wide` and `flash_attn_carry_bf16_d64`), at the
    same tolerance."""
    _bf16_carry_chain_vs_pallas(d)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ring_of_one_step_vs_jax(monkeypatch, d, heads, compute_dtype):
    """One MID-FC SSA full-attention train step at d_model `d` in `heads`
    heads (d_k = d_v = d) and `compute_dtype`, dropout 0, through
    `make_midfc_steps(runner, 1, 1)` in a gloo world of one in this process
    (`RingFlashAttentionFn` over a ring of one: the carry and the block
    backward, their plain versions on the CPU), and the JAX `MidfcRunner`
    step (plain attention) on the weights carried across by
    `flax_to_torch_midfc`. Checks that the ring handed the per-block
    wrappers q in the compute dtype and took back f32 carry and dQ terms;
    returns (torch loss, torch gradients, JAX loss, JAX gradients as torch
    tensors)."""
    kw = dict(num_classes=MF_C, n_heads=heads, K=2, batch_size=MF_B,
              d_model=d, chunk_size=None, num_points=MF_P, weight_decay=5e-4,
              compute_dtype=compute_dtype)
    rng = np.random.default_rng(13)
    feats = rng.normal(size=(MF_B, MF_P, d)).astype(np.float32)
    labels = rng.integers(0, MF_C, size=(MF_B, MF_P)).astype(np.int32)
    jr = JMidfcRunner(JMidfcConfig(use_flash=False, **kw), "ssa")
    jr.model = jr.model.clone(dropout=0.0)
    jr._grad = jax.jit(jr._make_grad())
    jr.initialize(feats, None)
    tr = MidfcRunner(MidfcConfig(use_flash=True, **kw), "ssa", device="cpu")
    tr.initialize()
    tr.model.attention.mha.dropout = 0.0
    tr.load_state(flax_to_torch_midfc(_np_tree(jr.params)))
    seen = []

    def spy(fn, what):
        def call(q, *a, **k):
            res = fn(q, *a, **k)
            seen.append((what, q.dtype, res[0].dtype))
            return res
        return call

    monkeypatch.setattr(attention, "flash_forward_carry",
                        spy(flash.flash_forward_carry, "carry"))
    monkeypatch.setattr(attention, "flash_block_backward",
                        spy(flash.flash_block_backward, "block"))
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        steps = make_midfc_steps(tr, 1, 1)
        dt = getattr(torch, compute_dtype)
        assert tr.model.compute_dtype == dt
        tl, tg = steps.grad(feats, labels, None, 0)
    finally:
        dist.destroy_process_group()
    assert seen == [("carry", dt, torch.float32),
                    ("block", dt, torch.float32)], seen
    jl, jg = jr._grad(jr.params, jnp.asarray(feats), jnp.asarray(labels),
                      None, jax.random.PRNGKey(0))
    ref_g = flax_to_torch_midfc(_np_tree(jg))
    assert set(tg) == set(ref_g)
    return float(tl), tg, float(jl), ref_g


def _assert_step_close(tl, tg, jl, ref_g, loss_rel, grad_tol):
    rel = abs(tl - jl) / abs(jl)
    assert rel <= loss_rel, f"loss {tl} vs {jl}: {rel:.3e} relative"
    for name, r in ref_g.items():
        err = float((tg[name].float() - r).abs().max())
        scale = float(r.abs().max())
        assert err <= grad_tol * scale, (
            f"{name}: max_abs_err {err:.3e} above {grad_tol:.0e} x max|ref| "
            f"{grad_tol * scale:.3e}")


def test_bf16_full_attention_step_through_a_ring_of_one_matches_jax(
        monkeypatch):
    """One MID-FC SSA full-attention train step (chunk_size None) in bf16
    at dropout 0, d_model 256 in 2 heads of 256, through a ring of one
    (`_ring_of_one_step_vs_jax`; on the card the `_bf16_wide` rows at heads
    of 256), against the JAX `MidfcRunner` step in compute_dtype
    "bfloat16": the loss within 2e-3 relative (the f32 logit head reads
    bf16 attention outputs, each rounded to 2^-9 of itself) and every
    gradient within 2e-2·max|ref| of its tensor (a few bf16 roundings that
    the packages place differently). The ring hands the per-block wrappers
    bf16 q, k, v and adds their f32 dQ terms."""
    _assert_step_close(*_ring_of_one_step_vs_jax(monkeypatch, 256, 2,
                                                 "bfloat16"), 2e-3, 2e-2)


@pytest.mark.parametrize("d_model", [64, 128])
@pytest.mark.parametrize("compute_dtype,loss_rel,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 2e-3, 2e-2)])
def test_d_model_128_full_attention_step_through_a_ring_of_one_matches_jax(
        monkeypatch, compute_dtype, loss_rel, grad_tol, d_model):
    """The same step at d_model 128 and 64 (2 heads of 128 or 64: on the
    card the ring's D=128 rows, `_tf32_d128` in f32 and `_bf16_wide` in
    bf16, and its D=64 rows, `_tf32_d64` and `_bf16_d64`), against the JAX
    step in the same compute dtype: in f32 the loss within 1e-5 relative
    and every gradient within 1e-4·max|ref| (the MID-FC f32 tolerances of
    `tests/test_torch_midfc.py`), in bf16 at the bf16 step's 2e-3 and
    2e-2."""
    _assert_step_close(*_ring_of_one_step_vs_jax(monkeypatch, d_model, 2,
                                                 compute_dtype), loss_rel,
                       grad_tol)


# ---------------------------------------------------------------------------
# head dims 128 and 64: the ring at d_model 128 and 64 (`_tf32_d128` /
# `_bf16_wide` and `_tf32_d64` / `_bf16_d64` rows)
# ---------------------------------------------------------------------------

def _inputs_d(d, seed):
    """Seeded f32 q, k, v, g [B, H, L, d] and a key mask with a valid prefix
    in every block."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, L, d)).astype(
        np.float32)) for _ in range(4))
    mask = rng.random((B, L)) > 0.3
    mask[:, :8] = True
    return q, k, v, g, torch.from_numpy(mask)


def _within(got, ref, tol):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= tol * scale, (f"max_abs_err {err:.3e} above {tol:.0e} x "
                                f"max|ref| {tol * scale:.3e}")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("drop", [0.0, DROP])
def test_f32_d128_carry_chain_over_uneven_cuts_equals_dense(drop, d):
    """The f32 carry chain at head dims 128 and 64 (on the card the carry
    forms of `csrc/flash_tf32_d128_fwd.cuh` and `csrc/flash_tf32_d64_fwd.cuh`,
    rows `flash_attn_carry_tf32_d128` and `flash_attn_carry_tf32_d64`) over
    blocks cut at columns 1, 3 and 2 mod 4, against the dense attention
    with the same dropout mask: out and lse within 1e-4·max|ref|."""
    q, k, v, _, mask = _inputs_d(d, 31)
    temp = d ** 0.5
    sd = SEED if drop else None
    carry = flash.flash_carry_init(B, H, L, d)
    for a, c in zip(UNEVEN[:-1], UNEVEN[1:]):
        carry = flash.flash_forward_carry(
            q, k[:, :, a:c], v[:, :, a:c], mask[:, a:c], None, carry, temp,
            drop, sd, col_offset=a)
    out, lse = flash.flash_carry_finalize(carry)
    ref, ref_lse = attention.scaled_dot_product_attention(
        q, k, v, mask, temp, dropout=drop, seed=sd, return_lse=True)
    _within(out, ref, 1e-4)
    _within(lse, ref_lse, 1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("drop", [0.0, DROP])
def test_f32_d128_block_backwards_sum_to_the_full_backward(drop, d):
    """`flash_block_backward` at head dims 128 and 64 (on the card the block
    forms of `csrc/flash_tf32_bwd.cuh` at 128 and
    `csrc/flash_tf32_d64_bwd.cuh`, rows `flash_attn_block_bwd_tf32_d128` and
    `flash_attn_block_bwd_tf32_d64`) on blocks cut at columns 1, 3 and 2
    mod 4, against the chain's global out and lse: the f32 dQ terms summed
    over the blocks and the blocks' dK and dV side by side equal autograd
    of the dense attention, within 1e-4·max|ref|."""
    q, k, v, g, mask = _inputs_d(d, 37)
    temp = d ** 0.5
    sd = SEED if drop else None
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_out = attention.scaled_dot_product_attention(
        *leaves, mask, temp, dropout=drop, seed=sd)
    refs = torch.autograd.grad(ref_out, leaves, g)
    carry = flash.flash_carry_init(B, H, L, d)
    for a, c in zip(UNEVEN[:-1], UNEVEN[1:]):
        carry = flash.flash_forward_carry(
            q, k[:, :, a:c], v[:, :, a:c], mask[:, a:c], None, carry, temp,
            drop, sd, col_offset=a)
    out, lse = flash.flash_carry_finalize(carry)
    dq = torch.zeros(B, H, L, d)
    dks, dvs = [], []
    for a, c in zip(UNEVEN[:-1], UNEVEN[1:]):
        dq_c, dk_c, dv_c = flash.flash_block_backward(
            q, k[:, :, a:c], v[:, :, a:c], mask[:, a:c], out, lse, g, temp,
            drop, sd, col_offset=a)
        assert dq_c.dtype == torch.float32
        dq += dq_c
        dks.append(dk_c)
        dvs.append(dv_c)
    for got, ref in zip((dq, torch.cat(dks, 2), torch.cat(dvs, 2)), refs):
        _within(got, ref, 1e-4)


def _meta(*shape, dtype=torch.bfloat16, shift=0):
    """A contiguous meta tensor, `shift` elements past a 16-byte boundary."""
    n = int(np.prod(shape))
    t = torch.empty(n + shift, dtype=dtype, device="meta")[shift:]
    return t.view(*shape)


class _Launcher:
    """Stands in for the kernel library: records the block backward's
    scratch pointer and returns success."""

    def __init__(self):
        self.calls = []

    def csn_flash_attn_carry(self, *args):
        self.calls.append(("carry", args))
        return 0

    def csn_flash_attn_block_bwd(self, *args):
        self.calls.append(("block", args))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash.RING_HEAD_DIMS)
def test_ring_wrappers_count_rows_and_ask_for_the_ds_scratch(monkeypatch,
                                                              dtype, d):
    """Without a card (meta tensors through the wrappers, the CUDA-device
    check and the library stubbed): at every (dtype, D) of
    `RING_HEAD_DIMS`, `flash_forward_carry` and `flash_block_backward`
    count their launch in `ring_row`'s row (f32 at 64 and 128: the
    `"_tf32_d64"` and `"_tf32_d128"` rows; bf16 at 64: the `"_bf16_d64"`
    rows, at 128 and 256 the `"_bf16_wide"` rows; f32 at 256 the base
    rows), and the block backward asks for a dS^T scratch of
    B·H·ceil32(Lk)·ceil32(Lq) elements in q's dtype at 128 and 256 (f32
    and bf16) and none at 64."""
    lib = _Launcher()
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    scratch = []

    def ds_scratch(*a, **k):
        scratch.append(real(*a, **k))
        return scratch[-1]

    real = flash._ds_scratch
    monkeypatch.setattr(flash, "_ds_scratch", ds_scratch)
    b, h, lq, lk = 2, 3, 70, 45
    q = _meta(b, h, lq, d, dtype=dtype)
    k = _meta(b, h, lk, d, dtype=dtype)
    kv = torch.ones(b, lk, dtype=torch.bool, device="meta")
    carry = (_meta(b, h, lq, dtype=torch.float32),
             _meta(b, h, lq, dtype=torch.float32),
             _meta(b, h, lq, d, dtype=torch.float32))
    lse = _meta(b, h, lq, dtype=torch.float32)
    flash.flash_forward_carry(q, k, k, kv, None, carry, 16.0)
    flash.flash_block_backward(q, k, k, kv, q, lse, q, 16.0, delta=lse)
    suffix = ""
    if dtype == torch.bfloat16:
        suffix = "_bf16_d64" if d == 64 else "_bf16_wide"
    elif d in (64, 128):
        suffix = f"_tf32_d{d}"
    rows = {n: n + suffix for n in (
        "flash_attn_carry", "flash_attn_block_bwd")}
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        r: 1 for r in rows.values()}
    assert [c[0] for c in lib.calls] == ["carry", "block"]
    ds_t, = scratch
    if d in (128, 256):
        assert ds_t.dtype == dtype
        assert ds_t.numel() == b * h * 64 * 96   # ceil32(45), ceil32(70)
    else:
        assert ds_t is None


def test_ring_row_names_every_ring_width():
    """`ring_row` at every head dim 1-256 in both dtypes, as `k2_row` names
    K2's: bf16 dims that the ring runs at the width 64 (1-64, zero-padded
    up to it) count in the `"_bf16_d64"` rows, at the widths 128 and 256
    (65-256) in the `"_bf16_wide"` rows, f32 dims it runs at 64 (1-64) in
    the `"_tf32_d64"` rows, at 128 (65-128) in the `"_tf32_d128"` rows, f32
    129-256 in the base rows; each name is a row of `kernels.LAUNCHES`; and
    the ring's `_bf16_wide`, `_bf16_d64`, `_tf32_d128` and `_tf32_d64` rows
    are these eight."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, flash.MAX_HEAD_DIM + 1):
            if dtype == torch.bfloat16:
                suffix = "_bf16_d64" if d <= 64 else "_bf16_wide"
            else:
                suffix = ("_tf32_d64" if d <= 64 else
                          "_tf32_d128" if d <= 128 else "")
            for what in ("flash_attn_carry", "flash_attn_block_bwd"):
                row = flash.ring_row(what, dtype, d)
                assert row == what + suffix, (d, row)
                assert row in kernels.LAUNCHES
    assert {flash.ring_row(w, torch.bfloat16, d) for w in (
        "flash_attn_carry", "flash_attn_block_bwd") for d in (128, 256)} == {
        "flash_attn_carry_bf16_wide", "flash_attn_block_bwd_bf16_wide"}
    assert {flash.ring_row(w, torch.float32, 128) for w in (
        "flash_attn_carry", "flash_attn_block_bwd")} == {
        "flash_attn_carry_tf32_d128", "flash_attn_block_bwd_tf32_d128"}
    assert {flash.ring_row(w, dt, 64) for w in (
        "flash_attn_carry", "flash_attn_block_bwd") for dt in (
        torch.float32, torch.bfloat16)} == {
        "flash_attn_carry_tf32_d64", "flash_attn_block_bwd_tf32_d64",
        "flash_attn_carry_bf16_d64", "flash_attn_block_bwd_bf16_d64"}


@pytest.mark.parametrize("source,launch", [
    ("flash_attn_carry.cu", r"csn_tcw::launch_fwd_split<256, true, (true|"
     r"false)>"),
    ("flash_attn_block_bwd.cu", r"csn_tcw::launch_bwd_split<256, float>")])
def test_ring_dispatch_sends_bf16_256_to_the_tensor_cores(source, launch):
    """The C launchers of the ring: bf16 at 256 goes to the carry form of
    `csrc/flash_bf16_wide_fwd.cuh` (both dropout-word paths) and to the
    block form of `csrc/flash_bf16_wide_bwd.cuh` with an f32 dQ; no
    CUDA-core body is left (no `CSN_CARRY` / `CSN_BLOCK` dispatch, and no
    source under `csrc/` names the CUDA-core headers `flash_wide.cuh` or
    `flash_bwd_wide.cuh`, which are gone)."""
    text = (kernels.CSRC / source).read_text()
    body = text[text.index('extern "C" int csn_flash_attn'):]
    carry = "carry" in source
    assert not re.search(r"CSN_(CARRY|BLOCK)|csn_wide", text)
    for src in kernels.sources():
        assert not re.search(r"flash_(bwd_)?wide\.cuh|csn_wide",
                             src.read_text()), src.name
    assert not (kernels.CSRC / "flash_wide.cuh").exists()
    assert not (kernels.CSRC / "flash_bwd_wide.cuh").exists()
    assert len(re.findall(launch, body)) == (2 if carry else 1)
    header = "flash_bf16_wide_fwd.cuh" if carry else "flash_bf16_wide_bwd.cuh"
    assert f'#include "{header}"' in text


@pytest.mark.parametrize("source,condition,launch,header", [
    ("flash_attn_carry.cu", "dtype == csn::kF32 && D == 128",
     r"csn_tf32_d128::launch_fwd<true, (true|false)>",
     "flash_tf32_d128_fwd.cuh"),
    ("flash_attn_carry.cu", "dtype == csn::kBF16 && D == 128",
     r"csn_tc_fwd::launch_fwd<128, true, (true|false)>", "flash_tc_fwd.cuh"),
    ("flash_attn_block_bwd.cu", "dtype == csn::kF32 && D == 128",
     r"csn_tf32::launch_bwd_tf32<float, 128>", "flash_tf32_bwd.cuh"),
    ("flash_attn_block_bwd.cu", "dtype == csn::kBF16 && D == 128",
     r"csn_tcw::launch_bwd_split<128, float>", "flash_bf16_wide_bwd.cuh"),
    ("flash_attn_carry.cu", "dtype == csn::kF32 && D == 64",
     r"csn_tf32_d64::launch_fwd<true, (true|false)>",
     "flash_tf32_d64_fwd.cuh"),
    ("flash_attn_carry.cu", "dtype == csn::kBF16 && D == 64",
     r"csn_tc_fwd::launch_fwd<64, true, (true|false)>", "flash_tc_fwd.cuh"),
    ("flash_attn_block_bwd.cu", "dtype == csn::kF32 && D == 64",
     r"csn_tf32_d64::launch_bwd<true, (true|false)>",
     "flash_tf32_d64_bwd.cuh"),
    ("flash_attn_block_bwd.cu", "dtype == csn::kBF16 && D == 64",
     r"csn_tc_bwd::launch_tc<64, true, (true|false)>", "flash_tc_bwd.cuh")])
def test_ring_dispatch_sends_d128_to_the_tensor_cores(source, condition,
                                                      launch, header):
    """The C launchers of the ring at head dims 128 and 64: f32 at 128 goes
    to the carry form of `csrc/flash_tf32_d128_fwd.cuh` and the block form
    of `csrc/flash_tf32_bwd.cuh` at 128, bf16 at 128 to the carry form of
    `csrc/flash_tc_fwd.cuh`'s template and the block form of
    `csrc/flash_bf16_wide_bwd.cuh` at 128 with an f32 dQ; f32 at 64 to the
    carry and block forms of `csrc/flash_tf32_d64_fwd.cuh` /
    `csrc/flash_tf32_d64_bwd.cuh` (`launch_fwd<true, ...>`,
    `launch_bwd<true, ...>`: the block form's dQ is f32), bf16 at 64 to
    those of `csrc/flash_tc_fwd.cuh`'s and `csrc/flash_tc_bwd.cuh`'s
    templates (`launch_tc<64, true, ...>`: an f32 dQ); both dropout-word
    paths of each D=64 form and of each carry form, each right under its
    (dtype, D) test; no CUDA-core body is left at either."""
    text = (kernels.CSRC / source).read_text()
    body = text[text.index('extern "C" int csn_flash_attn'):]
    after = body[body.index(f"if ({condition})"):]
    stmt = after[:after.index(";\n  if (")] if ";\n  if (" in after \
        else after[:after.index(";\n  return")]
    carry = "carry" in source
    paths = 2 if carry or " 64" in condition else 1
    assert len(re.findall(launch, stmt)) == paths, stmt
    assert not re.search(r"CSN_(CARRY|BLOCK)\((float|__nv_bfloat16), "
                         r"(64|128)\)", body)
    assert f'#include "{header}"' in text


@pytest.mark.parametrize("what", ["carry", "block"])
def test_ring_wrappers_refuse_other_devices_and_misaligned_views(
        monkeypatch, what):
    """The bf16 D=256 forms on the card copy q, k, v (and dO, or the
    carry's acc) 16 bytes at a time: with the library stubbed, a tensor
    that is not on the CUDA device (meta here; the CPU takes the plain
    version) is refused by the device check, and with that check stubbed
    too, a view that does not start on a 16-byte boundary is refused;
    neither reaches the launcher nor counts a launch. An aligned call gets
    as far as the library."""
    def no_library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(kernels, "library", no_library)
    b, h, lq, lk, d = 1, 2, 9, 11, 256
    q = _meta(b, h, lq, d)
    k = _meta(b, h, lk, d)
    kv = torch.ones(b, lk, dtype=torch.bool, device="meta")
    f32 = dict(dtype=torch.float32)
    carry = (_meta(b, h, lq, **f32), _meta(b, h, lq, **f32),
             _meta(b, h, lq, d, **f32))
    lse = _meta(b, h, lq, **f32)

    def call(qq, kk, gg, acc):
        if what == "carry":
            return flash.flash_forward_carry(qq, kk, kk, kv, None,
                                             carry[:2] + (acc,), 16.0)
        return flash.flash_block_backward(qq, kk, kk, kv, qq, lse, gg, 16.0,
                                          delta=lse)

    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        call(q, k, q, carry[2])
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    shifted = [(_meta(b, h, lq, d, shift=1), k, q, carry[2]),
               (q, _meta(b, h, lk, d, shift=3), q, carry[2])]
    shifted.append((q, k, q, _meta(b, h, lq, d, shift=2, **f32))
                   if what == "carry" else
                   (q, k, _meta(b, h, lq, d, shift=5), carry[2]))
    for args in shifted:
        with pytest.raises(ValueError, match="16-byte"):
            call(*args)
    with pytest.raises(LookupError, match="reached the launch"):
        call(q, k, q, carry[2])
    assert kernels.LAUNCHES == before

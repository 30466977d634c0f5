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
"""

import os
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
from jax.sharding import PartitionSpec as PS

from csn_tpu.ops import attention as j_attention
from csn_tpu.ops import flash as j_flash
from csn_tpu.parallel.midfc import make_midfc_mesh
from csn_tpu_torch.midfc.training import MidfcConfig, MidfcRunner
from csn_tpu_torch.ops import attention, flash

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

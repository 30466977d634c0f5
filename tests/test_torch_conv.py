"""Port: the sparse conv (`csn_tpu_torch.core.conv`) against the JAX
package on a real built and concatenated batch: the plain forward against
`_conv_impl`, and `SparseConvFn`'s backward (its plain version on the CPU)
against `jax.vjp` of the JAX `sparse_conv` with the transpose map, with
random asymmetric weights so that a missed mirror shows. Also the dtypes of
the gradients, the dW kernel's split choice (its CUDA-core body and both
tensor-core bodies) and the launchers' refusal of CPU tensors and of
misaligned views; the one tensor-core rule of K1, dW and the im2col pair
(bf16, and f32 in split TF32) and the im2col backward's splits; CPU models
of the split-TF32 bodies' arithmetic against the JAX package; `sparse_conv_with_bias` and
`masked_fill` against the JAX functions. Tolerance: max abs <= 1e-5 * max|ref| (f32 on both sides; the
two sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from csn_tpu.core.conv import _conv_impl
from csn_tpu.core.conv import masked_fill as j_masked_fill
from csn_tpu.core.conv import sparse_conv as j_sparse_conv
from csn_tpu.core.conv import sparse_conv_with_bias as j_sparse_conv_with_bias
from csn_tpu.models.layers import transpose_map_name as j_transpose_map_name
from csn_tpu_torch import kernels
from csn_tpu_torch.core import conv, window_conv
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.models import load_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def big():
    """2 + 2 shapes of HRNetSimCSN3S's pyramid with the protocol's k5 stem,
    concatenated as in the combined pass."""
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=400, voxel_size=0.15,
        conv1_kernel_size=5, shrink=1.5)
    rng = np.random.default_rng(1)
    return concat_batches([to_torch(pipeline.collate_shapes(
        [bench.make_surface_shape(rng, 400) for _ in range(2)], spec,
        rng=rng), "cpu") for _ in range(2)])


@pytest.mark.parametrize("map_name,cin,cout", [
    ("same0k5", 3, 32), ("same0k3", 32, 64), ("same1k3", 64, 64),
    ("down0k3", 32, 64), ("up0k3", 64, 32)])
def test_sparse_conv_matches_jax(big, map_name, cin, cout):
    kmap = big.kmaps[map_name]
    src_l, _ = map_levels(map_name)
    n_in = big.masks[src_l].numel()
    rng = np.random.default_rng(sum(map_name.encode()))
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(kmap.shape[0], cin, cout)) / np.sqrt(cin)
         ).astype(np.float32)
    ref = np.asarray(_conv_impl(jnp.asarray(feats), jnp.asarray(kmap.numpy()),
                                jnp.asarray(w)))
    got = conv.sparse_conv(torch.from_numpy(feats), kmap,
                           torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape == (kmap.shape[1], cout)
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    assert kernels.LAUNCHES["sparse_conv_fwd"] == 0


def test_gather_rows_fills_sentinel_with_zeros():
    feats = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[3, 4], [0, 9]], dtype=torch.int32)
    out = conv.gather_rows(feats, idx)
    np.testing.assert_array_equal(out[0, 0].numpy(), [9, 10, 11])
    assert not out[0, 1].any() and not out[1, 1].any()
    np.testing.assert_array_equal(out[1, 0].numpy(), [0, 1, 2])


def test_k1_launcher_refuses_cpu_tensors():
    feats = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_fwd(feats, torch.zeros(27, 4, dtype=torch.int32),
                                    torch.zeros(27, 3, 8))


def _stub_launch(monkeypatch):
    """Wrappers run their checks on meta tensors: the CUDA-device check
    passes, and reaching the library raises LookupError."""
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)

    def no_library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(kernels, "library", no_library)


def _meta_view(*shape, dtype, shift):
    """A contiguous meta view of `shape` that starts `shift` elements into
    its storage: off a 16-byte boundary iff `shift`."""
    n = int(np.prod(shape))
    t = torch.empty(n + shift, dtype=dtype, device="meta")[shift:].view(*shape)
    assert t.is_contiguous() and bool(t.data_ptr() % 16) == bool(shift)
    return t


def test_k1_refuses_a_misaligned_bf16_view(monkeypatch):
    """K1's tensor-core bodies (bf16, and f32 in split TF32, with Cout % 8
    == 0) copy the weights, and feats where Cin % 16 == 0, 16 bytes at a
    time with cp.async: `sparse_conv_fwd` refuses such a view that does not
    start on a 16-byte boundary before the launch (meta tensors through the
    wrapper's checks, the CUDA-device check stubbed out), the weights of an
    f32 stem included. Aligned calls, and misaligned ones that no 16-byte
    copy reads (the stems' feats, which the flattened steps gather element
    by element, in bf16 and f32; a Cout off the multiples of 8, on the
    CUDA-core body), get as far as the library."""
    _stub_launch(monkeypatch)
    view = _meta_view
    n_in, n_out, k = 10, 7, 27
    kmap = torch.empty(k, n_out, dtype=torch.int32, device="meta")
    bf, f32 = torch.bfloat16, torch.float32
    assert window_conv.k1_tensor_cores(bf, 32, 64)
    assert window_conv.k1_tensor_cores(bf, 3, 32)
    assert window_conv.k1_tensor_cores(bf, 24, 64)
    assert not window_conv.k1_tensor_cores(bf, 32, 60)
    assert window_conv.k1_tensor_cores(f32, 32, 64)
    assert window_conv.k1_tensor_cores(f32, 3, 32)
    before = dict(kernels.LAUNCHES)
    for cin, dt, fs, ws in ((32, bf, 1, 0), (32, bf, 0, 1), (3, bf, 0, 1),
                            (32, f32, 1, 1), (3, f32, 0, 1), (3, f32, 1, 1)):
        with pytest.raises(ValueError, match="16-byte"):
            window_conv.sparse_conv_fwd(
                view(n_in, cin, dtype=dt, shift=fs), kmap,
                view(k, cin, 64, dtype=dt, shift=ws))
    for cin, cout, dt, fs, ws in ((32, 64, bf, 0, 0), (3, 32, bf, 1, 0),
                                  (3, 32, f32, 1, 0), (3, 30, f32, 1, 1)):
        with pytest.raises(LookupError, match="reached the launch"):
            window_conv.sparse_conv_fwd(
                view(n_in, cin, dtype=dt, shift=fs), kmap,
                view(k, cin, cout, dtype=dt, shift=ws))
    assert kernels.LAUNCHES == before

TC_RULE_CASES = [(torch.bfloat16, 32, 64, True), (torch.bfloat16, 3, 32, True),
                 (torch.bfloat16, 24, 64, True),
                 (torch.bfloat16, 32, 60, False),
                 (torch.float32, 32, 64, True), (torch.float32, 3, 32, True),
                 (torch.float32, 24, 64, True),
                 (torch.float32, 32, 60, False)]


@pytest.mark.parametrize("dtype,cin,cout,want", TC_RULE_CASES)
def test_dw_tensor_cores_rule(dtype, cin, cout, want):
    """dW's tensor-core bodies take what K1's takes: bf16, and f32 in split
    TF32, with Cout % 8 == 0, whatever Cin, the stems' Cin 3 included (the
    rule `csn_sparse_conv_dw` and `csn_sparse_conv_fwd` apply)."""
    assert window_conv.dw_tensor_cores(dtype, cin, cout) is want
    assert window_conv.k1_tensor_cores(dtype, cin, cout) is want
    assert window_conv.k1_split_tf32(dtype, cin, cout) is (
        want and dtype == torch.float32)


def test_dw_refuses_a_misaligned_bf16_view(monkeypatch):
    """dW's tensor-core bodies (K1's rule) copy g rows, and feats rows where
    Cin % 16 == 0, 16 bytes at a time with cp.async: `sparse_conv_dw`
    refuses such a view that does not start on a 16-byte boundary before
    the launch, the g of an f32 stem included. Aligned calls, and
    misaligned ones that no 16-byte copy reads (the stems' feats, loaded
    element by element by the narrow body in bf16 and f32; a Cout off the
    multiples of 8, on the CUDA-core body), get as far as the library."""
    _stub_launch(monkeypatch)
    n_in, n_g, k = 10, 7, 27
    kmap_t = torch.empty(k, n_in, dtype=torch.int32, device="meta")
    bf, f32 = torch.bfloat16, torch.float32
    before = dict(kernels.LAUNCHES)
    for cin, cout, dt, fs, gs in ((32, 64, bf, 1, 0), (32, 64, bf, 0, 1),
                                  (3, 32, bf, 0, 1), (32, 64, f32, 1, 1),
                                  (3, 32, f32, 0, 1), (3, 32, f32, 1, 1)):
        with pytest.raises(ValueError, match="16-byte"):
            window_conv.sparse_conv_dw(
                _meta_view(n_in, cin, dtype=dt, shift=fs),
                _meta_view(n_g, cout, dtype=dt, shift=gs), kmap_t)
    for cin, cout, dt, fs, gs in ((32, 64, bf, 0, 0), (3, 32, bf, 1, 0),
                                  (3, 32, f32, 1, 0), (3, 30, f32, 1, 1)):
        with pytest.raises(LookupError, match="reached the launch"):
            window_conv.sparse_conv_dw(
                _meta_view(n_in, cin, dtype=dt, shift=fs),
                _meta_view(n_g, cout, dtype=dt, shift=gs), kmap_t)
    assert kernels.LAUNCHES == before


def _close(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("map_name,cin,cout,input_grad", [
    ("same0k5", 3, 32, False), ("same0k3", 32, 64, True),
    ("same1k3", 64, 64, True), ("down0k3", 32, 64, True),
    ("up0k3", 64, 32, True)])
def test_sparse_conv_backward_matches_jax_vjp(big, map_name, cin, cout,
                                              input_grad):
    kmap = big.kmaps[map_name]
    t_name, mirror = conv.transpose_map_name(map_name)
    kmap_t = big.kmaps[t_name]
    src_l, _ = map_levels(map_name)
    n_in = big.masks[src_l].numel()
    rng = np.random.default_rng(7 + sum(map_name.encode()))
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(kmap.shape[0], cin, cout)).astype(np.float32)
    g = rng.normal(size=(kmap.shape[1], cout)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda f, ww: j_sparse_conv(f, jnp.asarray(kmap.numpy()), ww,
                                    kmap_t=jnp.asarray(kmap_t.numpy()),
                                    mirror=mirror, input_grad=input_grad),
        jnp.asarray(feats), jnp.asarray(w))
    ref_df, ref_dw = map(np.asarray, vjp(jnp.asarray(g)))

    tf = torch.from_numpy(feats).requires_grad_(input_grad)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = conv.sparse_conv(tf, kmap, tw, kmap_t, mirror)
    out.backward(torch.from_numpy(g))
    _close(tw.grad.numpy(), ref_dw)
    if input_grad:
        _close(tf.grad.numpy(), ref_df)
    else:
        assert tf.grad is None
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_conv_bwd_plain_mirror_matters(big):
    """With asymmetric weights, pairing the transpose edges with W instead of
    W reversed gives another d_feats: the mirror is exercised."""
    kmap = big.kmaps["same0k3"]
    rng = np.random.default_rng(3)
    n = kmap.shape[1]
    feats = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (27, 8, 8)).astype(np.float32))
    right, _ = conv.conv_bwd_plain(feats, g, kmap, w, True, True)
    wrong, _ = conv.conv_bwd_plain(feats, g, kmap, w, False, True)
    assert (right - wrong).abs().max() > 0.1 * right.abs().max()


def test_sparse_conv_grad_dtypes_bf16_activations(big):
    """f32 weights, bf16 activations: dW in f32 (the weights' dtype),
    d_feats in bf16 (the activations'), as the JAX backward returns them."""
    kmap = big.kmaps["same1k3"]
    n = kmap.shape[1]
    feats = torch.randn(n, 16, generator=torch.Generator().manual_seed(0))
    feats = feats.to(torch.bfloat16).requires_grad_(True)
    w = torch.nn.Parameter(torch.rand(27, 16, 8) - 0.5)
    out = conv.sparse_conv(feats, kmap, w, kmap, True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert w.grad.dtype == torch.float32
    assert feats.grad.dtype == torch.bfloat16


def test_transpose_map_name_matches_jax():
    for name in ("same0k5", "same2k3", "down0k3", "down1k3", "up0k3",
                 "up1k3"):
        assert conv.transpose_map_name(name) == j_transpose_map_name(name)


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 27, 64, 64, 10), (90112, 125, 3, 32, 3), (10240, 27, 256, 256, 1),
    (30208, 27, 128, 128, 3), (500, 27, 64, 64, 1)])
def test_dw_splits_fill_the_card(n_in, k, cin, cout, want):
    s = window_conv.dw_splits(n_in, k, cin, cout)
    assert s == want
    tm = 16 if cin <= 16 else 64
    blocks = -(-cin // tm) * -(-cout // 64) * k * s
    assert blocks >= 2 * window_conv.SMS or s == n_in // 1024 or s == 1


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 27, 64, 64, 64), (30208, 27, 128, 128, 20),
    (10240, 27, 256, 256, 5), (45056, 27, 96, 96, 20),
    (90112, 27, 64, 384, 14), (9293, 5, 48, 40, 9), (500, 27, 64, 64, 1)])
def test_dw_tc_splits_fill_the_card(n_in, k, cin, cout, want):
    """The tensor-core body's splits: about DW_TC_WARPS_PER_SM warps on each
    SM, unless the rows run out (at least MIN_SPLIT_ROWS per split) or 64
    splits are reached; its Cout tiles (K1's) cover Cout."""
    s = window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True)
    assert s == want
    tiles, wn = window_conv.col_tiles(cout)
    assert 1 <= wn <= 4 and tiles * 64 * wn >= cout > (tiles * wn - 1) * 64
    warps = -(-cin // 64) * tiles * k * 2 * wn * s
    assert (warps >= window_conv.DW_TC_WARPS_PER_SM * window_conv.SMS
            or s == min(64, n_in // window_conv.MIN_SPLIT_ROWS) or s == 1)


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 125, 3, 32, 26), (45056, 125, 3, 32, 26), (9293, 5, 24, 40, 9),
    (9293, 5, 3, 200, 9), (500, 125, 3, 32, 1)])
def test_dw_narrow_splits_fill_the_card(n_in, k, cin, cout, want):
    """The narrow tensor-core body's splits (Cin % 16 != 0: HRNet's stem at
    90112 rows, Res16UNet34C's at 45056): blocks of DW_NARROW_WARPS warps
    per tile of 16 input channels by 32 output channels (64 past Cout 32),
    about DW_NARROW_WARPS_PER_SM warps of the grid on each SM, unless the
    rows run out (at least MIN_SPLIT_ROWS per split) or 64 splits are
    reached."""
    s = window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True)
    assert s == want
    bn = 32 if cout <= 32 else 64
    tiles = -(-cin // 16) * -(-cout // bn)
    assert tiles == window_conv.dw_narrow_tiles(cin, cout)
    warps = tiles * k * window_conv.DW_NARROW_WARPS * s
    assert (warps >= window_conv.DW_NARROW_WARPS_PER_SM * window_conv.SMS
            or s == min(64, n_in // window_conv.MIN_SPLIT_ROWS) or s == 1)
    # not far more than it aims at either
    assert warps - tiles * k * window_conv.DW_NARROW_WARPS < (
        window_conv.DW_NARROW_WARPS_PER_SM * window_conv.SMS)


@pytest.mark.parametrize("n_in,k,cin,cout", [
    (90112, 125, 3, 32), (45056, 125, 3, 32), (9293, 5, 24, 40),
    (9293, 5, 3, 32)])
def test_dw_narrow_splits_f32_match_bf16(n_in, k, cin, cout):
    """The narrow body in f32 (split TF32) takes the bf16 body's splits: its
    tiles hold the same 256 live pairs, and 26 splits measured best at
    both stems in either type (`tools/stem_splits.py`)."""
    assert window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True,
                                 dtype=torch.float32) == \
        window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True)


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 27, 64, 64, 40), (30208, 27, 128, 128, 10),
    (10240, 27, 256, 256, 3), (45056, 8, 96, 384, 11), (500, 27, 64, 64, 1)])
def test_dw_tf32_splits_fill_the_card(n_in, k, cin, cout, want):
    """The wide body's splits in f32 (split TF32, whose tiles take twice the
    bf16 body's shared memory): about DW_TF32_WARPS_PER_SM warps on each SM,
    half the bf16 body's aim, unless the rows run out or 64 splits are
    reached."""
    s = window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True,
                              dtype=torch.float32)
    assert s == want
    assert window_conv.DW_TF32_WARPS_PER_SM * 2 == \
        window_conv.DW_TC_WARPS_PER_SM
    tiles, wn = window_conv.col_tiles(cout)
    warps = -(-cin // 64) * tiles * k * 2 * wn * s
    assert (warps >= window_conv.DW_TF32_WARPS_PER_SM * window_conv.SMS
            or s == min(64, n_in // window_conv.MIN_SPLIT_ROWS) or s == 1)
    assert s <= window_conv.dw_splits(n_in, k, cin, cout, tensor_cores=True)


# -- split TF32 (the f32 bodies of K1 and dW on the tensor cores) -------------
# A CPU model of the kernels' arithmetic: each f32 operand x is split into
# hi = x rounded to TF32 (10 stored mantissa bits, round to nearest, ties to
# even: PTX cvt.rn.tf32.f32) and lo = x - hi (exact in f32), of which the
# tensor cores read the top 10 mantissa bits (the low 13 bits dropped);
# a . b ~= a_lo . b_hi + a_hi . b_lo + a_hi . b_hi, each product in f32.
# Held to the JAX package's f32 sparse conv and its VJP within the f32
# checks' 1e-4 of max|ref| on the card, at HRNet's conv shapes.

TF32_DROP = 13   # mantissa bits of f32 that TF32 does not keep


def _tf32_round(x):
    """f32 -> f32 values rounded to TF32, round to nearest, ties to even
    (integer bit operations on the f32 bits; finite inputs)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    half = np.uint32((1 << (TF32_DROP - 1)) - 1)
    odd = (u >> np.uint32(TF32_DROP)) & np.uint32(1)
    mask = np.uint32(~((1 << TF32_DROP) - 1) & 0xFFFFFFFF)
    return ((u + half + odd) & mask).view(np.float32)


def _tf32_truncate(x):
    """The TF32 operand the tensor cores read from f32 bits: the low 13
    mantissa bits dropped."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    mask = np.uint32(~((1 << TF32_DROP) - 1) & 0xFFFFFFFF)
    return (u & mask).view(np.float32)


def _split_tf32(x):
    """(hi, lo) of the split: hi TF32, lo = x - hi as the product reads it."""
    hi = _tf32_round(x)
    return hi, _tf32_truncate(x - hi)


def _tf32_product(a, b, terms=3):
    """a @ b in f32 from split-TF32 operands: the three products, small
    first (`terms` 3), or the one product hi . hi (`terms` 1)."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    if terms == 1:
        return ah @ bh
    return ((al @ bh).astype(np.float32) + (ah @ bl)).astype(np.float32) \
        + (ah @ bh)


def _partial_permutation_maps(rng, k, n_src, n_dst, live):
    """kmap [K, n_dst] and its transpose kmap_t [K, n_src]: per offset a
    `live` share of the destination rows gets a distinct source row (each
    offset map a partial permutation, as the pyramid's maps are), the rest
    the sentinel."""
    kmap = np.full((k, n_dst), n_src, np.int32)
    kmap_t = np.full((k, n_src), n_dst, np.int32)
    m = int(live * min(n_src, n_dst))
    for o in range(k):
        dst = rng.choice(n_dst, m, replace=False)
        src = rng.choice(n_src, m, replace=False)
        kmap[o, dst] = src
        kmap_t[o, src] = dst
    return kmap, kmap_t


def _gather_np(x, idx):
    rows = np.zeros((idx.shape[0], x.shape[1]), np.float32)
    ok = idx < x.shape[0]
    rows[ok] = x[idx[ok]]
    return rows


def _flat_steps_model(feats, kmap, w, terms):
    """K1's flattened steps (Cin % 16 != 0, the stems) in split TF32: the
    gathered rows of every offset side by side, IC [N_out, K*Cin], against
    W.reshape(K*Cin, Cout), in k-steps of 8 columns (zero-padded past
    K*Cin), each step's product summed into the output in f32."""
    k, cin, cout = w.shape
    ic = np.concatenate([_gather_np(feats, kmap[o]) for o in range(k)], 1)
    wf = w.reshape(k * cin, cout)
    pad = -(k * cin) % 8
    ic = np.pad(ic, ((0, 0), (0, pad)))
    wf = np.pad(wf, ((0, pad), (0, 0)))
    out = np.zeros((ic.shape[0], cout), np.float32)
    for j in range(0, ic.shape[1], 8):
        out = (out + _tf32_product(ic[:, j:j + 8], wf[j:j + 8], terms)
               ).astype(np.float32)
    return out


@pytest.mark.parametrize("what", ["forward", "dW"])
@pytest.mark.parametrize("cin,cout,k", [(32, 32, 27), (64, 128, 8),
                                        (256, 256, 27), (3, 32, 125)])
def test_split_tf32_model_matches_jax(cin, cout, k, what):
    """Three TF32 products per f32 product (the kernels' split TF32) give
    the JAX package's f32 sparse conv (forward) and its VJP's weight
    gradient (dW, over the transpose map) within 1e-4 of max|ref|, the
    tolerance the f32 bodies are held to on the card; one TF32 product
    (hi . hi alone) comes out further off. At the k5 stem (Cin 3, 125
    offsets) the forward is K1's flattened steps (`_flat_steps_model`)."""
    rng = np.random.default_rng(cin * 1000 + cout + k)
    n_in, n_out = 300, 260
    kmap, kmap_t = _partial_permutation_maps(rng, k, n_in, n_out, 0.25)
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(k, cin, cout)) / np.sqrt(cin * k)
         ).astype(np.float32)
    g = rng.normal(size=(n_out, cout)).astype(np.float32)

    def jconv(f, ww):
        return j_sparse_conv(f, jnp.asarray(kmap), ww,
                             kmap_t=jnp.asarray(kmap_t), mirror=False,
                             input_grad=False)

    if what == "forward":
        ref = np.asarray(jconv(jnp.asarray(feats), jnp.asarray(w)))
        if cin % 16:
            models = [_flat_steps_model(feats, kmap, w, terms)
                      for terms in (3, 1)]
        else:
            models = [sum(_tf32_product(_gather_np(feats, kmap[o]), w[o],
                                        terms) for o in range(k))
                      for terms in (3, 1)]
    else:
        _, vjp = jax.vjp(jconv, jnp.asarray(feats), jnp.asarray(w))
        ref = np.asarray(vjp(jnp.asarray(g))[1])
        models = [np.stack([_tf32_product(feats.T, _gather_np(g, kmap_t[o]),
                                          terms) for o in range(k)])
                  for terms in (3, 1)]
    scale = np.abs(ref).max()
    err3, err1 = (np.abs(m.astype(np.float32) - ref).max() for m in models)
    assert models[0].shape == ref.shape
    assert err3 <= 1e-4 * scale, (err3, scale)
    assert err1 > err3, (err1, err3)


IM2COL_SUPER_TILE = 256   # rows of the im2col backward's super-tile


def _im2col_bwd_model(feats, g, kmap_t, w, terms, input_grad):
    """The split-TF32 im2col backward's summation order: GG [N_in, K*Cout]
    gathered once, d_feats = GG @ WT (WT [K*Cout, Cin] the stacked
    transposed weights) in k-steps of 8 columns of K*Cout, each step's
    product added in f32; dW_flat = feats^T @ GG in k-steps of 8 rows within
    a super-tile of IM2COL_SUPER_TILE rows, each step's product added in f32
    to the super-tile's sum, which is added once to the running dW.
    Returns (d_feats or None, dW_t [K, Cin, Cout])."""
    k, cin, cout = w.shape
    n_in = feats.shape[0]
    gg = np.concatenate([_gather_np(g, kmap_t[o]) for o in range(k)], 1)
    d_feats = None
    if input_grad:
        wt = np.ascontiguousarray(w.transpose(0, 2, 1).reshape(k * cout, cin))
        d_feats = np.zeros((n_in, cin), np.float32)
        for j in range(0, k * cout, 8):
            d_feats = (d_feats + _tf32_product(gg[:, j:j + 8], wt[j:j + 8],
                                               terms)).astype(np.float32)
    dw = np.zeros((cin, k * cout), np.float32)
    for m0 in range(0, n_in, IM2COL_SUPER_TILE):
        tile = np.zeros_like(dw)
        for r in range(m0, min(m0 + IM2COL_SUPER_TILE, n_in), 8):
            tile = (tile + _tf32_product(feats[r:r + 8].T, gg[r:r + 8], terms)
                    ).astype(np.float32)
        dw = (dw + tile).astype(np.float32)
    return d_feats, dw.reshape(cin, k, cout).transpose(1, 0, 2)


@pytest.mark.parametrize("cin,cout,k,input_grad", [
    (32, 32, 27, True), (256, 256, 27, True), (48, 40, 5, True),
    (3, 32, 125, False)])
def test_split_tf32_im2col_bwd_model_matches_jax(cin, cout, k, input_grad):
    """The split-TF32 im2col backward's arithmetic (`_im2col_bwd_model`:
    three TF32 products per f32 product, each k-step of 8 columns (d_feats)
    or 8 rows (dW) added in f32, dW summed per 256-row super-tile) gives the
    JAX package's f32 sparse conv VJP, d_feats and dW over the transpose
    map, within 1e-4 of max|ref|, the tolerance the f32 body is held to on
    the card; one TF32 product (hi . hi alone) comes out further off. The
    k5 stem (Cin 3, 125 offsets) takes dW only, as the model's stem does;
    48 -> 40 leaves part k-steps and chunks of K*Cout."""
    rng = np.random.default_rng(cin * 1000 + cout + k + 7)
    n_in, n_out = 300, 260
    kmap, kmap_t = _partial_permutation_maps(rng, k, n_in, n_out, 0.25)
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(k, cin, cout)) / np.sqrt(cin * k)
         ).astype(np.float32)
    g = rng.normal(size=(n_out, cout)).astype(np.float32)

    def jconv(f, ww):
        return j_sparse_conv(f, jnp.asarray(kmap), ww,
                             kmap_t=jnp.asarray(kmap_t), mirror=False,
                             input_grad=input_grad)

    _, vjp = jax.vjp(jconv, jnp.asarray(feats), jnp.asarray(w))
    ref_df, ref_dw = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    models = [_im2col_bwd_model(feats, g, kmap_t, w, terms, input_grad)
              for terms in (3, 1)]
    pairs = [(1, ref_dw)] + ([(0, ref_df)] if input_grad else [])
    for i, ref in pairs:
        scale = np.abs(ref).max()
        assert models[0][i].shape == ref.shape
        err3, err1 = (np.abs(m[i].astype(np.float32) - ref).max()
                      for m in models)
        assert err3 <= 1e-4 * scale, (i, err3, scale)
        assert err1 > err3, (i, err1, err3)


@pytest.mark.parametrize("name", ["dw_unroll_4", "skip_dfeats",
                                  "skip_dw_ksteps", "skip_dw_groups",
                                  "skip_both"])
def test_im2col_bwd_designs_apply_to_the_shipped_source(name):
    """`tools/im2col_bwd_designs.py` builds its designs as text variants of
    the shipped split-TF32 backward: each substitution finds its text in
    `csrc/sparse_conv_im2col_bwd.cu` (the tool raises when the source has
    moved on), changes only the split-TF32 body, and the skip designs record
    the live masks and read them."""
    from csn_tpu_torch.tools import im2col_bwd_designs as designs

    shipped = designs.SOURCE.read_text()
    text = designs.variant(name, shipped)
    assert text != shipped
    head = shipped.index("// --- the split-TF32 body")
    assert text[:head] == shipped[:head]
    if name.startswith("skip"):
        assert "__ballot_sync" in text and "masks[" in text
        assert "mk[" in text or "lv[" in text
    with pytest.raises(RuntimeError, match="changed"):
        designs.variant(name, shipped.replace("#pragma unroll 8\n      for "
                                              "(int ks = 0; ks < SR / 8",
                                              "for (int ks = 0; ks < SR / 8")
                        .replace("  // NST stages (GG, WT), one feats tile\n",
                                 ""))


def test_tf32_rounding_ties_to_even():
    """`_tf32_round` keeps 10 mantissa bits, rounds to nearest with ties to
    even, and `_split_tf32`'s hi + lo is x to within lo's dropped bits."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([one + ulp / 2, one + 1.5 * ulp, one + ulp / 4,
                  one + 0.75 * ulp, -(one + 1.5 * ulp)], np.float32)
    want = np.array([one, one + 2 * ulp, one, one + ulp, -(one + 2 * ulp)],
                    np.float32)
    np.testing.assert_array_equal(_tf32_round(x), want)
    y = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi, lo = _split_tf32(y)
    assert np.array_equal(_tf32_round(hi), hi)
    assert np.abs((hi + lo) - y).max() <= 2.0 ** -21 * np.abs(y).max()


def test_dw_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_dw(torch.zeros(4, 3), torch.zeros(5, 8),
                                   torch.zeros(27, 4, dtype=torch.int32))


# -- the im2col form (CSN_DYNG=2/3) -------------------------------------------
# The JAX im2col Pallas kernels run on a TPU only, so the reference is the
# JAX plain path (the gather form they are held to in test_window_jobs.py).

IM2COL_CASES = [
    ("same0k5", 3, 32, False), ("same0k3", 32, 64, True),
    ("same1k3", 64, 64, True), ("down0k3", 32, 64, True),
    ("up0k3", 64, 32, True)]


def _conv_inputs(big, map_name, cin, cout, seed):
    kmap = big.kmaps[map_name]
    t_name, mirror = conv.transpose_map_name(map_name)
    kmap_t = big.kmaps[t_name]
    n_in = big.masks[map_levels(map_name)[0]].numel()
    rng = np.random.default_rng(seed + sum(map_name.encode()))
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(kmap.shape[0], cin, cout)).astype(np.float32)
    g = rng.normal(size=(kmap.shape[1], cout)).astype(np.float32)
    return kmap, kmap_t, mirror, feats, w, g


def _port_conv(mode, feats, w, g, kmap, kmap_t, mirror, input_grad,
               dtype=torch.float32):
    tf = torch.from_numpy(feats).to(dtype).requires_grad_(input_grad)
    tw = torch.from_numpy(w).requires_grad_(True)
    with window_conv.dyng(mode):
        out = conv.sparse_conv(tf, kmap, tw, kmap_t, mirror)
        out.backward(torch.from_numpy(g).to(dtype))
    return (out.detach().float().numpy(), tw.grad.numpy(),
            tf.grad.float().numpy() if input_grad else None)


@pytest.mark.parametrize("mode", [2, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("map_name,cin,cout,input_grad", IM2COL_CASES)
def test_im2col_conv_matches_jax(big, map_name, cin, cout, input_grad, dtype,
                                 tol, mode):
    """Forward, dW and d_feats of the port in modes 2 and 3 against the JAX
    `sparse_conv` and its `jax.vjp`, f32 operands on the JAX side."""
    kmap, kmap_t, mirror, feats, w, g = _conv_inputs(big, map_name, cin,
                                                     cout, 11)
    if dtype == torch.bfloat16:   # both sides see the rounded operands
        feats, g = (torch.from_numpy(x).to(dtype).float().numpy()
                    for x in (feats, g))
        w_ref = torch.from_numpy(w).to(dtype).float().numpy()
    else:
        w_ref = w
    ref, vjp = jax.vjp(
        lambda f, ww: j_sparse_conv(f, jnp.asarray(kmap.numpy()), ww,
                                    kmap_t=jnp.asarray(kmap_t.numpy()),
                                    mirror=mirror, input_grad=input_grad),
        jnp.asarray(feats), jnp.asarray(w_ref))
    ref_df, ref_dw = map(np.asarray, vjp(jnp.asarray(g)))
    out, dw, df = _port_conv(mode, feats, w, g, kmap, kmap_t, mirror,
                             input_grad, dtype)
    for got, want in ((out, np.asarray(ref)), (dw, ref_dw)) + (
            ((df, ref_df),) if input_grad else ()):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("map_name,cin,cout,input_grad", IM2COL_CASES)
def test_im2col_mode_matches_mode_0(big, map_name, cin, cout, input_grad):
    """The port's two forms of the conv agree on the same inputs."""
    kmap, kmap_t, mirror, feats, w, g = _conv_inputs(big, map_name, cin,
                                                     cout, 13)
    a = _port_conv(0, feats, w, g, kmap, kmap_t, mirror, input_grad)
    b = _port_conv(2, feats, w, g, kmap, kmap_t, mirror, input_grad)
    for x, y in zip(a, b):
        if x is not None:
            _close(y, x)


def test_im2col_unstack_order_is_pinned():
    """dW_flat [Cin, K*Cout] unstacks as [Cin, K, Cout] -> [K, Cin, Cout];
    reading it as [K, Cin, Cout] directly gives another tensor."""
    cin, k, cout = 3, 5, 4
    flat = torch.arange(cin * k * cout, dtype=torch.float32).reshape(
        cin, k * cout)
    got = conv.unstack_dw(flat, k)
    assert got.shape == (k, cin, cout)
    for kk in range(k):
        for c in range(cin):
            np.testing.assert_array_equal(
                got[kk, c].numpy(),
                flat[c, kk * cout:(kk + 1) * cout].numpy())
    assert not torch.equal(got, flat.reshape(k, cin, cout))


def test_im2col_stacked_weights_order_is_pinned():
    """WT[k*Cout + d, c] = W_pair[k, c, d]."""
    k, cin, cout = 4, 3, 5
    w = torch.arange(k * cin * cout, dtype=torch.float32).reshape(k, cin,
                                                                  cout)
    wt = conv.stack_pair_transposed(w)
    assert wt.shape == (k * cout, cin)
    assert wt[2 * cout + 3, 1] == w[2, 1, 3]
    assert not torch.equal(wt, w.reshape(k * cout, cin))


def test_im2col_bwd_plain_mirror_matters(big):
    """With asymmetric weights, the mirrored and the unmirrored pairing give
    another d_feats and another offset order of dW."""
    kmap = big.kmaps["same0k3"]
    rng = np.random.default_rng(3)
    n = kmap.shape[1]
    feats = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (27, 8, 8)).astype(np.float32))
    right_df, right_dw = conv.conv_im2col_bwd_plain(feats, g, kmap, w, True,
                                                    True)
    wrong_df, wrong_dw = conv.conv_im2col_bwd_plain(feats, g, kmap, w, False,
                                                    True)
    assert (right_df - wrong_df).abs().max() > 0.1 * right_df.abs().max()
    assert torch.equal(right_dw, wrong_dw.flip(0))
    assert (right_dw - wrong_dw).abs().max() > 0.1 * right_dw.abs().max()
    ref_df, ref_dw = conv.conv_bwd_plain(feats, g, kmap, w, True, True)
    _close(right_df.numpy(), ref_df.numpy())
    _close(right_dw.numpy(), ref_dw.numpy())


def test_im2col_plain_walks_rows_in_chunks(big, monkeypatch):
    """The plain versions give the same result whatever their row chunk."""
    kmap, kmap_t, mirror, feats, w, g = _conv_inputs(big, "same1k3", 16, 8,
                                                     17)
    f, ww, gg = (torch.from_numpy(x) for x in (feats, w, g))
    ref = conv.conv_im2col_plain(f, kmap, ww)
    ref_b = conv.conv_im2col_bwd_plain(f, gg, kmap_t, ww, mirror, True)
    monkeypatch.setattr(conv, "IM2COL_PLAIN_ROWS", 37)
    _close(conv.conv_im2col_plain(f, kmap, ww).numpy(), ref.numpy())
    got_b = conv.conv_im2col_bwd_plain(f, gg, kmap_t, ww, mirror, True)
    _close(got_b[0].numpy(), ref_b[0].numpy())
    _close(got_b[1].numpy(), ref_b[1].numpy())


def test_im2col_launchers_refuse_cpu_tensors():
    kmap = torch.zeros(27, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_im2col_fwd(torch.zeros(4, 3), kmap,
                                           torch.zeros(27, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_im2col_bwd(
            torch.zeros(4, 3), torch.zeros(5, 8), kmap,
            torch.zeros(27 * 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        window_conv.sparse_conv_im2col_bwd(
            torch.zeros(4, 3), torch.zeros(5, 8), kmap, None, dw_only=True)


@pytest.mark.parametrize("value", ["0", "1", "2", "3", "4", "", "junk", None])
def test_dyng_mode_matches_jax(value, monkeypatch):
    from csn_tpu.core.window_conv import dyng_mode as j_dyng_mode

    if value is None:
        monkeypatch.delenv("CSN_DYNG", raising=False)
    else:
        monkeypatch.setenv("CSN_DYNG", value)
    assert window_conv.dyng_mode() == j_dyng_mode()
    with window_conv.dyng(2):
        assert window_conv.dyng_mode() == j_dyng_mode() == 2
        with window_conv.dyng(None):
            assert window_conv.dyng_mode() == 0
        assert window_conv.dyng_mode() == 2
    assert window_conv.dyng_mode() == j_dyng_mode()
    import os
    assert os.environ.get("CSN_DYNG") == value


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 27, 64, 64, 470), (90112, 125, 3, 32, 470),
    (10240, 27, 256, 256, 54), (30208, 27, 128, 128, 236),
    (500, 27, 64, 64, 8)])
def test_im2col_bwd_splits_bounded(n_in, k, cin, cout, want):
    s = window_conv.im2col_bwd_splits(n_in, k, cin, cout)
    assert s == want
    assert s <= -(-n_in // window_conv.IM2COL_TILE)
    assert s * cin * k * cout * 4 <= window_conv.IM2COL_PART_BYTES or s == 1


IM2COL_TC_RULE_CASES = [
    (torch.bfloat16, 32, 64, True), (torch.bfloat16, 3, 32, True),
    (torch.bfloat16, 24, 64, True), (torch.bfloat16, 48, 40, True),
    (torch.bfloat16, 160, 200, True), (torch.bfloat16, 32, 60, False),
    (torch.bfloat16, 3, 30, False), (torch.float32, 32, 64, True),
    (torch.float32, 3, 32, True)]


@pytest.mark.parametrize("dtype,cin,cout,want", IM2COL_TC_RULE_CASES)
def test_im2col_tensor_cores_rule(dtype, cin, cout, want):
    """The im2col pair's tensor-core bodies take bf16, and f32 in split
    TF32, with Cout % 8 == 0 whatever Cin (the rule
    `csn_sparse_conv_im2col_fwd` and `_bwd` apply, K1's): the stem's Cin of
    3 and a Cin off the multiples of 16 included; a Cout off the multiples
    of 8 runs the CUDA-core bodies in either type. The split-TF32 launches
    count apart (`k1_split_tf32`)."""
    assert window_conv.im2col_tensor_cores(dtype, cin, cout) is want
    assert window_conv.k1_tensor_cores(dtype, cin, cout) is want
    assert window_conv.k1_split_tf32(dtype, cin, cout) is (
        want and dtype == torch.float32)


@pytest.mark.parametrize("dtype,cin,cout,want",
                         TC_RULE_CASES + IM2COL_TC_RULE_CASES)
def test_k1_and_im2col_rules_agree(dtype, cin, cout, want):
    """K1, dW and the im2col pair take their tensor-core bodies at the same
    convs, in both types: K1 and the im2col forward share one body (bf16,
    and f32 in split TF32), and the im2col backward's bodies follow the same
    rule."""
    k1 = window_conv.k1_tensor_cores(dtype, cin, cout)
    assert k1 is want
    assert window_conv.dw_tensor_cores(dtype, cin, cout) is k1
    assert window_conv.im2col_tensor_cores(dtype, cin, cout) is k1


@pytest.mark.parametrize("n_in,k,cin,cout,want", [
    (90112, 27, 64, 64, 118), (90112, 125, 3, 32, 118),
    (10240, 27, 256, 256, 20), (30208, 27, 128, 128, 59),
    (45056, 8, 96, 384, 59), (1792, 8, 384, 384, 7),
    (35917, 5, 48, 40, 71), (35917, 5, 160, 200, 36),
    (90112, 640, 256, 256, 3), (500, 27, 64, 64, 2), (200, 27, 64, 64, 1),
    (0, 27, 64, 64, 1)])
def test_im2col_bwd_tc_splits(n_in, k, cin, cout, want):
    """The tensor-core backward's splits at the kernel's tiles (256-row
    super-tiles, 64 input channels per block, 16 for the stem): whole
    super-tiles per split, spread so that no split is empty, about one
    block (split x channel tile) per SM, partials within
    IM2COL_PART_BYTES, one split when the rows fit one super-tile."""
    rows, bc = 256, 16 if cin <= 16 else 64
    s = window_conv.im2col_bwd_tc_splits(n_in, k, cin, cout, rows, bc)
    assert s == want
    n_st = max(1, -(-n_in // rows))
    per = -(-n_st // s)                  # super-tiles per split, as the kernel
    assert (s - 1) * per < n_st <= s * per
    assert s * cin * k * cout * 4 <= window_conv.IM2COL_PART_BYTES or s == 1
    tiles = -(-cin // bc)
    assert s * tiles <= window_conv.SMS or s == 1
    # and not far fewer blocks than SMs, unless the rows or the budget end
    assert s == n_st or 2 * s * tiles > window_conv.SMS or (
        s + 1) * cin * k * cout * 4 > window_conv.IM2COL_PART_BYTES
    if n_in <= rows:
        assert s == 1


def test_im2col_fwd_refuses_a_misaligned_bf16_view(monkeypatch):
    """The im2col forward's tensor-core bodies (K1's: bf16, and f32 in split
    TF32, with Cout % 8 == 0) copy the weights, and feats where Cin % 16 ==
    0 (K1's loop), 16 bytes at a time with cp.async:
    `sparse_conv_im2col_fwd` refuses such a view that does not start on a
    16-byte boundary before the launch, in both types. Aligned calls, and
    misaligned ones that no 16-byte copy reads (the stem's feats, which the
    flattened steps gather element by element, in bf16 and f32; a Cout off
    the multiples of 8, on the CUDA-core body in either type), get as far
    as the library."""
    _stub_launch(monkeypatch)
    view = _meta_view
    n_in, n_out, k = 10, 7, 27
    kmap = torch.empty(k, n_out, dtype=torch.int32, device="meta")
    bf, f32 = torch.bfloat16, torch.float32
    before = dict(kernels.LAUNCHES)
    for cin, dt, fs, ws in ((32, bf, 1, 0), (32, bf, 0, 1), (3, bf, 0, 1),
                            (32, f32, 1, 1), (32, f32, 1, 0), (3, f32, 0, 1)):
        with pytest.raises(ValueError, match="16-byte"):
            window_conv.sparse_conv_im2col_fwd(
                view(n_in, cin, dtype=dt, shift=fs), kmap,
                view(k, cin, 64, dtype=dt, shift=ws))
    for cin, cout, dt, fs, ws in ((32, 64, bf, 0, 0), (3, 32, bf, 1, 0),
                                  (32, 60, bf, 1, 1), (32, 64, f32, 0, 0),
                                  (3, 32, f32, 1, 0), (32, 60, f32, 1, 1)):
        with pytest.raises(LookupError, match="reached the launch"):
            window_conv.sparse_conv_im2col_fwd(
                view(n_in, cin, dtype=dt, shift=fs), kmap,
                view(k, cin, cout, dtype=dt, shift=ws))
    assert kernels.LAUNCHES == before


def test_im2col_bwd_refuses_a_misaligned_bf16_view(monkeypatch):
    """The im2col backward's tensor-core bodies (bf16, and f32 in split
    TF32, with Cout % 8 == 0) copy g, and feats and wt_flat where their rows
    are 16-byte pieces (Cin % 8 == 0 in bf16, Cin % 4 == 0 in f32), 16
    bytes at a time with cp.async: `sparse_conv_im2col_bwd` refuses such a
    view that does not start on a 16-byte boundary before the launch.
    Aligned calls, and misaligned ones that no 16-byte copy reads (the
    stem's feats and wt_flat, element by element; bf16 feats at Cin 12; a
    Cout off the multiples of 8, on the CUDA-core body in either type), get
    as far as the library."""
    _stub_launch(monkeypatch)
    view = _meta_view
    n_in, n_g, k = 10, 7, 27
    kmap_t = torch.empty(k, n_in, dtype=torch.int32, device="meta")
    bf, f32 = torch.bfloat16, torch.float32
    before = dict(kernels.LAUNCHES)
    for cin, dt, fs, gs, ws, dw_only in (
            (32, bf, 1, 0, 0, False), (32, bf, 0, 1, 0, False),
            (32, bf, 0, 0, 1, False), (32, bf, 1, 0, 0, True),
            (3, bf, 0, 1, 0, True), (32, f32, 1, 1, 1, False),
            (32, f32, 0, 0, 1, False), (12, f32, 1, 0, 0, True),
            (3, f32, 0, 1, 0, True)):
        with pytest.raises(ValueError, match="16-byte"):
            window_conv.sparse_conv_im2col_bwd(
                view(n_in, cin, dtype=dt, shift=fs),
                view(n_g, 64, dtype=dt, shift=gs), kmap_t,
                None if dw_only else view(k * 64, cin, dtype=dt, shift=ws),
                dw_only=dw_only)
    for cin, cout, dt, fs, gs, ws in ((32, 64, bf, 0, 0, 0),
                                      (3, 32, bf, 1, 0, 1),
                                      (12, 32, bf, 1, 0, 1),
                                      (32, 60, bf, 1, 1, 1),
                                      (32, 64, f32, 0, 0, 0),
                                      (3, 32, f32, 1, 0, 1),
                                      (32, 60, f32, 1, 1, 1)):
        for dw_only in (False, True):
            with pytest.raises(LookupError, match="reached the launch"):
                window_conv.sparse_conv_im2col_bwd(
                    view(n_in, cin, dtype=dt, shift=fs),
                    view(n_g, cout, dtype=dt, shift=gs), kmap_t,
                    None if dw_only
                    else view(k * cout, cin, dtype=dt, shift=ws),
                    dw_only=dw_only)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("with_t", [False, True])
def test_sparse_conv_with_bias_matches_jax(big, with_t):
    """Forward (and with the transpose map, every gradient through the
    gather backward) against the JAX `sparse_conv_with_bias`, f32."""
    kmap, kmap_t, mirror, feats, w, g = _conv_inputs(big, "same1k3", 16, 24,
                                                     19)
    bias = np.random.default_rng(5).normal(size=24).astype(np.float32)
    kw = dict(kmap_t=kmap_t, mirror=mirror) if with_t else {}
    j_kw = (dict(kmap_t=jnp.asarray(kmap_t.numpy()), mirror=mirror)
            if with_t else {})
    ref, vjp = jax.vjp(
        lambda f, ww, b: j_sparse_conv_with_bias(
            f, jnp.asarray(kmap.numpy()), ww, b, **j_kw),
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(bias))
    tf, tw, tb = (torch.from_numpy(x).requires_grad_(True)
                  for x in (feats, w, bias))
    out = conv.sparse_conv_with_bias(tf, kmap, tw, tb, **kw)
    _close(out.detach().numpy(), np.asarray(ref))
    from csn_tpu_torch.core import sparse_conv_with_bias
    assert sparse_conv_with_bias is conv.sparse_conv_with_bias
    out.backward(torch.from_numpy(g))
    for got, want in zip((tf.grad, tw.grad, tb.grad),
                         vjp(jnp.asarray(g))):
        _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(37, 5), (3, 11, 4)])
def test_masked_fill_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    feats = rng.normal(size=shape).astype(np.float32)
    mask = rng.random(shape[:-1]) < 0.6
    got = conv.masked_fill(torch.from_numpy(feats), torch.from_numpy(mask))
    ref = np.asarray(j_masked_fill(jnp.asarray(feats), jnp.asarray(mask)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got.numpy()[~mask].any()

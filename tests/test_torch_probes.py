"""Port: the probes (`csn_tpu_torch/probes/`): their plain versions against
the probe scripts' own Pallas kernels, run through the Pallas interpreter on
the CPU (`csn_tpu.ops.flash.interpret_mode`), on the scripts' inputs.

The scripts are loaded with importlib (they are no package); loading one sets
`jax_compilation_cache_dir`, which is restored afterwards. Every body of the
scripts runs under the interpreter here, `pltpu.bitcast` included, so each
comparison is against the Pallas kernel's output itself (captured from
`pl.pallas_call`), and also against the scripts' numpy `want = win[rel]`.

Tolerances: the gathers and slot loads are exact (0); the accumulations over
9 offsets 1e-5 x max|ref| in f32, and with the script's bf16 window against
the one-hot product (whose MXU-style product rounds the same bf16 values)
1e-5 x max|ref| as well. The emulation of the card's one-hot product with
an f32 window (three bf16 parts, `dyngather.gather_accum_onehot`) is held
to the plain version within 1e-5 x max|ref| (its f32 sums round three
times per offset), and one part alone must miss 1e-4 x max|ref|, the
kernel's tolerance on the card.

The launch geometry the wrappers compute (`accum_launch`, `window_launch`)
and their refusals are checked on meta tensors, with the kernel library
stubbed: there is no card here.
"""

import contextlib
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from csn_tpu.ops.flash import interpret_mode
from csn_tpu_torch import kernels
from csn_tpu_torch.probes import dyngather, dyngather2, iw_bwd

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@functools.lru_cache(maxsize=None)
def _script(name):
    saved = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            f"_probe_script_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return mod


@contextlib.contextmanager
def _captured_pallas():
    """Within: every `pl.pallas_call` runs under the interpreter and its
    output is appended to the yielded list."""
    outs = []
    with interpret_mode():
        inner = pl.pallas_call

        def capture(*args, **kwargs):
            call = inner(*args, **kwargs)

            def run(*xs):
                out = call(*xs)
                outs.append(np.asarray(out, np.float32))
                return out

            return run

        pl.pallas_call = capture
        try:
            yield outs
        finally:
            pl.pallas_call = inner


def test_loading_a_script_leaves_the_cache_dir_alone():
    before = jax.config.jax_compilation_cache_dir
    _script("probe_dyngather")
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("body,layout,dtype", [
    ("k_take", 0, "float32"), ("k_take_along", 0, "float32"),
    ("k_take", 0, "bfloat16"), ("k_take_along_t", 1, "float32")])
def test_window_gather_matches_the_script_kernel(body, layout, dtype):
    mod = _script("probe_dyngather")
    assert (mod.T, mod.W, mod.C) == (dyngather.T, dyngather.W, dyngather.C)
    with _captured_pallas() as outs:
        assert mod.run(body, getattr(mod, body), getattr(jnp, dtype))
    win, rel, want = dyngather.probe_inputs()
    tdt = getattr(torch, dtype)
    got = dyngather.window_gather(torch.from_numpy(win).to(tdt),
                                  torch.from_numpy(rel), layout)
    assert got.dtype == tdt and got.shape == (dyngather.T, dyngather.C)
    np.testing.assert_array_equal(got.float().numpy(), outs[0])
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("body,layout,W,dtype", [
    ("k_matched_sublane", 0, 384, "float32"),
    ("k_matched_sublane", 0, 256, "float32"),
    ("k_matched_sublane", 0, 384, "bfloat16"),
    ("k_matched_lane", 1, 256, "float32")])
def test_matched_gather_matches_the_script_kernel(body, layout, W, dtype):
    mod = _script("probe_dyngather2")
    T = 256
    with _captured_pallas() as outs:
        assert mod.run(body, getattr(mod, body), W, T, getattr(jnp, dtype))
    win, rel, want = dyngather.probe_inputs(W, T, dyngather2.C)
    tdt = getattr(torch, dtype)
    got = dyngather2.matched_gather(torch.from_numpy(win).to(tdt),
                                    torch.from_numpy(rel), layout)
    assert got.shape == (T, dyngather2.C)
    np.testing.assert_array_equal(got.float().numpy(), outs[0][:T])
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="row ids"):
        dyngather2.matched_gather(torch.zeros(4, 8), torch.zeros(
            5, dtype=torch.int32))


def _pallas_accum(mod, mode, rows, win, n_tiles, k, t, w, c, **kw):
    kern = functools.partial(mod._timing_kernel, mode=mode, k_offsets=k, **kw)
    with interpret_mode():
        return np.asarray(pl.pallas_call(
            kern, grid=(n_tiles,),
            in_specs=[pl.BlockSpec((k, t), lambda i: (i, 0)),
                      pl.BlockSpec((w, c), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((t, c), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((n_tiles * t, c), jnp.float32),
        )(jnp.asarray(rows), win))


@pytest.mark.parametrize("script,mode,dtype", [
    ("probe_dyngather", "onehot", "bfloat16"),
    ("probe_dyngather", "take", "bfloat16"),
    ("probe_dyngather2", "onehot", "float32"),
    ("probe_dyngather2", "gather", "float32")])
def test_gather_accum_matches_the_script_timing_kernel(script, mode, dtype):
    """The scripts' timing geometry (T=256, W=384, C=128, 9 offsets) on 2
    tiles, with row ids outside the window mixed in."""
    mod = _script(script)
    T, W, C, k, n_tiles = 256, 384, 128, 9, 2
    rng = np.random.default_rng(2)
    rows = rng.integers(0, W, size=(n_tiles * k, T)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = W + 5   # beyond the window
    rows[0, :7] = -1
    win = rng.normal(size=(W, C)).astype(np.float32)
    kw = dict(W=W, T=T) if script == "probe_dyngather2" else {}
    ref = _pallas_accum(mod, mode, rows, jnp.asarray(win, getattr(jnp, dtype)),
                        n_tiles, k, T, W, C, **kw)
    twin = torch.from_numpy(win).to(getattr(torch, dtype))
    if (script, mode) == ("probe_dyngather2", "onehot"):
        # that body rounds its f32 window to bf16 for the one-hot product
        twin = twin.bfloat16().float()
    trows = torch.from_numpy(rows)
    for port_mode in dyngather.MODES:    # on the CPU: one plain version
        got = dyngather.gather_accum(trows, twin, k, port_mode).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(ref).max() > 3.0


@pytest.mark.parametrize("variant", sorted(iw_bwd.VARIANTS))
def test_slot_load_matches_the_script_kernel(variant, monkeypatch):
    mod = _script("probe_iw_bwd")
    assert (mod.NB, mod.W, mod.CP) == (iw_bwd.NB, iw_bwd.W, iw_bwd.CP)
    names = []
    monkeypatch.setattr(
        mod, "probe", functools.partial(_named_probe, mod.probe, names))
    with _captured_pallas() as outs:
        mod.main()
        mod.extra()
    assert len(outs) == 7 and all(ok for _, ok in names)
    by_name = {name.split()[0]: out for (name, _), out in zip(names, outs)}
    x = torch.from_numpy(iw_bwd.probe_input(variant))
    got = iw_bwd.slot_load(variant, x)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), by_name[f"P{variant}"])
    assert iw_bwd.VARIANTS[variant][0].split()[0] == f"P{variant}"
    assert float(got.abs().max()) > 0.5


def _named_probe(inner, names, name, shape, dtype, body):
    ok = inner(name, shape, dtype, body)
    names.append((name, ok))
    return ok


def test_probe_mains_print_the_scripts_lines(capsys, monkeypatch):
    # the entry points time the scripts' 352 tiles: two tiles will do here
    for mod in (dyngather, dyngather2):
        monkeypatch.setattr(mod, "time_modes", functools.partial(
            mod.time_modes, n_tiles=2, iters=1))
    res = dyngather.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert set(res) == {"onehot", "smem", "global"}
    for line in ("take(axis=0) f32", "take_along_axis(axis=0) f32",
                 "take(axis=0) bf16", "take_along_axis lane-dim via T"):
        assert f"{line:40s} LAUNCHES  max_err=" in out
    assert out.count("timing ") == 3 and "us/(tile x 9 offsets)" in out
    dyngather2.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("LAUNCHES  max_err=0.00e+00") == 3
    assert "matched lane gather (transposed)" in out and "float32" in out
    errs = iw_bwd.main(["--device", "cpu", "--extra"])
    out = capsys.readouterr().out
    assert sorted(errs) == [1, 2, 3, 4, 5, 6, 7]
    assert out.count("LAUNCHES  max_err=0.00e+00") == 7
    assert not any(kernels.LAUNCHES[k] for k in (
        "probe_window_gather", "probe_gather_accum", "probe_slot_load"))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    win = torch.zeros(8, 4)
    rel = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        dyngather.window_gather(win, rel.long())
    with pytest.raises(ValueError, match="layout"):
        dyngather.window_gather(win, rel, 2)
    with pytest.raises(ValueError, match="win \\[W, C\\]"):
        dyngather.window_gather(win[0], rel)
    rows = torch.zeros(6, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        dyngather.gather_accum(rows, win, 3, "dma")
    with pytest.raises(ValueError, match="n_tiles"):
        dyngather.gather_accum(rows, win, 4, "smem")
    with pytest.raises(TypeError, match="int32"):
        dyngather.gather_accum(rows.long(), win, 3)
    with pytest.raises(ValueError, match="variant"):
        iw_bwd.slot_load(8, torch.zeros(8, 512))
    with pytest.raises(ValueError, match="wants x f32"):
        iw_bwd.slot_load(3, torch.zeros(8, 512))
    with pytest.raises(ValueError, match="wants x f32"):
        iw_bwd.slot_load(1, torch.zeros(8, 512, dtype=torch.float64))


def _wrapper_args(name, device):
    t = lambda *s: torch.zeros(*s, device=device)
    i = lambda *s: torch.zeros(*s, dtype=torch.int32, device=device)
    return {"window_gather": lambda: (t(384, 128), i(256)),
            "gather_accum": lambda: (i(18, 256), t(384, 128), 9, "smem"),
            "slot_load": lambda: (1, t(8, 512))}[name]()


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", ["window_gather", "gather_accum",
                                  "slot_load"])
def test_wrappers_take_the_plain_version_for_cpu_tensors_only(name, device):
    """One wrapper per kernel: a CPU tensor takes the plain version, and a
    tensor that lies neither on the CPU nor on the card raises (it is never
    handed to the plain version). Neither counts a launch."""
    mod = iw_bwd if name == "slot_load" else dyngather
    args = _wrapper_args(name, device)
    if device == "cpu":
        out = getattr(mod, name)(*args)
        assert out.device.type == "cpu" and float(out.abs().max()) == 0.0
    else:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(mod, name)(*args)
    assert not any(kernels.LAUNCHES[k] for k in (
        "probe_window_gather", "probe_gather_accum", "probe_slot_load"))


# ---------------------------------------------------------------------------
# the one-hot product's f32 split, as the card's kernel computes it
# ---------------------------------------------------------------------------

def _accum_case(W, n_tiles=2, k=9, T=256, C=128):
    """The scripts' timing geometry on `n_tiles` tiles with row ids outside
    the window mixed in (seed 2, as the scripts)."""
    rng = np.random.default_rng(2)
    rows = rng.integers(0, W, size=(n_tiles * k, T)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = W + 5
    rows[0, :7] = -1
    win = rng.normal(size=(W, C)).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(win)


def test_three_bf16_parts_hold_an_f32_window_exactly():
    _, win = _accum_case(384)
    parts = dyngather.split_bf16(win)
    assert [p.dtype for p in parts] == [torch.bfloat16] * 3
    total = sum(p.double() for p in parts)
    assert torch.equal(total, win.double())
    # two parts do not: the split needs its third
    assert not torch.equal(parts[0].double() + parts[1].double(),
                           win.double())


@pytest.mark.parametrize("W", [384, 256])
def test_onehot_emulation_matches_the_plain_version(W):
    """The kernel's arithmetic on an f32 window (the one-hot [T, W] in bf16
    times each bf16 part, f32 sums offset by offset) computes the plain
    version's function; the window rounded to one bf16 part would miss the
    card's tolerance."""
    k = 9
    rows, win = _accum_case(W)
    ref = dyngather.gather_accum_plain(rows, win, k)
    scale = float(ref.abs().max())
    got = dyngather.gather_accum_onehot(rows, win, k)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    one = dyngather.gather_accum_onehot(rows, win, k, parts=1)
    assert float((one - ref).abs().max()) > 1e-4 * scale
    # a bf16 window is its own single part: the three give the plain sums
    wb = win.bfloat16()
    got_b = dyngather.gather_accum_onehot(rows, wb, k)
    ref_b = dyngather.gather_accum_plain(rows, wb, k)
    assert float((got_b - ref_b).abs().max()) <= 1e-5 * scale


def test_one_bf16_part_is_the_script_onehot_body():
    """One part is what the JAX `probe_dyngather2` one-hot body computes:
    the f32 window rounded to bf16, multiplied on the matrix unit."""
    mod = _script("probe_dyngather2")
    T, W, C, k, n_tiles = 256, 384, 128, 9, 2
    rows, win = _accum_case(W, n_tiles, k, T, C)
    ref = _pallas_accum(mod, "onehot", rows.numpy(), jnp.asarray(win.numpy()),
                        n_tiles, k, T, W, C, W=W, T=T)
    got = dyngather.gather_accum_onehot(rows, win, k, parts=1).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype,W,want", [
    ("onehot", torch.bfloat16, 384, (264, 256, 384 * 136 * 2)),
    ("onehot", torch.float32, 384, (132, 384, 384 * 132 * 4)),
    ("onehot", torch.float32, 256, (132, 384, 256 * 132 * 4)),
    ("onehot", torch.bfloat16, 250, (264, 256, 256 * 136 * 2)),
    ("smem", torch.bfloat16, 384, (132, 1024, 384 * 128 * 2)),
    ("smem", torch.float32, 384, (132, 1024, 384 * 128 * 4)),
    ("smem", torch.float32, 256, (132, 1024, 256 * 128 * 4)),
    ("global", torch.bfloat16, 384, (396, 256, 0)),
    ("global", torch.float32, 256, (396, 256, 0))])
def test_accum_blocks_fill_the_card(mode, dtype, W, want):
    """The persistent grid at the probe's 352 tiles x 256 rows: the blocks
    the 132 SMs hold at once (by shared memory, the runtime's 1 KB per block
    included, and by the body's register bound), each with work."""
    n_rows, C = 352 * 256, 128
    grid, threads, smem = dyngather.accum_launch(mode, dtype, W, C, n_rows)
    assert (grid, threads, smem) == want
    per_sm = grid // dyngather.SMS
    assert grid % dyngather.SMS == 0 and per_sm >= 1
    assert per_sm * (smem + dyngather.SMEM_RESERVED) <= dyngather.SMEM_PER_SM
    assert smem <= dyngather.SMEM_BYTES
    if mode == "onehot":
        warps, blocks, pad, mt, cols = dyngather.ONEHOT[dtype]
        assert per_sm == blocks and threads == 32 * warps
        es = 2 if dtype == torch.bfloat16 else 4
        # the staged row pitch: an odd multiple of 16 bytes for ldmatrix
        # (bf16); 4 words past a multiple of 16 for the f32 fragment loads
        pitch = (C + pad) * es
        assert (pitch // 16) % 2 == 1 if es == 2 else (C + pad) % 16 == 4
        # a block's warps have items to spare
        items = -(-n_rows // (16 * mt)) * -(-C // cols)
        assert items >= grid * warps
    else:
        assert (threads, per_sm) == dyngather.GATHER[mode]
        assert -(-n_rows // dyngather.GATHER_GROUP) >= grid


@pytest.mark.parametrize("mode", sorted(dyngather.MODES))
def test_accum_grid_stops_at_the_work(mode):
    """A small call gets no more blocks than it has items, and at least
    one."""
    for n_rows, dtype in ((64, torch.float32), (8, torch.bfloat16)):
        grid, _, _ = dyngather.accum_launch(mode, dtype, 384, 128, n_rows)
        if mode == "onehot":
            _, _, _, mt, cols = dyngather.ONEHOT[dtype]
            items = -(-n_rows // (16 * mt)) * -(-128 // cols)
        else:
            items = -(-n_rows // dyngather.GATHER_GROUP)
        assert grid == items
    assert dyngather.accum_launch(mode, torch.float32, 384, 128, 352 * 256,
                                  sms=66)[0] * 2 == dyngather.accum_launch(
        mode, torch.float32, 384, 128, 352 * 256)[0]


@pytest.mark.parametrize("W,C,es,layout,want", [
    (384, 128, 4, 0, (4, 32, 384 * 32 * 4)),
    (384, 128, 4, 1, (4, 32, 32 * 385 * 4)),
    (256, 128, 4, 1, (4, 32, 32 * 257 * 4)),
    (384, 128, 2, 1, (4, 32, 32 * 386 * 2)),
    (385, 128, 4, 1, (4, 32, 32 * 385 * 4)),
    (384, 48, 2, 0, (2, 32, 384 * 32 * 2)),
    (256, 8, 2, 1, (1, 8, 8 * 258 * 2))])
def test_window_gather_slabs(W, C, es, layout, want):
    """A block per slab of up to 32 channels (C = 128: four blocks); the
    transposed slab's pitch an odd number of words, at least W elements."""
    blocks, slab, smem = dyngather.window_launch(W, C, es, layout)
    assert (blocks, slab, smem) == want
    assert (blocks - 1) * slab < C <= blocks * slab and slab <= 32
    assert slab * es % 16 == 0
    pitch = dyngather.lane_pitch(W, es)
    assert pitch >= W and (pitch * es // 4) % 2 == 1 and pitch * es % 4 == 0


# ---------------------------------------------------------------------------
# refusals, on meta tensors with the kernel library stubbed
# ---------------------------------------------------------------------------

class _Launcher:
    """Stands in for the kernel library: records each launcher's arguments
    and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.fixture
def launcher(monkeypatch):
    lib = _Launcher()
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    return lib


def _meta(*shape, dtype=torch.float32, shift=0):
    """A contiguous meta view of `shape` that starts `shift` elements into
    its storage: off a 16-byte boundary iff `shift`."""
    n = int(np.prod(shape))
    t = torch.empty(n + shift, dtype=dtype, device="meta")[shift:].view(*shape)
    assert t.is_contiguous() and bool(t.data_ptr() % 16) == bool(shift)
    return t


def _rows(n_tiles=2, k=9, t=256):
    return torch.empty(n_tiles * k, t, dtype=torch.int32, device="meta")


def test_accum_launches_with_the_grid_it_computes(launcher):
    for mode in dyngather.MODES:
        for dtype, W in ((torch.bfloat16, 384), (torch.float32, 256)):
            launcher.calls.clear()
            out = dyngather.gather_accum(_rows(), _meta(W, 128, dtype=dtype),
                                         9, mode)
            assert out.shape == (512, 128) and out.dtype == torch.float32
            args = launcher.calls["csn_probe_gather_accum"]
            grid = dyngather.accum_launch(mode, dtype, W, 128, 512)[0]
            assert args[1] == dyngather.MODES[mode]
            assert args[5:11] == (2, 9, W, 256, 128, grid)
    assert kernels.LAUNCHES["probe_gather_accum"] == 6


def test_accum_refuses_what_its_bodies_do_not_take(launcher):
    bf16, f32 = torch.bfloat16, torch.float32
    for mode in dyngather.MODES:
        # rows of 24 bytes: no 16-byte pieces
        with pytest.raises(ValueError, match="no multiple of (8|16)"):
            dyngather.gather_accum(_rows(), _meta(384, 12, dtype=bf16), 9,
                                   mode)
        with pytest.raises(ValueError, match="16-byte boundary"):
            dyngather.gather_accum(_rows(), _meta(384, 128, shift=1), 9, mode)
        with pytest.raises(ValueError, match="multiple of 8"):
            dyngather.gather_accum(_rows(t=252), _meta(384, 128), 9, mode)
    # 24 bf16 channels are 48 bytes, but no whole 16-column pair
    with pytest.raises(ValueError, match="no multiple of 16"):
        dyngather.gather_accum(_rows(), _meta(384, 24, dtype=bf16), 9,
                               "onehot")
    for mode in ("smem", "global"):
        dyngather.gather_accum(_rows(), _meta(384, 24, dtype=bf16), 9, mode)
    # f32 at the one-hot pitch: 432 rows are 228096 bytes, 433 rows pad to
    # 448 and 236544
    dyngather.gather_accum(_rows(), _meta(432, 128, dtype=f32), 9, "onehot")
    with pytest.raises(ValueError, match="does not fit"):
        dyngather.gather_accum(_rows(), _meta(433, 128, dtype=f32), 9,
                               "onehot")
    # smem: 454 x 128 f32 is the whole 232448 bytes, one row more is not
    dyngather.gather_accum(_rows(), _meta(454, 128, dtype=f32), 9, "smem")
    with pytest.raises(ValueError, match="does not fit"):
        dyngather.gather_accum(_rows(), _meta(455, 128, dtype=f32), 9, "smem")
    dyngather.gather_accum(_rows(), _meta(4000, 128, dtype=f32), 9, "global")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dyngather.gather_accum(_rows(), _meta(384, 128, dtype=torch.float64),
                               9, "global")
    assert kernels.LAUNCHES["probe_gather_accum"] == 5


def test_window_gather_refuses_what_its_bodies_do_not_take(launcher):
    rel = torch.empty(256, dtype=torch.int32, device="meta")
    for layout in (0, 1):
        launcher.calls.clear()
        with pytest.raises(ValueError, match="no multiple of 4"):
            dyngather.window_gather(_meta(384, 6), rel, layout)
        with pytest.raises(ValueError, match="16-byte boundary"):
            dyngather.window_gather(_meta(384, 128, shift=2), rel, layout)
        # a slab of 32 f32 channels: 1816 rows fit, 1817 do not (layout 1
        # pads its rows to an odd number of words: 1815 fit, 1816 do not)
        w_fit = 1816 if layout == 0 else 1815
        dyngather.window_gather(_meta(w_fit, 128), rel, layout)
        with pytest.raises(ValueError, match="does not fit"):
            dyngather.window_gather(_meta(w_fit + 1, 128), rel, layout)
        args = launcher.calls["csn_probe_window_gather"]
        assert args[1] == layout and args[5:9] == (w_fit, 256, 128, 32)
    assert kernels.LAUNCHES["probe_window_gather"] == 2


@pytest.mark.parametrize("variant", sorted(iw_bwd.VARIANTS))
def test_slot_load_bodies_read_only_what_the_kernel_fills(variant):
    """The kernel writes only the slots' first 8 rows and 128 columns (slot
    0 from x, slot 1 zeros): with anything else in the rest of the scratch
    the bodies give the plain version's bits, and x beyond those rows and
    columns changes nothing."""
    x = torch.from_numpy(iw_bwd.probe_input(variant)) * 3.0
    want = iw_bwd.slot_load_plain(variant, x)
    for rest in (123456, -7):
        assert torch.equal(iw_bwd.slot_load_filled(variant, x, rest), want)
    r, c = iw_bwd.FILLED
    far = x.clone()
    far[r:] = 1e6
    far[:, c:] = -1e6
    assert torch.equal(iw_bwd.slot_load_plain(variant, far), want)
    # the filled part does matter: a changed value there changes out
    near = x.clone()
    near[3, 5] += 4.0
    assert not torch.equal(iw_bwd.slot_load_plain(variant, near), want)


def test_slot_load_launches_once_and_refuses_x_off_16_bytes(launcher):
    for v, (_, shape, _) in iw_bwd.VARIANTS.items():
        launcher.calls.clear()
        out = iw_bwd.slot_load(v, _meta(*shape[1:]))
        assert out.shape == (8, 128) and out.dtype == torch.float32
        args = launcher.calls["csn_probe_slot_load"]
        assert args[0] == v and args[3] == 0
        with pytest.raises(ValueError, match="16-byte boundary"):
            iw_bwd.slot_load(v, _meta(*shape[1:], shift=2))
    assert kernels.LAUNCHES["probe_slot_load"] == len(iw_bwd.VARIANTS)


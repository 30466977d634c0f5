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
1e-5 x max|ref| as well.
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

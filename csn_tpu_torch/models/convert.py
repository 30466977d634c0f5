"""flax variables of the JAX package -> `state_dict` of the port's models.

The port's module attributes follow the flax module names, so the mapping
is a renaming, applied to each '/'-joined flax path in this order:

  .../MaskedBatchNorm_0/x        -> .../x  (the norm module is the BN)
  SparseConv_i, Norm_i           -> conv_i, norm_i  (inside BasicBlock)
  Conv1x1_i/Dense_0              -> conv1x1_i/linear
  stages_i_j_b                   -> stages/i/j/b
  exchange_i_j_k_s_0 / _1        -> exchange/i/j/k/s/conv / norm
  trans_i_s_0 / _1               -> trans/i/s/conv / norm
  fc1|fc2|out_head/Dense_0       -> fc1|fc2|out_head/linear
  LayerNorm_0/scale              -> layer_norm/weight
  .../MaskedInstanceNorm_0/x     -> .../x, or .../inst/x beside a
                                    MaskedBatchNorm_0 (INSTANCE_BATCH_NORM)
  .../SparseLayerNorm_0/LayerNorm_0/x -> .../x
  down_convs_l, up_norms_s, ...  -> down_convs/l, up_norms/s, ...
  enc_blocks_l_b, dec_blocks_s_b, layers_i_b, block0_b
                                 -> enc_blocks/l/b, ..., block0/b
  final|final_fc|final_out/Dense_0 -> .../linear

Sparse-conv kernels `[K, Cin, Cout]` keep their layout and offset order.
Dense kernels are `[in, out]` in flax and are TRANSPOSED into the
`[out, in]` `weight` of `nn.Linear`.

The MinkowskiEngine loaders (`convert_mink_state_dict`,
`convert_res16unet_state_dict`, `convert_resunet_state_dict`,
`load_mink_torch_checkpoint`; counterparts of `csn_tpu/models/convert.py`)
map a reference `.pth` state dict onto the same `state_dict` layout: they
build the flax-named tree the JAX package's converters build and rename it
with `flax_to_torch`, so the two packages read a released checkpoint into
the same numbers.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RULES = (
    (r"/MaskedBatchNorm_0/", "/"),
    (r"/MaskedInstanceNorm_0/", "/"),
    (r"/SparseLayerNorm_0/LayerNorm_0/", "/"),
    (r"(^|/)(down_convs|down_norms|up_convs|up_norms)_(\d+)/", r"\1\2/\3/"),
    (r"(^|/)(enc_blocks|dec_blocks|layers)_(\d+)_(\d+)/", r"\1\2/\3/\4/"),
    (r"(^|/)block0_(\d+)/", r"\1block0/\2/"),
    (r"(^|/)(final|final_fc|final_out)/Dense_0/", r"\1\2/linear/"),
    (r"(^|/)SparseConv_(\d+)/", r"\1conv_\2/"),
    (r"(^|/)Norm_(\d+)/", r"\1norm_\2/"),
    (r"(^|/)Conv1x1_(\d+)/Dense_0/", r"\1conv1x1_\2/linear/"),
    (r"(^|/)stages_(\d+)_(\d+)_(\d+)/", r"\1stages/\2/\3/\4/"),
    (r"(^|/)exchange_(\d+)_(\d+)_(\d+)_(\d+)_0/", r"\1exchange/\2/\3/\4/\5/conv/"),
    (r"(^|/)exchange_(\d+)_(\d+)_(\d+)_(\d+)_1/", r"\1exchange/\2/\3/\4/\5/norm/"),
    (r"(^|/)trans_(\d+)_(\d+)_0/", r"\1trans/\2/\3/conv/"),
    (r"(^|/)trans_(\d+)_(\d+)_1/", r"\1trans/\2/\3/norm/"),
    (r"(^|/)(fc1|fc2|out_head)/Dense_0/", r"\1\2/linear/"),
    (r"(^|/)LayerNorm_0/scale$", r"\1layer_norm/weight"),
    (r"(^|/)LayerNorm_0/", r"\1layer_norm/"),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, path + "/")
        else:
            yield path, v


def _torch_name(flax_path: str, ndim: int) -> str:
    """Port `state_dict` key of one flax leaf path (without the
    params/batch_stats collection)."""
    name = flax_path
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    if name.endswith("/kernel") and ndim == 2:  # Dense: nn.Linear weight
        name = name[:-len("kernel")] + "weight"
    return name.replace("/", ".")


def flax_to_torch(params: Mapping, batch_stats: Mapping
                  ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (the flax `params` and `batch_stats`
    collections) -> a `state_dict` for `model.load_state_dict(strict=True)`."""
    sd = {}
    leaves = [pl for tree in (params, batch_stats or {})
              for pl in _flatten(tree)]
    # an instance norm beside a batch norm (INSTANCE_BATCH_NORM) is the
    # batch norm's submodule `inst`
    inbn = {path[:path.index("/MaskedBatchNorm_0/")] for path, _ in leaves
            if "/MaskedBatchNorm_0/" in path}
    for path, leaf in leaves:
        head, sep, _ = path.partition("/MaskedInstanceNorm_0/")
        if sep and head in inbn:
            path = path.replace("/MaskedInstanceNorm_0/", "/inst/")
        arr = np.asarray(leaf, dtype=np.float32)
        name = _torch_name(path, arr.ndim)
        if name.endswith(".weight") and arr.ndim == 2:
            arr = arr.T
        sd[name] = torch.tensor(arr)
    return sd


def load_jax_trainer_state(trainer, params: Mapping, batch_stats: Mapping,
                           momentum: Optional[Mapping] = None,
                           adam: Optional[Tuple[Mapping, Mapping]] = None,
                           opt_steps: int = 0,
                           host: Optional[Mapping] = None) -> None:
    """Put an initialized port trainer at the point of a JAX trainer whose
    state is given as numpy trees: `params` and `batch_stats` (the flax
    collections), the optimizer's `momentum` tree (SGD: the `TraceState`
    buffer) or `adam` = (mu, nu) trees, all shaped like `params`, after
    `opt_steps` optimizer steps, and `host`, the dict the JAX trainer's
    `_host_state()` returns. With `opt_steps == 0` the optimizer state stays
    empty: both packages then start SGD's buffer from the first gradient."""
    trainer.model.load_state_dict(flax_to_torch(params, batch_stats),
                                  strict=True)
    trainer.model.to(trainer.device)
    opt = trainer.optimizer
    opt.state.clear()
    named = dict(trainer.model.named_parameters())
    if opt_steps > 0 and momentum is not None:
        for name, buf in flax_to_torch(momentum, {}).items():
            opt.state[named[name]] = {
                "momentum_buffer": buf.to(trainer.device)}
    if opt_steps > 0 and adam is not None:
        mu, nu = (flax_to_torch(t, {}) for t in adam)
        for name in mu:
            opt.state[named[name]] = {
                "step": torch.tensor(float(opt_steps)),
                "exp_avg": mu[name].to(trainer.device),
                "exp_avg_sq": nu[name].to(trainer.device)}
    if host is None:
        return
    trainer.curr_iter = host["iteration"]
    trainer.epoch = host["epoch"] - 1
    for k in ("best_val_part_iou", "best_val_shape_iou", "best_val_loss",
              "best_val_acc"):
        setattr(trainer, k, host[k])
        setattr(trainer, k + "_iter", host[k + "_iter"])
    if "plateau" in host and hasattr(trainer, "plateau"):
        trainer.plateau.load_state_dict(dict(host["plateau"]))
    if "csn_data" in host:
        cd = host["csn_data"]
        trainer.patience = cd["patience"]
        trainer.cooldown = cd["cooldown"]
        trainer.n_graph_construction = cd["n_graph_construction"]
        trainer.train_dataset.neighbors = [
            (int(a), [int(x) for x in b]) for a, b in cd["train_neighbors"]]
        trainer.val_dataset.neighbors = [
            (int(a), [int(x) for x in b]) for a, b in cd["val_neighbors"]]


# ---------------------------------------------------------------------------
# MinkowskiEngine checkpoints
# ---------------------------------------------------------------------------

def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _kernel_perm(ksize: int, offset_order: str) -> np.ndarray:
    """Row permutation taking an ME kernel to the port's z-fastest offset
    order (`MapSpec.offsets`): 'xyz' for ME's x-fastest rows, 'zyx' the
    identity."""
    k = ksize
    if offset_order == "zyx":  # already z-fastest
        return np.arange(k ** 3)
    # ME x-fastest: me_row(x,y,z) = x + k*y + k^2*z; ours = z + k*y + k^2*x
    ours = np.arange(k ** 3)
    z = ours % k
    y = (ours // k) % k
    x = ours // (k * k)
    return x + k * y + k * k * z


class _SD:
    """state_dict view that records consumed keys and converts kernels."""

    def __init__(self, sd: Mapping, offset_order: str):
        self.sd = {k: _numpy(v) for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")}
        self.offset_order = offset_order
        self.used = set()

    def a(self, name: str) -> np.ndarray:
        self.used.add(name)
        if name not in self.sd:
            raise KeyError(
                f"checkpoint is missing '{name}'; available near-misses: "
                f"{[k for k in self.sd if k.split('.')[0] in name][:8]}")
        return self.sd[name]

    def conv(self, name: str) -> np.ndarray:
        w = self.a(name + ".kernel")
        if w.ndim == 3:  # [K, in, out]: permute offsets to our order
            return w[_kernel_perm(round(w.shape[0] ** (1 / 3)),
                                  self.offset_order)]
        return w        # k=1 conv: [in, out], a Dense kernel

    def bn(self, name: str) -> Tuple[Dict, Dict]:
        return ({"MaskedBatchNorm_0": {"scale": self.a(name + ".bn.weight"),
                                       "bias": self.a(name + ".bn.bias")}},
                {"MaskedBatchNorm_0": {"mean": self.a(name +
                                                      ".bn.running_mean"),
                                       "var": self.a(name +
                                                     ".bn.running_var")}})

    def bias(self, name: str) -> np.ndarray:
        """Conv bias as a 1-D vector. ME 0.5.x stores it as `[1, out]`; the
        plain `[out]` layout is accepted too."""
        return self.a(name + ".bias").reshape(-1)

    def unused(self):
        return sorted(set(self.sd) - self.used)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def convert_mink_state_dict(
    sd: Mapping, num_stages: int, num_blocks: int = 3, *,
    csn_head: bool = True, k_neighbors: int = 1,
    offset_order: str = "xyz",
) -> Dict[str, torch.Tensor]:
    """A reference HRNetSeg / HRNetSimCSN state_dict -> the `state_dict` of
    the port's `HRNetSeg` / `HRNetSimCSN`. Raises KeyError naming the first
    missing checkpoint key; the keys left unconsumed are reported in
    `convert_mink_state_dict.unused` after a call."""
    v = _SD(sd, offset_order)
    params: Dict = {}
    stats: Dict = {}

    params["conv0"] = {"kernel": v.conv("conv0s1")}
    params["norm0"], stats["norm0"] = v.bn("bn0s1")
    params["conv1"] = {"kernel": v.conv("conv1s1")}
    params["norm1"], stats["norm1"] = v.bn("bn1s1")

    # stages.{i}.{j}.{b}: BasicBlocks (conv1/norm1/conv2/norm2)
    for i in range(num_stages):
        for j in range(i + 1):
            for b in range(num_blocks):
                base = f"stages.{i}.{j}.{b}"
                name = f"stages_{i}_{j}_{b}"
                p = {"SparseConv_0": {"kernel": v.conv(base + ".conv1")},
                     "SparseConv_1": {"kernel": v.conv(base + ".conv2")}}
                s = {}
                p["Norm_0"], s["Norm_0"] = v.bn(base + ".norm1")
                p["Norm_1"], s["Norm_1"] = v.bn(base + ".norm2")
                params[name] = p
                stats[name] = s

    # exchange_blocks.{i}.{j}.{k}: Sequential [C,N] then [R,C,N] per step
    # (conv at 3s, norm at 3s+1)
    for i in range(num_stages - 1):
        depth = i + 1
        for j in range(depth):
            for k in range(depth + 1):
                if j == k:
                    continue
                for s in range(abs(k - j)):
                    base = f"exchange_blocks.{i}.{j}.{k}"
                    name = f"exchange_{i}_{j}_{k}_{s}"
                    params[name + "_0"] = {
                        "kernel": v.conv(f"{base}.{3 * s}")}
                    pn, sn = v.bn(f"{base}.{3 * s + 1}")
                    params[name + "_1"] = pn
                    stats[name + "_1"] = sn

    # final transitions: Sequential [ConvT, Norm, ReLU] x steps
    ft_p, ft_s = {}, {}
    for i in range(1, num_stages):
        for j in range(i):
            base = f"final_transitions.{i - 1}.{3 * j}"
            name = f"trans_{i - 1}_{j}"
            ft_p[name + "_0"] = {"kernel": v.conv(base)}
            pn, sn = v.bn(f"final_transitions.{i - 1}.{3 * j + 1}")
            ft_p[name + "_1"] = pn
            ft_s[name + "_1"] = sn
    params["final_transitions"] = ft_p
    stats["final_transitions"] = ft_s

    if csn_head:
        params["fc1"] = {"Dense_0": {"kernel": v.conv("fc_layer.0"),
                                     "bias": v.bias("fc_layer.0")}}
        params["fc1_norm"], stats["fc1_norm"] = v.bn("fc_layer.1")
        params["mha"] = {
            "w_qs": {"kernel": _t(v.a("MHA.w_qs.weight"))},
            "w_ks": {"kernel": _t(v.a("MHA.w_ks.weight"))},
            "w_vs": {"kernel": _t(v.a("MHA.w_vs.weight"))},
            "fc": {"kernel": _t(v.a("MHA.fc.weight"))},
            "LayerNorm_0": {"scale": v.a("MHA.norm.weight"),
                            "bias": v.a("MHA.norm.bias")},
        }
        params["out_head"] = {"Dense_0": {"kernel": v.conv("output"),
                                          "bias": v.bias("output")}}
        if k_neighbors > 0:
            params["linear_q"] = {"kernel": _t(v.a("linear_q.weight"))}
            params["linear_k"] = {"kernel": _t(v.a("linear_k.weight"))}
    else:  # HRNetSeg head: final = Sequential [fc1, bn, relu, fc2]
        params["fc1"] = {"Dense_0": {"kernel": v.conv("final.0"),
                                     "bias": v.bias("final.0")}}
        params["fc1_norm"], stats["fc1_norm"] = v.bn("final.1")
        params["fc2"] = {"Dense_0": {"kernel": v.conv("final.3"),
                                     "bias": v.bias("final.3")}}

    convert_mink_state_dict.unused = v.unused()
    return flax_to_torch(params, stats)


def _convert_block(v: _SD, base: str) -> Tuple[Dict, Dict]:
    """One residual block (`modules/resnet_block.py` of the reference):
    BasicBlock (conv1/norm1/conv2/norm2 [+ downsample]) or Bottleneck
    (conv1..conv3/norm1..norm3 [+ downsample], k1-k3-k1), under the flax
    names of the blocks (SparseConv_N for k3, Conv1x1_N/Dense_0 for k1,
    Norm_N, the width projection last)."""
    p: Dict = {}
    s: Dict = {}
    bottleneck = (base + ".conv3.kernel") in v.sd
    if bottleneck:
        p["Conv1x1_0"] = {"Dense_0": {"kernel": v.conv(base + ".conv1")}}
        p["Norm_0"], s["Norm_0"] = v.bn(base + ".norm1")
        p["SparseConv_0"] = {"kernel": v.conv(base + ".conv2")}
        p["Norm_1"], s["Norm_1"] = v.bn(base + ".norm2")
        p["Conv1x1_1"] = {"Dense_0": {"kernel": v.conv(base + ".conv3")}}
        p["Norm_2"], s["Norm_2"] = v.bn(base + ".norm3")
        proj_conv, proj_norm = "Conv1x1_2", "Norm_3"
    else:
        p["SparseConv_0"] = {"kernel": v.conv(base + ".conv1")}
        p["Norm_0"], s["Norm_0"] = v.bn(base + ".norm1")
        p["SparseConv_1"] = {"kernel": v.conv(base + ".conv2")}
        p["Norm_1"], s["Norm_1"] = v.bn(base + ".norm2")
        proj_conv, proj_norm = "Conv1x1_0", "Norm_2"
    if (base + ".downsample.0.kernel") in v.sd:
        p[proj_conv] = {"Dense_0": {"kernel": v.conv(base + ".downsample.0")}}
        p[proj_norm], s[proj_norm] = v.bn(base + ".downsample.1")
    return p, s


def _block_count(sd: Mapping, name: str) -> int:
    n = 0
    while any(k.startswith(f"{name}.{n}.") for k in sd):
        n += 1
    return n


def convert_res16unet_state_dict(
    sd: Mapping, *, offset_order: str = "xyz",
) -> Dict[str, torch.Tensor]:
    """A reference Res16UNet* state_dict (stem conv0p1s1/bn0, four k2/s2
    down convs conv{1-4}p*s2/bn{1-4} with residual stages block{1-4}, four
    k2/s2 transposes convtr{4-7}p*s2/bntr{4-7} with skip-concat stages
    block{5-8}, final k1 head) -> the `state_dict` of the port's
    `Res16UNetBase` models."""
    v = _SD(sd, offset_order)
    params: Dict = {"conv0": {"kernel": v.conv("conv0p1s1")}}
    stats: Dict = {}
    params["norm0"], stats["norm0"] = v.bn("bn0")
    tr_names = ["convtr4p16s2", "convtr5p8s2", "convtr6p4s2", "convtr7p2s2"]
    for l in range(4):
        params[f"down_convs_{l}"] = {
            "kernel": v.conv(f"conv{l + 1}p{2 ** l}s2")}
        params[f"down_norms_{l}"], stats[f"down_norms_{l}"] = v.bn(
            f"bn{l + 1}")
        params[f"up_convs_{l}"] = {"kernel": v.conv(tr_names[l])}
        params[f"up_norms_{l}"], stats[f"up_norms_{l}"] = v.bn(f"bntr{l + 4}")
        for b in range(_block_count(v.sd, f"block{l + 1}")):
            params[f"enc_blocks_{l}_{b}"], stats[f"enc_blocks_{l}_{b}"] = \
                _convert_block(v, f"block{l + 1}.{b}")
        for b in range(_block_count(v.sd, f"block{l + 5}")):
            params[f"dec_blocks_{l}_{b}"], stats[f"dec_blocks_{l}_{b}"] = \
                _convert_block(v, f"block{l + 5}.{b}")
    params["final"] = {"Dense_0": {"kernel": v.conv("final"),
                                   "bias": v.bias("final")}}
    convert_res16unet_state_dict.unused = v.unused()
    return flax_to_torch(params, stats)


def convert_resunet_state_dict(
    sd: Mapping, *, offset_order: str = "xyz",
) -> Dict[str, torch.Tensor]:
    """A reference ResUNet* / MinkUNetBase state_dict (stem conv1p1s1/bn1 +
    block1 at level 0, three k2/s2 downs conv{2-4}p*s2/bn{2-4} with stages
    block{2-4}, three k2/s2 transposes convtr{4-6}p*s2/bntr{4-6} with stages
    block{5-6}, 2-layer k1 head `final.{0,1,3}`) -> the `state_dict` of the
    port's `ResUNetBase` models."""
    v = _SD(sd, offset_order)
    params: Dict = {"conv0": {"kernel": v.conv("conv1p1s1")}}
    stats: Dict = {}
    params["norm0"], stats["norm0"] = v.bn("bn1")
    for b in range(_block_count(v.sd, "block1")):
        params[f"block0_{b}"], stats[f"block0_{b}"] = _convert_block(
            v, f"block1.{b}")
    tr_names = ["convtr4p8s2", "convtr5p4s2", "convtr6p2s2"]
    for l in range(3):
        params[f"down_convs_{l}"] = {
            "kernel": v.conv(f"conv{l + 2}p{2 ** l}s2")}
        params[f"down_norms_{l}"], stats[f"down_norms_{l}"] = v.bn(
            f"bn{l + 2}")
        params[f"up_convs_{l}"] = {"kernel": v.conv(tr_names[l])}
        params[f"up_norms_{l}"], stats[f"up_norms_{l}"] = v.bn(f"bntr{l + 4}")
        for b in range(_block_count(v.sd, f"block{l + 2}")):
            params[f"enc_blocks_{l}_{b}"], stats[f"enc_blocks_{l}_{b}"] = \
                _convert_block(v, f"block{l + 2}.{b}")
        if l < 2:
            for b in range(_block_count(v.sd, f"block{l + 5}")):
                params[f"dec_blocks_{l}_{b}"], stats[f"dec_blocks_{l}_{b}"] \
                    = _convert_block(v, f"block{l + 5}.{b}")
    params["final_fc"] = {"Dense_0": {"kernel": v.conv("final.0"),
                                      "bias": v.bias("final.0")}}
    # final_norm is a bare batch norm, not a Norm wrapper
    pn, sn = v.bn("final.1")
    params["final_norm"] = pn["MaskedBatchNorm_0"]
    stats["final_norm"] = sn["MaskedBatchNorm_0"]
    params["final_out"] = {"Dense_0": {"kernel": v.conv("final.3"),
                                       "bias": v.bias("final.3")}}
    convert_resunet_state_dict.unused = v.unused()
    return flax_to_torch(params, stats)


def load_mink_torch_checkpoint(path: str, num_stages: int, **kw
                               ) -> Dict[str, torch.Tensor]:
    """Load a reference .pth (`lib/utils.py` checkpoint() format: a dict
    with 'state_dict', or the bare state dict) and convert it."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    return convert_mink_state_dict(sd, num_stages, **kw)

"""Carry the JAX package's weights into the port.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``
nested dicts of arrays (anything ``numpy.asarray`` takes). These functions
return the port's ``state_dict`` under the reference's key names:

* Dense kernels ``(in, out)`` → Linear weights ``(out, in)``;
* conv kernels ``(kh, kw, in, out)`` → ``(out, in, kh, kw)``, and SlowFast's
  3-D ``(t, h, w, in, out)`` → ``(out, in, t, h, w)``;
* the TimeSformer's head-major qkv columns ``(H, [q|k|v], dh)`` → the
  ``[q|k|v]``-major ``to_qkv`` the port's attention kernel reads — the
  permutation happens here, once, never per call;
* embedding tables stay at the rows that are indexed.

The keys and values are the ones ``mintime_tpu.utils.torch_convert.
timesformer_params_to_torch`` / ``efficientnet_params_to_torch`` /
``xception_params_to_torch`` emit, apart from those exporters' zero rows below
the embedding tables; SlowFast's are pytorchvideo's, the ones
``slowfast_params_from_torch`` reads.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mintime_torch.config import ModelConfig
from mintime_torch.models.efficientnet import expand_blocks
from mintime_torch.models.xception import BLOCK_SPECS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def timesformer_state_dict(params: Mapping, config: ModelConfig) -> dict[str, torch.Tensor]:
    """``SizeInvariantTimeSformer`` params → the port's TimeSformer state_dict."""
    H, dh = config.heads, config.dim_head
    sd: dict[str, torch.Tensor] = {}

    def linear(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def layernorm(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["scale"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    sd["cls_token"] = _t(params["cls_token"])
    sd["pos_emb.weight"] = _t(params["pos_emb"]["embedding"])
    linear("to_patch_embedding", params["to_patch_embedding"])
    layernorm("to_out.0", params["out_norm"])
    linear("to_out.1", params["out_proj"])
    if "size_emb" in params:
        sd["size_emb.weight"] = _t(params["size_emb"]["embedding"])
    for i in range(config.depth):
        for j, kind in ((0, "time"), (1, "space")):
            base = f"layers.{i}.{j}"
            attn = params[f"{kind}_attn_{i}"]
            wq = np.asarray(attn["qkv_kernel"], np.float32)  # (D, H*3*dh) head-major
            wq = wq.reshape(wq.shape[0], H, 3, dh).transpose(0, 2, 1, 3).reshape(wq.shape[0], -1)
            sd[f"{base}.fn.to_qkv.weight"] = _t(wq).T.contiguous()
            sd[f"{base}.fn.to_out.0.weight"] = _t(attn["proj_kernel"]).T.contiguous()
            sd[f"{base}.fn.to_out.0.bias"] = _t(attn["proj_bias"])
            layernorm(f"{base}.norm", params[f"{kind}_norm_{i}"])
        base = f"layers.{i}.2"
        layernorm(f"{base}.norm", params[f"ff_norm_{i}"])
        linear(f"{base}.fn.net.0", params[f"ff_{i}"]["Dense_0"])
        linear(f"{base}.fn.net.3", params[f"ff_{i}"]["Dense_1"])
    return sd


def efficientnet_state_dict(variables: Mapping, variant: str = "efficientnet-b0") -> dict[str, torch.Tensor]:
    """``EfficientNet`` variables → the port's EfficientNet state_dict. A
    network tapped at a block (``tap_block``) holds only the blocks it runs,
    and the head conv only when it runs it; the dict holds the same."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def conv(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def bn(prefix, pleaf, sleaf):
        sd[f"{prefix}.weight"] = _t(pleaf["scale"])
        sd[f"{prefix}.bias"] = _t(pleaf["bias"])
        sd[f"{prefix}.running_mean"] = _t(sleaf["mean"])
        sd[f"{prefix}.running_var"] = _t(sleaf["var"])

    conv("_conv_stem", params["conv_stem"])
    bn("_bn0", params["bn_stem"], stats["bn_stem"])
    for i, ba in enumerate(expand_blocks(variant)):
        if f"block_{i}" not in params:
            break
        blk, bst = params[f"block_{i}"], stats[f"block_{i}"]
        p = f"_blocks.{i}"
        if ba.expand != 1:
            conv(f"{p}._expand_conv", blk["expand_conv"])
            bn(f"{p}._bn0", blk["bn0"], bst["bn0"])
        conv(f"{p}._depthwise_conv", blk["depthwise_conv"])
        bn(f"{p}._bn1", blk["bn1"], bst["bn1"])
        conv(f"{p}._se_reduce", blk["se_reduce"])
        conv(f"{p}._se_expand", blk["se_expand"])
        conv(f"{p}._project_conv", blk["project_conv"])
        bn(f"{p}._bn2", blk["bn2"], bst["bn2"])
    if "conv_head" in params:
        conv("_conv_head", params["conv_head"])
        bn("_bn1", params["bn_head"], stats["bn_head"])
    return sd


def xception_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``Xception`` variables → the port's Xception state_dict (the
    reference's SenseTime key names)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def bn(prefix, pleaf, sleaf):
        sd[f"{prefix}.weight"] = _t(pleaf["scale"])
        sd[f"{prefix}.bias"] = _t(pleaf["bias"])
        sd[f"{prefix}.running_mean"] = _t(sleaf["mean"])
        sd[f"{prefix}.running_var"] = _t(sleaf["var"])

    def sep(prefix, leaf):
        sd[f"{prefix}.conv1.weight"] = _conv_weight(leaf["depthwise"])
        sd[f"{prefix}.pointwise.weight"] = _conv_weight(leaf["pointwise"])

    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = _conv_weight(params[name])
    bn("bn1", params["bn1"], stats["bn1"])
    bn("bn2", params["bn2"], stats["bn2"])
    for b, (cin, cout, reps, stride, start_with_relu, _) in enumerate(BLOCK_SPECS, start=1):
        blk, bst = params[f"block_{b}"], stats[f"block_{b}"]
        off = 1 if start_with_relu else 0  # rep: [relu] sep bn (relu sep bn)*
        for i in range(reps):
            sep(f"block{b}.rep.{3 * i + off}", blk[f"sep_{i}"])
            bn(f"block{b}.rep.{3 * i + off + 1}", blk[f"bn_{i}"], bst[f"bn_{i}"])
        if cout != cin or stride != 1:
            sd[f"block{b}.skip.weight"] = _conv_weight(blk["skip_conv"])
            bn(f"block{b}.skipbn", blk["skip_bn"], bst["skip_bn"])
    for i in (3, 4):
        sep(f"conv{i}", params[f"conv{i}"])
        bn(f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    return sd


def baseline_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``Baseline`` params → the port's ``mlp_head`` state_dict."""
    return {
        "mlp_head.0.weight": _t(params["mlp_0"]["kernel"]).T.contiguous(),
        "mlp_head.0.bias": _t(params["mlp_0"]["bias"]),
        "mlp_head.1.weight": _t(params["mlp_1"]["kernel"]).T.contiguous(),
        "mlp_head.1.bias": _t(params["mlp_1"]["bias"]),
    }


def classifier_state_dict(variables: Mapping, config: ModelConfig,
                          backbone: str = "efficientnet-b0",
                          head: str = "timesformer") -> dict[str, torch.Tensor]:
    """``MintimeVideoClassifier`` variables → the port's classifier state_dict."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    if backbone != "none":
        convert = {"efficientnet-b0": efficientnet_state_dict,
                   "xception": xception_state_dict}[backbone]
        ext = convert({"params": params["extractor"],
                       "batch_stats": variables["batch_stats"]["extractor"]})
        sd.update({f"extractor.{k}": v for k, v in ext.items()})
    if head == "timesformer":
        hd = timesformer_state_dict(params["head"], config)
    else:
        hd = baseline_state_dict(params["head"])
    sd.update({f"head.{k}": v for k, v in hd.items()})
    return sd


def conv_timesformer_state_dict(variables: Mapping, config: ModelConfig) -> dict[str, torch.Tensor]:
    """``ConvolutionalTimeSformer`` variables → the port's state_dict: the
    tapped extractor under ``extractor.``, and the head's embeddings, layers and
    output under ``head.`` with the flagship TimeSformer's key names (the JAX
    package names them as its TimeSformer does). The JAX package has no
    reference checkpoint format for this model (``mintime_tpu/utils/
    checkpoint.py:130-135``), so these keys are the port's choice."""
    params = variables["params"]
    head = {k: v for k, v in params.items() if k != "extractor"}
    return classifier_state_dict({"params": {"extractor": params["extractor"], "head": head},
                                  "batch_stats": variables["batch_stats"]}, config)


#: (blocks, slow_temporal) of res2..res5 in pytorchvideo's ``slowfast_r50``
SLOWFAST_STAGES = ((3, 1), (4, 1), (6, 3), (3, 3))


def slowfast_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``SlowFastR50`` variables (or ``SlowFastClassifier``'s, which hold
    them under ``slowfast``) → pytorchvideo ``slowfast_r50`` keys, the port's
    :class:`~mintime_torch.models.slowfast.SlowFastClassifier` state_dict;
    the inverse of ``slowfast_params_from_torch``. Kernels ``(t, h, w, in,
    out)`` → ``(out, in, t, h, w)``, BatchNorm ``mean`` / ``var`` →
    ``running_mean`` / ``running_var``, ``proj``'s kernel transposed."""
    params, stats = variables["params"], variables["batch_stats"]
    if "slowfast" in params:
        params, stats = params["slowfast"], stats["slowfast"]
    sd: dict[str, torch.Tensor] = {}

    def convbn(pleaf, sleaf, conv, norm):
        sd[f"{conv}.weight"] = _t(pleaf["conv"]["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
        sd[f"{norm}.weight"] = _t(pleaf["bn"]["scale"])
        sd[f"{norm}.bias"] = _t(pleaf["bn"]["bias"])
        sd[f"{norm}.running_mean"] = _t(sleaf["bn"]["mean"])
        sd[f"{norm}.running_var"] = _t(sleaf["bn"]["var"])

    def fusion(name, tb):
        base = f"blocks.{tb}.multipathway_fusion"
        convbn(params[name]["fuse"], stats[name]["fuse"], f"{base}.conv_fast_to_slow",
               f"{base}.norm")

    for p, stem in ((0, "slow_stem"), (1, "fast_stem")):
        base = f"blocks.0.multipathway_blocks.{p}"
        convbn(params[stem], stats[stem], f"{base}.conv", f"{base}.norm")
    fusion("fuse_stem", 0)
    for idx, (blocks, _) in enumerate(SLOWFAST_STAGES):
        tb = idx + 1
        for p, stage in ((0, f"slow_res{idx + 2}"), (1, f"fast_res{idx + 2}")):
            for j in range(blocks):
                pb, sb = params[stage][f"block_{j}"], stats[stage][f"block_{j}"]
                base = f"blocks.{tb}.multipathway_blocks.{p}.res_blocks.{j}"
                for part in ("a", "b", "c"):
                    convbn(pb[f"conv_{part}"], sb[f"conv_{part}"], f"{base}.branch2.conv_{part}",
                           f"{base}.branch2.norm_{part}")
                if "shortcut" in pb:
                    convbn(pb["shortcut"], sb["shortcut"], f"{base}.branch1_conv",
                           f"{base}.branch1_norm")
        if idx < 3:
            fusion(f"fuse_res{idx + 2}", tb)
    sd["blocks.5.proj.weight"] = _t(params["proj"]["kernel"]).T.contiguous()
    sd["blocks.5.proj.bias"] = _t(params["proj"]["bias"])
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load JAX variables into a port model (the classifier, the
    Convolutional TimeSformer or SlowFast, by its ``head_kind``), in its
    device and dtype (strict: every key must match)."""
    if model.head_kind == "conv_timesformer":
        sd = conv_timesformer_state_dict(variables, model.config)
    elif model.head_kind == "slowfast":
        sd = slowfast_state_dict(variables)
    else:
        sd = classifier_state_dict(variables, model.config, model.backbone, model.head_kind)
    model.load_state_dict(sd, strict=True)
    return model


def _conv_weight(leaf) -> torch.Tensor:
    """flax conv kernel ``(kh, kw, in, out)`` → torch ``(out, in, kh, kw)``."""
    return _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()


def facenet_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``InceptionResnetV1`` variables → the port's (facenet-pytorch's)
    state_dict; the inverse of ``facenet_params_from_torch``. BatchNorm's
    ``num_batches_tracked``, which that converter drops, comes back as 0."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def convbn(prefix, pleaf, sleaf):
        sd[f"{prefix}.conv.weight"] = _conv_weight(pleaf["conv"])
        sd[f"{prefix}.bn.weight"] = _t(pleaf["bn"]["scale"])
        sd[f"{prefix}.bn.bias"] = _t(pleaf["bn"]["bias"])
        sd[f"{prefix}.bn.running_mean"] = _t(sleaf["bn"]["mean"])
        sd[f"{prefix}.bn.running_var"] = _t(sleaf["bn"]["var"])
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a", "conv2d_4b"):
        convbn(name, params[name], stats[name])
    blocks = [(f"repeat_1_{i}", f"repeat_1.{i}") for i in range(5)] + [("mixed_6a", "mixed_6a")]
    blocks += [(f"repeat_2_{i}", f"repeat_2.{i}") for i in range(10)] + [("mixed_7a", "mixed_7a")]
    blocks += [(f"repeat_3_{i}", f"repeat_3.{i}") for i in range(5)] + [("block8", "block8")]
    for flax_name, torch_name in blocks:
        p, s = params[flax_name], stats[flax_name]
        for branch in s:  # branch0, branch1_0, ... → branch0, branch1.0, ...
            convbn(f"{torch_name}.{branch.replace('_', '.')}", p[branch], s[branch])
        if "conv2d" in p:
            sd[f"{torch_name}.conv2d.weight"] = _conv_weight(p["conv2d"])
            sd[f"{torch_name}.conv2d.bias"] = _t(p["conv2d"]["bias"])
    sd["last_linear.weight"] = _t(params["last_linear"]["kernel"]).T.contiguous()
    sd["last_bn.weight"] = _t(params["last_bn"]["scale"])
    sd["last_bn.bias"] = _t(params["last_bn"]["bias"])
    sd["last_bn.running_mean"] = _t(stats["last_bn"]["mean"])
    sd["last_bn.running_var"] = _t(stats["last_bn"]["var"])
    sd["last_bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def mtcnn_state_dicts(variables: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """``{"pnet", "rnet", "onet"}`` variables → facenet-pytorch P/R/O-Net
    state_dicts; the inverse of ``mtcnn_params_from_torch``."""
    out = {}
    for net, v in variables.items():
        sd: dict[str, torch.Tensor] = {}
        for name, leaf in v["params"].items():
            if "alpha" in leaf:  # PReLU
                sd[f"{name}.weight"] = _t(leaf["alpha"])
            elif np.ndim(leaf["kernel"]) == 4:
                sd[f"{name}.weight"] = _conv_weight(leaf)
                sd[f"{name}.bias"] = _t(leaf["bias"])
            else:
                sd[f"{name}.weight"] = _t(leaf["kernel"]).T.contiguous()
                sd[f"{name}.bias"] = _t(leaf["bias"])
        out[net] = sd
    return out

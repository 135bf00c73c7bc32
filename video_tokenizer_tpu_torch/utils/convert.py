"""Weight bridge: the JAX package's Flax parameters -> the port's state_dict.

`state_dict_from_jax(params, model[, batch_stats])` takes the Flax parameter
tree of a `video_tokenizer_tpu` LARP tokenizer as nested dicts of numpy
arrays (no JAX needed) and returns the state_dict of the matching port model,
under the upstream torch names (the dict
`tools/export_reference_tokenizer.py` writes):
  * Flax Dense kernel [in, out] -> `weight` [out, in];
  * LayerNorm and BatchNorm `scale` -> `weight` (the bottleneck's `ln_nd`
    scale and bias keep their (n, d) shape), a BatchNorm's `batch_stats`
    mean / var -> `running_mean` / `running_var`;
  * the patch kernel [(pt p p c), D] -> the Conv3d-shaped [D, C, pt, p, p];
  * the `prior` subtree (`gptc_from_jax`, `gptc_state_dict_from_jax` for a
    bare GPTC) under its Flax names, `blocks_{i}` -> `blocks.{i}`;
  * fixed sin-cos PEs -> the model's own buffers (regenerated from `sincos`).
`TOP_LEVEL_PARAMS` / `top_level_param_names` name the parameters at the top
of the Flax tree (the JAX tokenizer trainer's `emb` learning-rate group).

`loss_state_dict_from_jax(loss_params, loss_ema, module)` does the same for
the tokenizer trainer's loss module (discriminator, LPIPS, LeCam EMAs). With
`spectral_norm` the Flax tree holds the raw weights under the same names
(the normalisation happens on the way into the forward, on both sides), so
they come across as they are.

`model_new_state_dict_from_jax(params, model)` does the same for a model_new
`RoPEAutoEncoder` (`encoder`, `encoder1`, `decoder`: their `proj_in`,
`proj_cond`, `mask_token`, `proj_out` and the block stacks' `attn_{i}`,
`ffd_{i}` or the simple style's `ln1_/qkv_/proj_/ln2_/fc1_/fc2_{i}` and
`final_norm`), whose module names are the Flax names.

It maps a model_basic `BasicAutoEncoder` too (`encoder`, `encoder1`,
`decoder`: their projections, PEs, query tokens, unpatchify heads and
`stack.blocks`), whose module names are the Flax names as well.

`titok_state_dict_from_jax(params, model)` does the same for a `TiTok`
(`encoder` and `decoder`: `mask_token`, `proj_in`, `ln_post` / `ln_pre`,
`proj_out` and the packed stacks' `attn_{i}` (`pre_ln`, `to_qkv`, `q_norm`,
`k_norm`, `out_proj`), `ffd_norm_{i}`, `ffd_in_{i}`, `ffd_out_{i}`), whose
module names are the Flax names: the model_new mapping maps it as it is.

`stat_state_dict_from_jax(params, model)` does the same for the STAT
family's `AutoEncoderStat`, whose names are the Flax names too. The LARP
tokenizer's `fsq` (`fsq_norm`, `fsq_in_linear`, `fsq_out_linear`) and `sq`
(`sq_in_linear`, `sq_out_linear`, `sq_quantizer.embedding`) bottlenecks come
across in `state_dict_from_jax` under the JAX module's names.

`i3d_state_dict_from_jax(variables)` does the same for the FVD extractor's
`InceptionI3D` (conv kernels (kT, kH, kW, Cin, Cout) -> (Cout, Cin, kT, kH,
kW); BatchNorm scale, bias and `batch_stats` as they are).

`inception_state_dict_from_jax(variables)` does the same for FID's
`InceptionV3` (conv kernels (kH, kW, Cin, Cout) -> (Cout, Cin, kH, kW);
BatchNorm scale, bias and `batch_stats` as I3D's) and
`milo_state_dict_from_jax(params)` for MILO (the Flax `conv{i}` of
`mask_finder_1` / `scaler_network` -> the reference's `netBasic.{2i}` /
`model.{2i}`); both raise unless the tree fills every tensor of the module
once. JEDi's V-JEPA2 teacher comes across through `vfm_state_dict_from_jax`.

`cosmos_state_dict_from_jax(params, model)` does the same for a Cosmos
tokenizer (`cosmos`, `cosmos_fsq`), whose module names are the Flax names:
conv kernels [kt, kh, kw, in, out] -> [out, in, kt, kh, kw], Dense [in, out]
-> [out, in], GroupNorm `scale` -> `weight`; each parameter of the model
filled exactly once (the SimVQ anchors are a buffer the model computes).

`vfm_state_dict_from_jax(params, model)` does the same for the V-JEPA2-teacher
tokenizers (`larp_tokenizer_vfm`, `larp_tokenizer_vfm_noquant`), whose names
are the Flax names (`flax_tree_state_dict`: Dense kernels -> weight [out, in],
LayerNorm and GroupNorm `scale` -> weight, the pyramid fusion's depthwise
conv kernel [3, 3, 3, 1, C] -> [C, 1, 3, 3, 3], the ViT stacks' `blocks_{i}`
-> `blocks.{i}`), the `vq` bottleneck's through `bottleneck_from_jax`;
`sem_state_dict_from_jax(params, model)` for `larp_tokenizer_sem` (the LARP
tokenizer under `tokenizer.` through `state_dict_from_jax`, the teacher and
the aligner's two MLPs under the Flax names). Both raise unless the tree
fills every parameter of the model, with its shape, once.

`vfm_auto_state_dict_from_jax(params, model)` does the same for the
teacher-space autoencoders (`autoencoder_vfm*`), `cnnvit_state_dict_from_jax`
for the CNN-ViT family and `ResNAFAutoEncoder` (conv kernels [kt, kh, kw,
in / groups, out] -> [out, in / groups, kt, kh, kw]),
`dino_disc_state_dict_from_jax(variables, model)` for `dino_disc` (its
`params`, and the `spectral` collection's `u` as the heads' buffers), and
`embedder_state_dict_from_jax(params, model)` for the latent-token,
latent-continuous and timestep embedders (an `nn.Embed`'s `embedding` ->
`weight`): all under the Flax names, each raising unless the tree fills every
parameter of the model, with its shape, once.

`ar_state_dict_from_jax(params, model)` does the same for a `LARP_AR` prior,
under the names `export_larp_ar` writes: Dense kernels -> `weight` [out, in],
RMSNorm `scale` -> `weight`, the token and class tables, `abs_pe`; a
quantized tree {kernel int8 [in, out], scale [out]} -> a `QuantDense`'s int8
`weight` [out, in] and fp32 `scale`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Set

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)  # a writable copy (torch.from_numpy shares it)


def linear_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _f32(tree["kernel"]).T
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _f32(tree["bias"])


def layernorm_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    if "scale" in tree:
        sd[f"{prefix}.weight"] = _f32(tree["scale"])
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _f32(tree["bias"])


def vit_stack_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    i = 0
    while f"blocks_{i}" in tree:
        block, p = tree[f"blocks_{i}"], f"{prefix}.blocks.{i}"
        layernorm_from_jax(sd, f"{p}.norm1", block["norm1"])
        linear_from_jax(sd, f"{p}.attn.qkv", block["attn"]["qkv"])
        linear_from_jax(sd, f"{p}.attn.proj", block["attn"]["proj"])
        layernorm_from_jax(sd, f"{p}.norm2", block["norm2"])
        linear_from_jax(sd, f"{p}.mlp.fc1", block["mlp"]["fc1"])
        linear_from_jax(sd, f"{p}.mlp.fc2", block["mlp"]["fc2"])
        i += 1


def patch_embed_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any],
                         patch: tuple, in_channels: int) -> None:
    """Dense patch kernel [(patch... c), D] -> conv weight [D, c, patch...]."""
    k = _f32(tree["kernel"])
    w = k.reshape(*patch, in_channels, k.shape[1])
    sd[f"{prefix}.weight"] = w.transpose(w.ndim - 1, w.ndim - 2, *range(len(patch)))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _f32(tree["bias"])


def bottleneck_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any],
                        stats: Optional[Dict[str, Any]] = None) -> None:
    """The bottleneck's projections, its norm (LayerNorm or BatchNorm: `scale`
    and `bias`; a BatchNorm's `batch_stats` mean / var -> running_mean /
    running_var) and its regularizer (the VQ codebook; skl has none)."""
    for name in ("in_linear", "out_linear"):
        if name in tree:
            linear_from_jax(sd, f"{prefix}.{name}", tree[name])
    if "norm_layer" in tree:
        layernorm_from_jax(sd, f"{prefix}.norm_layer", tree["norm_layer"])
    if stats and "norm_layer" in stats:
        sd[f"{prefix}.norm_layer.running_mean"] = _f32(stats["norm_layer"]["mean"])
        sd[f"{prefix}.norm_layer.running_var"] = _f32(stats["norm_layer"]["var"])
    reg = tree.get("reg", {})
    if "embedding" in reg:
        sd[f"{prefix}.regularizer.embedding.weight"] = _f32(reg["embedding"])
    if "stochastic_temperature_inv" in reg:
        sd[f"{prefix}.regularizer.stochastic_temperature_inv"] = _f32(
            reg["stochastic_temperature_inv"]
        )


def gptc_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    """A Flax `GPTC` tree under `prefix` ("" for none): Dense kernels ->
    weight [out, in], LayerNorm scale -> weight, `pos_emb` as it is,
    `blocks_{i}` -> `blocks.{i}`."""
    pre = f"{prefix}." if prefix else ""
    linear_from_jax(sd, f"{pre}input_proj", tree["input_proj"])
    sd[f"{pre}pos_emb"] = _f32(tree["pos_emb"])
    i = 0
    while f"blocks_{i}" in tree:
        block, p = tree[f"blocks_{i}"], f"{pre}blocks.{i}"
        for name in ("ln1", "ln2"):
            layernorm_from_jax(sd, f"{p}.{name}", block[name])
        for name in ("query", "key", "value", "proj", "mlp_fc", "mlp_proj"):
            linear_from_jax(sd, f"{p}.{name}", block[name])
        i += 1
    layernorm_from_jax(sd, f"{pre}ln_f", tree["ln_f"])
    linear_from_jax(sd, f"{pre}head", tree["head"])


def gptc_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `GPTC` params (nested dicts of arrays) -> the port's `GPTC` state_dict."""
    sd: Dict[str, np.ndarray] = {}
    gptc_from_jax(sd, "", params)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# the LARP tokenizer's top-level Flax parameters (path length 1) -> the port's
# names (upstream spells the learned w table 'encode_w_embed')
TOP_LEVEL_PARAMS = {
    name: {"encoder_w_embed": "encode_w_embed"}.get(name, name) for name in (
        "encoder_h_embed", "encoder_w_embed", "encoder_t_embed",
        "decoder_h_embed", "decoder_w_embed", "decoder_t_embed",
        "encoder_latent_query_embed", "decoder_latent_pe",
        "encoder_patch_token_type_embed", "encoder_latent_query_token_type_embed",
        "decoder_latent_token_type_embed", "decoder_patch_query_token_type_embed",
    )
}


def top_level_param_names(model) -> Set[str]:
    """The port's names of `model`'s parameters that sit at the top of its
    Flax tree (path length 1, the JAX trainer's `emb` group): for the LARP
    tokenizer those of `TOP_LEVEL_PARAMS` it has as parameters; for the
    families whose port names are the Flax names (model_new, STAT), the
    parameters named without a dot."""
    from ..models.larp_tokenizer import LARPTokenizer

    params = dict(model.named_parameters())
    if isinstance(model, LARPTokenizer):
        return {t for t in TOP_LEVEL_PARAMS.values() if t in params}
    return {n for n in params if "." not in n}


def state_dict_from_jax(params: Dict[str, Any], model,
                        batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Flax LARPTokenizer params (nested dicts of arrays) -> `model`'s state_dict;
    `batch_stats`, the Flax collection of a BatchNorm bottleneck norm, gives
    its running statistics."""
    sd: Dict[str, np.ndarray] = {}
    patch = (model.patch_size,) * 2
    if model.temporal_patch_size != 1:
        patch = (model.temporal_patch_size, *patch)
    patch_embed_from_jax(sd, "x_embedder.proj", params["x_embedder"]["proj"], patch,
                         model.in_channels)
    vit_stack_from_jax(sd, "encoder", params["encoder"])
    vit_stack_from_jax(sd, "decoder", params["decoder"])

    for name, port_name in TOP_LEVEL_PARAMS.items():  # the learned embeddings
        if name in params:
            sd[port_name] = _f32(params[name])

    if model.bottleneck_type == "vq":
        bottleneck_from_jax(sd, "bottleneck", params["bottleneck_module"],
                            (batch_stats or {}).get("bottleneck_module"))
        if "prior" in params:
            gptc_from_jax(sd, "prior", params["prior"])
    elif model.bottleneck_type == "fsq":
        layernorm_from_jax(sd, "fsq_norm", params["fsq_norm"])
        linear_from_jax(sd, "fsq_in_linear", params["fsq_in_linear"])
        linear_from_jax(sd, "fsq_out_linear", params["fsq_out_linear"])
    else:  # sq: the codebook as the JAX param holds it (normalised at use)
        linear_from_jax(sd, "sq_in_linear", params["sq_in_linear"])
        linear_from_jax(sd, "sq_out_linear", params["sq_out_linear"])
        sd["sq_quantizer.embedding"] = _f32(params["sq_quantizer"]["embedding"])

    layernorm_from_jax(sd, "final_layer.norm_final", params["final_layer"]["norm_final"])
    linear_from_jax(sd, "final_layer.linear", params["final_layer"]["linear"])

    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    # the fixed sin-cos tables are the model's own persistent buffers (FSQ's
    # constants are non-persistent: not in the state_dict)
    persistent = set(model.state_dict())
    for name, buf in model.named_buffers():
        if name in persistent:
            out.setdefault(name, buf.detach().cpu().clone())
    return out


def _flax_tree_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    """A Flax module tree under the same module names: Dense (`kernel`) ->
    weight [out, in] (+ bias), LayerNorm (`scale`) -> weight and bias, any
    other leaf (a mask token) as it is."""
    if "kernel" in tree:
        linear_from_jax(sd, prefix, tree)
    elif "scale" in tree:
        layernorm_from_jax(sd, prefix, tree)
    else:
        for name, sub in tree.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, dict):
                _flax_tree_from_jax(sd, key, sub)
            else:
                sd[key] = _f32(sub)


def model_new_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax RoPEAutoEncoder or BasicAutoEncoder params (nested dicts of
    arrays) -> `model`'s state_dict. The rotary tables and FSQ constants are
    non-persistent buffers, rebuilt by the model, so every key here is a
    parameter."""
    sd: Dict[str, np.ndarray] = {}
    _flax_tree_from_jax(sd, "", params)
    differ = sorted(set(sd) ^ set(model.state_dict()))
    if differ:
        raise ValueError(f"Flax tree and model differ in {differ}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def stat_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `AutoEncoderStat` params -> `model`'s state_dict: the encoder's
    `proj_in`, scalar `mask_token`, gated blocks, `prob_head.fc1/fc2` and
    `proj_out`, and the model_new decoder, all under the Flax names (the
    model_new mapping)."""
    return model_new_state_dict_from_jax(params, model)


def titok_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `TiTok` params -> `model`'s state_dict: the encoder's and
    decoder's mask tokens, projections, LayerNorms and packed GQA stacks under
    the Flax names (the model_new mapping; FSQ has no parameters and the
    rotation tables are rebuilt by the model)."""
    return model_new_state_dict_from_jax(params, model)


def cosmos_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) of a family whose module names are
    the port's -> `model`'s parameters (`flax_tree_state_dict`): the Cosmos
    tokenizers, the teacher-space autoencoders (`vfm_auto_state_dict_from_jax`)
    and the CNN-ViT family with ResNAF (`cnnvit_state_dict_from_jax`); their
    fixed tables and FSQ constants are non-persistent buffers, rebuilt by the
    model. Raises unless the two hold the same parameters, of the same
    shapes, each once."""
    return _check_parameters(flax_tree_state_dict(params), model)


vfm_auto_state_dict_from_jax = cnnvit_state_dict_from_jax = cosmos_state_dict_from_jax


def loss_state_dict_from_jax(loss_params: Dict[str, Any], loss_ema: Dict[str, Any],
                             module) -> Dict[str, torch.Tensor]:
    """Flax `VQLPIPSWithDiscriminator` params and its 'ema' collection ->
    the state_dict of the port's `module`: the transformer discriminator, the
    LPIPS VGG convs (HWIO -> OIHW, under the lpips package's
    `net.slice{n}.{torchvision index}` names), the `lin{i}` heads, and the
    LeCam EMAs."""
    from ..models.lpips import CONV_INDICES, SLICE_ENDS

    sd: Dict[str, np.ndarray] = {}
    disc, p = loss_params["discriminator"], "discriminator"
    embed = module.discriminator.x_embedder
    patch = (embed.p, embed.p) if not hasattr(embed, "pt") else (embed.pt, embed.p, embed.p)
    patch_embed_from_jax(sd, f"{p}.x_embedder.proj", disc["x_embedder"]["proj"], patch,
                         module.discriminator.in_channels)
    sd[f"{p}.cls_token"] = _f32(disc["cls_token"])
    vit_stack_from_jax(sd, f"{p}.transformer_encoder", disc["transformer_encoder"])
    layernorm_from_jax(sd, f"{p}.norm_final", disc["norm_final"])
    linear_from_jax(sd, f"{p}.fc", disc["fc"])

    lp = loss_params["perceptual"]
    for ci, idx in enumerate(CONV_INDICES):
        n = next(i for i, end in enumerate(SLICE_ENDS) if idx < end) + 1
        conv = lp["net"][f"conv{ci}"]
        sd[f"perceptual.net.slice{n}.{idx}.weight"] = _f32(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"perceptual.net.slice{n}.{idx}.bias"] = _f32(conv["bias"])
    for i in range(len(SLICE_ENDS)):
        sd[f"perceptual.lin{i}.model.1.weight"] = _f32(lp[f"lin{i}"]).reshape(1, -1, 1, 1)
    for name in ("lecam_ema_real", "lecam_ema_fake"):
        sd[name] = _f32(loss_ema[name])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def i3d_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `InceptionI3D` variables {"params", "batch_stats"} (the tree
    `tools/convert_i3d.py` writes) -> the port's `InceptionI3D` state dict
    under the same module names: conv kernels (kT, kH, kW, Cin, Cout) ->
    `conv3d.weight` (Cout, Cin, kT, kH, kW), the logits conv's `bias` kept;
    BatchNorm `scale` / `bias` -> `bn.weight` / `bn.bias`, `batch_stats`
    `mean` / `var` -> `bn.running_mean` / `bn.running_var`."""
    sd: Dict[str, np.ndarray] = {}

    def walk(prefix: str, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        if "conv3d" in params:
            sd[f"{prefix}conv3d.weight"] = _f32(params["conv3d"]["kernel"]).transpose(4, 3, 0, 1, 2)
            if "bias" in params["conv3d"]:
                sd[f"{prefix}conv3d.bias"] = _f32(params["conv3d"]["bias"])
            if "bn" in params:
                sd[f"{prefix}bn.weight"] = _f32(params["bn"]["scale"])
                sd[f"{prefix}bn.bias"] = _f32(params["bn"]["bias"])
                sd[f"{prefix}bn.running_mean"] = _f32(stats["bn"]["mean"])
                sd[f"{prefix}bn.running_var"] = _f32(stats["bn"]["var"])
            return
        for name, sub in params.items():
            walk(f"{prefix}{name}.", sub, stats.get(name, {}))

    walk("", variables["params"], variables.get("batch_stats", {}))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _state_dict_of(sd: Dict[str, np.ndarray], module_cls) -> Dict[str, torch.Tensor]:
    """`sd` as tensors, if its keys and shapes are those of a `module_cls()`
    state dict (built on the meta device); else ValueError."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in module_cls().state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        raise ValueError(f"Flax tree and {module_cls.__name__} differ in "
                         f"{sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def inception_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `InceptionV3` variables {"params", "batch_stats"} -> the port's
    `InceptionV3` state dict under the same module names: conv kernels (kH,
    kW, Cin, Cout) -> `conv.weight` (Cout, Cin, kH, kW); BatchNorm `scale` /
    `bias` -> `bn.weight` / `bn.bias`, `batch_stats` `mean` / `var` ->
    `bn.running_mean` / `bn.running_var`."""
    from ..metrics.inception import InceptionV3

    sd: Dict[str, np.ndarray] = {}

    def walk(prefix: str, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        if "conv" in params:
            sd[f"{prefix}conv.weight"] = _f32(params["conv"]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{prefix}bn.weight"] = _f32(params["bn"]["scale"])
            sd[f"{prefix}bn.bias"] = _f32(params["bn"]["bias"])
            sd[f"{prefix}bn.running_mean"] = _f32(stats["bn"]["mean"])
            sd[f"{prefix}bn.running_var"] = _f32(stats["bn"]["var"])
            return
        for name, sub in params.items():
            walk(f"{prefix}{name}.", sub, stats.get(name, {}))

    walk("", variables["params"], variables.get("batch_stats", {}))
    return _state_dict_of(sd, InceptionV3)


def milo_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `MILO` params (`{"params": ...}` or the tree itself) -> the
    reference's `MILO.pth` keys: `mask_finder_1.conv{i}` ->
    `mask_finder_1.netBasic.{2i}`, `scaler_network.conv{i}` ->
    `scaler_network.model.{2i}`; kernels HWIO -> OIHW, biases as they are."""
    from ..metrics.milo import MILO

    tree = params.get("params", params)
    seq = {"mask_finder_1": "netBasic", "scaler_network": "model"}
    sd: Dict[str, np.ndarray] = {}
    for module, convs in tree.items():
        for name, leaf in convs.items():
            key = f"{module}.{seq.get(module, module)}.{2 * int(name[len('conv'):])}"
            sd[f"{key}.weight"] = _f32(leaf["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{key}.bias"] = _f32(leaf["bias"])
    return _state_dict_of(sd, MILO)


def _ar_linear(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    kernel = np.asarray(tree["kernel"])
    if kernel.dtype == np.int8:  # QuantDense
        sd[f"{prefix}.weight"] = np.array(kernel.T, np.int8)
        sd[f"{prefix}.scale"] = _f32(tree["scale"])
    else:
        linear_from_jax(sd, prefix, tree)


def ar_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax LARP_AR params (nested dicts of arrays) -> `model`'s state_dict."""
    sd: Dict[str, np.ndarray] = {
        "tok_embeddings.weight": _f32(params["tok_embeddings"]["embedding"]),
        "norm.weight": _f32(params["norm"]["scale"]),
    }
    _ar_linear(sd, "output", params["output"])
    if "abs_pe" in params:
        sd["abs_pe"] = _f32(params["abs_pe"])
    if "cls_embedding" in params:
        sd["cls_embedding.embedding_table.weight"] = _f32(
            params["cls_embedding"]["embedding_table"]["embedding"]
        )
    i = 0
    while f"layers_{i}" in params:
        t, p = params[f"layers_{i}"], f"layers.{i}"
        _ar_linear(sd, f"{p}.attention.wqkv", t["attention"]["wqkv"])
        _ar_linear(sd, f"{p}.attention.wo", t["attention"]["wo"])
        for w in ("w1", "w2", "w3"):
            _ar_linear(sd, f"{p}.feed_forward.{w}", t["feed_forward"][w])
        sd[f"{p}.attention_norm.weight"] = _f32(t["attention_norm"]["scale"])
        sd[f"{p}.ffn_norm.weight"] = _f32(t["ffn_norm"]["scale"])
        i += 1
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if "abs_pe" not in out:  # fixed sin-cos PE: the model's own buffer
        out["abs_pe"] = model.abs_pe.detach().cpu().float().clone()
    return out


def flax_tree_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax tree whose module names are the port's: a Dense kernel [in, out]
    -> `weight` [out, in], a conv kernel [k..., in / groups, out] -> [out, in /
    groups, k...], a norm's `scale` -> `weight`, `blocks_{i}` -> `blocks.{i}`
    (the ViT stacks' ModuleList), any other leaf as it is."""
    sd: Dict[str, np.ndarray] = {}

    def walk(pre: str, sub: Dict[str, Any]) -> None:
        for name, leaf in sub.items():
            key = f"{pre}.{name}" if pre else name
            key = re.sub(r"(^|\.)blocks_(\d+)(?=\.|$)", r"\1blocks.\2", key)
            if isinstance(leaf, dict):
                walk(key, leaf)
            elif name == "kernel":
                k = _f32(leaf)
                w = k.T if k.ndim == 2 else k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
                sd[f"{key[:-len('.kernel')]}.weight"] = w
            elif name == "scale":
                sd[f"{key[:-len('.scale')]}.weight"] = _f32(leaf)
            else:
                sd[key] = _f32(leaf)

    walk("", tree)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _check_parameters(sd: Dict[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    want = {k: tuple(v.shape) for k, v in model.named_parameters()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        raise ValueError(f"Flax tree and model differ in "
                         f"{sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}")
    return sd


def vfm_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `LARPTokenizerVFM` / `LARPTokenizerVFMNoQuant` params -> `model`'s
    parameters (the fixed sin-cos tables and the rotary tables are
    non-persistent buffers, rebuilt by the model)."""
    rest = {k: v for k, v in params.items() if k != "bottleneck_module"}
    sd = flax_tree_state_dict(rest)
    if "bottleneck_module" in params:
        bn: Dict[str, np.ndarray] = {}
        bottleneck_from_jax(bn, "bottleneck_module", params["bottleneck_module"])
        sd.update({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in bn.items()})
    return _check_parameters(sd, model)


def sem_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `LARPTokenizerSem` params -> `model`'s state_dict: `tokenizer`
    through `state_dict_from_jax` (its persistent sin-cos buffers included),
    `teacher_model` and `aligner` under the Flax names."""
    sd = {f"tokenizer.{k}": v for k, v in state_dict_from_jax(
        params["tokenizer"], model.tokenizer).items()}
    rest = {k: v for k, v in params.items() if k != "tokenizer"}
    sd.update(flax_tree_state_dict(rest))
    buffers = dict(model.named_buffers())
    _check_parameters({k: v for k, v in sd.items() if k not in buffers}, model)
    return sd


def dino_disc_state_dict_from_jax(variables: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `DinoDisc` variables {"params", "spectral"} -> `model`'s
    state_dict: the parameters under the Flax names (the spectral-norm
    kernels [k, in, out] -> [out, in, k]) and each `SpectralConv1d`'s
    power-iteration vector `u` as its buffer."""
    sd = _check_parameters(flax_tree_state_dict(variables["params"]), model)
    sd.update(flax_tree_state_dict(variables.get("spectral", {})))
    differ = sorted(set(sd) ^ set(model.state_dict()))
    if differ:
        raise ValueError(f"Flax variables and model differ in {differ}")
    return sd


def embedder_state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax `LatentTokenEmbedder`, `LatentContEmbedder` or `TimestepEmbedder`
    params -> `model`'s parameters (`embedding_table.embedding` ->
    `embedding_table.weight`)."""
    sd = flax_tree_state_dict(params)
    if "embedding_table.embedding" in sd:
        sd["embedding_table.weight"] = sd.pop("embedding_table.embedding")
    return _check_parameters(sd, model)

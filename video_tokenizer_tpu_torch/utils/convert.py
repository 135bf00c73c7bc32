"""Weight bridge: the JAX package's Flax parameters -> the port's state_dict.

`state_dict_from_jax(params, model)` takes the Flax parameter tree of a
`video_tokenizer_tpu` LARP tokenizer as nested dicts of numpy arrays (no JAX
needed) and returns the state_dict of the matching port model, under the
upstream torch names (the dict `tools/export_reference_tokenizer.py`
writes):
  * Flax Dense kernel [in, out] -> `weight` [out, in];
  * LayerNorm `scale` -> `weight`;
  * the patch kernel [(pt p p c), D] -> the Conv3d-shaped [D, C, pt, p, p];
  * fixed sin-cos PEs -> the model's own buffers (regenerated from `sincos`).

`loss_state_dict_from_jax(loss_params, loss_ema, module)` does the same for
the tokenizer trainer's loss module (discriminator, LPIPS, LeCam EMAs).

`model_new_state_dict_from_jax(params, model)` does the same for a model_new
`RoPEAutoEncoder` (`encoder`, `encoder1`, `decoder`: their `proj_in`,
`proj_cond`, `mask_token`, `proj_out` and the block stacks' `attn_{i}`,
`ffd_{i}` or the simple style's `ln1_/qkv_/proj_/ln2_/fc1_/fc2_{i}` and
`final_norm`), whose module names are the Flax names.

`ar_state_dict_from_jax(params, model)` does the same for a `LARP_AR` prior,
under the names `export_larp_ar` writes: Dense kernels -> `weight` [out, in],
RMSNorm `scale` -> `weight`, the token and class tables, `abs_pe`; a
quantized tree {kernel int8 [in, out], scale [out]} -> a `QuantDense`'s int8
`weight` [out, in] and fp32 `scale`.
"""
from __future__ import annotations

from typing import Any, Dict

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


def bottleneck_from_jax(sd: Dict[str, np.ndarray], prefix: str, tree: Dict[str, Any]) -> None:
    for name in ("in_linear", "out_linear"):
        if name in tree:
            linear_from_jax(sd, f"{prefix}.{name}", tree[name])
    if "norm_layer" in tree:
        layernorm_from_jax(sd, f"{prefix}.norm_layer", tree["norm_layer"])
    reg = tree["reg"]
    sd[f"{prefix}.regularizer.embedding.weight"] = _f32(reg["embedding"])
    if "stochastic_temperature_inv" in reg:
        sd[f"{prefix}.regularizer.stochastic_temperature_inv"] = _f32(
            reg["stochastic_temperature_inv"]
        )


def state_dict_from_jax(params: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """Flax LARPTokenizer params (nested dicts of arrays) -> `model`'s state_dict."""
    sd: Dict[str, np.ndarray] = {}
    patch = (model.patch_size,) * 2
    if model.temporal_patch_size != 1:
        patch = (model.temporal_patch_size, *patch)
    patch_embed_from_jax(sd, "x_embedder.proj", params["x_embedder"]["proj"], patch,
                         model.in_channels)
    vit_stack_from_jax(sd, "encoder", params["encoder"])
    vit_stack_from_jax(sd, "decoder", params["decoder"])

    # learned embeddings (upstream spells the learned w table 'encode_w_embed')
    renamed = {"encoder_w_embed": "encode_w_embed"}
    for name in (
        "encoder_h_embed", "encoder_w_embed", "encoder_t_embed",
        "decoder_h_embed", "decoder_w_embed", "decoder_t_embed",
        "encoder_latent_query_embed", "decoder_latent_pe",
        "encoder_patch_token_type_embed", "encoder_latent_query_token_type_embed",
        "decoder_latent_token_type_embed", "decoder_patch_query_token_type_embed",
    ):
        if name in params:
            sd[renamed.get(name, name)] = _f32(params[name])

    bottleneck_from_jax(sd, "bottleneck", params["bottleneck_module"])

    layernorm_from_jax(sd, "final_layer.norm_final", params["final_layer"]["norm_final"])
    linear_from_jax(sd, "final_layer.linear", params["final_layer"]["linear"])

    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    # the fixed sin-cos tables are the model's own persistent buffers
    for name, buf in model.named_buffers():
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
    """Flax RoPEAutoEncoder params (nested dicts of arrays) -> `model`'s
    state_dict. The rotary tables and FSQ constants are non-persistent
    buffers, rebuilt by the model, so every key here is a parameter."""
    sd: Dict[str, np.ndarray] = {}
    _flax_tree_from_jax(sd, "", params)
    differ = sorted(set(sd) ^ set(model.state_dict()))
    if differ:
        raise ValueError(f"Flax tree and model differ in {differ}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


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

"""The port's state_dict is the upstream torch checkpoint's.

`state_dict_from_jax` must produce exactly the tensors that the JAX
package's exporter (`tools/export_reference_tokenizer.py`) writes for the
upstream reference: same keys, shapes and values. A `.pth` in the upstream
layout then loads through `LARPTokenizer.from_checkpoint` with strict
key matching and reproduces the JAX outputs.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_ARGS, clips, f32, jax_tokenizer, port_tokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from export_reference_tokenizer import export_larp_tokenizer  # noqa: E402

from video_tokenizer_tpu_torch.models import LARPTokenizer  # noqa: E402
from video_tokenizer_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

# the flagship cfg's flags (cfgs/larp_tokenizer.yaml), and every learned
# table and token-type embedding switched on (the renamed 'encode_w_embed')
VARIANTS = {
    "flagship_cfg_flags": dict(use_decoder_patch_query_token_type_embed=True),
    "all_learned": dict(
        learned_encoder_patch_pe=True, learned_decoder_latent_pe=True,
        learned_decoder_patch_query_embed=True, use_encoder_patch_token_type_embed=True,
        use_encoder_latent_query_token_type_embed=True,
        use_decoder_latent_token_type_embed=True,
        use_decoder_patch_query_token_type_embed=True,
    ),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_equals_the_upstream_export(variant):
    jm, params = jax_tokenizer(jnp.float32, **VARIANTS[variant])
    upstream = export_larp_tokenizer(jm, params)
    tm = LARPTokenizer(**{**TINY_ARGS, **VARIANTS[variant]})
    ours = state_dict_from_jax(params, tm)
    assert sorted(ours) == sorted(upstream) == sorted(tm.state_dict())
    for key, value in upstream.items():
        assert tuple(ours[key].shape) == value.shape, key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    tm.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_upstream_pth_loads_and_matches_jax(variant, tmp_path):
    jm, params = jax_tokenizer(jnp.float32, **VARIANTS[variant])
    sd = export_larp_tokenizer(jm, params)
    path = tmp_path / "tokenizer.pth"
    # the layout tools/export_reference_tokenizer.py:212-218 writes
    torch.save({"model": {
        "name": "larp_tokenizer",
        "args": {**TINY_ARGS, **VARIANTS[variant], "dtype": "<class 'jax.numpy.float32'>"},
        "sd": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
    }}, path)
    tm = LARPTokenizer.from_checkpoint(str(path))
    x = clips(4)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got["bottleneck_rep"].numpy(), np.asarray(want["bottleneck_rep"]))
    # fp32 on both sides, as in test_torch_models.py
    np.testing.assert_allclose(f32(got["pred_frames"]), f32(want["pred_frames"]), atol=1e-4)
    # and the same as the model built through the bridge
    with torch.inference_mode():
        bridged = port_tokenizer(params, **VARIANTS[variant])(torch.from_numpy(x))
    np.testing.assert_array_equal(f32(got["pred_frames"]), f32(bridged["pred_frames"]))


def test_unported_branches_name_their_roadmap_item():
    # the fsq and sq bottlenecks are ported (tests/test_torch_lattice.py); an
    # unknown one is refused by name
    with pytest.raises(ValueError, match="bottleneck_type"):
        LARPTokenizer(**{**TINY_ARGS, "bottleneck_type": "kl"})
    # the gptc prior, skl and the bottleneck norms are ported
    # (tests/test_torch_gptc.py, tests/test_torch_bottleneck_norms.py); an
    # unknown norm is refused by name
    assert LARPTokenizer(**{**TINY_ARGS, "prior_model": {"name": "gptc-XXS"}}).prior is not None
    skl = {"name": "bottleneck", "args": {"bottleneck_dim": 8,
                                          "regularizer": {"name": "skl", "args": {}}}}
    assert LARPTokenizer(**{**TINY_ARGS, "bottleneck": skl}).bottleneck.in_linear.weight.shape[0] == 16
    for norm in ("bn_b", "bn_bn", "ln_nd"):
        bn = {"name": "bottleneck", "args": {"bottleneck_dim": 8, "norm": norm, "regularizer": {
            "name": "vq", "args": {"codebook_size": 64}}}}
        LARPTokenizer(**{**TINY_ARGS, "bottleneck": bn})
    bn["args"]["norm"] = "gn"
    with pytest.raises(ValueError, match="gn"):
        LARPTokenizer(**{**TINY_ARGS, "bottleneck": bn})
    # R1 and spectral_norm in the loss are ported (tests/test_torch_r1_spectral.py):
    # they build, and R1's discriminator is built on the plain attention
    from video_tokenizer_tpu_torch.models.loss import VQLPIPSWithDiscriminator

    for kwargs, plain in (({"r1_gp_weight": 1.0}, True), ({"spectral_norm": True}, False)):
        loss = VQLPIPSWithDiscriminator(disc_tran_hidden_size=64, disc_tran_n_heads=2,
                                        disc_tran_n_layers=1, **kwargs)
        blocks = loss.discriminator.transformer_encoder.blocks
        assert all(b.attn.plain_attention is plain for b in blocks)

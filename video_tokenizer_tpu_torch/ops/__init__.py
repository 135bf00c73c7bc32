"""Kernels of the port and their plain PyTorch versions.

Importing this package builds nothing: `_build` compiles the CUDA sources
at the first launch on a card. `sincos` (the fixed positional-embedding
tables) is numpy only.
"""
from . import sincos
from .attention import attention, attention_reference, attention_with_lse, flash_attn_fwd
from .decode_attention import decode_attention, decode_attention_reference
from .quant_matmul import w8_matmul, w8_matmul_reference
from .vq import vq_argmax, vq_lookup, vq_lookup_reference

__all__ = [
    "attention", "attention_reference", "attention_with_lse", "flash_attn_fwd",
    "decode_attention", "decode_attention_reference", "w8_matmul", "w8_matmul_reference",
    "vq_argmax", "vq_lookup", "vq_lookup_reference", "sincos",
]

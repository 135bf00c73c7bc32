"""Codebook lookup for the VQ bottleneck: the CUDA kernel and its plain version.

Counterpart of `video_tokenizer_tpu/ops/vq.py`.

* `vq_argmax` wraps `csrc/vq_lookup_sm90.cu` (fp32 scores on the tensor
  cores as three TF32 products, the codebook split over a thread-block
  cluster; code dims 4, 8, 16, 24 and 32, 24 being the Leech codebook of
  the sq bottleneck, K = 196,560), which replaces the TPU kernel
  `_vq_kernel` in both of its modes;
  `vq_kernel` names the kernel a call launches (that one, for every code dim
  and mode). `csrc/vq_lookup.cu`, the earlier fp32-FMA kernel, stays built and
  is launched only by name through `_vq_launch`, to be timed beside it. On a
  CUDA tensor `vq_argmax` launches the kernel or raises; on a CPU tensor it
  runs `vq_lookup_reference`.
* `vq_argmax_tf32x3_tiled_reference` repeats the new kernel's arithmetic in
  plain PyTorch, for the CPU tests (`tests/test_torch_vq_tiled.py`); nothing
  else calls it.
* `vq_lookup_reference` is the plain version, the JAX package's
  `vq_lookup_xla`: fp32 scores, then argmax (the first maximum on ties).
* Stochastic mode samples codes from softmax(score * inv_temp) by Gumbel-max:
  argmax_k (score * inv_temp + g), g = -log(-log(u + 1e-10) + 1e-10) with u
  uniform from 24 random bits. The bits come from a counter-based
  Philox4x32-10 keyed by a 64-bit seed; `philox4x32_10` computes in PyTorch
  exactly the bits the kernel computes, so the two can be held index for
  index. (The JAX package draws from the TPU core's PRNG or
  `jax.random.gumbel`, so the port and JAX agree in distribution only.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .attention import split_tf32

_CODE_DIMS = (4, 8, 16, 24, 32)  # 24: the Leech codebook of the sq bottleneck
_VQ_CLUSTER = 8  # csrc/vq_lookup_sm90.cu: blocks of a cluster, the codebook's splits
_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC 2011)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * b for a 32-bit constant a and int64 b
    holding 32-bit values, without overflowing int64 (16-bit halves of b)."""
    b_hi, b_lo = b >> 16, b & 0xFFFF
    hi_part, lo_part = a * b_hi, a * b_lo  # each < 2**48
    hi = (hi_part + (lo_part >> 16)) >> 16
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 of counters (c0, c1, c2, c3) (int64 tensors of 32-bit
    values) under the 64-bit `seed`; returns four int64 tensors of 32 bits."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel_noise(M: int, K: int, seed: int, device=None) -> torch.Tensor:
    """The kernel's Gumbel noise g[m, k] (fp32 [M, K]): Philox on the counter
    (k // 4, m, 0, 0) gives the bits of codes 4 * (k // 4) + 0..3 of row m."""
    groups = (K + 3) // 4
    c0 = torch.arange(groups, device=device, dtype=torch.int64)[None, :].expand(M, groups)
    c1 = torch.arange(M, device=device, dtype=torch.int64)[:, None].expand(M, groups)
    zero = torch.zeros((), device=device, dtype=torch.int64)
    bits = torch.stack(philox4x32_10(c0, c1, zero, zero, seed), dim=-1).reshape(M, 4 * groups)
    u = (bits[:, :K] & 0xFFFFFF).float() * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


def vq_lookup_reference(z, emb, score_bias: Optional[torch.Tensor] = None, *,
                        stochastic: bool = False, inv_temp: float = 1.0,
                        seed: int = 0) -> torch.Tensor:
    """argmax_k (z @ emb.T + score_bias[k]) in fp32 (times inv_temp, plus the
    Gumbel noise of `seed`, if stochastic). z: [M, d] -> int32 [M]."""
    s = z.float() @ emb.float().T
    if score_bias is not None:
        s = s + score_bias.float()[None, :]
    if stochastic:
        s = s * inv_temp + gumbel_noise(s.shape[0], s.shape[1], seed, s.device)
    return torch.argmax(s, dim=-1).to(torch.int32)


def vq_kernel(d: int, stochastic: bool) -> str:
    """The kernel a `vq_argmax` call on the card launches: the tensor-core
    kernel of `csrc/vq_lookup_sm90.cu` for every code dim (4, 8, 16, 24, 32)
    and both modes. The one place where the choice is made; no call falls back to
    the earlier `vq_argmax_kernel`."""
    if d not in _CODE_DIMS:
        raise ValueError(f"vq_kernel: d {d} not in {_CODE_DIMS}")
    return "vq_tc_kernel"


def vq_tile_codes(d: int) -> int:
    """Codes of one shared-memory tile of `vq_tc_kernel` at code dim d (its
    `Geometry<D>::kTileCodes`): 64 KB of TF32 fragments, 64 bytes a code and
    k-step of 8 dims, where that divides; 512 codes (96 KB) at d = 24."""
    if d not in _CODE_DIMS:
        raise ValueError(f"vq_tile_codes: d {d} not in {_CODE_DIMS}")
    return 512 if d == 24 else 1024 // max(1, d // 8)


def vq_tile_code(j: int, c: int) -> int:
    """Code offset, within a codebook tile of `csrc/vq_lookup_sm90.cu`, of
    column c of 8-code n-tile j (the kernel's `tile_code`): n-tiles go in
    pairs of 16 codes, and the four columns 2 tig, 2 tig + 1 of both tiles of a
    pair, which one thread holds of a row, are codes 16 p + 4 tig .. + 3: one
    Philox group."""
    return 16 * (j // 2) + 4 * (c // 2) + 2 * (j % 2) + c % 2


def vq_argmax_tf32x3_tiled_reference(z, emb, score_bias: Optional[torch.Tensor] = None, *,
                                     stochastic: bool = False, inv_temp: float = 1.0,
                                     seed: int = 0, n_splits: int = _VQ_CLUSTER) -> torch.Tensor:
    """The arithmetic of `vq_tc_kernel`, in plain PyTorch (tests only). Same
    contract as `vq_lookup_reference`.

    What it repeats of the kernel: z and the codes padded with zeros to whole
    k-steps of 8 dims and split into TF32 parts (`split_tf32`); per k-step the
    three products in the kernel's order, lo.hi, hi.lo, then hi.hi, added to
    an accumulator that starts at the bias (first k-step) or at zero (the
    others, joined to the first by an fp32 add); Gumbel noise as the kernel
    draws it, one Philox group per thread's four codes of a pair of n-tiles;
    the codebook cut into `n_splits` slices of ceil(K / n_splits) codes
    rounded up to 16, each scanned in tiles of `vq_tile_codes(d)` codes (the
    argmax of a tile, first maximum, replacing the running best only by a
    larger score), and the merge of the slices in order, a later slice
    winning only by a larger score."""
    M, d = z.shape
    K = emb.shape[0]
    steps = max(1, d // 8)
    pad = 8 * steps - d
    zh, zl = split_tf32(torch.nn.functional.pad(z.float(), (0, pad)))
    eh, el = split_tf32(torch.nn.functional.pad(emb.float(), (0, pad)))
    s = None
    for ks in range(steps):
        c = slice(8 * ks, 8 * ks + 8)
        acc = torch.zeros((M, K), device=z.device)
        if ks == 0 and score_bias is not None:
            acc = acc + score_bias.float()[None, :]
        for a, b in ((zl, eh), (zh, el), (zh, eh)):
            acc = acc + a[:, c] @ b[:, c].T
        s = acc if s is None else s + acc
    if stochastic:
        s = s * inv_temp + _gumbel_by_thread(M, K, seed, s.device)
    size = -(-K // n_splits)  # codes of a slice: ceil(K / n_splits), rounded up to 16
    size = -(-size // 16) * 16
    tile = vq_tile_codes(d) if d in _CODE_DIMS else size
    best = torch.full((M,), float("-inf"), device=z.device)
    idx = torch.zeros((M,), dtype=torch.int64, device=z.device)
    for lo in range(0, K, size):  # a split: its tiles in ascending order
        hi = min(lo + size, K)
        s_best, s_idx = torch.full_like(best, float("-inf")), torch.zeros_like(idx)
        for t in range(lo, hi, tile):
            part = s[:, t : min(t + tile, hi)]
            i = torch.argmax(part, dim=-1)
            v = part.gather(1, i[:, None])[:, 0]
            take = v > s_best
            s_best, s_idx = torch.where(take, v, s_best), torch.where(take, t + i, s_idx)
        take = s_best > best
        best, idx = torch.where(take, s_best, best), torch.where(take, s_idx, idx)
    return idx.to(torch.int32)


def _gumbel_by_thread(M: int, K: int, seed: int, device) -> torch.Tensor:
    """The kernel's noise, drawn as its threads draw it: for each pair of
    n-tiles p and thread column tig, one Philox call on the counter of the
    codes `vq_tile_code` gives that thread, (code // 4, m, 0, 0), whose four
    words are those four codes' bits in order."""
    pairs = -(-K // 16)
    codes = torch.tensor([[vq_tile_code(2 * p + h, 2 * tig + e) for h in (0, 1) for e in (0, 1)]
                          for p in range(pairs) for tig in range(4)], dtype=torch.int64,
                         device=device)  # [pairs * 4 threads, 4 codes], ascending per thread
    c0 = (codes[:, 0] // 4)[None, :].expand(M, -1)
    c1 = torch.arange(M, device=device, dtype=torch.int64)[:, None].expand_as(c0)
    zero = torch.zeros((), device=device, dtype=torch.int64)
    bits = torch.stack(philox4x32_10(c0, c1, zero, zero, seed), dim=-1)  # [M, threads, 4]
    u = (bits & 0xFFFFFF).float() * (1.0 / 16777216.0)
    g = torch.empty((M, 16 * pairs), device=device)
    g[:, codes.reshape(-1)] = (-torch.log(-torch.log(u + 1e-10) + 1e-10)).reshape(M, -1)
    return g[:, :K]


def vq_argmax(z, emb, score_bias: Optional[torch.Tensor] = None, *, stochastic: bool = False,
              inv_temp: float = 1.0, seed: int = 0) -> torch.Tensor:
    """Codebook kernel. z: [M, d] fp32, emb: [K, d] fp32, bias: [K] fp32;
    `seed` (0 <= seed < 2**63) keys the Gumbel noise of stochastic mode."""
    if z.device.type == "cpu":
        return vq_lookup_reference(z, emb, score_bias, stochastic=stochastic,
                                   inv_temp=inv_temp, seed=seed)
    if z.device.type != "cuda":
        raise ValueError(f"vq_argmax: no kernel for device {z.device}")
    operands = [("z", z), ("emb", emb)] + ([("bias", score_bias)] if score_bias is not None else [])
    for name, x in operands:
        if x.device != z.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"vq_argmax: {name} must be contiguous fp32 on {z.device} "
                f"(got {x.dtype} on {x.device})"
            )
    M, d = z.shape
    K = emb.shape[0]
    if emb.shape != (K, d) or d not in _CODE_DIMS or K < 1:
        raise ValueError(f"vq_argmax: z {tuple(z.shape)}, emb {tuple(emb.shape)}; d in {_CODE_DIMS}")
    if score_bias is not None and score_bias.shape != (K,):
        raise ValueError(f"vq_argmax: bias {tuple(score_bias.shape)} != {(K,)}")
    if not 0 <= seed < 2**63:
        raise ValueError(f"vq_argmax: seed {seed} outside [0, 2**63)")
    idx = torch.empty((M,), dtype=torch.int32, device=z.device)
    if M:
        kernel = vq_kernel(d, stochastic)
        _vq_launch(kernel, z, emb, score_bias, idx, stochastic, inv_temp, seed)
        vq_argmax.launches += 1
        vq_argmax.launches_tc += kernel == "vq_tc_kernel"
        vq_argmax.last_kernel = kernel
    return idx


def _vq_launch(kernel: str, z, emb, score_bias, idx, stochastic: bool, inv_temp: float,
               seed: int) -> None:
    """Launches the named VQ kernel on checked operands (see `vq_argmax`)."""
    M, d = z.shape
    lib = _build.library()
    entry = lib.vtt_vq_argmax_sm90 if kernel == "vq_tc_kernel" else lib.vtt_vq_argmax
    with torch.cuda.device(z.device):
        code = entry(
            z.data_ptr(), emb.data_ptr(),
            score_bias.data_ptr() if score_bias is not None else None,
            idx.data_ptr(), M, emb.shape[0], d, int(stochastic), float(inv_temp), int(seed),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(code, kernel)


vq_argmax.launches = 0  # kernel launches (either kernel), read by chip_smoke.py
vq_argmax.launches_tc = 0  # of which vq_tc_kernel
vq_argmax.last_kernel = None  # name of the kernel the last call launched


def vq_lookup(z, emb, *, metric: str = "l2", stochastic: bool = False, inv_temp: float = 1.0,
              seed: int = 0) -> torch.Tensor:
    """Nearest-code lookup, or sampling. z: [..., d] -> int32 indices [...].

    metric='l2' : argmin |z - e|^2 == argmax (z.e - |e|^2 / 2).
    metric='cos': argmax z.e (the caller pre-normalises z and emb).
    stochastic  : a sample of softmax(score * inv_temp) by Gumbel-max, the
                  noise keyed by `seed`."""
    batch_shape = z.shape[:-1]
    zf = z.detach().reshape(-1, z.shape[-1]).float().contiguous()
    emb = emb.detach().float().contiguous()
    if metric == "l2":
        bias = -0.5 * torch.sum(emb**2, dim=-1)
    elif metric == "cos":
        bias = None
    else:
        raise ValueError(metric)
    idx = vq_argmax(zf, emb, bias, stochastic=stochastic, inv_temp=inv_temp, seed=seed)
    return idx.reshape(batch_shape)

"""Semantic-alignment utilities and `larp_tokenizer_sem`, in PyTorch.

Counterpart of `video_tokenizer_tpu/models/sem.py`:
  * `SoftKMeans`: soft prototype pooling, initial centres drawn from the
    tokens, `iters` softmax-weighted updates. The draw is an argument: the
    indices themselves (the tests feed JAX's) or a `torch.Generator`;
  * `gram_matrix`, `pca_subspace_basis`, `_degenerate_dummy`,
    `subspace_alignment_loss` (degenerate samples swapped for a
    well-conditioned dummy before the SVD and masked out of the mean; the
    loss is invariant to the signs of the singular vectors), `off_diagonal`
    and `vicreg_pooled_loss`;
  * `VJepaAlignerV3`: student and teacher MLPs into a common width, the
    teacher's grid resized to the student's (`utils/resize.py`, JAX's
    antialiased trilinear resize), prototypes of both matched by MSE;
  * `larp_tokenizer_sem` (`LARPTokenizerSem`, built by `_sem_factory` from
    flat LARP-tokenizer arguments): the LARP tokenizer, and in train mode a
    frozen V-JEPA2 teacher (`models/vfm.py::VJEPA2TeacherViT`, 1024 wide,
    16 heads: head dim 64) and the aligner, adding `align_loss` (0.5 x the
    aligner's, before the trainer's 0.2) and `gram_loss`. Its k-means draw
    comes from the model's `sample_generator` (one of the generators the
    trainer saves and restores); the JAX module folds it from the `vq` rng
    stream, and the two cannot draw the same bits.
Module and parameter names are the Flax names (the aligner's MLPs keep
Flax `nn.Sequential`'s `layers_0`, `layers_1`, `layers_3`).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import models
from .larp_tokenizer import LARPTokenizer
from .layers import Dense, LayerNorm
from .vfm import VJEPA2TeacherViT, preprocess_for_teacher

Draw = Union[None, torch.Tensor, torch.Generator]


def kmeans_indices(draw: Draw, B: int, K: int, N: int, device) -> torch.Tensor:
    """[B, K] initial-centre indices in [0, N): `draw` itself if a tensor, else
    drawn from the generator `draw` (on the host, then moved)."""
    if isinstance(draw, torch.Tensor):
        if tuple(draw.shape) != (B, K):
            raise ValueError(f"k-means indices {tuple(draw.shape)}, expected {(B, K)}")
        return draw.to(device=device, dtype=torch.long)
    return torch.randint(0, N, (B, K), generator=draw).to(device)


class SoftKMeans(nn.Module):
    def __init__(self, num_prototypes: int = 256, iters: int = 5, temp: float = 0.5,
                 eps: float = 1e-6):
        super().__init__()
        self.num_prototypes, self.iters, self.temp, self.eps = num_prototypes, iters, temp, eps

    def forward(self, x: torch.Tensor, draw: Draw = None) -> torch.Tensor:
        """x [B, N, D] -> prototypes [B, K, D] (fp32)."""
        x = x.float()
        B, N, D = x.shape
        idx = kmeans_indices(draw, B, self.num_prototypes, N, x.device)
        c = torch.gather(x, 1, idx[..., None].expand(B, self.num_prototypes, D))
        x2 = (x * x).sum(-1, keepdim=True)  # [B, N, 1]
        for _ in range(self.iters):
            c2 = (c * c).sum(-1)[:, None, :]  # [B, 1, K]
            dist2 = x2 + c2 - 2 * torch.einsum("bnd,bkd->bnk", x, c)
            w = torch.softmax(-dist2 / max(self.temp, self.eps), dim=-1)
            denom = w.sum(1)[..., None] + self.eps
            c = torch.einsum("bnk,bnd->bkd", w, x) / denom
        return c


def gram_matrix(tokens: torch.Tensor, normalize_tokens: bool = True, eps: float = 1e-6):
    if normalize_tokens:
        tokens = tokens / (torch.linalg.vector_norm(tokens, dim=-1, keepdim=True) + eps)
    return torch.einsum("bnd,bmd->bnm", tokens, tokens)


def pca_subspace_basis(tokens: torch.Tensor, r: int = 32, center: bool = True) -> torch.Tensor:
    """Top-r right-singular directions of each batch's token set: [B, K, D]
    -> [B, D, r], orthonormal columns."""
    x = tokens
    if center:
        x = x - x.mean(dim=1, keepdim=True)
    vh = torch.linalg.svd(x, full_matrices=False).Vh  # [B, min(K, D), D]
    return vh[:, :r, :].transpose(1, 2)


def _degenerate_dummy(K: int, D: int, device=None) -> torch.Tensor:
    """[K, D] with the distinct singular values 1..min(K, D): the SVD input put
    in place of a degenerate sample."""
    n = min(K, D)
    out = torch.zeros(K, D, device=device)
    i = torch.arange(n, device=device)
    out[i, i] = torch.arange(1.0, n + 1.0, device=device)
    return out


def subspace_alignment_loss(u_tokens: torch.Tensor, v_tokens: torch.Tensor, r: int = 32,
                            var_eps: float = 1e-8) -> torch.Tensor:
    """r - ||Bu^T Bv||_F^2 per sample, averaged over the samples whose token
    sets both vary (var > var_eps); the others are swapped for
    `_degenerate_dummy` before the SVD, whose gradient would be NaN on
    coincident singular values, and masked out."""
    ok = (u_tokens.var(dim=(1, 2), unbiased=False) > var_eps) & (
        v_tokens.var(dim=(1, 2), unbiased=False) > var_eps)
    du = _degenerate_dummy(*u_tokens.shape[1:], device=u_tokens.device)[None]
    dv = _degenerate_dummy(*v_tokens.shape[1:], device=v_tokens.device)[None]
    u_tokens = torch.where(ok[:, None, None], u_tokens, du)
    v_tokens = torch.where(ok[:, None, None], v_tokens, dv)
    bu, bv = pca_subspace_basis(u_tokens, r), pca_subspace_basis(v_tokens, r)
    m = torch.einsum("bdr,bds->brs", bu, bv)
    per_sample = m.shape[1] - (m * m).sum(dim=(1, 2))
    return (per_sample * ok).sum() / torch.clamp(ok.sum(), min=1)


def off_diagonal(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return x.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(-1)


def vicreg_pooled_loss(s_tok, t_tok, sim_w: float = 25.0, var_w: float = 25.0,
                       cov_w: float = 1.0, eps: float = 1e-4
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, y = s_tok.mean(dim=1), t_tok.mean(dim=1)
    sim = torch.mean((x - y) ** 2)

    def var_term(z):
        std = torch.sqrt(z.var(dim=0, unbiased=False) + eps)
        return torch.mean(F.relu(1.0 - std))

    def cov_term(z):
        z = z - z.mean(dim=0, keepdim=True)
        B, D = z.shape
        cov = (z.T @ z) / (B - 1 + 1e-6)
        return (off_diagonal(cov) ** 2).sum() / D

    var = var_term(x) + var_term(y)
    cov = cov_term(x) + cov_term(y)
    total = sim_w * sim + var_w * var + cov_w * cov
    return total, {"vic_sim": sim, "vic_var": var, "vic_cov": cov}


class _MLP(nn.Module):
    """Dense -> LayerNorm -> exact GELU -> Dense (Flax `nn.Sequential`'s names)."""

    def __init__(self, d_in: int, d: int, generator=None, device=None):
        super().__init__()
        kw = dict(init="lecun_normal", generator=generator, device=device)
        self.layers_0 = Dense(d_in, d, **kw)
        self.layers_1 = LayerNorm(d, device=device)
        self.layers_3 = Dense(d, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_3(F.gelu(self.layers_1(self.layers_0(x)), approximate="none"))


class VJepaAlignerV3(nn.Module):
    def __init__(self, student_dim: int, teacher_dim: int, student_grid: Tuple[int, int, int],
                 common_dim: int = 512, num_prototypes: int = 256, kmeans_iters: int = 5,
                 kmeans_temp: float = 0.2, gram_weight: float = 2.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.student_grid, self.gram_weight = tuple(student_grid), gram_weight
        self.student_proj = _MLP(student_dim, common_dim, generator, device)
        self.teacher_proj = _MLP(teacher_dim, common_dim, generator, device)
        self.pool = SoftKMeans(num_prototypes, kmeans_iters, kmeans_temp)

    def forward(self, student_q: torch.Tensor, teacher_feats: torch.Tensor,
                teacher_grid_shape: Tuple[int, int, int],
                draws: Tuple[Draw, Draw] = (None, None)
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`draws`: the student's and the teacher's k-means draws (indices or
        generators; JAX splits its rng in two)."""
        from ..utils.resize import resize

        ts, hs, ws = self.student_grid
        tt, ht, wt = teacher_grid_shape
        s = self.student_proj(student_q.float())
        t = self.teacher_proj(teacher_feats.float())
        expected = tt * ht * wt
        if t.shape[1] == expected + 1:
            t = t[:, 1:]
        t = t[:, :expected]
        B, _, Dc = t.shape
        t_aligned = resize(t.reshape(B, tt, ht, wt, Dc), (B, ts, hs, ws, Dc), "trilinear")
        t_tok = t_aligned.reshape(B, ts * hs * ws, Dc)
        s_proto = self.pool(s, draws[0])
        t_proto = self.pool(t_tok.detach(), draws[1])
        gram_loss = torch.mean((s_proto - t_proto) ** 2)
        return self.gram_weight * gram_loss, {"gram_loss": gram_loss}


@models.register("larp_tokenizer_sem")
class LARPTokenizerSem(nn.Module):
    """LARPTokenizer + frozen V-JEPA2 teacher + prototype alignment (train mode only)."""

    def __init__(self, tokenizer_args: Dict[str, Any], use_vjepa_loss: bool = True,
                 teacher_dim: int = 1024, teacher_depth: int = 8, teacher_heads: int = 16,
                 vjepa2_img_size: int = 256, vjepa2_num_frames: int = 16,
                 vjepa2_patch_size: int = 16, vjepa2_tubelet_size: int = 2,
                 latent_grid_shape: Tuple[int, int, int] = (4, 16, 16),
                 align_common_dim: int = 256, align_num_prototypes: int = 256,
                 align_kmeans_iters: int = 5, align_kmeans_temp: float = 0.2,
                 align_gram_weight: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.tokenizer = LARPTokenizer(**{**tokenizer_args, "dtype": dtype}, **kw)
        self.use_vjepa_loss = use_vjepa_loss
        self.vjepa2_img_size = vjepa2_img_size
        self.teacher_grid = (vjepa2_num_frames // vjepa2_tubelet_size,
                             vjepa2_img_size // vjepa2_patch_size,
                             vjepa2_img_size // vjepa2_patch_size)
        if use_vjepa_loss:
            self.teacher_model = VJEPA2TeacherViT(
                teacher_dim, teacher_depth, teacher_heads, vjepa2_img_size, vjepa2_num_frames,
                vjepa2_patch_size, vjepa2_tubelet_size, (teacher_depth - 1,), dtype, **kw)
            self.aligner = VJepaAlignerV3(
                tokenizer_args.get("decoder_hidden_size", 768), teacher_dim, latent_grid_shape,
                align_common_dim, align_num_prototypes, align_kmeans_iters, align_kmeans_temp,
                align_gram_weight, **kw)
        # the k-means draws of train-mode forwards (saved with the trainer's state)
        seed = int(torch.randint(0, 2**62, (), generator=generator)) if generator else 0
        self.sample_generator = torch.Generator().manual_seed(seed)

    @property
    def bottleneck_token_num(self) -> int:
        return self.tokenizer.bottleneck_token_num

    @property
    def codebook_size(self) -> int:
        return self.tokenizer.codebook_size

    @property
    def frame_num(self) -> int:
        return self.tokenizer.frame_num

    @property
    def input_size(self) -> int:
        return self.tokenizer.input_size

    def encode(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        return self.tokenizer.encode(x, train=train)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.decode(z)

    def decode_from_bottleneck(self, rep: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.decode_from_bottleneck(rep)

    def forward(self, data: torch.Tensor, train: bool = False,
                kmeans_draws: Optional[Tuple[Draw, Draw]] = None) -> Dict[str, Any]:
        """`kmeans_draws`: the aligner's two k-means draws (indices or
        generators); default the model's `sample_generator`. Eval batches
        skip the teacher, as the reference does."""
        out = self.tokenizer(data, train=train)
        if self.use_vjepa_loss and train:
            taps = self.teacher_model(preprocess_for_teacher(data, self.vjepa2_img_size))
            draws = kmeans_draws or (self.sample_generator, self.sample_generator)
            align_loss, info = self.aligner(out["encoded"], taps[-1], self.teacher_grid, draws)
            # 0.5x before the trainer's 0.2, as the reference halves it
            out["align_loss"] = 0.5 * align_loss
            out["gram_loss"] = info["gram_loss"]
        return out


_SEM_FIELDS = set(inspect.signature(LARPTokenizerSem.__init__).parameters) - {
    "self", "tokenizer_args", "generator", "device", "dtype"}
_TOK_FIELDS = set(inspect.signature(LARPTokenizer.__init__).parameters) - {
    "self", "generator", "device", "dtype"}


def _sem_factory(**kwargs):
    """The registry entry: flat LARP-tokenizer arguments plus the align_* /
    vjepa2_* / teacher_* keys (the reference's larp_tokenizer_sem signature)."""
    common = {k: kwargs[k] for k in ("generator", "device", "dtype") if k in kwargs}
    sem_args = {k: v for k, v in kwargs.items() if k in _SEM_FIELDS}
    tok_args = {k: v for k, v in kwargs.items() if k in _TOK_FIELDS}
    return LARPTokenizerSem(tokenizer_args=tok_args, **sem_args, **common)


models.update({"larp_tokenizer_sem": _sem_factory})

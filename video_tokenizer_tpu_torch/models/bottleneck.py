"""Bottleneck projections, the VQ and summed-KL regularizers, the bottleneck norms.

Counterpart of `video_tokenizer_tpu/models/bottleneck.py`:
  * `Bottleneck`: in/out projections around a regularizer (the in-projection
    twice as wide for a KL regularizer: mean and logvar interleaved), an
    optional norm of the projected z: LayerNorm over the last dim (`ln_d`,
    `ln_d_na` without scale and bias) or over (tokens, dim) with a (n, d)
    scale and bias (`ln_nd`), or BatchNorm (`bn_bn` over [b * n, d], `bn_b`
    over [b, n * d]; `FlaxBatchNorm`); returns the same dict as the JAX
    module.
  * `SimpleVectorQuantizer` ("vq"): l2-normalised (x / (|x| + 1e-12)) or raw
    codebook, nearest-code lookup or (stochastic, in training or with
    `eval_deterministic=False`) a sample of softmax(cos * inv_temp) through
    `ops.vq` (the CUDA kernel on the card), commitment / codebook / entropy
    losses, straight-through estimator. Each sampling call draws its 64-bit
    seed from the module's own `torch.Generator` (`sample_generator`), seeded
    from the init generator: one draw per call, as the JAX module draws one
    seed from its 'vq' key.
  * `SummedKLDivergenceRegularizer` ("skl"): a diagonal Gaussian from the
    interleaved (mean, logvar), logvar clipped to [-30, 20], a sample mean +
    std * noise whose noise comes from the module's host generator
    (`sample_generator`, so the card and the CPU draw the same noise), and
    `loss_kl`, the KL to N(0, 1) summed per clip and averaged.
  * `entropy_loss`.
The whole bottleneck computes in fp32, whatever the model's compute dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.vq import vq_lookup
from ..registry import models
from .layers import Dense, LayerNorm


def entropy_loss(affinity: torch.Tensor, loss_type: str = "softmax", temperature: float = 0.01):
    """Sample entropy minus codebook entropy of softmaxed affinities."""
    flat = affinity.reshape(-1, affinity.shape[-1]) / temperature
    probs = torch.softmax(flat, dim=-1)
    log_probs = torch.log_softmax(flat + 1e-5, dim=-1)
    if loss_type == "softmax":
        target_probs = probs
    elif loss_type == "argmax":
        onehots = nn.functional.one_hot(flat.argmax(-1), flat.shape[-1]).to(flat.dtype)
        target_probs = probs - (probs - onehots).detach()
    else:
        raise ValueError(f"Entropy loss {loss_type} not supported")
    avg_probs = target_probs.mean(0)
    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-5))
    sample_entropy = -torch.mean(torch.sum(target_probs * log_probs, dim=-1))
    return sample_entropy - avg_entropy, sample_entropy, avg_entropy


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    # not F.normalize: the JAX package divides by |x| + 1e-12
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


@models.register("vq")
class SimpleVectorQuantizer(nn.Module):
    def __init__(self, dim: int, codebook_size: int, commitment_loss_weight: float = 0.25,
                 entropy_loss_weight: float = 0.0, entropy_loss_temperature: float = 0.01,
                 l2_normalized: bool = False, stochastic: bool = False,
                 stochastic_temperature: float = 1.0, codebook_loss_weight: float = 1.0,
                 eval_deterministic: bool = True, token_nums: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if stochastic and not l2_normalized:
            raise ValueError("stochastic VQ sampling requires l2_normalized")
        self.dim, self.codebook_size = dim, codebook_size
        self.commitment_loss_weight = commitment_loss_weight
        self.codebook_loss_weight = codebook_loss_weight
        self.entropy_loss_weight = entropy_loss_weight
        self.entropy_loss_temperature = entropy_loss_temperature
        self.l2_normalized, self.stochastic = l2_normalized, stochastic
        self.eval_deterministic = eval_deterministic
        self.embedding = nn.Embedding(codebook_size, dim, device=device)
        with torch.no_grad():  # U(+-sqrt(6 / dim)), torch's kaiming_uniform_
            nn.init.kaiming_uniform_(self.embedding.weight, generator=generator)
        self.stochastic_temperature = stochastic_temperature
        if stochastic and stochastic_temperature <= 0:  # learnable inverse temperature
            self.stochastic_temperature_inv = nn.Parameter(torch.tensor(10.0, device=device))
        # the sampling seeds' generator, on the host: one draw per call
        seed = 0 if generator is None else int(torch.randint(2**62, (), generator=generator))
        self.sample_generator = torch.Generator().manual_seed(seed)

    def get_emb(self) -> torch.Tensor:
        emb = self.embedding.weight.float()
        return _l2_normalise(emb) if self.l2_normalized else emb

    def forward(self, z: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        if z.ndim != 3:
            raise ValueError("Input shape must be (batch, n_tokens, e_dim)")
        z = z.float()
        if self.l2_normalized:
            z = _l2_normalise(z)
        emb = self.get_emb()
        if not self.stochastic:
            q_indices = vq_lookup(z, emb, metric="l2")
        else:
            sample = train or not self.eval_deterministic
            seed = self.draw_seed() if sample else 0
            if hasattr(self, "stochastic_temperature_inv"):
                # a learnable temperature is folded into z, as the JAX module does
                q_indices = vq_lookup(z * self.stochastic_temperature_inv.detach(), emb,
                                      metric="cos", stochastic=sample, seed=seed)
            else:  # (a fixed temperature does not move a deterministic argmax)
                q_indices = vq_lookup(z, emb, metric="cos", stochastic=sample,
                                      inv_temp=1.0 / self.stochastic_temperature, seed=seed)
        quantized = emb[q_indices.long()]

        loss_commit = torch.mean((quantized.detach() - z) ** 2)
        loss_codebook = torch.mean((quantized - z.detach()) ** 2)
        zero = torch.zeros((), device=z.device)
        loss_entropy = sample_entropy = avg_entropy = zero
        if self.entropy_loss_weight > 0:
            zf = z.reshape(-1, self.dim)
            d = (
                torch.sum(zf**2, dim=1, keepdim=True)
                + torch.sum(emb**2, dim=1)[None, :]
                - 2.0 * zf @ emb.T
            )
            loss_entropy, sample_entropy, avg_entropy = entropy_loss(
                -d, temperature=self.entropy_loss_temperature
            )
        loss = (
            self.commitment_loss_weight * loss_commit
            + self.codebook_loss_weight * loss_codebook
            + self.entropy_loss_weight * loss_entropy
        )
        quantized = z + (quantized - z).detach()  # straight-through estimator
        return {
            "unregularized_z": z,
            "emb": emb,
            "regularized_z": quantized,
            "bottleneck_rep": q_indices,
            "loss_q": loss,
            "loss_commit": loss_commit,
            "loss_codebook": loss_codebook,
            "loss_entropy": loss_entropy,
            "per_sample_entropy": sample_entropy,
            "codebook_entropy": avg_entropy,
        }

    def draw_seed(self) -> int:
        """The next sampling seed (0 <= seed < 2**62) from `sample_generator`."""
        return int(torch.randint(2**62, (), generator=self.sample_generator))

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return self.get_emb()[indices.long()]


@models.register("skl")
class SummedKLDivergenceRegularizer(nn.Module):
    """Diagonal-Gaussian KL regularizer; the input is (mean, logvar) interleaved."""

    def __init__(self, dim: int, token_nums: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dim = dim
        # the noise's generator, on the host (the JAX module draws from 'vq')
        seed = 0 if generator is None else int(torch.randint(2**62, (), generator=generator))
        self.sample_generator = torch.Generator().manual_seed(seed)

    def forward(self, z: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        if z.shape[-1] != self.dim * 2:
            raise ValueError(f"skl takes (mean, logvar) interleaved: last dim {2 * self.dim}, "
                             f"got {z.shape[-1]}")
        mean, logvar = z[..., ::2], z[..., 1::2]
        logvar = logvar.clamp(-30.0, 20.0)
        std, var = torch.exp(0.5 * logvar), torch.exp(logvar)
        noise = torch.randn(mean.shape, generator=self.sample_generator, dtype=mean.dtype)
        z_sampled = mean + std * noise.to(mean.device)
        loss_kl = 0.5 * (mean**2 + var - 1.0 - logvar)
        loss_kl = loss_kl.reshape(loss_kl.shape[0], -1).sum(dim=1).mean()
        return {"regularized_z": z_sampled, "bottleneck_rep": mean, "loss_kl": loss_kl}

    def decode(self, z_bottleneck: torch.Tensor) -> torch.Tensor:
        return z_bottleneck


class FlaxBatchNorm(nn.BatchNorm1d):
    """Flax `nn.BatchNorm(momentum=0.9)` over x [N, F] under torch's names.

    In training it normalises with the batch's mean and its BIASED variance,
    E[x^2] - E[x]^2 clipped at 0 (Flax's fast variance), and moves the running
    statistics by 0.1 toward them; `torch.nn.BatchNorm1d` would move
    `running_var` toward the unbiased variance. Otherwise it normalises
    with the running statistics. eps 1e-5, fp32."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


@models.register("bottleneck")
class Bottleneck(nn.Module):
    """Linear in/out projections around a latent regularizer (fp32)."""

    def __init__(self, bottleneck_dim: int, input_dim: int, output_dim: int,
                 token_nums: int, norm: Optional[str] = None,
                 regularizer: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        norm = (norm or "none").lower()
        self._norm = None if norm in ("no", "none") else norm
        if bottleneck_dim > 0:
            bdim = bottleneck_dim
        else:
            if input_dim != output_dim:
                raise ValueError("bottleneck_dim <= 0 needs input_dim == output_dim")
            bdim = input_dim
        reg_name = None if regularizer is None else regularizer["name"].lower()
        # a KL regularizer takes mean and logvar: twice the width
        pdim = bdim * 2 if reg_name and "kl" in reg_name and reg_name != "vqkl" else bdim
        if bottleneck_dim > 0:
            self.in_linear = Dense(input_dim, pdim, init="lecun_normal", generator=generator, device=device)
            self.out_linear = Dense(bdim, output_dim, init="lecun_normal", generator=generator, device=device)
        else:
            self.in_linear = self.out_linear = nn.Identity()
        if self._norm == "ln_d":
            self.norm_layer = LayerNorm(pdim, device=device)
        elif self._norm == "ln_d_na":
            self.norm_layer = LayerNorm(pdim, affine=False)
        elif self._norm == "ln_nd":
            self.norm_layer = LayerNorm((token_nums, pdim), device=device)
        elif self._norm == "bn_bn":
            self.norm_layer = FlaxBatchNorm(pdim, device=device)
        elif self._norm == "bn_b":
            self.norm_layer = FlaxBatchNorm(token_nums * pdim, device=device)
        elif self._norm is not None:
            raise ValueError(f"Normalization type {self._norm} not supported")
        self.regularizer = None
        if reg_name is not None and reg_name not in ("no", "none"):
            self.regularizer = models.make(
                regularizer,
                args={"dim": bdim, "token_nums": token_nums, "generator": generator, "device": device},
            )

    def project_in(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = self.in_linear(x)
        if self._norm is None:
            return z
        z = z.float()
        if not self._norm.startswith("bn"):
            return self.norm_layer(z)
        b, n, d = z.shape  # BatchNorm over [b * n, d] (bn_bn) or [b, n * d] (bn_b)
        flat = z.reshape(b * n, d) if self._norm == "bn_bn" else z.reshape(b, n * d)
        return self.norm_layer(flat, train).reshape(b, n, d)

    def decode(self, bottleneck_rep: torch.Tensor) -> torch.Tensor:
        return self.out_linear(self.regularizer.decode(bottleneck_rep))

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        input_norm_first = torch.linalg.vector_norm(x[:, 0, :], dim=-1).mean()
        input_norm_last = torch.linalg.vector_norm(x[:, -1, :], dim=-1).mean()
        z = self.project_in(x, train)
        if self.regularizer is not None:
            reg_out = dict(self.regularizer(z, train=train))
        else:
            reg_out = {"regularized_z": z, "bottleneck_rep": z}
        x_hat = self.out_linear(reg_out["regularized_z"])
        return {
            "output": x_hat,
            "bottleneck_rep": reg_out.pop("bottleneck_rep"),
            "projected_z": z,
            "input_norm_first": input_norm_first,
            "input_norm_last": input_norm_last,
            **reg_out,
        }

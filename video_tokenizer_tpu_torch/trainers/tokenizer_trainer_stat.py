"""STAT tokenizer trainer: the adaptive-token-count losses.

Counterpart of `video_tokenizer_tpu/trainers/tokenizer_trainer_stat.py`.
`stat_loss`: 0.1 x the content term (1 - the squared Pearson correlation
between each clip's mean keep probability and its LPIPS, 0 where that is
NaN; where the correlation's denominator is 0, a batch of one clip among
them, its gradient is 0 here and NaN in the JAX function, a fault not
copied) + 0.01 x the mean rise between neighbouring probabilities (they should
decrease along the latents) + 0.01 x the squared distance of the mean
probability to a target sparsity + 0.0005 / (the probabilities' variance +
1e-4) (diversity); `avg_tokens` counts the latents kept at probs > 0.5.
`LARPTokenizerTrainerStat` runs the tokenizer trainer's step with the
model's stage of the epoch (`get_stage`, logged as `STAT stage -> ...` when
it changes) and its own CPU generator (`stat_gen`) for every draw: the
forward's Bernoulli masks and random prefixes, and the target sparsity,
uniform in [0.85, 0.99] each step. The STAT losses join the generator loss
in the 'adaptive' stage, in training and in eval, as in the JAX step. The
generator is saved with the checkpoint, so a resumed run draws what an
uninterrupted one draws. `train_epoch` switches the stage and then runs the
base trainer's loop, so the SIGTERM checkpoint, `resume_skip_steps` and
`profile_steps` hold here too.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..registry import trainers
from .tokenizer_trainer import LARPTokenizerTrainer


def stat_loss(probs: torch.Tensor, lpips_scores: torch.Tensor, target_sparsity,
              lambda_content: float = 0.1, lambda_decrease: float = 0.01,
              lambda_sparse: float = 0.01) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """probs [B, N]; lpips_scores [B] (no gradient); target_sparsity a scalar."""
    s_probs = probs.mean(dim=-1)
    lp = lpips_scores.detach().float()
    lx, ly = lp - lp.mean(), s_probs - s_probs.mean()
    # sqrt(0) (a batch of one, or equal scores) has an infinite derivative, and
    # the JAX function's gradient is NaN there; the same value, gradient 0
    prod = torch.sum(lx**2) * torch.sum(ly**2)
    pos = prod > 0
    denom = torch.where(pos, torch.sqrt(torch.where(pos, prod, torch.ones_like(prod))), 0.0) + 1e-8
    corr = torch.sum(lx * ly) / denom
    content_loss = 1.0 - corr**2
    content_loss = torch.where(torch.isnan(content_loss), 0.0, content_loss)
    sparsity_loss = torch.mean((s_probs - target_sparsity) ** 2)
    loss_decrease = torch.mean(torch.relu(probs[:, 1:] - probs[:, :-1]))
    prob_var = torch.mean(torch.var(probs, dim=1, unbiased=False))
    # a division, as JAX divides (`0.0005 / t` would be t's reciprocal times 0.0005)
    diversity_loss = torch.full_like(prob_var, 0.0005) / (prob_var + 1e-4)
    total = (lambda_content * content_loss + lambda_decrease * loss_decrease
             + lambda_sparse * sparsity_loss + diversity_loss)
    info = {
        "loss_content": content_loss,
        "loss_decrease": loss_decrease,
        "loss_sparse": sparsity_loss,
        "diversity_loss": diversity_loss,
        "avg_tokens": torch.mean(torch.sum((probs > 0.5).float(), dim=-1)),
        "stat_target_sparsity": target_sparsity,
    }
    return total, info


@trainers.register("larp_tokenizer_trainer_stat")
class LARPTokenizerTrainerStat(LARPTokenizerTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self._stage = "adaptive"
        self.stat_gen = torch.Generator().manual_seed(self.seed + 1234)

    def train_epoch(self):
        stage = self.model.get_stage(self.epoch)
        if stage != self._stage:
            self._stage = stage
            self.log(f"STAT stage -> {stage}")
        return super().train_epoch()

    def _model_forward(self, data: torch.Tensor, train: bool) -> Dict[str, Any]:
        return self.model(data, train=train, stage=self._stage, generator=self.stat_gen)

    def _generator_extra_loss(self, out, data, pred
                              ) -> Tuple[Optional[torch.Tensor], Dict[str, Any]]:
        if self._stage != "adaptive" or "probs" not in out:
            return None, {}
        with torch.no_grad():
            lpips_scores = self.loss_mod.perceptual_per_sample(data, pred.detach())
        u = torch.rand((), generator=self.stat_gen)
        target = (0.85 + (0.99 - 0.85) * u).to(data.device)
        return stat_loss(out["probs"], lpips_scores, target)

    def _generators(self) -> Dict[str, torch.Generator]:
        return {**super()._generators(), "stat": self.stat_gen}

"""LARP tokenizer trainer: a generator and a discriminator, two optimizers, one device.

Counterpart of `video_tokenizer_tpu/trainers/tokenizer_trainer.py`. One
step, in the JAX package's order:
  1. ONE tokenizer forward under autograd (stochastic VQ draws its seed from
     the bottleneck's generator);
  2. the discriminator branch runs when epoch >= disc_self_start and
     (step + 1) % d_update_freq == 0: its loss on real clips and the
     detached reconstructions, the LeCam EMA advances, and the D optimizer
     steps if the loss is above `d_update_loss_threshold`, at the D learning
     rate of the global step. On other steps the D loss is only evaluated
     (for the log) without a graph, and the D optimizer is not touched;
  3. the generator loss with the UPDATED discriminator: pixel + LPIPS
     (frozen) + adversarial, + loss_q (warmed up by epoch) [+ loss_latent_ce].
     The discriminator's parameters are frozen for this backward, so its
     gradient reaches the reconstruction only, never the D optimizer;
  4. the G optimizer steps (optional global-norm clip), then the EMAs.
The step's scalars (the JAX step's packed keys) come back as one device
tensor. Attention runs through `ops.attention` (the flash forward and the
dQ / dK-dV backward kernels on the card), VQ through `ops.vq`.
`use_amp: true` computes the tokenizer, LPIPS and the discriminator in
bf16 (the bottleneck stays fp32); `false` is fp32.
`visualize_epoch` writes the JAX trainer's gt-over-reconstruction grid
(`vis/epoch_<n>.png`, through the standard-library PNG writer) and logs any
failure rather than stopping the run; its TensorBoard half is left out with
the writers (ROADMAP.md, 'Still to port', item 3).
Not ported (each raises NotImplementedError): `grad_accum_steps > 1`
(ROADMAP.md, 'Still to port', item 3), eval FVD (item 6).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import torch

from .. import registry
from ..metrics import statistics as stats
from ..registry import trainers
from ..utils import common
from .base_trainer import BaseTrainer, ema_update, make_lr_schedule

# the tokenizer's outputs that the generator loss takes (not logged as aux scalars)
_DIFF_KEYS = ("pred_frames", "loss_q", "loss_latent_ce")


def make_optimizer(name: str, params, args) -> torch.optim.Optimizer:
    """adam / adamw / sgd with the config's args; the learning rate is set
    before every step from the schedule."""
    name = name.lower()
    betas = tuple(args.get("betas", [0.9, 0.999]))
    lr = float(args.get("lr", 0.0))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas,
                                 weight_decay=float(args.get("weight_decay", 0.0)))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=float(args.get("momentum", 0.0)))
    raise ValueError(f"unknown optimizer {name}")


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@trainers.register("larp_tokenizer_trainer")
class LARPTokenizerTrainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.loss_q_weight = float(cfg.get("loss_q_weight", 0.0))
        warmup = str(cfg.get("loss_q_warmup", "1.0_1")).split("_")
        self.loss_q_starting_ratio = float(warmup[0])
        self.loss_q_warmup_epochs = int(warmup[1])
        self.loss_latent_ce_weight = float(cfg.get("loss_latent_ce_weight", 0.0))
        self.clip_grad_max_norm = float(cfg.get("clip_grad_max_norm", 0.0))
        if int(cfg.get("grad_accum_steps", 1)) > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet (ROADMAP.md, 'Still to port', item 3)")
        if cfg.get("force_fvd", False) or cfg.get("i3d_weights"):
            raise NotImplementedError("eval FVD is not ported yet (ROADMAP.md, 'Still to port', item 6)")
        self.compute_dtype = torch.bfloat16 if cfg.get("use_amp", False) else torch.float32
        self.step = 0

    # -------------------------------------------------------------- building

    def make_model(self):
        cfg = self.cfg
        gen = torch.Generator().manual_seed(self.seed)
        model_spec = dict(cfg["model"])
        model_args = {**dict(model_spec.get("args", {})), "generator": gen}
        model_args.setdefault("dtype", self.compute_dtype)
        # built on the host from the seed, then moved (the init draws on the CPU)
        self.model = registry.models.make({"name": model_spec["name"], "args": model_args})
        self.model.to(self.device)
        loss_spec = dict(cfg["loss"])
        self.loss_mod = registry.models.make({
            "name": loss_spec["name"],
            "args": {**dict(loss_spec.get("args", {})), "dtype": self.compute_dtype,
                     "generator": gen},
        }).to(self.device)
        self.disc = self.loss_mod.discriminator
        self.log(f"model params: {common.compute_num_params(self.model)}; "
                 f"loss params: {common.compute_num_params(self.loss_mod)}")

        opt_cfg = cfg["optimizer"]
        steps_per_epoch, max_epoch = self.steps_per_epoch(), int(cfg["max_epoch"])
        d_args = opt_cfg.get("loss_args", opt_cfg["args"])
        self.g_sched = make_lr_schedule(opt_cfg, float(opt_cfg["args"]["lr"]), steps_per_epoch,
                                        max_epoch)
        self.d_sched = make_lr_schedule(opt_cfg, float(d_args["lr"]), steps_per_epoch, max_epoch)
        for mult in ("emb_lr_mult", "prior_lr_mult"):  # every config of the repo sets 1.0
            if float(opt_cfg.get(mult, 1.0)) != 1.0:
                raise NotImplementedError(
                    f"{mult} != 1 is not ported yet (ROADMAP.md, 'Still to port', item 3)")
        named = list(self.model.named_parameters())
        self.opt_g = make_optimizer(opt_cfg.get("name", "adam"), self.model.parameters(),
                                    opt_cfg["args"])
        # only the discriminator trains; LPIPS is frozen
        self.opt_d = make_optimizer(opt_cfg.get("loss_name", opt_cfg.get("name", "adam")),
                                    self.disc.parameters(), d_args)
        self.ema_params = {
            str(d): {n: p.detach().float().clone() for n, p in named} for d in self.ema_decays
        }
        self.step = 0

    # ------------------------------------------------------------- schedules

    def _loss_q_weight_for_epoch(self, epoch: int) -> float:
        w = self.loss_q_weight
        if self.loss_q_warmup_epochs > 1 and epoch < self.loss_q_warmup_epochs:
            ratio = self.loss_q_starting_ratio + (1 - self.loss_q_starting_ratio) * (
                epoch - 1) / (self.loss_q_warmup_epochs - 1)
            w = ratio * w
        return w

    def _generators(self) -> Dict[str, torch.Generator]:
        """The modules' own generators (VQ seeds, ns_smooth label noise)."""
        gens = {}
        for root, mod in (("model", self.model), ("loss", self.loss_mod)):
            for name, m in mod.named_modules():
                for attr in ("sample_generator", "noise_generator"):
                    if isinstance(getattr(m, attr, None), torch.Generator):
                        gens[f"{root}.{name}.{attr}"] = getattr(m, attr)
        return gens

    # ------------------------------------------------------------------ step

    def _generator_total(self, data, pred, out, epoch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        g_loss, info = self.loss_mod.generator_loss(data, pred, epoch)
        total = g_loss
        if "loss_q" in out:
            total = total + out["loss_q"].float() * self._loss_q_weight_for_epoch(epoch)
            info["loss_q"] = out["loss_q"]
        if "loss_latent_ce" in out:
            total = total + out["loss_latent_ce"].float() * self.loss_latent_ce_weight
            info["loss_latent_ce"] = out["loss_latent_ce"]
        return total, info

    @torch.no_grad()
    def _metrics(self, info, data, pred, out, total) -> None:
        B = data.shape[0]
        mses = torch.mean((pred - data).reshape(B, -1) ** 2, dim=-1)
        info["mse"] = mses.mean()
        info["psnr"] = common.psnr_from_mse(mses).mean()
        info["ssim"] = stats.video_ssim(pred, data)
        info["loss"] = total
        rep = out.get("bottleneck_rep")
        if rep is not None and rep.dtype in (torch.int32, torch.int64):
            cb = self.model.codebook_size
            hist_first = stats.index_histogram(rep[0], cb)
            info["index_usage"] = stats.index_usage_percentage(hist_first)
            info["index_usage_batch"] = stats.index_usage_percentage(stats.index_histogram(rep, cb))
            info["perplexity"] = stats.perplexity(hist_first)
            info["kl_uni"] = stats.kl_divergence_from_uniform(hist_first)
        for k, v in out.items():
            if k not in _DIFF_KEYS and isinstance(v, torch.Tensor) and v.ndim == 0:
                info[k] = v

    def _pack(self, info: Dict[str, Any]) -> Tuple[List[str], torch.Tensor]:
        keys = sorted(k for k, v in info.items() if not isinstance(v, torch.Tensor) or v.ndim == 0)
        return keys, torch.stack([
            torch.as_tensor(info[k], dtype=torch.float32, device=self.device).detach()
            for k in keys
        ])

    def train_step(self, batch) -> Tuple[List[str], torch.Tensor]:
        """One GAN step; returns (keys, fp32 device tensor of the step's scalars)."""
        data = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        epoch, step = self.epoch, self.step
        out = self.model(data, train=True)
        pred, info = out["pred_frames"].float(), {}

        # --- the discriminator first, on the detached reconstructions
        lm = self.loss_mod
        should_run = epoch >= lm.disc_self_start and (step + 1) % lm.d_update_freq == 0
        with torch.set_grad_enabled(should_run):
            d_loss, d_info = lm.discriminator_loss(data, pred.detach(), epoch, train=True,
                                                   update_ema=should_run)
        if should_run and float(d_loss.detach()) > lm.d_update_loss_threshold:
            self.opt_d.zero_grad(set_to_none=True)
            d_loss.backward()
            if self.clip_grad_max_norm > 0:
                torch.nn.utils.clip_grad_norm_(self.disc.parameters(), self.clip_grad_max_norm)
            _set_lr(self.opt_d, self.d_sched(step))
            self.opt_d.step()
        info.update(d_info)

        # --- the generator, against the updated discriminator (frozen here)
        self.disc.requires_grad_(False)
        try:
            total, g_info = self._generator_total(data, pred, out, epoch)
            self.opt_g.zero_grad(set_to_none=True)
            total.backward()
        finally:
            self.disc.requires_grad_(True)
        if self.clip_grad_max_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.clip_grad_max_norm)
        _set_lr(self.opt_g, self.g_sched(step))
        self.opt_g.step()
        if self.ema_params:
            params = dict(self.model.named_parameters())
            for d, ema in self.ema_params.items():
                ema_update(ema, params, float(d))
        info.update(g_info)
        self._metrics(info, data, pred, out, total)
        self.step += 1
        return self._pack(info)

    @torch.no_grad()
    def evaluate_step(self, batch) -> Dict[str, float]:
        data = common.video_to_float(batch["gt"].to(self.device, non_blocking=True))
        out = self.model(data, train=False)
        pred, info = out["pred_frames"].float(), {}
        _, d_info = self.loss_mod.discriminator_loss(data, pred, self.epoch, train=False)
        info.update(d_info)
        total, g_info = self._generator_total(data, pred, out, self.epoch)
        info.update(g_info)
        self._metrics(info, data, pred, out, total)
        keys, packed = self._pack(info)
        return dict(zip(keys, packed.tolist()))

    def visualize_epoch(self):
        """`vis/epoch_<epoch>.png`: for up to 4 clips of the first test set's
        first batch, a row of ground-truth frames over a row of
        reconstructed ones. A failure is logged: visualization never stops
        training (the JAX trainer's rule)."""
        if not self.test_datasets:
            return
        try:
            batch = next(iter(self.test_loader(next(iter(self.test_datasets)))))
            data = common.video_to_float(batch["gt"][:4].to(self.device))
            with torch.no_grad():
                pred = self.model(data, train=False)["pred_frames"].float()
            vis_dir = common.ensure_path(os.path.join(self.save_dir, "vis"))
            gt, pred = data.cpu().numpy(), pred.cpu().numpy()
            common.save_video_grid(os.path.join(vis_dir, f"epoch_{self.epoch}.png"),
                                   [v for pair in zip(gt, pred) for v in pair])
        except Exception as e:  # visualization must never kill training
            self.log(f"visualize_epoch failed: {e}")

    # ----------------------------------------------------------- checkpoints

    def checkpoint_meta(self):
        meta = super().checkpoint_meta()
        meta["model"] = meta["cfg"]["model"]
        return meta

    def state_for_checkpoint(self) -> Dict[str, Any]:
        return {
            "params": self.model.state_dict(),
            "loss_params": self.loss_mod.state_dict(),  # the LeCam EMAs are its buffers
            "opt_g": self.opt_g.state_dict(),
            "opt_d": self.opt_d.state_dict(),
            "ema_params": self.ema_params,
            "step": self.step,
            "rng": {k: g.get_state() for k, g in self._generators().items()},
        }

    def load_state(self, state: Dict[str, Any]):
        self.model.load_state_dict(state["params"])
        self.loss_mod.load_state_dict(state["loss_params"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.ema_params = {d: {n: t.to(self.device) for n, t in ema.items()}
                           for d, ema in state["ema_params"].items()}
        self.step = int(state["step"])
        gens = self._generators()
        for k, s in state.get("rng", {}).items():
            gens[k].set_state(s)


@trainers.register("larp_tokenizer_trainer_stat")
def _unported_trainer(cfg=None, device=None):
    raise NotImplementedError(
        "the STAT tokenizer trainer is not ported yet (ROADMAP.md, 'Still to port', item 3)")

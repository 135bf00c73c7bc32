"""BaseTrainer: the epoch loop of the port's trainers, on one device.

Counterpart of `video_tokenizer_tpu/trainers/base_trainer.py`:
  * cosine-with-warmup and constant ('step') learning-rate schedules, as
    functions of the global step (`make_lr_schedule`), and `ema_update`;
  * the epoch loop: train an epoch, then eval / save on their intervals,
    `log.txt`, `results.csv`, the slim `epoch-final` export at the end;
  * with `save_best: true`, the `epoch-last` save also keeps the best
    checkpoint by FVD: one `best_fvd_<value>` directory, replaced only by
    a lower `current_fvd` (`_maybe_save_best`);
  * resume from `<save_dir>/epoch-last` (parameters, both optimizers, EMA,
    RNG states, step) and warm start from `init_checkpoint`;
  * `save_on_preempt` (default true): a SIGTERM sets a flag, which is
    honoured at the next step boundary, between the epoch's phases and
    after every eval step: `epoch-last` is saved with `preempted: true` and
    the process leaves through `SystemExit(0)`. Mid-epoch the saved epoch
    is rolled back one and `resume_skip_steps` counts the batches already
    applied; the resumed run replays that epoch's (seeded) batches and
    skips them without stepping, so it ends where an uninterrupted run
    ends. The position goes into `state.pth` and `meta.json` alike. The
    handler is installed only from the main thread, and the previous one
    comes back when `train()` returns or raises;
  * `profile_steps: N`: a torch.profiler trace of steps 2..N+1 of the
    starting epoch (step 1 builds and first launches the kernels), each
    step annotated `train_step#<global step>`, written after a synchronize
    to `<save_dir>/profile/trace.json` (CUDA and CPU activity on the card,
    CPU on the CPU);
  * `enable_tb` (default true): a TensorBoard `SummaryWriter` under
    `<save_dir>/tensorboard` (its event files written through tensorboard's
    TensorFlow-free stub), `None` with one log line when
    `torch.utils.tensorboard` does not import; `wandb_upload`: a wandb run,
    online when api.wandb.ai answers and offline otherwise, `None` (and a
    log line) without the package. `log_temp_scalar` writes to both: the
    epoch means as `train/<key>`, each eval set's as `eval_<name>/<key>`.
The step's telemetry stays on the device and is fetched once per epoch.
One process drives one device (`device`, explicit; there is no CPU
fallback when it is a card that is missing).

Multi-device training (the JAX `base_trainer.py:81-102`): under `torchrun`
(or with `mesh_model`, `mesh_seq` or `param_placement: fsdp` at one rank)
the trainer joins the process group (`parallel.mesh.init_distributed`:
NCCL on `cuda:LOCAL_RANK`, gloo for `--device cpu`) and builds the
("data", "seq", "model") mesh from `mesh_model` and `mesh_seq`; at one
process with none of these the path is the one-device one. Then:
  * the batch size is the global batch, as in the JAX package: each data
    index loads only its rows of each global batch, in the order one
    process loads them (`make_loader`'s `rows`), and every random draw of
    a step is made for the global batch (`parallel.mesh.global_batch`
    around the step), so N ranks draw the masks of one process at the same
    seed;
  * `place_model` splits a model over the model axis, shards it with FSDP2
    over the data axis (`param_placement: fsdp`, `fsdp_min_size`) and
    records which gradients `sync_grads` averages itself;
  * the step runs inside `ring_sequence` when `mesh_seq` > 1;
  * only rank 0 writes logs, TensorBoard, wandb, the CSV and checkpoints;
    checkpoints hold whole state dicts in the one-device format (gathered
    one tensor at a time by every rank, kept on rank 0's host only), so a
    run saved at N ranks resumes at any count;
  * the SIGTERM flag is all-reduced at each boundary over a gloo group
    (host memory: the card's queue does not wait), so every rank stops at
    the same step;
  * the step's scalars are averaged over the data axis once per epoch;
    eval batches are computed whole on every rank.
`mesh_pipe` > 1 (GPipe, `parallel/pp.py`) is not ported (ROADMAP.md, item
8b, slice 23).
"""
from __future__ import annotations

import contextlib
import csv as _csv
import glob
import math
import os
import shutil
import signal
import socket
import sys
import threading
import time
import types
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
import yaml

from .. import registry
from ..data.loader import make_loader
from ..parallel import fsdp as fsdp_lib
from ..parallel.mesh import Layout, MeshConfig, create_mesh, global_batch, init_distributed
from ..utils import checkpoint as ckpt_lib
from ..utils import common


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           min_lr_mult: float) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step <= warmup_steps:
            return base_lr * (min_lr_mult + (1.0 - min_lr_mult) * step / max(warmup_steps, 1))
        progress = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return base_lr * (min_lr_mult + (1.0 - min_lr_mult) * 0.5 * (math.cos(math.pi * progress) + 1.0))

    return schedule


def make_lr_schedule(opt_cfg, base_lr: float, steps_per_epoch: int,
                     max_epoch: int) -> Callable[[int], float]:
    lr_type = opt_cfg.get("lr_type", "cosine")
    if lr_type == "cosine":
        return cosine_warmup_schedule(
            base_lr, warmup_steps=opt_cfg.get("warmup_epoch", 0) * steps_per_epoch,
            max_steps=steps_per_epoch * max_epoch, min_lr_mult=opt_cfg.get("min_lr_mult", 0.1),
        )
    if lr_type == "step":  # the reference never applies its step multiplier: constant
        return lambda step: base_lr
    raise NotImplementedError(f"lr_type {lr_type}")


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), in place, in the EMA's dtype."""
    for name, e in ema.items():
        e.mul_(decay).add_(params[name].to(e.dtype), alpha=1.0 - decay)


def _wandb_online(timeout: float = 2.0) -> bool:
    """True when api.wandb.ai accepts a connection (the JAX trainer's probe)."""
    try:
        socket.create_connection(("api.wandb.ai", 443), timeout=timeout).close()
    except OSError:
        return False
    return True


def _plain(cfg):
    """A config (dicts, lists, scalars) as plain Python containers."""
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_plain(v) for v in cfg]
    return cfg


class BaseTrainer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device if device is not None else cfg.get("device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested, but torch sees no CUDA device")
        if int(cfg.get("mesh_pipe", 1)) > 1:
            raise NotImplementedError(
                "mesh_pipe > 1 (GPipe) is not ported yet (ROADMAP.md, item 8b: slice 23)")
        self.placement = str(cfg.get("param_placement", "replicated"))
        if self.placement not in ("replicated", "fsdp"):
            raise ValueError(f"param_placement {self.placement!r}: 'replicated' or 'fsdp'")
        n_model, n_seq = int(cfg.get("mesh_model", 1)), int(cfg.get("mesh_seq", 1))
        mesh_cfg = MeshConfig(model=n_model, seq=n_seq)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        mesh_cfg.resolve(dist.get_world_size() if dist.is_initialized() else world)  # refuse early
        mesh = None
        if dist.is_initialized() or world > 1 or n_model > 1 or n_seq > 1 or self.placement == "fsdp":
            _, _, self.device = init_distributed(str(self.device), cfg.get("dist_url"), force=True)
            mesh = create_mesh(mesh_cfg, self.device.type)
        self.layout = Layout(mesh)
        self.is_master = self.layout.is_master
        # the SIGTERM flag's group: on the host, whatever the device's backend
        self._flag_group = (dist.new_group(backend="gloo")
                            if self.layout.distributed and dist.get_world_size() > 1 else None)
        if self.layout.distributed:  # one seed for every rank (the CLI draws one when none is given)
            seed = [int(cfg.get("manualSeed", 0) or 0)]
            dist.broadcast_object_list(seed, src=0)
            cfg["manualSeed"] = seed[0]
        self.save_dir = cfg.get("save_dir", cfg.get("out_path", "save/run"))
        if self.is_master:
            common.ensure_path(self.save_dir)
            with open(os.path.join(self.save_dir, "cfg.yaml"), "w") as f:
                yaml.safe_dump(_plain(cfg), f, sort_keys=False)
        self.logger = common.set_logger(os.path.join(self.save_dir, "log.txt")
                                        if self.is_master else None)
        if self.layout.distributed:
            lay = self.layout
            self.log(f"mesh data {lay.data_size} x seq {lay.seq_size} x model {lay.model_size} "
                     f"on {self.device}, placement {self.placement}")
        self.writer = self._make_tb_writer()
        self.wandb = self._make_wandb()

        self.seed = int(cfg.get("manualSeed", 0) or 0)
        np.random.seed(self.seed)
        self.epoch = 0
        self.global_step = 0
        self.log_buffer = []
        self.train_psnr = []
        self.train_loss = []
        self.current_fvd = 99999.99  # the last eval's FVD (99999.99: none yet)
        self.best_fvd = None
        ema_raw = str(cfg.get("ema_decay", "_"))
        self.ema_decays = [float(x) for x in ema_raw.split("_") if x not in ("", "none")]

    # ------------------------------------------------------------------ infra

    def _make_tb_writer(self):
        if not self.is_master or not self.cfg.get("enable_tb", True):
            return None
        # tensorboard's own stub does the event files' I/O: tensorboard picks
        # its TF API once, when the first writer opens, and without the `notf`
        # marker it imports TensorFlow where one is installed (and, through
        # it, JAX); the marker is there only while this writer opens
        notf = "tensorboard.compat.notf"
        placed = notf not in sys.modules
        if placed:
            sys.modules[notf] = types.ModuleType(notf)
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(os.path.join(self.save_dir, "tensorboard"))
        except Exception as e:  # no tensorboard package: scalars go to log.txt only
            self.log(f"TensorBoard writer unavailable ({type(e).__name__}: {e}); "
                     "scalars go to log.txt only")
            return None
        finally:
            if placed:
                del sys.modules[notf]

    def _make_wandb(self):
        if not self.is_master or not self.cfg.get("wandb_upload", False):
            return None
        try:
            import wandb

            mode = "online" if _wandb_online() else "offline"
            run = wandb.init(
                project=self.cfg.get("wandb_project") or "video_tokenizer_tpu",
                entity=self.cfg.get("wandb_entity"), name=os.path.basename(self.save_dir),
                dir=self.save_dir, mode=mode, config=_plain(self.cfg), resume="allow",
                id=self.cfg.get("wandb_run_id"),
            )
            self.log(f"wandb initialized (mode={mode})")
            return run
        except Exception as e:
            self.log(f"wandb unavailable: {e}")
            return None

    def log(self, msg: str):
        if self.is_master:
            self.logger.info(msg)

    def log_temp_scalar(self, k: str, v: float, t=None):
        """A scalar to TensorBoard and wandb at step `t` (default: the epoch)."""
        step = t if t is not None else self.epoch
        if self.writer is not None:
            self.writer.add_scalar(k, v, global_step=step)
        if self.wandb is not None:
            self.wandb.log({k: v}, step=step)

    # ------------------------------------------------------------------- data

    def make_datasets(self):
        train_spec = self.cfg["train_dataset"]
        self.train_dataset = registry.datasets.make(train_spec)
        loader_cfg = train_spec.get("loader", {})
        self.train_batch_size = int(loader_cfg.get("batch_size", 8))
        self.train_workers = int(loader_cfg.get("num_workers", 0))
        self.log(f"train dataset: {len(self.train_dataset)} samples, batch {self.train_batch_size}")
        self.test_datasets: Dict[str, Any] = {}
        test_spec = self.cfg.get("test_dataset")
        if test_spec is not None:
            for name, csv_path in test_spec.get("csv_paths", {}).items():
                if not csv_path:
                    continue
                spec = {"name": test_spec["name"],
                        "args": {**dict(test_spec.get("args", {})), "csv_file": csv_path,
                                 "split": "test"}}
                self.test_datasets[name] = registry.datasets.make(spec)
                self.log(f"test dataset {name}: {len(self.test_datasets[name])} samples")
            loader = test_spec.get("loader", {})
            self.test_batch_size = int(loader.get("batch_size", self.train_batch_size))
            self.test_workers = int(loader.get("num_workers", 0))

    def train_loader(self, epoch: int):
        """One epoch of batches; the order is a function of (manualSeed, epoch).
        Under a data axis each rank loads its rows of each global batch: the
        batch sampler of one process, each batch cut to those rows."""
        if getattr(self, "_train_loader", None) is None:
            self._train_gen = torch.Generator()
            self._train_loader = make_loader(
                self.train_dataset, self.train_batch_size, self.train_workers, shuffle=True,
                generator=self._train_gen, rows=self.layout.batch_rows(self.train_batch_size))
        self._train_gen.manual_seed(self.seed * 1_000_003 + epoch)
        return iter(self._train_loader)

    def test_loader(self, name: str):
        return make_loader(self.test_datasets[name], self.test_batch_size, self.test_workers,
                           shuffle=False, drop_last=False)

    def steps_per_epoch(self) -> int:
        """ONE definition of epoch length: the schedules and the loop agree on it."""
        return max(len(self.train_dataset) // self.train_batch_size, 1)

    # ------------------------------------------------------------ state hooks

    def make_model(self):
        raise NotImplementedError

    def train_step(self, batch):
        raise NotImplementedError

    def evaluate_step(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def visualize_epoch(self):
        pass

    def state_for_checkpoint(self, on_every_rank: bool = False) -> Dict[str, Any]:
        """The trainer's state, whole (one-device format), on the host: under
        a mesh a collective that every rank calls, whose sharded parts rank 0
        keeps (every rank with `on_every_rank`)."""
        raise NotImplementedError

    # ------------------------------------------------------------ the mesh

    def place_model(self, model: torch.nn.Module, blocks, tp_shard=None) -> None:
        """Splits `model` over the model axis (`tp_shard(model, tp)`, with
        `sequence_parallel`) and shards it with FSDP2 over the data axis under
        `param_placement: fsdp` (`blocks`: the modules sharded one by one).
        Before any optimizer is built. Records `replicated_params` (averaged
        by `sync_grads`) and `tp_params` (split over the model axis)."""
        from ..parallel.tp import ModelParallel

        lay = self.layout
        self.tp = None
        if lay.model_size > 1:
            if tp_shard is None:
                raise NotImplementedError(f"mesh_model > 1: no tensor-parallel split of "
                                          f"{type(model).__name__}")
            self.tp = ModelParallel(lay.model_group, bool(self.cfg.get("sequence_parallel", False)))
            tp_shard(model, self.tp)
        if self.placement == "fsdp":
            min_size = int(self.cfg.get("fsdp_min_size", fsdp_lib.FSDP_MIN_SIZE))
            self.replicated_params = fsdp_lib.shard_module(model, list(blocks), lay.mesh["data"],
                                                           min_size)
        else:
            self.replicated_params = list(model.parameters())
        specs = getattr(model, "_tp_specs", {})
        self.tp_params = {p for n, p in model.named_parameters() if n in specs}

    def sync_grads(self, params=None) -> None:
        """Averages the replicated gradients over the data axis (FSDP2
        reduce-scatters its own)."""
        if self.layout.data_size > 1:
            fsdp_lib.sync_grads(self.replicated_params if params is None else params,
                                self.layout.data_group, self.layout.data_size)

    def step_context(self, n_rows: int):
        """Around a step (forward and backward): the global-batch draws and,
        with `mesh_seq` > 1, the ring."""
        stack = contextlib.ExitStack()
        lay = self.layout
        if lay.distributed:
            stack.enter_context(global_batch(lay.batch_rows(n_rows), n_rows, lay.data_rank,
                                             lay.data_size, lay.data_group))
            if lay.seq_size > 1:
                from ..parallel.ring import ring_sequence

                stack.enter_context(ring_sequence(lay.seq_group))
        return stack

    def barrier(self) -> None:
        if self.layout.distributed:
            dist.barrier()

    def load_state(self, state: Dict[str, Any]):
        raise NotImplementedError

    def checkpoint_meta(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "global_step": self.global_step, "cfg": _plain(self.cfg)}

    # ------------------------------------------------------------ checkpoints

    def _full_state(self) -> Dict[str, Any]:
        # the position goes into state.pth itself, so resume never pairs a
        # state with the meta.json of another save
        return {**self.state_for_checkpoint(), "epoch": self.epoch,
                "global_step": self.global_step}

    def save_checkpoint(self, name: str, save_best: bool = False):
        path = os.path.join(self.save_dir, name)
        t0 = time.time()
        state = self._full_state()  # every rank gathers
        if self.is_master:
            ckpt_lib.save_checkpoint(path, state, self.checkpoint_meta())
        self.barrier()
        self.log(f"checkpoint saved to {path} ({time.time() - t0:.1f}s)")
        if save_best:
            self._maybe_save_best(state)

    def _maybe_save_best(self, state: Dict[str, Any]):
        """Keeps a single `best_fvd_<value>` checkpoint: written when this
        eval's FVD is below the value in the existing directory's name (or
        there is none), which it then replaces."""
        if self.current_fvd >= 99999.0 or not self.is_master:
            return
        existing = glob.glob(os.path.join(self.save_dir, "best_fvd_*"))
        best_prev = None
        for p in existing:
            try:
                best_prev = float(os.path.basename(p).split("_")[-1])
            except ValueError:
                continue
        if best_prev is not None and self.current_fvd >= best_prev:
            return
        for p in existing:
            shutil.rmtree(p, ignore_errors=True)
        name = f"best_fvd_{self.current_fvd:.2f}"
        ckpt_lib.save_checkpoint(os.path.join(self.save_dir, name), state,
                                 self.checkpoint_meta())
        self.best_fvd = self.current_fvd
        self.log(f"new best checkpoint: {name}")

    def save_final_checkpoint(self):
        """Slim export: parameters, EMA, loss parameters and step; no
        optimizer or RNG state. `params` is the model's state_dict."""
        state = self.state_for_checkpoint()
        keep = {k: v for k, v in state.items()
                if k in ("params", "ema_params", "loss_params", "step")}
        path = os.path.join(self.save_dir, "epoch-final")
        if self.is_master:
            ckpt_lib.save_checkpoint(path, keep, self.checkpoint_meta())
        self.barrier()
        self.log(f"final slim checkpoint saved to {path}")

    def try_resume(self) -> bool:
        path = os.path.join(self.save_dir, "epoch-last")
        if not ckpt_lib.checkpoint_exists(path) or self.cfg.get("replace", False):
            return False
        state = ckpt_lib.restore_checkpoint(path)
        self.load_state(state)
        self.epoch = int(state["epoch"])
        self.global_step = int(state["global_step"])
        # a mid-epoch preemption checkpoint: the interrupted epoch replays its
        # seeded batches, the first `resume_skip_steps` consumed, not applied
        self._resume_skip = int(state.get("resume_skip_steps", 0) or 0)
        self.log(f"resumed from {path} at epoch {self.epoch}"
                 + (f" (+{self._resume_skip} steps)" if self._resume_skip else ""))
        return True

    def try_init_checkpoint(self):
        """Warm start of the parameters (not the optimizers, not the epoch)
        from cfg.init_checkpoint."""
        path = str(self.cfg.get("init_checkpoint", "") or "")
        if not path or not ckpt_lib.checkpoint_exists(path):
            return
        state = ckpt_lib.restore_checkpoint(path)
        warm = self.state_for_checkpoint(on_every_rank=True)  # every rank loads it back
        for k in ("params", "loss_params", "ema_params"):
            if k in state and k in warm:
                warm[k] = state[k]
        self.load_state(warm)
        self.log(f"warm-started params from {path}")

    # ------------------------------------------------------------------ loops

    def run(self):
        self.make_datasets()
        self.make_model()
        resumed = self.try_resume()
        if not resumed:
            self.try_init_checkpoint()
        self.starting_epoch = self.epoch + 1 if resumed else 1
        self.train()

    # ------------------------------------------------------- preemption

    def _install_preemption_handler(self):
        """`save_on_preempt` (default true): a SIGTERM asks for a checkpoint at
        the next step boundary. Installed only from the main thread; the
        handler it replaces is kept for `_restore_preemption_handler`."""
        self._preempt_requested = False
        self._previous_sigterm = None
        if not bool(self.cfg.get("save_on_preempt", True)):
            return
        if threading.current_thread() is not threading.main_thread():
            return

        def handler(signum, frame):
            self._preempt_requested = True

        previous = signal.getsignal(signal.SIGTERM)
        try:
            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            return
        # a handler installed outside Python reads as None: restore the default
        self._previous_sigterm = signal.SIG_DFL if previous is None else previous

    def _restore_preemption_handler(self):
        if self._previous_sigterm is not None:
            signal.signal(signal.SIGTERM, self._previous_sigterm)
            self._previous_sigterm = None

    def _maybe_preempt(self):
        """Checkpoint and exit if a SIGTERM is pending: called after every
        step, after every eval step and between the epoch's phases. Under a
        mesh the flag is all-reduced, so every rank stops at this boundary."""
        requested = getattr(self, "_preempt_requested", False)
        if self._flag_group is not None:  # a host all-reduce: no wait for the card
            flag = torch.tensor([int(requested)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._flag_group)
            requested = bool(flag.item())
        if requested:
            self._checkpoint_on_preempt()

    def _checkpoint_on_preempt(self):
        """Saves a resumable `epoch-last` and leaves through SystemExit(0).
        Mid-epoch the epoch is rolled back one and `resume_skip_steps`
        counts the batches already applied; once the epoch's training is
        done (a preemption in eval, vis or a save) the epoch stands."""
        epoch_done = getattr(self, "_epoch_complete", False)
        position = {"epoch": self.epoch if epoch_done else self.epoch - 1,
                    "global_step": self.global_step, "preempted": True}
        if not epoch_done:
            position["resume_skip_steps"] = getattr(self, "_epoch_step", 0)
        path = os.path.join(self.save_dir, "epoch-last")
        state = self._full_state()
        if self.is_master:
            ckpt_lib.save_checkpoint(path, {**state, **position},
                                     {**self.checkpoint_meta(), **position})
        self.barrier()
        if self.writer is not None:
            self.writer.flush()
        self.log(f"preempted: checkpoint saved to {path}; exiting")
        raise SystemExit(0)

    # ------------------------------------------------------------------ loops

    def train(self):
        self._install_preemption_handler()
        try:
            self._train_epochs()
        finally:
            self._restore_preemption_handler()
            if self.writer is not None:  # a later scalar opens a new event file
                self.writer.close()

    def _train_epochs(self):
        cfg = self.cfg
        max_epoch = int(cfg["max_epoch"])
        eval_epoch = int(cfg.get("eval_epoch", max_epoch + 1))
        vis_epoch = int(cfg.get("vis_epoch", max_epoch + 1))
        save_epoch = int(cfg.get("save_epoch", max_epoch + 1))
        latest_interval = int(cfg.get("latest_interval", 1))
        timer = common.EpochTimer(max_epoch)
        self.n_steps_per_epoch = self.steps_per_epoch()
        for epoch in range(self.starting_epoch, max_epoch + 1):
            self.epoch = epoch
            self.global_step = (epoch - 1) * self.n_steps_per_epoch
            self.log_buffer = [f"Epoch {epoch}"]
            self.t_data, self.t_model = 0.0, 0.0
            st = time.time()
            self._epoch_complete = False
            self.train_epoch()
            self._epoch_complete = True
            self.log(f"Epoch {epoch} training done. Time: {time.time() - st:.2f}s")
            self._maybe_preempt()
            if epoch % eval_epoch == 0:
                self.evaluate_epoch()
                self._maybe_preempt()
            if epoch % vis_epoch == 0:
                self.visualize_epoch()
                self._maybe_preempt()
            if epoch % save_epoch == 0:
                self.save_checkpoint(f"epoch-{epoch}")
            if epoch % latest_interval == 0:
                self.save_checkpoint("epoch-last", save_best=bool(cfg.get("save_best", False)))
            self._maybe_preempt()
            epoch_time, tot_time, est_time = timer.epoch_done()
            d_ratio = self.t_data / (self.t_data + self.t_model + 1e-6)
            self.log_buffer.append(f"{epoch_time} (d {d_ratio:.2f}) {tot_time}/{est_time}")
            self.log(", ".join(self.log_buffer))
        self.dump_csv()
        if max_epoch >= self.starting_epoch:
            self.save_final_checkpoint()

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, n_steps: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        if not self.is_master:
            return
        out = common.ensure_path(os.path.join(self.save_dir, "profile"))
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        self.log(f"profiler trace ({n_steps} steps) -> {out}")

    def train_epoch(self):
        deferred = []  # (keys, device tensor): fetched once, at the end of the epoch
        # `profile_steps: N` traces steps 2..N+1 of the starting epoch (step 1
        # builds and first launches the kernels)
        profile_steps = int(self.cfg.get("profile_steps", 0))
        prof = None
        epoch_step = 0
        # the batches of an interrupted epoch that are already applied are
        # consumed without stepping (`_checkpoint_on_preempt`)
        skip, self._resume_skip = getattr(self, "_resume_skip", 0), 0
        t1 = time.time()
        try:
            for _, batch in zip(range(self.n_steps_per_epoch), self.train_loader(self.epoch)):
                self.global_step += 1
                epoch_step += 1
                self._epoch_step = epoch_step
                if skip > 0:
                    skip -= 1
                    t1 = time.time()
                    continue
                if profile_steps and self.epoch == self.starting_epoch:
                    if epoch_step == 2:
                        prof = self._start_profile()
                    elif prof is not None and epoch_step == 2 + profile_steps:
                        self._stop_profile(prof, profile_steps)
                        prof = None
                t0 = time.time()
                self.t_data += t0 - t1
                with self.step_context(self.train_batch_size):
                    if prof is not None:
                        with torch.profiler.record_function(f"train_step#{self.global_step}"):
                            deferred.append(self.train_step(batch))
                    else:
                        deferred.append(self.train_step(batch))
                self.t_model += time.time() - t0
                self._maybe_preempt()
                t1 = time.time()
        finally:
            if prof is not None:  # the epoch ended (or was preempted) inside the window
                self._stop_profile(prof, epoch_step - 1)
        ave: Dict[str, common.Averager] = {}
        if deferred and self.layout.data_size > 1:  # the data axis's means, one all-reduce
            stacked = torch.stack([packed for _, packed in deferred])
            dist.all_reduce(stacked, group=self.layout.data_group)
            deferred = [(keys, row / self.layout.data_size)
                        for (keys, _), row in zip(deferred, stacked)]
        for keys, packed in deferred:
            for k, v in zip(keys, packed.tolist()):
                ave.setdefault(k, common.Averager()).add(v)
        for k, v in ave.items():
            self.log_temp_scalar("train/" + k, v.item())
        self.log_buffer.append("train:" + "".join(f" {k}={v.item():.4f}" for k, v in ave.items()))
        if "psnr" in ave:
            self.train_psnr.append(ave["psnr"].item())
        if "loss" in ave:
            self.train_loss.append(ave["loss"].item())

    def evaluate_epoch(self):
        for name in self.test_datasets:
            ave: Dict[str, common.Averager] = {}
            for batch in self.test_loader(name):
                with self.step_context(len(batch["gt"])):  # whole batches, on every rank
                    ret = self.evaluate_step(batch)
                self._maybe_preempt()
                for k, v in ret.items():
                    ave.setdefault(k, common.Averager()).add(float(v), n=len(batch["gt"]))
            for k, v in ave.items():
                self.log_temp_scalar(f"eval_{name}/{k}", v.item())
            logtext = f"eval {name}:" + "".join(f" {k}={v.item():.4f}" for k, v in ave.items())
            self.log_buffer.append(logtext)
            self.log(logtext)

    def dump_csv(self):
        if not self.is_master:
            return
        with open(os.path.join(self.save_dir, "results.csv"), "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["epoch", "train_psnr", "train_loss"])
            for i, (p, l) in enumerate(zip(self.train_psnr or [None] * len(self.train_loss),
                                           self.train_loss or [None] * len(self.train_psnr))):
                w.writerow([i + 1, p, l])

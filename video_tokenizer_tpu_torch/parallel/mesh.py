"""The process layout of multi-device training: one process per device.

Counterpart of `video_tokenizer_tpu/parallel/mesh.py`. The JAX package runs
one SPMD program over a `jax.sharding.Mesh`; here `torchrun` starts one
process per device (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) and the processes
form a `torch.distributed.device_mesh.DeviceMesh` with the axes
("data", "seq", "model") in that order: data outermost, as torchrun's
node-major ranks give it, so rank = (d * seq + s) * model + m.

  * "data": the batch. Each data index takes its rows of the global batch
    (`batch_rows`); a batch that does not divide over the axis is
    replicated, every rank computing the whole ragged batch, as the JAX
    `shard_batch` does. Gradients are averaged over it.
  * "seq": ring attention (`parallel/ring.py`).
  * "model": Megatron tensor parallelism (`parallel/tp.py`).

`init_distributed` joins the process group: NCCL for a card (one process
per `cuda:LOCAL_RANK`), gloo for `--device cpu`. At one process with no
mesh knob no group is made and the trainers run their one-device path.

Random draws. A training step draws every dropout mask, DropPath mask and
class-dropout uniform for the GLOBAL batch from the trainer's one generator
(every rank holds the same generator state), and each rank keeps its slice
(`draw_keep`, `draw_uniform`, `draw_normal`, through the ambient
`global_batch` context that the trainers enter around a step). A run at N
ranks then draws the masks of one process at the same seed, mask for mask.
The one exception is the stochastic VQ's Gumbel noise, which the VQ kernel
keys by the row index within its call: each data index mixes its index
into the seed (`rank_seed`), so that ranks draw independent noise; its
draws differ from one process's.

Not ported: `slice_count` and the multi-slice DCN layout of the JAX
`create_mesh` (TPU topology; ROADMAP.md, "Don't port").
"""
from __future__ import annotations

import dataclasses
import os
import socket
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")


@dataclasses.dataclass
class MeshConfig:
    data: int = -1  # -1: every rank that the other axes leave
    model: int = 1
    seq: int = 1  # ring-attention context parallelism (parallel/ring.py)

    def resolve(self, n_devices: Optional[int] = None) -> Tuple[int, int, int]:
        n = n_devices if n_devices is not None else world_size()
        model = max(1, self.model)
        seq = max(1, self.seq)
        data = self.data if self.data > 0 else n // (model * seq)
        if data * seq * model != n:
            raise ValueError(f"mesh {data}x{seq}x{model} does not cover {n} devices")
        return data, seq, model


def world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     force: bool = False) -> Tuple[int, int, torch.device]:
    """Joins the process group of a torchrun launch: (rank, world size, device).

    The device is `cuda:LOCAL_RANK` (NCCL) for `device` 'cuda', or the CPU
    (gloo) for 'cpu'. `init_method` defaults to torchrun's `env://`; a
    single process asked to form a group (`force`, a mesh knob or fsdp at
    one rank) gets `tcp://localhost:<free port>`. Without a group to form,
    nothing is initialised and the device is `device` as given."""
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        world = dist.get_world_size()
    elif world > 1 or force or init_method:
        rank = int(os.environ.get("RANK", "0"))
        if init_method is None:
            init_method = ("env://" if world > 1 or "MASTER_ADDR" in os.environ
                           else f"tcp://localhost:{_free_port()}")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank, world_size=world)
    if dist.is_initialized() and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank, world, dev


def create_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """The ("data", "seq", "model") DeviceMesh over every rank of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (config or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


class Layout:
    """This rank's place in the mesh: its index and the size of each axis,
    and each axis's process group (None without a mesh: one process)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.rank = dist.get_rank() if mesh is not None else 0
        for axis in AXES:
            size = mesh.size(AXES.index(axis)) if mesh is not None else 1
            setattr(self, f"{axis}_size", size)
            setattr(self, f"{axis}_rank", mesh.get_local_rank(axis) if mesh is not None else 0)
            setattr(self, f"{axis}_group", mesh.get_group(axis) if mesh is not None else None)

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def is_master(self) -> bool:
        return self.rank == 0

    def batch_rows(self, n: int) -> slice:
        return batch_rows(n, self.data_rank, self.data_size)


def batch_rows(n: int, data_rank: int, data_size: int) -> slice:
    """The rows of an n-row global batch that data index `data_rank` of
    `data_size` computes: its 1/data_size share, or all n rows where n does
    not divide (a ragged batch is replicated)."""
    if data_size <= 1 or n % data_size:
        return slice(0, n)
    share = n // data_size
    return slice(data_rank * share, (data_rank + 1) * share)


def shard_batch(batch: Dict[str, Any], rows: slice) -> Dict[str, Any]:
    """A host batch's rows `rows` along dim 0 (tensors, arrays and lists)."""
    return {k: v[rows] if hasattr(v, "__getitem__") and not isinstance(v, str) else v
            for k, v in batch.items()}


# ----------------------------------------------------------- global draws


class _Ambient(threading.local):
    rows: Optional[slice] = None  # this rank's rows of the global batch
    n: int = 0  # rows of the global batch
    data_rank: int = 0
    data_size: int = 1
    group = None  # the data axis's process group


_ambient = _Ambient()
_FIELDS = ("rows", "n", "data_rank", "data_size", "group")


class global_batch:
    """Context: the step's tensors hold rows `rows` of an n-row global batch;
    `draw_*` draw for the global batch and keep those rows, `batch_mean`
    and `gather_rows` reach over the data axis's `group`."""

    def __init__(self, rows: slice, n: int, data_rank: int = 0, data_size: int = 1, group=None):
        self.state = (rows, n, data_rank, data_size, group)

    def __enter__(self):
        self.saved = tuple(getattr(_ambient, f) for f in _FIELDS)
        for f, v in zip(_FIELDS, self.state):
            setattr(_ambient, f, v)
        return self

    def __exit__(self, *exc):
        for f, v in zip(_FIELDS, self.saved):
            setattr(_ambient, f, v)


def _split_rows() -> bool:
    """Whether the ambient step holds a share (not all) of its global batch."""
    rows = _ambient.rows
    return (_ambient.data_size > 1 and rows is not None
            and rows.stop - rows.start != _ambient.n)


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        x = x.detach().clone()
        dist.all_reduce(x, group=group)
        return x / size

    @staticmethod
    def backward(ctx, g):  # each rank's loss counts 1/size in the averaged gradients
        return g, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A per-rank batch mean -> the global batch's (equal shares), where a
    loss is nonlinear in it (LeCam). Its gradient passes unchanged: the
    ranks' averaged gradients are then the global batch's."""
    if not _split_rows():
        return x
    return _MeanOverData.apply(x, _ambient.group, _ambient.data_size)


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows -> the global batch's (for statistics of the batch)."""
    if not _split_rows():
        return x
    parts = [torch.empty_like(x) for _ in range(_ambient.data_size)]
    dist.all_gather(parts, x.contiguous(), group=_ambient.group)
    return torch.cat(parts)


def _global(shape, seq: Optional[Tuple[int, int]], batch_dim: int = 0):
    """(global shape, index) of a local draw of `shape`: dim `batch_dim` the
    batch rows (when a `global_batch` context is entered and that dim is its
    share), dim 1 the `seq` = (index, count) part of a sequence sharded over
    the model axis."""
    shape = tuple(shape)
    full, index = list(shape), [slice(None)] * len(shape)
    rows, b = _ambient.rows, batch_dim
    if (rows is not None and len(shape) > b and shape[b] == rows.stop - rows.start
            and shape[b] != _ambient.n):
        full[b], index[b] = _ambient.n, rows
    if seq is not None and seq[1] > 1:
        full[1] = shape[1] * seq[1]
        index[1] = slice(seq[0] * shape[1], (seq[0] + 1) * shape[1])
    return full, tuple(index)


def draw_keep(shape, keep: float, generator: Optional[torch.Generator], device,
              seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A bool mask, True with probability `keep`: this rank's part of the
    global batch's draw (`bernoulli_` on the global shape)."""
    full, index = _global(shape, seq)
    m = torch.empty(full, dtype=torch.bool, device=device).bernoulli_(keep, generator=generator)
    return m if tuple(full) == tuple(shape) else m[index].contiguous()


def draw_uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    full, index = _global(shape, None)
    u = torch.rand(full, generator=generator, device=device)
    return u if tuple(full) == tuple(shape) else u[index].contiguous()


def draw_normal(shape, generator: Optional[torch.Generator], dtype=torch.float32,
                device=None, batch_dim: int = 0) -> torch.Tensor:
    full, index = _global(shape, None, batch_dim)
    z = torch.randn(full, generator=generator, dtype=dtype, device=device)
    return z if tuple(full) == tuple(shape) else z[index].contiguous()


_SEED_MIX = 0x9E3779B97F4A7C15


def rank_seed(seed: int) -> int:
    """A kernel's noise seed for this data index: the seed itself at one
    data index or on a replicated batch, else mixed with the index, so that
    ranks draw independent noise (0 <= result < 2**62)."""
    if not _split_rows():
        return seed
    return (seed + _ambient.data_rank * _SEED_MIX) % (2**62)

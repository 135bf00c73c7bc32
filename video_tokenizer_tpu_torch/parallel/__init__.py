"""Multi-device training over torch.distributed: the mesh and the data axis
(`mesh`), ZeRO-3 placement (`fsdp`), Megatron tensor and sequence
parallelism (`tp`) and ring attention (`ring`). Counterpart of
`video_tokenizer_tpu/parallel/` but for `pp.py` (ROADMAP.md item 8b)."""
from .mesh import (  # noqa: F401
    Layout, MeshConfig, batch_rows, create_mesh, global_batch, init_distributed, shard_batch,
)

"""Runs `_torch_parallel_worker.py` at N gloo ranks on the CPU: one
subprocess per rank, one `FileStore` in a fresh directory (no port to race
for under xdist), every scenario of a file in one launch."""
import os
import subprocess
import sys
from pathlib import Path

import torch

WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
REPO = WORKER.parent.parent


def run_ranks(jobs, world: int, job_dir: Path, timeout: float = 240.0):
    """[(name, job dict)] at `world` ranks -> [rank 0's results, ...]: each a
    {name: result} (a failed scenario's result is {"error": traceback})."""
    job_dir.mkdir(parents=True, exist_ok=True)
    torch.save(list(jobs), job_dir / "job.pt")
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(job_dir), str(r), str(world)],
                              env=env, cwd=str(job_dir), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for r in range(world):
        path = job_dir / f"out_{r}.pt"
        if not path.exists():
            raise RuntimeError(f"rank {r} wrote no results:\n" + "\n".join(logs)[-6000:])
        outs.append(torch.load(path, weights_only=False))
    return outs


def result(outs, name: str, rank: int = 0):
    got = outs[rank][name]
    if isinstance(got, dict) and "error" in got:
        raise AssertionError(f"{name} failed on rank {rank}:\n{got['error']}")
    return got

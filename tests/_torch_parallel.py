"""Run the port's parallel CPU tests' ranks: one process per rank of a
gloo group on localhost (tests/_torch_parallel_worker.py), each on its
own port-free thread budget. No jax here: the workers import the port
only."""

import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(tmp_path, world: int, job: dict, timeout: float = 240) -> list[dict]:
    """Write `job` (mesh, config, state, tasks: see the worker), start
    `world` ranks and return each rank's results, in rank order. A rank
    that fails fails the call, with its output."""
    path = os.path.join(str(tmp_path), "job.pt")
    torch.save(job, path)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, WORKER, path, str(port), str(r), str(world)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r][-4000:]}"
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

"""PyTorch port: a run over two OS processes joined through the
HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES / HPCMG_PROCESS_ID variables
(`parallel.initialize`), the analog of tests/test_multiprocess.py and
tests/_mp_worker.py.

Each process is one gloo rank on the CPU.  It runs `distributed_run` of
the flagship mixed-precision configuration at n=64 (both levels
partitioned at min_local 8, the coarsest solved on its gathered field),
then `cli scaling --distributed` over the
same world.  uT must equal the single-process run to the bit (every op
but the norms is exact per schedule), rank 0 prints one scaling line with
`devices == 2`, and rank 1 prints none.

This file is also the worker: `python tests/test_torch_multiprocess.py
<port> <num_processes> <process_id> <out>`; it imports no jax, so the
workers import torch and numpy alone.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, MIN_LOCAL = 64, 5, 8
SCALING = ["scaling", "--distributed", "--n", "64", "--steps", "2",
           "--dtype", "f64", "--reps", "1", "--device", "cpu"]


def _model():
    import torch

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    return AdvectionDiffusion(
        ProblemConfig(n=N, num_steps=STEPS),
        SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                     tol=1e-6, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense"), device="cpu")


def worker(port: str, nproc: str, pid: str, out: str) -> None:
    """One process of the world: join it, run, and (rank 0) save uT."""
    import torch

    os.environ.update(HPCMG_COORDINATOR=f"localhost:{port}",
                      HPCMG_NUM_PROCESSES=nproc, HPCMG_PROCESS_ID=pid)
    torch.set_num_threads(1)
    from hpcclassmultigridproject_tpu_torch.cli import main
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        initialize,
        is_multiprocess,
        make_mesh,
    )

    initialize("gloo")
    mesh = make_mesh()
    assert is_multiprocess() and mesh.world == int(nproc)
    assert mesh.rank == int(pid)
    uT, stats = distributed_run(_model(), mesh, min_local=MIN_LOCAL)
    if mesh.rank == 0:
        np.save(out, uT.numpy())
        with open(out + ".json", "w") as f:
            json.dump({"world": mesh.world, "max_rel_residual": float(
                stats["rel_residual"].max())}, f)
    sys.stdout.flush()
    main(SCALING)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_match_the_single_process_run(tmp_path, capsys):
    import torch

    port = _free_port()
    out = str(tmp_path / "uT.npy")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), "2",
         str(pid), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e}"
    meta = json.load(open(out + ".json"))
    assert meta["world"] == 2 and meta["max_rel_residual"] <= 1e-6
    torch.set_num_threads(2)
    uT1, _ = _model().run(warn=False)
    assert np.array_equal(np.load(out), uT1.numpy())

    lines = [[json.loads(line) for line in o.splitlines()
              if line.startswith("{")] for o, _ in outs]
    assert lines[1] == []
    (rec,) = lines[0]
    assert rec["devices"] == 2 and rec["n"] == 64
    assert rec["mesh"] == {"x": 1, "y": 2} and rec["layout"] == "auto"
    assert rec["efficiency"] is None and "speedup" not in rec
    # the same line on one process, through the same subcommand
    from hpcclassmultigridproject_tpu_torch.cli import main as t_main

    capsys.readouterr()
    argv = [a for a in SCALING if a != "--distributed"]
    assert t_main([*argv, "--max-devices", "1"]) == 0
    (one,) = [json.loads(line) for line in
              capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rec["center_uT"] == one["center_uT"]


if __name__ == "__main__":
    if _REPO_ROOT not in sys.path:
        sys.path.insert(0, _REPO_ROOT)
    worker(*sys.argv[1:5])

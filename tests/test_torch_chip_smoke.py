"""chip_smoke.py on the CPU, where no phase can run: which phases each
mode selects (`main`, with every phase replaced by a recorder), the
process tree `_cli` kills at its deadline, and phase 19 (e)'s captured
scaling sweep (`_captured_scaling`) against `cli scaling`'s own records,
its spawned ranks gloo ranks on the CPU."""

import json
import os
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from hpcclassmultigridproject_tpu_torch.cli import main as t_main  # noqa: E402

ONE_CARD = ["phase_device", "phase_build", "phase_kernels", "phase_main_path",
            "phase_golden", "phase_galerkin", "phase_poisson",
            "phase_refined", "phase_distributed", "phase_open_smooth",
            "phase_cli", "phase_probe", "phase_device_build", "phase_grid",
            "phase_routes_oracle", "phase_compiled", "phase_loops",
            "phase_peer", "phase_multi_gpu"]
# phases 1 and 2, phase 4's run, 13 (b), 17 (a), then 16 and 19
MULTI_GPU = ["phase_device", "phase_build", "phase_main_path", "_phase_big",
             "_compiled_main", "phase_multi_gpu"]


class _Measured(dict):
    """A kernel's measured row for any kernel asked for."""

    def __missing__(self, key):
        return (0.0, 1.0, 2.0, 0.5, "bytes")


class _Counts(dict):
    def __missing__(self, key):
        return 0


STUBS = {
    "phase_device": "H100",
    "phase_build": None,
    "phase_kernels": _Measured(),
    "phase_main_path": (_Counts(), "uT"),
    "phase_golden": None,
    "phase_galerkin": {"smooth9": 1},
    "phase_poisson": {"smooth5": 1},
    "phase_refined": None,
    "phase_distributed": 1,
    "phase_open_smooth": {"open_presmooth": 1},
    "phase_cli": None,
    "phase_probe": {},
    "phase_device_build": (5, {}),
    "phase_grid": None,
    "phase_routes_oracle": None,
    "phase_compiled": 0.02,
    "phase_loops": (0.0, 1.0, 2.0, 0.5, "bytes", 3),
    "phase_peer": {k: (0.0, 1.0, 2.0, 0.5, "bytes", None, 3)
                   for k in ("peer_exchange", "peer_gather")},
    "phase_multi_gpu": None,
    "_phase_big": (5, {}),
    "_compiled_main": (None, 0.02),
}


class _Record(list):
    def __init__(self):
        super().__init__()
        self.kwargs = []


def _recorded(monkeypatch, cards: int) -> list:
    """Every phase of chip_smoke replaced by a recorder returning a stub,
    on a stand-in of `cards` CUDA devices; returns the live record of the
    phases called, each call's keyword arguments in `ran.kwargs`."""
    ran = _Record()
    for name, value in STUBS.items():
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, _v=value, **k:
                            ran.append(_n) or ran.kwargs.append(k) or _v)
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "H100, 700.00 W")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    return ran


@pytest.mark.parametrize("argv,want", [([], ONE_CARD),
                                       (["--multi-gpu"], MULTI_GPU)],
                         ids=["one-card", "multi-gpu"])
def test_mode_selects_its_phases(monkeypatch, capsys, argv, want):
    """No argument: every phase in order, as before the mode existed;
    --multi-gpu: phases 1 and 2, the one-card references and phases 16
    and 19 (`phase_multi_gpu`), nothing else, and the same last line."""
    assert chip_smoke.parse_args(argv).multi_gpu == bool(argv)
    ran = _recorded(monkeypatch, 4)
    chip_smoke.main(argv)
    assert ran == want
    # --multi-gpu times each case and point once; no argument keeps the
    # phase's own depth
    reps = ran.kwargs[ran.index("phase_multi_gpu")].get("reps")
    assert reps == (chip_smoke.MULTI_GPU_REPS if argv else None)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "H100", "count": 4}}
    # the kernels' line only where phase 3 measured them
    assert lines[-2].startswith('{"kernels": ') == (not argv)


def test_multi_gpu_mode_needs_four_cards(monkeypatch):
    """On fewer cards --multi-gpu fails before any reference runs."""
    ran = _recorded(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="--multi-gpu takes 4 cards"):
        chip_smoke.main(["--multi-gpu"])
    assert ran == ["phase_device", "phase_build"]


def test_descendants_are_the_process_tree():
    """`_descendants` (what `_cli` kills at its deadline) finds a child's
    child, and nothing once they are gone."""
    import subprocess

    proc = subprocess.Popen(["sh", "-c", "sleep 60 & wait"])
    try:
        deadline = time.monotonic() + 30
        while len(chip_smoke._descendants(proc.pid)) < 1:
            assert time.monotonic() < deadline, "no grandchild seen"
            time.sleep(0.05)
        kids = chip_smoke._descendants(proc.pid)
        assert proc.pid not in kids
        mine = chip_smoke._descendants(os.getpid())
        assert proc.pid in mine and set(kids) <= set(mine)
    finally:
        for pid in [*chip_smoke._descendants(proc.pid), proc.pid]:
            os.kill(pid, 9)
        proc.wait()
    assert chip_smoke._descendants(proc.pid) == []


@pytest.mark.parametrize("mode,cards", [("strong", 2), ("weak", 4)])
def test_captured_scaling_matches_the_cli(monkeypatch, capsys, mode, cards):
    """Phase 19 (e)'s sweep (`_captured_scaling`: the CLI's own
    `scaling_records`, each multi-rank point's ranks spawned with the
    switch on, here over gloo on the CPU, where the points stay eager)
    against `cli scaling` on the same arguments: the same records, key
    for key, but the seconds and the ratios made of them."""
    from hpcclassmultigridproject_tpu_torch import parallel

    real = parallel.launch_local
    spawns = []

    def gloo(fn, world, args, backend, device, deadline):
        spawns.append((fn.__name__, world, backend, device, deadline))
        return real(fn, world, args, backend="gloo", device=None,
                    deadline=deadline)

    monkeypatch.setattr(parallel, "launch_local", gloo)
    argv = ["--mode", mode, "--n", "32", "--steps", "2", "--dtype", "f64",
            "--reps", "1", "--max-devices", str(cards), "--layout", "rows",
            "--device", "cpu"]
    counts = [1, 2] if mode == "strong" else [1, 4]
    got = chip_smoke._captured_scaling(argv, counts)
    monkeypatch.undo()  # the CLI spawns through the real launch_local
    capsys.readouterr()
    assert spawns == [("_captured_scaling_point", cards, "nccl", "cuda",
                       chip_smoke.DEADLINE_S["point"])]
    assert t_main(["scaling", *argv]) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["devices"] for r in got] == [r["devices"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in ("devices", "n", "mesh", "layout", "compiled",
                    "capture_seconds"):
            assert g[key] == w[key], key
        assert g["center_uT"] == pytest.approx(w["center_uT"], rel=0,
                                               abs=1e-12)
        ratio = "speedup" if mode == "strong" else "efficiency"
        assert (g[ratio] is None) == (w[ratio] is None)

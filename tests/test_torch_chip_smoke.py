"""chip_smoke.py on the CPU, where no phase can run: which phases each
mode selects (`main`, with every phase replaced by a recorder), the
process tree `_cli` kills at its deadline, and what `cli scaling`'s
sweeps must say of each point (phases 14 (d) and 16 (d)): a replay over
NCCL, eager over gloo."""

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
                   for k in ("peer_exchange", "peer_gather", "peer_reduce")},
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


class _Model:
    """A stand-in for the single-device runs `_phase_grid_scaling` holds
    each point's center to."""

    def __init__(self, *args, **kwargs):
        pass

    def run(self, warn=True):
        return None, None

    def center_value(self, uT):
        return 0.5


def _scaling_lines(argv, multi_compiled: bool) -> list:
    """The records `cli scaling` prints for `argv` (a point of one rank
    a replay, a multi-rank point one iff `multi_compiled`)."""
    flags = dict(zip(argv[::2], argv[1::2]))
    mode, layout, n = flags["--mode"], flags["--layout"], int(flags["--n"])
    points = ([(1, n), (2, n), (4, n)] if mode == "strong"
              else [(1, n), (4, 2 * n)])
    meshes = {1: {"x": 1, "y": 1}, 2: {"x": 1, "y": 2}, 4: {"x": 2, "y": 2}}
    lines = []
    for c, size in points:
        compiled = c == 1 or multi_compiled
        rec = {"devices": c, "n": size, "mesh": meshes[c], "layout": layout,
               "seconds": 1.0 / c, "center_uT": 0.5, "efficiency": 1.0}
        if mode == "strong":
            rec["speedup"] = float(c)
        rec.update(compiled=compiled,
                   capture_seconds=0.25 if compiled else None)
        lines.append(rec)
    return lines


@pytest.mark.parametrize("cards,multi_compiled,ok", [
    (4, True, True), (1, False, True), (4, False, False)],
    ids=["nccl-replays", "gloo-eager", "nccl-eager-fails"])
def test_scaling_check_expects_replays_over_nccl(monkeypatch, capsys, cards,
                                                  multi_compiled, ok):
    """Phase 16 (d) and 14 (d) run `cli scaling` in a subprocess, as users
    run it: a point of NCCL ranks (a card each, four cards) must be a
    replay of its captured program, since the CLI's ranks take the
    default; a point of gloo ranks sharing one card must be eager, and a
    point of one rank a replay.  An eager NCCL point fails the phase."""
    from hpcclassmultigridproject_tpu_torch import models

    calls = []

    def cli(*argv, timeout):
        calls.append(argv)
        return _scaling_lines(list(argv[1:]), multi_compiled)

    monkeypatch.setattr(chip_smoke, "_cli", cli)
    monkeypatch.setattr(models, "AdvectionDiffusion", _Model)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    run = lambda: chip_smoke._phase_grid_scaling(
        "H100, 700.00 W", strong_n=64, weak_n=32, weak_layouts=("rows", "2d"),
        cycles=None, label="[multi-gpu] (d)")
    if ok:
        run()
        assert len(calls) == 4 and all(c[0] == "scaling" for c in calls)
        assert "compiled True" in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match="2 ranks compiled False"):
            run()

"""PyTorch port: the turn loop the scripts that time trees of the port
share (scripts/_turns.py), and each such script's summary, run on the CPU
with canned turn records in place of the card's processes.

A turn is a process of its own that prints one JSON record as its last
line; `take_turns` keeps it, `by_tree` folds a tree's records into their
medians, and each script checks its outputs across turns and prints its
summary as the last line.  The records here have each script's own keys,
so a script whose main reads a key the turns do not write fails here.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "scripts"))
import _turns  # noqa: E402
import torch_loop_turns  # noqa: E402
import torch_peer_turns  # noqa: E402
import torch_probe_turns  # noqa: E402
import torch_smooth_turns  # noqa: E402

CARD = ["NVIDIA H100 80GB HBM3, 700.00 W"]


def test_medians_fold_a_trees_records():
    records = [{"ms": 3.0, "walls": [1.0, 5.0], "sha": "a", "ok": [True],
                "case": {"n": 2, "us": [4.0]}},
               {"ms": 1.0, "walls": [2.0, 3.0], "sha": "b", "ok": [False],
                "case": {"n": 4, "us": [6.0, 8.0]}}]
    assert _turns.medians(records) == {
        "ms": 2.0, "walls": 2.5, "sha": "a", "ok": [True],
        "case": {"n": 3, "us": 6.0}}
    turns = [("p", {"x": 1}), ("c", {"x": 5}), ("c", {"x": 7}),
             ("p", {"x": 2})]
    assert _turns.by_tree(turns) == {"p": {"x": 1.5}, "c": {"x": 6}}
    assert list(_turns.by_tree(turns)) == ["p", "c"]


def test_take_turns_keeps_each_turns_last_line(capsys):
    def command(name):
        return [sys.executable, "-c",
                f"print('building'); print('{{\"tree\": \"{name}\"}}')"]

    turns = _turns.take_turns("pc", command, lambda r: r["tree"] * 2, 60)
    assert turns == [("p", {"tree": "p"}), ("c", {"tree": "c"})]
    assert capsys.readouterr().out.splitlines() == ["turn p: pp",
                                                    "turn c: cc"]
    with pytest.raises(SystemExit, match="turn c failed:\n.*no tree"):
        _turns.take_turns("c", lambda name: [
            sys.executable, "-c", "import sys; sys.exit('no tree')"],
            str, 60)


def _canned(monkeypatch, records):
    """Replace the turns' processes by `records`, one a turn in order, and
    the cards' query by CARD; returns the argvs the turns were given."""
    argvs, queue = [], list(records)

    def run(argv, **kw):
        argvs.append(argv)
        return subprocess.CompletedProcess(
            argv, 0, "built\n" + json.dumps(queue.pop(0)) + "\n", "")

    monkeypatch.setattr(_turns.subprocess, "run", run)
    monkeypatch.setattr(_turns, "card", lambda: list(CARD))
    return argvs


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_loop_turns_summary(monkeypatch, capsys):
    def record(wall, sha="s"):
        case = {"walls": [wall, wall + 0.2], "graph_ms": wall * 1e3,
                "nodes": 9, "whiles": 2, "body_nodes": 40, "while_set": 151,
                "sha": sha, "first_sha": sha}
        return {"tol 1e-5": case, "main": dict(case, whiles=0)}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argvs = _canned(monkeypatch, [record(w) for w in (1.0, 2.0, 2.2, 1.4)])
    torch_loop_turns.main(["--parent", "old", "--reps", "2"])
    out = _last(capsys)
    assert out["cards"] == CARD and out["turns"] == "pccp"
    assert out["loops"]["p"]["tol 1e-5"]["walls"] == pytest.approx(1.3)
    assert out["loops"]["c"]["main"]["whiles"] == 0
    assert [a[a.index("--one") + 1] for a in argvs] == [
        "old", str(torch_loop_turns.ROOT), str(torch_loop_turns.ROOT), "old"]
    _canned(monkeypatch, [record(1.0), record(1.0, sha="t")])
    with pytest.raises(SystemExit, match="tol 1e-5: outputs t / t"):
        torch_loop_turns.main(["--parent", "old", "--turns", "pc"])


def test_peer_turns_summary(monkeypatch, capsys):
    def record(us, equal=True):
        case = {"equal": [equal] * 4, "peer": [us, us + 1.0],
                "nccl": [2 * us]}
        return {"gather of one float64": case,
                "runs": {"f64 adaptive, rows": {
                    "walls": [0.1, 0.3], "nodes": 7, "body_nodes": 900,
                    "sha": ["abc"]}}}

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    argvs = _canned(monkeypatch, [record(3.0), record(4.0)])
    torch_peer_turns.main(["--tree", "p=old", "--turns", "cp", "--runs"])
    out = _last(capsys)
    assert out["medians"]["c"]["gather of one float64"]["peer"] == 3.5
    assert out["medians"]["p"]["runs"]["f64 adaptive, rows"]["walls"] == (
        pytest.approx(0.2))
    assert all("--runs" in a for a in argvs)
    _canned(monkeypatch, [record(3.0, equal=False)])
    with pytest.raises(SystemExit, match="differ from NCCL"):
        torch_peer_turns.main(["--turns", "c"])


@pytest.mark.parametrize("script", [torch_probe_turns, torch_smooth_turns],
                         ids=["probe", "smooth"])
def test_one_card_turns_summary(script, monkeypatch, capsys):
    keys = script.KEYS + getattr(script, "LIBRARY_KEYS", ())
    hashes = getattr(script, "HASHES", ("main_uT_sha256",))

    def record(v, sha="s"):
        return {**{k: v for k in keys}, "open_uT_sha256": sha,
                **{h: sha for h in hashes}}

    _canned(monkeypatch, [record(v) for v in (1.0, 3.0, 5.0, 2.0)])
    monkeypatch.setattr(sys, "argv", ["turns", "--parent", "old"])
    script.main()
    out = _last(capsys)
    assert out["card"] == CARD[0] and out["order"] == "pccp"
    assert out["median"]["p"][keys[0]] == 1.5
    assert out["median"]["c"][keys[-1]] == 4.0
    assert all(out.get("bit_equal", {"main": out.get("main_uT_bit_equal")})
               .values())
    _canned(monkeypatch, [record(1.0), record(1.0, sha="t")])
    monkeypatch.setattr(sys, "argv", ["turns", "--parent", "old",
                                      "--order", "pc"])
    script.main()
    out = _last(capsys)
    assert not all(out.get("bit_equal",
                           {"main": out.get("main_uT_bit_equal")}).values())

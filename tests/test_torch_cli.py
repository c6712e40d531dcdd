"""PyTorch port: the CLI (`hpcclassmultigridproject_tpu_torch.cli`) against
the JAX package's on the same arguments, on the CPU (`--device cpu`), at
n=32 in float64: the same printed JSON keys (a chunked run: the JAX keys
and the stats the port stitches from its chunks), and `center_uT` within
1e-12 (the f64 run bound of tests/test_golden.py).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu.cli import main as j_main
from hpcclassmultigridproject_tpu_torch.cli import main as t_main

BASE = ["--n", "32", "--dtype", "f64", "--levels", "3"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


def _lines(capsys, fn, argv) -> list[dict]:
    capsys.readouterr()
    assert fn(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def _both(capsys, argv, port_extra=CPU):
    return (_lines(capsys, j_main, argv),
            _lines(capsys, t_main, argv + port_extra))


RUNS = {
    "run": ["run", *BASE, "--steps", "3"],
    "delta": ["run", *BASE, "--steps", "4", "--delta", "--cycle-mode",
              "fixed", "--num-cycles", "1", "--coarse", "dense",
              "--certify-every", "2"],
    "chebyshev_fmg": ["run", *BASE, "--steps", "2", "--smoother",
                      "chebyshev", "--cycle-mode", "fmg", "--num-cycles", "1",
                      "--coarse", "dense"],
    "jacobi_w": ["run", *BASE, "--steps", "2", "--smoother", "jacobi",
                 "--cycle-shape", "2"],
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_matches_jax(capsys, case):
    (jout,), (tout,) = _both(capsys, RUNS[case])
    assert set(tout) == set(jout)
    assert tout["center_uT"] == pytest.approx(jout["center_uT"], abs=1e-12)
    assert tout["converged"] == jout["converged"]
    assert tout["max_cycles"] == jout["max_cycles"]


def test_run_checkpointed_matches_jax(capsys, tmp_path):
    argv = ["run", *BASE, "--steps", "5", "--checkpoint-every", "2"]
    (jout,) = _lines(capsys, j_main,
                     argv + ["--checkpoint-dir", str(tmp_path / "j")])
    (tout,) = _lines(capsys, t_main,
                     argv + ["--checkpoint-dir", str(tmp_path / "t")] + CPU)
    assert set(jout) <= set(tout) and tout["seconds"] is None
    assert tout["center_uT"] == pytest.approx(jout["center_uT"], abs=1e-12)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    # the port stitches the chunks' stats: its extra keys are the unchunked
    # port run's (the JAX package prints none for a checkpointed run)
    (straight,) = _lines(capsys, t_main, ["run", *BASE, "--steps", "5"] + CPU)
    extra = set(tout) - set(jout)
    assert extra == {"max_cycles", "max_rel_residual", "converged"}
    assert {k: tout[k] for k in extra} == {k: straight[k] for k in extra}


@pytest.mark.parametrize("chunking", [
    ["--checkpoint-every", "2"], ["--dump-every", "2"]],
    ids=["checkpoint", "dump_every"])
@pytest.mark.parametrize("case", ["run", "delta"])
def test_chunked_runs_print_the_unchunked_stats(capsys, tmp_path, case,
                                                chunking):
    """max_cycles, converged equal, max_rel_residual within 1e-14 (the
    delta form folds each chunk's last correction into its high-dtype
    state) of the same run unchunked."""
    where = (["--checkpoint-dir", str(tmp_path / "ck")]
             if chunking[0] == "--checkpoint-every"
             else ["--dump", str(tmp_path / "uT.txt")])
    (straight,) = _lines(capsys, t_main, RUNS[case] + CPU)
    (chunked,) = _lines(capsys, t_main, RUNS[case] + chunking + where + CPU)
    assert chunked["max_cycles"] == straight["max_cycles"]
    assert chunked["converged"] == straight["converged"]
    assert chunked["max_rel_residual"] == pytest.approx(
        straight["max_rel_residual"], rel=0, abs=1e-14)


def test_run_dump_and_diff(capsys, tmp_path):
    argv = ["run", *BASE, "--steps", "3"]
    _lines(capsys, j_main, argv + ["--dump", str(tmp_path / "j.txt")])
    _lines(capsys, t_main, argv + ["--dump", str(tmp_path / "t.txt")] + CPU)
    diff = ["diff", str(tmp_path / "j.txt"), str(tmp_path / "t.txt")]
    (jd,), (td,) = _both(capsys, diff, port_extra=[])
    assert set(td) == set(jd) == {"frobenius_norm"}
    assert td["frobenius_norm"] == jd["frobenius_norm"] <= 1e-5


def test_dump_series_and_animation(capsys, tmp_path):
    dump = str(tmp_path / "uT.txt")
    _lines(capsys, t_main, ["run", *BASE, "--steps", "6", "--dump", dump,
                            "--dump-every", "2"] + CPU)
    series = sorted(glob.glob(str(tmp_path / "uT.step*.txt")))
    assert len(series) == 4  # steps 0, 2, 4, 6
    (td,) = _lines(capsys, t_main, ["diff", dump, series[-1]])
    assert td["frobenius_norm"] == 0.0
    viz = ["viz", str(tmp_path / "uT.step*.txt"), "--animate", "--out"]
    (jv,) = _lines(capsys, j_main, viz + [str(tmp_path / "j.gif")])
    (tv,) = _lines(capsys, t_main, viz + [str(tmp_path / "t.gif")])
    assert set(tv) == set(jv) and tv["frames"] == jv["frames"] == 4
    assert os.path.getsize(tmp_path / "t.gif") > 1000
    (one,) = _lines(capsys, t_main, ["viz", dump, "--out",
                                     str(tmp_path / "uT.png")])
    assert one["n"] == 32 and os.path.getsize(tmp_path / "uT.png") > 1000


def test_sweep_matches_jax(capsys):
    argv = ["sweep", "--sizes", "16,32", "--steps", "2", "--dtype", "f64",
            "--reps", "1", "--levels", "1"]
    jout, tout = _both(capsys, argv)
    assert [r["n"] for r in tout] == [r["n"] for r in jout] == [16, 32]
    for t, j in zip(tout, jout):
        assert set(t) == set(j)
        assert t["center_uT"] == pytest.approx(j["center_uT"], abs=1e-12)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_gsbench_keys_match_jax(capsys, backend):
    argv = ["gsbench", "--n", "32", "--sweeps", "4", "--reps", "1",
            "--backend", backend]
    (jout,), (tout,) = _both(capsys, argv)
    assert set(tout) == set(jout)
    assert tout["backend"] == backend and tout["sweeps"] == 4


def test_gsbench_backends_agree():
    """K2's route (its plain version here) and the plain rb_gauss_seidel
    sweep the same field."""
    from hpcclassmultigridproject_tpu_torch.core.layout import pad_field
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        rotating_velocity,
    )
    from hpcclassmultigridproject_tpu_torch.mg.levels import build_fine_level
    from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
        fused_rb_sweeps,
    )
    from hpcclassmultigridproject_tpu_torch.ops.padded import rb_gauss_seidel

    v1, v2 = rotating_velocity(32, dtype=torch.float64, device="cpu")
    level = build_fine_level(v1, v2, 1 / 320, -4e-4, dtype=torch.float64,
                             device="cpu")
    u = torch.zeros((33, 33), dtype=torch.float64)
    u[1:-1, 1:-1] = 1.0
    u = pad_field(u)
    rhs = torch.zeros_like(u)
    a, b = u, u
    for _ in range(3):
        a = fused_rb_sweeps(level, a, rhs, 1)[0]
        b = rb_gauss_seidel(level, b, rhs)
    assert torch.equal(a, b)


def test_profile_matches_jax(capsys, tmp_path):
    argv = ["profile", *BASE, "--steps", "2", "--cycle-mode", "fixed",
            "--num-cycles", "1", "--coarse", "dense", "--reps", "1"]
    jout, tout = _both(capsys, argv,
                       port_extra=CPU + ["--trace", str(tmp_path / "tr")])
    assert tout[-1] == {"trace_logdir": str(tmp_path / "tr")}
    jphases, jsummary = jout[:-1], jout[-1]
    tphases, tsummary = tout[:-2], tout[-2]
    assert set(tsummary) == set(jsummary)
    assert [(r["phase"], r["level"]) for r in tphases] == [
        (r["phase"], r["level"]) for r in jphases]
    for t, j in zip(tphases, jphases):
        assert set(t) == set(j)
        assert t["model_gflop"] == pytest.approx(j["model_gflop"])
        assert t["per_step_count"] == j["per_step_count"]


@pytest.mark.parametrize("cmd,rows", [
    ("plot-sweep", [{"n": 32, "ms": 1.0}, {"n": 64, "ms": 3.0}]),
    ("plot-scaling", [{"devices": 1, "seconds": 2.0},
                      {"devices": 2, "seconds": 1.2}]),
])
def test_plots_match_jax(capsys, tmp_path, cmd, rows):
    data = tmp_path / "rows.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    (jout,) = _lines(capsys, j_main, [cmd, str(data), "--out",
                                      str(tmp_path / "j.png")])
    (tout,) = _lines(capsys, t_main, [cmd, str(data), "--out",
                                      str(tmp_path / "t.png")])
    assert set(tout) == set(jout)
    assert os.path.getsize(tmp_path / "t.png") > 1000


def test_device_defaults_to_the_card(monkeypatch):
    """Without --device the CLI asks for the card, and without one it
    raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["run", *BASE, "--steps", "1"])


def test_scaling_is_not_a_port_subcommand(capsys):
    with pytest.raises(SystemExit):
        t_main(["scaling"])
    assert "invalid choice" in capsys.readouterr().err


def test_port_cli_never_imports_jax(tmp_path):
    """The port's CLI module, with its utils and the probe, imports no
    jax."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import hpcclassmultigridproject_tpu_torch.cli as c\n"
            "import hpcclassmultigridproject_tpu_torch.utils.profiling\n"
            "import hpcclassmultigridproject_tpu_torch.ops.cuda.probe\n"
            "assert c.main(['diff', sys.argv[1], sys.argv[1]]) == 0\n"
            "assert 'jax' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    field = tmp_path / "field.txt"
    np.savetxt(field, np.eye(5), fmt="%f", delimiter="\t")
    proc = subprocess.run([sys.executable, "-c", code, str(field)], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr

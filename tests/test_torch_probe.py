"""PyTorch port: P, the Hopper feature probe (`ops/cuda/probe.py`), on
the CPU.  The six plain versions are held to the numpy expectations that
the JAX probe (scripts/mosaic_probe_tpu.py) checks (:64, :77, :89, :100,
:115, :134): equality for the index maps, atol 1e-6 for the products; the
JAX probe's own Pallas kernels run here in interpret mode, and
tests/test_torch_probe_pallas.py holds the plain versions to them.  The
products' plain version and the product kernel's order
(`dot_in_kernel_order`) are held to float64 within the float32 bound
k 2^-24 (|a| @ |b|) on dense operands.  The CUDA kernels are held to the
same checks, and to their plain versions, on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import probe
from hpcclassmultigridproject_tpu_torch.utils import profiling

NAMES = ["stride2_rows", "dot_decimate", "interleave_rows", "flatten",
         "dot_decimate_rows", "dot_prolong_rows"]


def test_probe_set_is_the_jax_scripts():
    assert list(probe.probes()) == NAMES
    assert (probe.R, probe.C) == (64, 256)


@pytest.mark.parametrize("name", NAMES)
def test_plain_probe_matches_the_expectation(name):
    ops = probe.probe_operands()
    kern, plain, names, expect, exact = probe.probes()[name]
    args = [torch.from_numpy(ops[k]) for k in names]
    want = expect(ops)
    for fn in (kern, plain):  # on the CPU the wrapper is the plain version
        got = fn(*args).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# (bytes, flops) at (64, 256) f32: x is 64 KiB; D, Dr and P hold 128, 32
# and 64 + 2 * 63 nonzeros, each met by a dense column or row of x.
_COSTS = {
    "stride2_rows": (32768 + 32768, 0.0),
    "dot_decimate": (65536 + 131072 + 32768, 2.0 * 128 * 64),
    "interleave_rows": (65536 + 131072, 0.0),
    "flatten": (65536 + 65536, 0.0),
    "dot_decimate_rows": (8192 + 65536 + 32768, 2.0 * 32 * 256),
    "dot_prolong_rows": (32768 + 65536 + 131072, 2.0 * 190 * 256),
}


@pytest.mark.parametrize("name", NAMES)
def test_probe_cost_counts_each_array_once(name):
    """The byte and operation model behind the bound column of P's rows,
    from numpy and from torch operands alike."""
    ops = probe.probe_operands()
    assert profiling.probe_cost(name, ops) == _COSTS[name]
    tens = {k: torch.from_numpy(v) for k, v in ops.items()}
    assert profiling.probe_cost(name, tens) == _COSTS[name]


def test_probe_operands_match_the_jax_script():
    ops = probe.probe_operands()
    x = ops["x"]
    assert x.shape == (64, 256) and x.dtype == np.float32
    np.testing.assert_array_equal(
        x, np.random.default_rng(0).standard_normal((64, 256))
        .astype(np.float32))
    assert ops["D"].sum() == 128 and ops["Dr"].sum() == 32
    # bilinear rows: even rows copy, odd rows average two neighbours
    np.testing.assert_array_equal(ops["P"].sum(axis=1)[:-1], 1.0)


def test_run_probes_on_the_cpu():
    cuda.reset_launches()
    records = probe.run_probes("cpu")
    assert [r["name"] for r in records] == NAMES
    assert all(r["passed"] and r["bit_identical"] for r in records)
    assert all(r["kernel_ms"] is None and r["plain_ms"] is None
               and r["library_ms"] is None for r in records)
    assert all(v == 0 for k, v in cuda.LAUNCHES.items()
               if k.startswith("probe_"))


def test_probe_entry_point_prints_the_jax_lines(capsys):
    assert probe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1:] == [f"PASS {n}" for n in NAMES] + ["PROBE DONE"]


def test_probe_refuses_a_cuda_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main([])


def test_probe_wrappers_refuse_bad_inputs(monkeypatch):
    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    with pytest.raises(ValueError, match="float32"):
        probe.stride2_rows(torch.zeros((4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        probe.flatten(torch.zeros((4, 4)).t())
    with pytest.raises(ValueError, match="@"):
        probe.dot(torch.zeros((4, 3)), torch.zeros((4, 4)), "probe_dot")


@pytest.mark.parametrize("shape", list(probe.DOT_SHAPES))
@pytest.mark.parametrize("fn", [probe.dot_plain, probe.dot_in_kernel_order],
                         ids=["plain", "kernel_order"])
def test_dot_within_the_float32_bound(fn, shape):
    """Dense seeded operands at the three probe shapes and one that no tile
    divides, against numpy in float64: |err| <= k 2^-24 (|a| @ |b|)."""
    m, k, n = probe.DOT_SHAPES[shape]
    a, b = probe.dense_operands(m, k, n)
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (m, n) and got.dtype == torch.float32
    exact = a.astype(np.float64) @ b.astype(np.float64)
    bound = k * 2.0 ** -24 * (np.abs(a).astype(np.float64)
                              @ np.abs(b).astype(np.float64))
    assert np.all(np.abs(got.numpy() - exact) <= bound)
    np.testing.assert_array_equal(
        probe.dot_error_bound(torch.from_numpy(a), torch.from_numpy(b))
        .numpy(), bound)


@pytest.mark.parametrize("m,k,n", [(3, 5, 7), (4, 33, 3), (2, 70, 2)])
def test_kernel_order_is_the_documented_one(m, k, n):
    """csrc/probe.cu's order, in float32 scalars: lane g sums its
    contiguous range of k in order from +0, then
    ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))."""
    a, b = probe.dense_operands(m, k, n, seed=5)
    span = -(-k // 8)
    want = np.zeros((m, n), np.float32)
    for i in range(m):
        for j in range(n):
            s = [np.float32(0.0)] * 8
            for g in range(8):
                for q in range(g * span, min((g + 1) * span, k)):
                    s[g] = np.float32(s[g] + np.float32(a[i, q] * b[q, j]))
            want[i, j] = ((s[0] + s[4]) + (s[2] + s[6])) + (
                (s[1] + s[5]) + (s[3] + s[7]))
    got = probe.dot_in_kernel_order(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["dot_decimate", "dot_decimate_rows",
                                  "dot_prolong_rows"])
def test_kernel_order_is_exact_on_the_probe_operands(name):
    """One product or one rounding of a sum of two exact products an
    output: any order gives the plain version's result to the bit."""
    ops = probe.probe_operands()
    _, plain, names, expect, _ = probe.probes()[name]
    args = [torch.from_numpy(ops[k]) for k in names]
    got = probe.dot_in_kernel_order(*args)
    assert torch.equal(got, plain(*args))
    np.testing.assert_array_equal(got.numpy(), expect(ops))


@pytest.mark.parametrize("fn", [probe.flatten, probe.flatten_plain],
                         ids=["wrapper", "plain"])
def test_flatten_writes_a_buffer_of_its_own(fn):
    """The TPU kernel writes x's values into an output of its own (no
    input_output_aliases, scripts/mosaic_probe_tpu.py:39-46): the result
    shares no storage with x, and writing to it leaves x as it was."""
    x = torch.from_numpy(probe.probe_operands()["x"])
    before = x.clone()
    out = fn(x)
    assert out.shape == (probe.R * probe.C, 1)
    assert torch.equal(out[:, 0], x.reshape(-1))
    assert (out.untyped_storage().data_ptr()
            != x.untyped_storage().data_ptr())
    out.fill_(7.0)
    assert torch.equal(x, before)

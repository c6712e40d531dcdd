"""PyTorch port: the compiled loops (`utils.graphs.while_loop`, the
counterpart of `jax.lax.while_loop`), on the CPU.

(i) `while_loop`'s host form against `jax.lax.while_loop` on the same cond
    and body (zero trips, the cap reached, float32, float64), bit for bit,
    and through the stand-in's conditional node (tests/test_torch_compiled.py
    `StandIn`): equal to the host form, its capture reading nothing back,
    and a replay's launch counts its eager run's at 0, 1 and k trips,
    nested loops included, with `while_set` once a test;
(ii) the four loop sites against the JAX package, called directly and
    through the stand-in's capture, with equal cycle and iteration counts:
    AdvectionDiffusion `_jit_run` under `SolverConfig()` and
    `SolverConfig(tol=1e-5)` (adaptive, the GS coarse solve nested) at
    n=32 and 64, 3 steps, V and W; the refined adaptive solve; Poisson
    `_jit_mg` adaptive in float64 and `_jit_gs`.  float64 holds to atol
    1e-12; a float32 field to 5e-7 of its largest value (the bar of
    tests/test_torch_cycle.py and test_torch_poisson.py: XLA contracts
    a*b+c into an FMA, a few ulp an op); the refined state, float64 with
    float32 corrections, to 1e-8 (ROADMAP's FMA note).  The captured form
    equals the direct one to the bit;
(iii) `csrc/loop.cu` built by g++ against a stand-in CUDA runtime
    (`SHIM`): the kernel passes its predicate to cudaGraphSetConditional
    and counts a trip where it holds, and the host half adds a conditional
    WHILE node after the stream's dependencies and captures its body;
(iv) `cli gsbench` through `graphs.Programs`: one capture per (n, sweeps,
    backend, dtype), and `LAUNCHES["smooth"]` grows by `sweeps` a replay.
"""

import ctypes
import functools
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.models import Poisson as JPoisson
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import cli as t_cli
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper
from hpcclassmultigridproject_tpu_torch.models import (
    AdvectionDiffusion,
    Poisson,
)
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, loop
from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
from hpcclassmultigridproject_tpu_torch.utils import graphs

from capture_stand_in import HostRead, StandIn, no_host_reads


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(params=["direct", "captured"])
def entry(request, monkeypatch):
    """The loops called directly (the host form) or through the stand-in's
    capture, which reads nothing back, and its replay."""
    if request.param == "captured":
        monkeypatch.setattr(graphs, "CAPTURE", StandIn(guard=no_host_reads))
    return request.param


# (i) the helper

def _halving(xp, tol, cap):
    """cond and body of one loop for either framework: halve x (exact in
    binary) until max|x| <= tol or `cap` trips ran; the carry is (x,
    max|x|, trips)."""
    def cond(carry):
        _, res, it = carry
        return (it < cap) & (res > tol)

    def body(carry):
        x, _, it = carry
        x = x * 0.5
        return x, xp.max(xp.abs(x)), it + 1

    return cond, body


# (name, dtype, tol, cap, trips the loop takes)
HELPER_CASES = [
    ("zero trips", jnp.float64, 100.0, 50, 0),
    ("the cap reached", jnp.float64, 0.0, 7, 7),
    ("f32", jnp.float32, 1e-3, 50, 13),
    ("f64", jnp.float64, 1e-9, 50, 33),
]


@pytest.mark.parametrize("name,jdtype,tol,cap,trips", HELPER_CASES,
                         ids=[c[0] for c in HELPER_CASES])
def test_while_loop_matches_lax_while_loop(entry, name, jdtype, tol, cap,
                                          trips):
    x0 = np.random.default_rng(16).uniform(-4.0, 4.0, 33).astype(jdtype)
    x0[5] = 5.0
    jx = jnp.asarray(x0)
    want = jax.lax.while_loop(*_halving(jnp, tol, cap),
                              (jx, jnp.max(jnp.abs(jx)), jnp.int32(0)))
    tx = torch.from_numpy(x0)
    carry = (tx, tx.abs().max(), torch.zeros((), dtype=torch.int32))
    cond, body = _halving(torch, tol, cap)
    programs = graphs.Programs()
    got = programs("halving", lambda *c: graphs.while_loop(cond, body, c),
                   carry)
    assert int(want[2]) == int(got[2]) == trips
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (programs.last is not None) == (entry == "captured")


def test_host_form_reads_once_a_test():
    cond, body = _halving(torch, 1e-3, 50)
    x = torch.full((4,), 5.0)
    cuda.reset_launches()
    graphs.while_loop(cond, body, (x, x.abs().max(),
                                   torch.zeros((), dtype=torch.int32)))
    assert cuda.HOST_TESTS["while_set"] == 14  # 13 trips
    assert cuda.LAUNCHES["while_set"] == 0
    with no_host_reads(), pytest.raises(HostRead):
        graphs.while_loop(cond, body, (x, x.abs().max(),
                                       torch.zeros((), dtype=torch.int32)))
    cuda.reset_launches()
    assert cuda.HOST_TESTS["while_set"] == 0


def _counting_loops(inner_trips):
    """An outer loop of len(inner_trips) trips whose trip k adds 2 smooth
    launches and runs an inner loop of inner_trips[k] trips adding 1
    smooth5 launch each, as kernel wrappers count."""
    table = torch.tensor(list(inner_trips) + [0], dtype=torch.int32)

    def fn(x):
        def outer_body(carry):
            x, it = carry
            cuda.LAUNCHES["smooth"] += 2

            def inner_cond(c):  # table[it], read on the device
                return c[1] < torch.index_select(table, 0, it.view(1))[0]

            def inner_body(c):
                cuda.LAUNCHES["smooth5"] += 1
                return c[0] + 1.0, c[1] + 1

            x, _ = graphs.while_loop(inner_cond, inner_body,
                                     (x, torch.zeros_like(it)))
            return x * 2.0, it + 1

        return graphs.while_loop(lambda c: c[1] < len(inner_trips),
                                 outer_body,
                                 (x, torch.zeros((), dtype=torch.int32)))

    return fn


@pytest.mark.parametrize("inner_trips", [(), (0,), (1,), (3, 0, 2, 5)],
                         ids=["0 trips", "1 trip, 0 inner", "1 trip",
                              "k trips, nested"])
def test_replay_counts_equal_eager(monkeypatch, inner_trips):
    fn = _counting_loops(inner_trips)
    x = torch.ones(3)
    cuda.reset_launches()
    want = fn(x)
    eager = dict(cuda.LAUNCHES)
    tests = cuda.HOST_TESTS["while_set"]
    assert eager["smooth"] == 2 * len(inner_trips)
    assert eager["smooth5"] == sum(inner_trips)
    assert tests == len(inner_trips) + 1 + sum(inner_trips) + len(
        inner_trips)
    fake = StandIn(guard=no_host_reads)
    monkeypatch.setattr(graphs, "CAPTURE", fake)
    programs = graphs.Programs()
    for _ in range(3):  # the capture's call, then two replays
        cuda.reset_launches()
        got = programs("loops", fn, (x,))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        counts = dict(cuda.LAUNCHES)
        assert counts.pop("while_set") == tests
        assert counts == {k: v for k, v in eager.items()
                          if k != "while_set"}
        assert cuda.HOST_TESTS["while_set"] == 0
    assert fake.captures == 1
    assert len(programs.last.loops) == 2  # the outer node, the inner one
    assert programs.last.launches == {"while_set": 1}  # the first test


def test_nested_node_counts_are_recorded_in_start_order(monkeypatch):
    """An inner node finishes its capture before its outer node: each
    keeps the counter it took at its start."""
    fake = StandIn()
    monkeypatch.setattr(graphs, "CAPTURE", fake)
    programs = graphs.Programs()
    programs("loops", _counting_loops((2, 1)), (torch.ones(2),))
    loops = programs.last.loops
    assert loops.counts[0] == {"smooth": 2, "while_set": 2}  # outer
    assert loops.counts[1] == {"smooth5": 1, "while_set": 1}  # inner


def test_capture_outside_a_program_raises():
    with pytest.raises(RuntimeError, match="outside"):
        graphs.CudaGraphs().while_node(lambda c: c[0] > 0, lambda c: c,
                                       (torch.ones(()),), torch.device("cpu"))


def test_carry_holds_tensors_only():
    with pytest.raises(TypeError, match="tensors only"):
        graphs.static_carry((torch.ones(1), 3))


def test_while_set_plain_version():
    cuda.reset_launches()
    trips = torch.zeros((), dtype=torch.int32)
    flags = torch.tensor([False, True, False, True])
    assert loop.while_set(0, flags[1], trips) is True
    assert loop.while_set(0, flags[2], trips) is False
    assert loop.while_set(0, flags[3:], trips) is True
    assert int(trips) == 2 and cuda.LAUNCHES["while_set"] == 0
    with pytest.raises(ValueError, match="one bool"):
        loop.while_set(0, flags, trips)
    with pytest.raises(ValueError, match="int32"):
        loop.while_set(0, flags[0], trips.to(torch.int64))
    with pytest.raises(ValueError, match="several devices"):
        loop.while_set(0, flags[0], trips.to("meta"))
    with cuda.plain_route():  # the route leaves the loop's test as it is
        assert loop.while_set(0, flags[1], trips) is True


# (ii) the four loop sites against the JAX package

@functools.cache
def _jax_run(n, shape, tol):
    kw = {} if tol is None else {"tol": tol}
    uT, stats = JModel(JProblem(n=n, num_steps=3),
                       JSolver(cycle_shape=shape, backend="jnp", **kw)).run(
        warn=False)
    return np.asarray(uT), np.asarray(stats["cycles"])


def _f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("shape", [1, 2], ids=["V", "W"])
@pytest.mark.parametrize("tol", [None, 1e-5], ids=["default", "tol 1e-5"])
def test_advection_adaptive_matches_jit_run(entry, n, shape, tol):
    """SolverConfig() (f32, tol 1e-6: at n=64 it stalls at max_cycles, as
    the JAX package's does) and the verify skill's tol 1e-5."""
    kw = {} if tol is None else {"tol": tol}
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=3),
                               SolverConfig(cycle_shape=shape, **kw),
                               device="cpu")
    juT, jcycles = _jax_run(n, shape, tol)
    runs = []
    for _ in range(2):  # the capture's call, then a replay
        uT, stats = model.run(warn=False)
        assert model.last_run_compiled == (entry == "captured")
        _f32_close(uT.numpy(), juT)
        np.testing.assert_array_equal(stats["cycles"].numpy(), jcycles)
        assert stats["cycles"].dtype == torch.int32
        runs.append(uT)
    assert torch.equal(runs[0], runs[1])
    if entry == "captured":
        # a step's mg_solve, and the coarse solves of its body's cycle:
        # shape at each level down to the coarsest, which solves shape times
        assert len(model.programs.last.loops) == 3 * (
            1 + shape ** model.num_levels)
        want, _ = timestepper(model.levels, model.u0, 3, model.solver)
        assert torch.equal(runs[0], model.crop(want))


_REFINED = dict(tol=1e-6, cycle_mode="adaptive", num_levels=2)


@functools.cache
def _jax_refined():
    uT, stats = JModel(JProblem(n=64, num_steps=3),
                       JSolver(dtype=jnp.float32, refine_dtype=jnp.float64,
                               backend="jnp", **_REFINED)).run(warn=False)
    return np.asarray(uT), np.asarray(stats["cycles"])


def test_refined_adaptive_matches_jax(entry):
    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=3),
        SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                     **_REFINED), device="cpu")
    juT, jcycles = _jax_refined()
    for _ in range(2):
        uT, stats = model.run(warn=False)
        assert model.last_run_compiled == (entry == "captured")
        np.testing.assert_allclose(uT.numpy(), juT, rtol=0, atol=1e-8)
        np.testing.assert_array_equal(stats["cycles"].numpy(), jcycles)


_POISSON = dict(tol=1e-10, restriction="full", coarse_mode="dense",
                num_levels=3)


@functools.cache
def _jax_poisson_mg():
    jm = JPoisson(n=64, solver=JSolver(dtype=jnp.float64, **_POISSON))
    u, stats = jm.solve()
    return np.asarray(u), {k: np.asarray(v) for k, v in stats.items()}


def test_poisson_adaptive_matches_jit_mg(entry):
    tm = Poisson(n=64, solver=SolverConfig(dtype=torch.float64, **_POISSON),
                 device="cpu")
    ju, jst = _jax_poisson_mg()
    for _ in range(2):
        tu, tst = tm.solve()
        assert tm.last_run_compiled == (entry == "captured")
        np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=1e-12)
        assert int(tst["cycles"]) == int(jst["cycles"]) > 1
        assert bool(tst["converged"]) == bool(jst["converged"])


# (max_iters, check_every, tol): zero trips, the cap reached, converged
GS_CASES = [(0, 10, 1e-6), (300, 100, 1e-6), (20_000, 50, 1e-3)]


@functools.cache
def _jax_gs(max_iters, check_every, tol):
    jm = JPoisson(n=16, solver=JSolver(dtype=jnp.float64, tol=tol))
    u, stats = jm.solve("gs", max_iters=max_iters, check_every=check_every)
    return np.asarray(u), {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.parametrize("max_iters,check_every,tol", GS_CASES,
                         ids=["zero trips", "the cap reached", "converged"])
def test_poisson_gs_matches_jit_gs(entry, max_iters, check_every, tol):
    tm = Poisson(n=16, solver=SolverConfig(dtype=torch.float64, tol=tol),
                 device="cpu")
    ju, jst = _jax_gs(max_iters, check_every, tol)
    for _ in range(2):
        tu, tst = tm.solve("gs", max_iters=max_iters, check_every=check_every)
        assert tm.last_run_compiled == (entry == "captured")
        np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=1e-12)
        assert tst["iters"].dtype == torch.int32
        assert int(tst["iters"]) == int(jst["iters"])
        np.testing.assert_allclose(tst["rel_residual"].numpy(),
                                   jst["rel_residual"], rtol=1e-10)
    if tol == 1e-3:
        assert 0 < int(jst["iters"]) < max_iters


def test_gs_programs_are_keyed_by_max_iters_and_check_every(monkeypatch):
    fake = StandIn()
    monkeypatch.setattr(graphs, "CAPTURE", fake)
    tm = Poisson(n=16, solver=SolverConfig(dtype=torch.float64),
                 device="cpu")
    for max_iters, check_every in ((100, 10), (100, 10), (200, 10),
                                   (100, 20)):
        tm.solve("gs", max_iters=max_iters, check_every=check_every)
    assert fake.captures == len(tm.programs) == 3
    assert fake.warmups == 3


# (iii) csrc/loop.cu on the host

# Enough of the CUDA runtime for g++ to build loop.cu and run it on the
# host: streams and graphs are records, `cudaGraphSetConditional` logs the
# (handle, value) it is given, and a launch runs the kernel once.
SHIM = r"""
#pragma once
#include <cstddef>
#include <vector>
#define CUDART_VERSION 12090
#define __global__
typedef unsigned long long cudaGraphConditionalHandle;
enum cudaError_t { cudaSuccess = 0, cudaErrorStreamCaptureImplicit = 906 };
enum cudaStreamCaptureStatus { cudaStreamCaptureStatusNone = 0,
                               cudaStreamCaptureStatusActive = 1 };
enum cudaStreamCaptureMode { cudaStreamCaptureModeGlobal = 0,
                             cudaStreamCaptureModeThreadLocal = 1 };
enum cudaGraphNodeType { cudaGraphNodeTypeKernel = 0,
                         cudaGraphNodeTypeConditional = 13 };
enum cudaGraphConditionalNodeType { cudaGraphCondTypeIf = 0,
                                    cudaGraphCondTypeWhile = 1 };
enum { cudaStreamSetCaptureDependencies = 1 };
struct Graph;
struct Node { int type; unsigned long long handle; int cond_type;
              unsigned size; Graph* body; std::vector<Node*> deps; };
struct Graph { std::vector<Node*> nodes; };
typedef Graph* cudaGraph_t;
typedef Node* cudaGraphNode_t;
struct Stream { int capturing; Graph* graph; std::vector<Node*> deps; };
typedef Stream* cudaStream_t;
struct cudaConditionalNodeParams {
  cudaGraphConditionalHandle handle;
  cudaGraphConditionalNodeType type;
  unsigned size;
  cudaGraph_t* phGraph_out;
};
struct cudaGraphNodeParams {
  cudaGraphNodeType type;
  int reserved0[3];
  cudaConditionalNodeParams conditional;
};

inline unsigned long long mg_log[64][2];
inline int mg_logged = 0;
inline unsigned long long mg_handles = 40;
inline cudaGraph_t mg_body_out[1];

inline void cudaGraphSetConditional(cudaGraphConditionalHandle h,
                                    unsigned value) {
  mg_log[mg_logged][0] = h;
  mg_log[mg_logged][1] = value;
  ++mg_logged;
}
inline int cudaGetLastError() { return 0; }
inline cudaError_t cudaStreamGetCaptureInfo(
    cudaStream_t s, cudaStreamCaptureStatus* status, unsigned long long*,
    cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* count) {
  *status = s->capturing ? cudaStreamCaptureStatusActive
                         : cudaStreamCaptureStatusNone;
  if (graph) *graph = s->graph;
  if (deps) *deps = s->deps.data();
  if (count) *count = s->deps.size();
  return cudaSuccess;
}
inline cudaError_t cudaGraphConditionalHandleCreate(
    cudaGraphConditionalHandle* h, cudaGraph_t, unsigned, unsigned) {
  *h = ++mg_handles;
  return cudaSuccess;
}
inline cudaError_t cudaGraphAddNode(cudaGraphNode_t* node, cudaGraph_t g,
                                    const cudaGraphNode_t* deps,
                                    size_t count, cudaGraphNodeParams* p) {
  Node* made = new Node{p->type, p->conditional.handle, p->conditional.type,
                        p->conditional.size, new Graph{},
                        std::vector<Node*>(deps, deps + count)};
  g->nodes.push_back(made);
  mg_body_out[0] = made->body;
  p->conditional.phGraph_out = mg_body_out;
  *node = made;
  return cudaSuccess;
}
inline cudaError_t cudaStreamUpdateCaptureDependencies(
    cudaStream_t s, cudaGraphNode_t* nodes, size_t count, unsigned flags) {
  if (flags == cudaStreamSetCaptureDependencies)
    s->deps.assign(nodes, nodes + count);
  return cudaSuccess;
}
inline cudaError_t cudaStreamBeginCaptureToGraph(
    cudaStream_t s, cudaGraph_t g, const cudaGraphNode_t*, const void*,
    size_t, cudaStreamCaptureMode) {
  s->capturing = 1;
  s->graph = g;
  s->deps.clear();
  return cudaSuccess;
}
inline cudaError_t cudaStreamEndCapture(cudaStream_t s, cudaGraph_t* g) {
  if (!s->capturing) return cudaErrorStreamCaptureImplicit;
  *g = s->graph;
  s->capturing = 0;
  return cudaSuccess;
}

template <class K, class... A>
void mg_host_launch(int, int, int, cudaStream_t, K kernel, A... args) {
  kernel(args...);
}

extern "C" void* mg_shim_stream(int capturing, int deps) {
  Stream* s = new Stream{capturing, new Graph{}, {}};
  for (int i = 0; i < deps; ++i) {
    s->graph->nodes.push_back(new Node{cudaGraphNodeTypeKernel});
    s->deps.push_back(s->graph->nodes.back());
  }
  return s;
}
extern "C" int mg_shim_logged(unsigned long long* out) {
  for (int i = 0; i < mg_logged; ++i) {
    out[2 * i] = mg_log[i][0];
    out[2 * i + 1] = mg_log[i][1];
  }
  return mg_logged;
}
// the stream's graph's last node: type, handle, condition type, size,
// its dependency count, whether they are the stream's dependencies before
// it (`before`), and whether the stream now depends on it alone
extern "C" void mg_shim_last_node(void* stream, void* before_deps,
                                  int before, long* out) {
  Stream* s = static_cast<Stream*>(stream);
  Node* n = s->graph->nodes.back();
  Node** prev = static_cast<Node**>(before_deps);
  int same = static_cast<int>(n->deps.size()) == before;
  for (int i = 0; same && i < before; ++i) same = n->deps[i] == prev[i];
  const long got[7] = {n->type, static_cast<long>(n->handle),
                       n->cond_type, n->size, (long)n->deps.size(), same,
                       s->deps.size() == 1 && s->deps[0] == n};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
}
extern "C" void mg_shim_deps(void* stream, void** out) {
  Stream* s = static_cast<Stream*>(stream);
  for (size_t i = 0; i < s->deps.size(); ++i) out[i] = s->deps[i];
}
extern "C" int mg_shim_capturing_into(void* stream, void* graph) {
  Stream* s = static_cast<Stream*>(stream);
  return s->capturing && s->graph == graph;
}
"""


@pytest.fixture(scope="module")
def host_loop(tmp_path_factory):
    """csrc/loop.cu built by g++ against SHIM, each `kernel<<<...>>>(args)`
    made `mg_host_launch(..., kernel, args)`."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel source for the host"
    directory = tmp_path_factory.mktemp("loop")
    (directory / "cuda_runtime.h").write_text(SHIM)
    source = (_build.CSRC / "loop.cu").read_text()
    host = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                  r"mg_host_launch(\2, \1, ", source, flags=re.S)
    assert "<<<" not in host and host.count("mg_host_launch(") == 1
    src, lib = directory / "loop_host.cpp", directory / "libloop_host.so"
    src.write_text(host)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(directory), "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _build._LOOP_SIGNATURES.items():
        getattr(cdll, name).argtypes = argtypes
        getattr(cdll, name).restype = ctypes.c_int
    cdll.mg_shim_stream.restype = ctypes.c_void_p
    cdll.mg_shim_stream.argtypes = [ctypes.c_int, ctypes.c_int]
    for name in ("mg_shim_last_node", "mg_shim_deps"):
        getattr(cdll, name).restype = None
    cdll.mg_shim_last_node.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
    cdll.mg_shim_deps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    cdll.mg_shim_capturing_into.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return cdll


def _logged(lib):
    out = (ctypes.c_ulonglong * 128)()
    count = lib.mg_shim_logged(out)
    return [(out[2 * i], out[2 * i + 1]) for i in range(count)]


def test_kernel_passes_the_predicate_through(host_loop):
    flags = torch.tensor([True, False, False, True, False])
    trips = torch.zeros(3, dtype=torch.int32)
    calls = [(11, 0, 1), (11, 1, 1), (12, 3, 2), (12, 4, 2)]
    start = len(_logged(host_loop))
    for handle, at, slot in calls:
        err = host_loop.mg_while_set(handle, flags[at:].data_ptr(),
                                     trips[slot:].data_ptr(), None)
        assert err == 0
    assert _logged(host_loop)[start:] == [(11, 1), (11, 0), (12, 1), (12, 0)]
    assert trips.tolist() == [0, 1, 1]


def test_host_half_adds_a_while_node_and_captures_its_body(host_loop):
    stream = host_loop.mg_shim_stream(1, 2)
    body_stream = host_loop.mg_shim_stream(0, 0)
    before = (ctypes.c_void_p * 2)()
    host_loop.mg_shim_deps(stream, before)
    handle = ctypes.c_ulonglong(0)
    assert host_loop.mg_while_handle(stream, ctypes.byref(handle)) == 0
    body = ctypes.c_void_p(0)
    assert host_loop.mg_while_begin(stream, handle.value, body_stream,
                                    ctypes.byref(body)) == 0
    node = (ctypes.c_long * 7)()
    host_loop.mg_shim_last_node(stream, before, 2, node)
    # a conditional WHILE node of the handle, one body, after the two
    # nodes the stream depended on, and the stream now after it alone
    assert list(node) == [13, handle.value, 1, 1, 2, 1, 1]
    assert host_loop.mg_shim_capturing_into(body_stream, body) == 1
    assert host_loop.mg_while_end(body_stream) == 0
    assert host_loop.mg_shim_capturing_into(body_stream, body) == 0
    idle = host_loop.mg_shim_stream(0, 0)
    assert host_loop.mg_while_handle(idle, ctypes.byref(handle)) == 906
    assert host_loop.mg_while_begin(idle, 1, body_stream,
                                    ctypes.byref(body)) == 906


# (iv) gsbench through a compiled program

def test_gsbench_replays_one_program_per_key(monkeypatch, capsys):
    fake = StandIn()
    monkeypatch.setattr(graphs, "CAPTURE", fake)
    plain = smoother.fused_rb_sweeps

    def counted(*args, **kwargs):
        cuda.LAUNCHES["smooth"] += 1  # the launch K2 makes on the card
        return plain(*args, **kwargs)

    monkeypatch.setattr(smoother, "fused_rb_sweeps", counted)
    base = ["gsbench", "--n", "32", "--device", "cpu", "--backend", "pallas"]
    lines = []
    for sweeps, reps in ((4, 3), (5, 2)):
        cuda.reset_launches()
        assert t_cli.main(base + ["--sweeps", str(sweeps), "--reps",
                                  str(reps)]) == 0
        # one untimed call (the capture's), then `reps` timed: each call
        # a replay adding `sweeps` launches
        assert cuda.LAUNCHES["smooth"] == sweeps * (reps + 1)
        lines.append(capsys.readouterr().out)
    assert fake.captures == fake.warmups == 2
    for line in lines:
        assert '"compiled": true' in line and '"capture_seconds": ' in line

"""PyTorch port: the weighted-Jacobi and Chebyshev smoothers
(`ops/padded.py`) and the cycle's routing of them (`mg/cycle.py`), against
the JAX package on the CPU in float64.

- `weighted_jacobi`, `gershgorin_bound` and `chebyshev_smooth` on a CN
  level (from_v in the port, stored bands in the JAX package), a Poisson
  five-band level and a Galerkin nine-band level: atol 1e-12
  (tests/test_golden.py's bound for f64 ops);
- one `mg_cycle` with each smoother (GS coarse solve, so the coarse solve
  iterates the smoother too): atol 1e-12;
- an FMG run of the model with each smoother: uT within 1e-12;
- the block forms of both smoothers (parallel/blocks.py) on a one-rank
  2-D partition of each level kind: the whole-level op to the bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.mg.cycle as j_cycle
import hpcclassmultigridproject_tpu.ops.padded as j_ops
from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.core.problem import rotating_velocity
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.models.poisson import (
    poisson_level as j_poisson_level,
)
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import interop
from hpcclassmultigridproject_tpu_torch.mg import cycle as t_cycle
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.ops import padded as t_ops

_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")
_FIELDS = ("aa", "bb", "cc", "dd", "ne", "nw", "se", "sw", "diag")
N = 32
SMOOTHERS = ["jacobi", "chebyshev"]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port_level(jl, banded: bool):
    d = {k: getattr(jl, k) for k in _STATIC}
    if banded:
        d.update({k: None if getattr(jl, k) is None
                  else np.asarray(getattr(jl, k)) for k in _FIELDS})
    else:
        d.update(v1=np.asarray(jl.v1), v2=np.asarray(jl.v2), a_inv=None)
    return interop.level_from_numpy(d, device="cpu")


@functools.cache
def _levels(kind):
    """(JAX level, port level) at n=N in float64."""
    if kind == "cn":
        v1, v2 = rotating_velocity(N, dtype=jnp.float64)
        jl = j_build(v1, v2, 0.1 / N, -4e-4, 2, dtype=jnp.float64)[0]
        return jl, _port_level(jl, banded=False)
    if kind == "poisson":
        jl = j_poisson_level(N, 1.0 / N, jnp.float64)
    else:
        v1, v2 = rotating_velocity(2 * N, dtype=jnp.float64)
        jl = j_build(v1, v2, (0.5 / N) / 10, -4e-4, 2, dtype=jnp.float64,
                     coarse_operator="galerkin", restriction="full")[1]
    return jl, _port_level(jl, banded=True)


def _fields(shape, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = np.zeros(shape)
        x[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        out.append(x)
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-12)


OPS = {
    "jacobi": (lambda l, u, r: j_ops.weighted_jacobi(l, u, r),
               lambda l, u, r: t_ops.weighted_jacobi(l, u, r)),
    "jacobi_omega": (lambda l, u, r: j_ops.weighted_jacobi(l, u, r, 0.8),
                     lambda l, u, r: t_ops.weighted_jacobi(l, u, r, 0.8)),
    "chebyshev": (lambda l, u, r: j_ops.chebyshev_smooth(l, u, r),
                  lambda l, u, r: t_ops.chebyshev_smooth(l, u, r)),
    "chebyshev_deg5": (
        lambda l, u, r: j_ops.chebyshev_smooth(l, u, r, 5, 0.1, 1.2),
        lambda l, u, r: t_ops.chebyshev_smooth(l, u, r, 5, 0.1, 1.2)),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("kind", ["cn", "poisson", "galerkin"])
def test_smoother_matches_jax(kind, op):
    jl, tl = _levels(kind)
    u, rhs = _fields(jl.padded, jl.n, 5)
    jfn, tfn = OPS[op]
    want = jfn(jl, jnp.asarray(u), jnp.asarray(rhs))
    got = tfn(tl, torch.from_numpy(u), torch.from_numpy(rhs))
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["cn", "poisson", "galerkin"])
def test_gershgorin_bound_matches_jax(kind):
    jl, tl = _levels(kind)
    want = float(j_ops.gershgorin_bound(jl))
    got = float(t_ops.gershgorin_bound(tl))
    assert got == pytest.approx(want, rel=0, abs=1e-12)


def _configs(smoother, **kw):
    kw = dict(dtype=jnp.float64, smoother=smoother, num_levels=3,
              coarse_mode="gs", **kw)
    jcfg = JSolver(backend="jnp", **kw)
    tcfg = SolverConfig(**dict(kw, dtype=torch.float64))
    return jcfg, tcfg


def _hierarchies():
    v1, v2 = rotating_velocity(N, dtype=jnp.float64)
    jl = j_build(v1, v2, 0.1 / N, -4e-4, 3, dtype=jnp.float64)
    return jl, tuple(_port_level(l, banded=False) for l in jl)


@pytest.mark.parametrize("shape", [1, 2])
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_mg_cycle_matches_jax(smoother, shape):
    jcfg, tcfg = _configs(smoother, cycle_shape=shape)
    jl, tl = _hierarchies()
    u, rhs = _fields(jl[0].padded, N, 9)
    ju, jr = j_cycle.mg_cycle(jl, jnp.asarray(u), jnp.asarray(rhs), jcfg,
                              want_final_residual=True)
    tu, tr = t_cycle.mg_cycle(tl, torch.from_numpy(u), torch.from_numpy(rhs),
                              tcfg, want_final_residual=True)
    _close(tu.numpy(), ju)
    _close(tr.numpy(), jr)


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_fmg_run_matches_jax(smoother):
    """The model's FMG stepper (the coarsest solve by the smoother too)."""
    kw = dict(smoother=smoother, cycle_mode="fmg", num_cycles=1,
              num_levels=3, coarse_mode="gs")
    jm = JModel(JProblem(n=N, num_steps=3),
                JSolver(dtype=jnp.float64, backend="jnp", **kw))
    tm = AdvectionDiffusion(ProblemConfig(n=N, num_steps=3),
                            SolverConfig(dtype=torch.float64, **kw),
                            device="cpu")
    juT, jst = jm.run(warn=False)
    tuT, tst = tm.run(warn=False)
    _close(tuT.numpy(), juT)
    np.testing.assert_array_equal(tst["cycles"].numpy(),
                                  np.asarray(jst["cycles"]))


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_coarse_solve_gs_iterates_the_smoother(smoother):
    """The coarsest GS solve takes the configured smoother, as the JAX
    package's does."""
    jcfg, tcfg = _configs(smoother)
    jl, tl = _hierarchies()
    u, rhs = _fields(jl[-1].padded, jl[-1].n, 4)
    want = j_cycle.coarse_solve_gs(jl[-1], jnp.asarray(u), jnp.asarray(rhs),
                                   jcfg, j_cycle._get_smoother(jcfg))
    got = t_cycle.coarse_solve_gs(tl[-1], torch.from_numpy(u),
                                  torch.from_numpy(rhs), tcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dec", [False, True])
def test_smooth_block_of_another_smoother(dec):
    """A non-rbgs block from zero with the residual: niter plain sweeps and
    the residual, its even rows under `residual_rows_decimated`."""
    _, tcfg = _configs("jacobi")
    _, tl = _hierarchies()
    _, rhs = (torch.from_numpy(x) for x in _fields(tl[0].padded, N, 2))
    u, r = t_cycle._smooth_block(tcfg, tl[0], None, rhs, True,
                                 zero_init=True, residual_rows_decimated=dec)
    want = torch.zeros_like(rhs)
    for _ in range(tcfg.niter):
        want = t_ops.weighted_jacobi(tl[0], want, rhs)
    res = t_ops.residual(tl[0], want, rhs)
    assert torch.equal(u, want)
    assert torch.equal(r, res[::2] if dec else res)


@pytest.mark.parametrize("kind", ["cn", "poisson", "galerkin"])
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_block_smoother_on_one_rank_equals_the_whole(smoother, kind):
    """The block forms of the smoothers (parallel/blocks.py), which run
    them over partitioned levels, on a one-rank 2-D "partition" holding
    the whole level: every halo line zero (no neighbour), the window past
    the array filled as outside the interior, the Gershgorin bound a max
    over the one rank; equal to the whole-level op to the bit.  The
    spawned runs over 4 ranks are in tests/test_torch_parallel.py."""
    from hpcclassmultigridproject_tpu_torch.parallel import (
        GridBlocks,
        Mesh,
        blocks,
    )

    _, tl = _levels(kind)
    u, rhs = (torch.from_numpy(x) for x in _fields(tl.padded, tl.n, 5))
    part = GridBlocks(Mesh(1), *tl.padded, *tl.padded)
    if smoother == "jacobi":
        got = blocks.weighted_jacobi(tl, u, rhs, 0.8, part)
        want = t_ops.weighted_jacobi(tl, u, rhs, 0.8)
    else:
        got = blocks.chebyshev_smooth(tl, u, rhs, 3, 1.0 / 30.0, 1.1, part)
        want = t_ops.chebyshev_smooth(tl, u, rhs)
        assert torch.equal(blocks.gershgorin_bound(tl, part),
                           t_ops.gershgorin_bound(tl))
    assert torch.equal(got, want)

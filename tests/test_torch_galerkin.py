"""PyTorch port: Galerkin R·A·P coarse levels (sparse/galerkin.py) against
the JAX package (CPU).

The extracted nine bands and varying diagonal of every coarse level, the
dense interior matrix and the coarsest inverse match the JAX build: f64 at
atol 1e-13, f32 within 4 ulp of each band's max-abs.  The bands reproduce
R·A·P exactly for the port's own transfers.  The Galerkin delta run at
n=64 matches the JAX run within the bounds of tests/test_torch_delta.py
(f64 1e-12, f32 1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.core.problem import rotating_velocity
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.sparse.galerkin import (
    dense_interior_matrix_9pt as j_dense_9pt,
)
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import (
    interior_mask,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import build_hierarchy
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.ops import padded as tops
from hpcclassmultigridproject_tpu_torch.sparse.galerkin import (
    attach_dense_inverse,
    dense_interior_matrix_9pt,
    galerkin_coarse_level,
)

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_BANDS = ("aa", "bb", "cc", "dd", "ne", "nw", "se", "sw", "diag")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _hierarchies(n, jdtype, restriction, num_levels=3):
    v1, v2 = rotating_velocity(n, dtype=jdtype)
    kw = dict(coarse_mode="dense", coarse_operator="galerkin",
              restriction=restriction)
    jl = j_build(v1, v2, 0.1 / n, -4e-4, num_levels, dtype=jdtype, **kw)
    tl = build_hierarchy(np.asarray(v1), np.asarray(v2), 0.1 / n, -4e-4,
                         num_levels, dtype=_DTYPES[jdtype], device="cpu", **kw)
    return jl, tl


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("restriction", ["inject", "full"])
@pytest.mark.parametrize("n", [32, 64])
def test_extracted_bands_match_jax(n, restriction, jdtype):
    """Level 1 from the fine level's stored bands, level 2 from level 1's
    nine-band operator; the coarsest carries the dense inverse."""
    jl, tl = _hierarchies(n, jdtype, restriction)
    assert [l.form for l in tl] == ["from_v", "nine", "nine"]
    for a, b in zip(jl[1:], tl[1:]):
        assert b.v1 is None and b.padded == a.padded
        assert (b.n, b.h, b.diag_a) == (a.n, a.h, a.diag_a)
        for k in _BANDS:
            want = np.asarray(getattr(a, k))
            got = getattr(b, k)
            assert got.dtype == _DTYPES[jdtype], k
            atol = (1e-13 if jdtype == jnp.float64
                    else 4 * float(np.spacing(np.abs(want).max())))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                       err_msg=k)
    # the varying diagonal is 1 outside the open interior
    diag = tl[1].diag.numpy()
    outside = ~interior_mask(tl[1].n, tl[1].padded, device="cpu").numpy()
    assert (diag[outside] == 1).all()
    want = np.asarray(jl[-1].a_inv)
    atol = 1e-12 if jdtype == jnp.float64 else 4 * float(
        np.spacing(np.abs(want).max()))
    np.testing.assert_allclose(tl[-1].a_inv.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [32, 64])
def test_dense_interior_matrix_9pt_matches_jax(n):
    jl, tl = _hierarchies(n, jnp.float64, "full", num_levels=2)
    np.testing.assert_allclose(dense_interior_matrix_9pt(tl[1]),
                               j_dense_9pt(jl[1]), rtol=0, atol=1e-13)
    inv = attach_dense_inverse(tl[1]).a_inv.numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(j_dense_9pt(jl[1])),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("restriction", ["inject", "full"])
def test_rap_extraction_is_exact_for_the_port_transfers(restriction):
    """apply_A with the extracted bands == R(A(P(x))) through the port's
    own restriction, stencil and prolongation, on the coarse interior."""
    n = 32
    rng = np.random.default_rng(11)
    v = rng.standard_normal((2, n + 1, n + 1))
    fine = build_hierarchy(v[0], v[1], 0.1 / n, -4e-4, 1,
                           dtype=torch.float64, device="cpu")[0]
    coarse = galerkin_coarse_level(fine, restriction)
    nc, shape_c = n // 2, padded_shape(n // 2)
    mask = interior_mask(nc, shape_c, dtype=torch.float64, device="cpu")
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal(shape_c)) * mask
        y = tops.apply_A(fine, tops.prolong_bilinear(x, fine.padded))
        want = (tops.restrict_inject(y, shape_c) if restriction == "inject"
                else tops.restrict_full_weighting(y, shape_c, nc))
        torch.testing.assert_close(tops.apply_A(coarse, x) * mask,
                                   want * mask, rtol=0, atol=1e-13)


def _models(jdtype, n=64, steps=5, **kw):
    kw = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
              delta_form=True, num_levels=3, certify_every=2,
              coarse_operator="galerkin", **kw)
    jm = JModel(JProblem(n=n, num_steps=steps),
                JSolver(dtype=jdtype, refine_dtype=jnp.float64, **kw))
    tm = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=steps),
        SolverConfig(dtype=_DTYPES[jdtype], refine_dtype=torch.float64, **kw),
        device="cpu")
    return jm, tm


@pytest.mark.parametrize("jdtype,atol", [(jnp.float64, 1e-12),
                                         (jnp.float32, 1e-8)],
                         ids=["f64", "f32"])
def test_galerkin_delta_run_matches_jax(jdtype, atol):
    jm, tm = _models(jdtype)
    assert [l.form for l in tm.levels] == ["from_v", "nine", "nine"]
    juT, jst = jm.run(warn=False)
    tuT, tst = tm.run(warn=False)
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=atol)
    assert (tst["rel_residual"].numpy() <= 1e-6).all()
    assert float(tst["final_rel_residual_hi"]) <= 1e-6
    np.testing.assert_array_equal(tst["certified"].numpy(),
                                  np.asarray(jst["certified"]))


def test_galerkin_levels_never_enter_the_tower(monkeypatch):
    """A Galerkin hierarchy in f32 with injection and a dense coarse solve
    passes every config gate of the tower; its nine-band levels must keep
    it on the per-level cycle."""
    from hpcclassmultigridproject_tpu_torch.mg import cycle

    def refuse(*args, **kwargs):
        raise AssertionError("tower_vcycle entered")

    monkeypatch.setattr(cycle, "tower_vcycle", refuse)
    _, tm = _models(jnp.float32, steps=2)
    _, stats = tm.run(warn=False)
    assert (stats["rel_residual"].numpy() <= 1e-6).all()

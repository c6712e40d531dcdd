"""PyTorch port: P's plain versions against the JAX probe's own Pallas
kernels, run on the CPU in Pallas interpret mode.

The kernels of scripts/mosaic_probe_tpu.py are closures inside its
`main()`, so their six bodies are restated here with the script's line
numbers, and each goes through a pallas_call built as `run_probe` builds it
(:39-46: every operand and the output whole in VMEM, no
`input_output_aliases`), with `interpret=True`.  The checks are the
script's own: equality for the index maps, atol 1e-6 for the products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hpcclassmultigridproject_tpu_torch.ops.cuda import probe

R, C = probe.R, probe.C


def k_stride(x_ref, o_ref):  # :58-59
    o_ref[:] = x_ref[:][::2, :]


def k_dot(x_ref, d_ref, o_ref):  # :70-72
    o_ref[:] = jnp.dot(x_ref[:], d_ref[:],
                       preferred_element_type=jnp.float32)


def k_interleave(x_ref, o_ref):  # :81-84
    a = x_ref[:]
    b = a + 1.0
    o_ref[:] = jnp.stack([a, b], axis=1).reshape(2 * R, C)


def k_flatten(x_ref, o_ref):  # :94-95
    o_ref[:] = x_ref[:].reshape(R * C, 1)


def k_dot_rows(d_ref, x_ref, o_ref):  # :108-110
    o_ref[:] = jnp.dot(d_ref[:], x_ref[:],
                       preferred_element_type=jnp.float32)


def k_prolong_rows(p_ref, x_ref, o_ref):  # :127-129
    o_ref[:] = jnp.dot(p_ref[:], x_ref[:],
                       preferred_element_type=jnp.float32)


# probe name -> (the script's kernel, its output shape)
KERNELS = {
    "stride2_rows": (k_stride, (R // 2, C)),
    "dot_decimate": (k_dot, (R, C // 2)),
    "interleave_rows": (k_interleave, (2 * R, C)),
    "flatten": (k_flatten, (R * C, 1)),
    "dot_decimate_rows": (k_dot_rows, (R // 2, C)),
    "dot_prolong_rows": (k_prolong_rows, (2 * R, C)),
}


def _run_probe(kernel, out_shape, *args):
    """scripts/mosaic_probe_tpu.py::run_probe (:39-46), interpreted."""
    f = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(*args))


def test_the_restated_kernels_are_the_probe_set():
    assert list(KERNELS) == list(probe.probes())


@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_probe_matches_the_pallas_kernel(name):
    ops = probe.probe_operands()
    kernel, out_shape = KERNELS[name]
    _, plain, names, _, exact = probe.probes()[name]
    want = _run_probe(kernel, out_shape,
                      *(jnp.asarray(ops[k]) for k in names))
    got = plain(*(torch.from_numpy(ops[k]) for k in names)).numpy()
    assert want.dtype == got.dtype == np.float32
    assert got.shape == want.shape == out_shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

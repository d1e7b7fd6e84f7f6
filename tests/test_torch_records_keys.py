"""The port's GEMM key helpers (``core/records.workload_key`` and
``parse_workload_key``), the ``backend_from_spec`` export of
``core/cost`` and the untiled GEMM oracle (``kernels/ref.py``), against
the JAX package's.

The keys are held string for string under the same backend name, and
the parse as the key's inverse over dims, types and backends (a
hypothesis property); the oracle on the CPU within f32 rtol 1e-6 on
positive operands (no cancellation, so the tolerance is relative to
every element), and within one bf16 rounding step in bf16."""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import records as ref_records  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.core.config_space import GemmConfigSpace  # noqa: E402
from repro_torch.core.cost import base  # noqa: E402
from repro_torch.core.records import (parse_workload_key, parse_workload_key_generic,  # noqa: E402
                                      workload_key, workload_key_for)
from repro_torch.kernels import ref  # noqa: E402

F32_RTOL = 1e-6
_DIMS = st.integers(min_value=1, max_value=1 << 20)
_DTYPES = st.sampled_from(["bfloat16", "float32", "float16"])
_BACKENDS = st.sampled_from(["analytical_h100", "hopper_timed", "analytical_tpu_v5e",
                             "hopper_timed?digest=ab12", "table"])


@pytest.mark.parametrize("dims,dtype,backend", [
    ((4096, 4096, 11008), "bfloat16", "hopper_timed"),
    ((8, 4096, 4096), "bfloat16", "analytical_h100"),
    ((1024, 1024, 1024), "float32", "analytical_tpu_v5e"),
    ((1, 7, 3), "float16", "table"),
])
def test_workload_key_is_the_references_spelling(dims, dtype, backend):
    got = workload_key(*dims, dtype=dtype, backend=backend)
    assert got == ref_records.workload_key(*dims, dtype=dtype, backend=backend)
    assert got == workload_key_for("gemm", dims, dtype, backend)
    assert core.workload_key is workload_key and core.parse_workload_key is parse_workload_key


def test_workload_key_defaults_to_the_h100_models_namespace():
    """The port carries no TPU constants: its default backend is the H100
    analytical model's name, where the reference's is the TPU's."""
    assert workload_key(64, 64, 64) == "gemm/m64k64n64/bfloat16/" + cost.AnalyticalHopperCost.name
    assert ref_records.workload_key(64, 64, 64).endswith("/analytical_tpu_v5e")


@settings(deadline=None, suppress_health_check=[HealthCheck.too_slow], max_examples=60)
@given(m=_DIMS, k=_DIMS, n=_DIMS, dtype=_DTYPES, backend=_BACKENDS)
def test_parse_workload_key_inverts_it_and_refuses_other_ops(m, k, n, dtype, backend):
    key = workload_key(m, k, n, dtype, backend)
    assert parse_workload_key(key) == (m, k, n, dtype, backend)
    assert parse_workload_key(key) == ref_records.parse_workload_key(key)
    assert parse_workload_key_generic(key) == ("gemm", (m, k, n), dtype, backend)
    flash = workload_key_for("flash", (m, k, n), dtype, backend)
    assert parse_workload_key(flash) is None
    assert ref_records.parse_workload_key(flash) is None


def test_backend_from_spec_is_exported_from_cost():
    """``core.cost`` re-exports ``backend_from_spec``, as the reference's
    does, and it rebuilds a backend from its worker recipe."""
    assert cost.backend_from_spec is base.backend_from_spec
    assert "backend_from_spec" in cost.__all__
    space = GemmConfigSpace(256, 256, 256)
    model = cost.AnalyticalHopperCost(space, dtype="float32")
    again = cost.backend_from_spec(model.worker_spec())
    st0 = space.initial_state()
    assert type(again) is type(model) and again.cost(st0) == model.cost(st0)


def _operands(m, k, n, seed):
    """Operands in [0, 1): every product term is positive, so no sum
    cancels and f32's rtol holds element by element."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(m, k)).astype(np.float32),
            rng.uniform(size=(k, n)).astype(np.float32))


def _one_rounding_step(got: torch.Tensor, want) -> None:
    """bf16 ``got`` and ``want`` differ by at most one bf16 step (2^-7 of
    the binade of ``want``) element by element."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step)


@pytest.mark.parametrize("m,k,n", [(64, 64, 32), (128, 512, 96), (5, 7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_gemm_matches_the_references(m, k, n, dtype):
    a, b = _operands(m, k, n, seed=m + k + n)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    got, want = ref.ref_gemm(ta, tb), ref_ref.ref_gemm(ja, jb)
    assert got.dtype == ta.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL)
    else:
        _one_rounding_step(got, want)
    wide = ref.ref_gemm(ta, tb, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    np.testing.assert_allclose(wide.numpy(), np.asarray(ref_ref.ref_gemm(ja, jb, jnp.float32)),
                               rtol=F32_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_gemm_vjp_matches_the_references(dtype):
    m, k, n = 96, 128, 64
    a, b = _operands(m, k, n, seed=3)
    g = _operands(m, n, 1, seed=4)[0]
    ja, jb, jg = (jnp.asarray(x, dtype) for x in (a, b, g))
    ta, tb, tg = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b, g))
    for got, want, like in zip(ref.ref_gemm_vjp(ta, tb, tg), ref_ref.ref_gemm_vjp(ja, jb, jg),
                               (ta, tb)):
        assert got.dtype == like.dtype and got.shape == like.shape
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL)
        else:
            _one_rounding_step(got, want)


def test_ref_imports_no_kernel():
    """The oracle stands apart from what it checks: its module imports
    neither kernel wrapper nor the build."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ref))
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "typing", "torch"}

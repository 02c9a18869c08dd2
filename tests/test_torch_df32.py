"""chomp_tpu_torch kernel C's plain version (two-float compensated
contraction) against the JAX package and against float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chomp_tpu.ops import df32 as jdf32
from chomp_tpu_torch.ops import df32
from torch_threads import capped_threads  # noqa: F401 (autouse)


def _hostile():
    """tests/test_df32.py's hostile-cancellation case (n=1024, m=8,
    seed 1): >1e3x cancellation in every row."""
    rng = np.random.default_rng(1)
    n, m = 1024, 8
    c64 = rng.lognormal(0.0, 2.0, n)
    a64 = rng.normal(0.0, 1.0, (m, n))
    w_true = a64 @ c64
    a64 -= np.outer(w_true / (c64 @ c64) * 0.9999, c64)
    amp = np.abs(a64 * c64).sum(1) / np.abs(a64 @ c64)
    assert np.min(amp) > 1e3
    return c64.astype(np.float32), a64


def test_df_contract_f64_matches_jax_passthrough():
    """float64: the JAX passthrough (a HIGHEST matmul) to 1e-12."""
    rng = np.random.default_rng(2)
    c = rng.uniform(0.1, 1.0, (3, 64))
    a = rng.normal(size=(4, 64))
    ref = np.asarray(jdf32.df_contract(jnp.asarray(c), a))
    got = df32.df_contract_ref(torch.tensor(c), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_df_contract_hostile_f32_in_process():
    """float32 in-process on the CPU: the eager error-free transforms stay
    exact, so the two-float sum tracks float64 to < 5e-6 where a plain
    float32 matmul loses > 1e-2."""
    c32, a64 = _hostile()
    ref = a64 @ c32.astype(np.float64)
    hi, lo = df32.split_operator(a64)
    got = df32.df_contract_ref(torch.tensor(c32[None]), torch.tensor(hi),
                               torch.tensor(lo))[0].double().numpy()
    plain = (torch.tensor(c32) @ torch.tensor(a64.astype(np.float32)).T
             ).double().numpy()
    assert np.max(np.abs(got / ref - 1.0)) < 5e-6
    assert np.max(np.abs(plain / ref - 1.0)) > 1e-2


def test_df_contract_f32_matches_jax_on_tpu_semantics():
    """The port's float32 result equals float64 of the split operator to
    ~2^-48 per product, so on benign input it matches the JAX float64
    answer to float32 output rounding."""
    rng = np.random.default_rng(4)
    c = rng.uniform(0.1, 1.0, (5, 300)).astype(np.float32)
    a = rng.normal(size=(6, 300))
    hi, lo = df32.split_operator(a)
    got = df32.df_contract_ref(torch.tensor(c), torch.tensor(hi),
                               torch.tensor(lo)).double().numpy()
    ref = np.asarray(jdf32.df_contract(jnp.asarray(c.astype(np.float64)), a))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_two_sum_exact():
    s, e = df32.two_sum(torch.tensor(1.0, dtype=torch.float32),
                        torch.tensor(1e-8, dtype=torch.float32))
    assert float(s) == 1.0
    np.testing.assert_allclose(float(e), 1e-8, rtol=1e-6)


def test_two_prod_exact():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    b = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    p, e = df32.two_prod(torch.tensor(a), torch.tensor(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert np.array_equal(p.double().numpy() + e.double().numpy(), exact)


def test_split_operator_reconstructs():
    a = np.random.default_rng(5).normal(size=(7, 33))
    hi, lo = df32.split_operator(a)
    assert hi.dtype == lo.dtype == np.float32
    np.testing.assert_allclose(hi.astype(np.float64) + lo, a, rtol=1e-13)


def test_df_contract_cpu_is_plain_version():
    c32, a64 = _hostile()
    hi, lo = (torch.tensor(x) for x in df32.split_operator(a64))
    c = torch.tensor(c32[None])
    assert torch.equal(df32.df_contract(c, hi, lo),
                       df32.df_contract_ref(c, hi, lo))
    c64 = c.double()
    a = torch.tensor(a64)
    assert torch.equal(df32.df_contract(c64, a), df32.df_contract_ref(c64, a))


@pytest.mark.parametrize("bad", ["no_lo", "lo_in_f64", "shape", "dtype",
                                 "device"])
def test_df_contract_rejects_bad_inputs(bad):
    """Malformed inputs raise; so does a device that is neither the CPU
    nor CUDA (no silent plain-version fallback)."""
    c = torch.ones(2, 8)
    hi, lo = torch.ones(3, 8), torch.zeros(3, 8)
    if bad == "no_lo":
        lo = None
    elif bad == "lo_in_f64":
        c, hi = c.double(), hi.double()
    elif bad == "shape":
        hi, lo = torch.ones(3, 9), torch.zeros(3, 9)
    elif bad == "dtype":
        c = c.half()
    else:
        c, hi, lo = (t.to("meta") for t in (c, hi, lo))
    with pytest.raises((ValueError, TypeError)):
        df32.df_contract(c, hi, lo)


def _tensor_core_contract(c, hi, lo):
    """Kernel C's arithmetic on the card: float32 ``c`` times the float64
    operator hi + lo (exact), summed in float64 and rounded once."""
    return (c.double() @ (hi.double() + lo.double()).T).float()


@pytest.mark.parametrize("case", ["cancelling", "hostile", "jax"])
def test_tensor_core_arithmetic_meets_the_gates(case):
    """The redesigned kernel's float64 arithmetic meets chip_smoke.py's
    phase-3 gates: <= 1e-6 of peak against the plain two-float version,
    < 5e-6 worst on the hostile case, rtol 1e-6 against the JAX float64
    answer on the inputs of the JAX-parity test above."""
    if case == "cancelling":
        rng = np.random.default_rng(3)
        c = rng.lognormal(0.0, 1.0, (16, 2220)).astype(np.float32)
        a = rng.normal(size=(64, 2220))
        hi, lo = (torch.tensor(x) for x in df32.split_operator(a))
        got = _tensor_core_contract(torch.tensor(c), hi, lo)
        ref = df32.df_contract_ref(torch.tensor(c), hi, lo)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6
    elif case == "hostile":
        c32, a64 = _hostile()
        hi, lo = (torch.tensor(x) for x in df32.split_operator(a64))
        got = _tensor_core_contract(torch.tensor(c32[None]), hi, lo)
        ref = a64 @ c32.astype(np.float64)
        assert np.max(np.abs(got[0].double().numpy() / ref - 1.0)) < 5e-6
    else:
        rng = np.random.default_rng(4)
        c = rng.uniform(0.1, 1.0, (5, 300)).astype(np.float32)
        a = rng.normal(size=(6, 300))
        hi, lo = (torch.tensor(x) for x in df32.split_operator(a))
        got = _tensor_core_contract(torch.tensor(c), hi, lo).double().numpy()
        ref = np.asarray(jdf32.df_contract(
            jnp.asarray(c.astype(np.float64)), a))
        np.testing.assert_allclose(got, ref, rtol=1e-6)

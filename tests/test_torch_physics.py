"""qfa_tpu_torch.physics.tau against qfa_tpu.physics.tau on the same numpy
inputs. Both compute in float32; pow/exp differ between the two libraries
by a few ulp, so the tolerance is rtol 1e-6 (atol 1e-7 near zero)."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfa_tpu_torch.data.grid import make_grid
from qfa_tpu_torch.physics import lyman

# the packages re-export the function ``tau`` over the module's name
jtau = importlib.import_module("qfa_tpu.physics.tau")
ttau = importlib.import_module("qfa_tpu_torch.physics.tau")

TOL = dict(rtol=1e-6, atol=1e-7)
Z = np.linspace(1.5, 4.5, 97).astype(np.float32)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("which", sorted(jtau.TAU_LAWS))
def test_tau_laws_match_jax(which):
    close(ttau.get_tau_law(which)(torch.from_numpy(Z)),
          jtau.get_tau_law(which)(jnp.asarray(Z)))
    for series in (1, 2, 3):
        close(ttau.tau(torch.from_numpy(Z), which, series),
              jtau.tau(jnp.asarray(Z), which, series))


@pytest.mark.parametrize("which", ["becker", "kamble"])
def test_tau_total_matches_jax(which):
    """Summed Lyman-series optical depth over the blue side of a grid
    reaching below Ly-beta (several lines contribute)."""
    grid = make_grid(930.0, 1300.0, 1e-3)
    zq = np.array([2.1, 2.7, 3.4], np.float32)
    ref = jtau.tau_total(grid.wav, jnp.asarray(zq), which=which)
    out = ttau.tau_total(grid.wav, torch.from_numpy(zq), which=which)
    assert out.shape == (3, grid.nb)
    close(out, ref, rtol=2e-6, atol=1e-7)


def test_omega_func_and_tau_hi_match_jax():
    z = torch.from_numpy(Z)
    for tau0, beta, c0 in [(0.02, 2.0, 0.3), (0.3, 3.5, -1.2)]:
        t = [torch.tensor(v, dtype=torch.float32) for v in (tau0, beta, c0)]
        j = [jnp.asarray(v, jnp.float32) for v in (tau0, beta, c0)]
        close(ttau.tau_hi(z, t[0], t[1]), jtau.tau_hi(jnp.asarray(Z), j[0], j[1]))
        close(ttau.omega_func(z, *t), jtau.omega_func(jnp.asarray(Z), *j))


def test_lyman_table_matches_jax():
    import qfa_tpu.physics.lyman as jly

    np.testing.assert_array_equal(lyman.COEFF, jly.COEFF)
    np.testing.assert_array_equal(lyman.WAVELENGTH, jly.WAVELENGTH)
    assert lyman.LYA_WAVELENGTH == jly.LYA_WAVELENGTH
    assert lyman.line_names() == jly.line_names()


def test_resolve_tau_matches_jax():
    """Names, the dispatcher-partial idiom and the law functions resolve to
    names; other callables (and partials of them) stay callables."""
    user = lambda z: 0.1 * z  # noqa: E731
    cases = [
        ("fg", "fg", "fg"),
        (functools.partial(ttau.tau, which="mock"),
         functools.partial(jtau.tau, which="mock"), "mock"),
        (ttau.tau_kamble, jtau.tau_kamble, "kamble"),
    ]
    for port_spec, jax_spec, name in cases:
        assert ttau.resolve_tau(port_spec) == jtau.resolve_tau(jax_spec) == name
    assert ttau.resolve_tau(user) is user
    partial_user = functools.partial(user)
    assert ttau.resolve_tau(partial_user) is partial_user
    # a series other than Ly-alpha is not the prediction law: kept callable
    beta_series = functools.partial(ttau.tau, which="becker", series=2)
    assert ttau.resolve_tau(beta_series) is beta_series
    with pytest.raises(NotImplementedError):
        ttau.resolve_tau("nope")
    with pytest.raises(TypeError):
        ttau.resolve_tau(3.0)

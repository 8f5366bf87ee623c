"""The port's card calibration against the JAX package: the plain version of
the alu_chain kernel against the kernel inside ``bench.calibrate_vpu``
(captured from its ``pl.pallas_call`` and run in interpret mode) on the same
numpy tile, the fma chain's count of reps against a numpy chain, the op
count of ``calibrate_alu`` against ``bench.py``'s own
constants, and the guards: the calibrations raise on the CPU, and CPU calls
of the wrapper are no launches."""

import ast
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qfa_tpu_torch import calibrate
from qfa_tpu_torch.ops import alu_chain as ac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small tile: the chains are elementwise, so its size changes nothing
SHAPE = (8, 128)
#: against the JAX kernel. fma: a fused and a separate multiply and add
#: drift apart by ~6e-8 of the value per rep (5.6e-6 after 96 reps, JAX
#: interpret mode against a numpy chain); exp, log and div contract to
#: their fixed points, so these check the op, not the count
RTOL = {"fma": 1e-5, "exp": 1e-6, "log": 1e-6, "div": 1e-6}
#: the plain fma chain against a numpy chain that rounds each rep once:
#: one rep moves the output by 2.2e-7 to 3.2e-7 of itself (1.19e-7 for the
#: factor, 1e-7 / x for the offset), so this limit checks the count of
#: iterations and of reps in each
FMA_COUNT_RTOL = 1e-7


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench"] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop("bench", None)
    return mod


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_alu_kernel():
    """``bench.calibrate_vpu``'s kernel, taken from its first trace (before
    any timing), as a function ``(n_iters, op_id, x) -> out`` in interpret
    mode at SHAPE."""
    bench = _load_bench()
    real = pl.pallas_call
    got = {}

    def capture(kernel, **kw):
        got.update(kernel=kernel, kw=kw)
        raise _Captured

    pl.pallas_call = capture
    try:
        with pytest.raises(_Captured):
            bench.calibrate_vpu()
    finally:
        pl.pallas_call = real
    kw = {k: v for k, v in got["kw"].items() if k != "compiler_params"}
    kw["out_shape"] = jax.ShapeDtypeStruct(SHAPE, jnp.float32)
    call = real(got["kernel"], interpret=True, **kw)
    return lambda n, op_id, x: np.asarray(
        call(jnp.asarray([n, op_id], jnp.int32), jnp.asarray(x)))


def _tile(seed):
    return np.random.default_rng(seed).uniform(0.5, 1.0, SHAPE) \
        .astype(np.float32)


@pytest.mark.parametrize("n_iters", [0, 1, 3])
@pytest.mark.parametrize("op", ac.OPS)
def test_alu_chain_plain_matches_jax_kernel(jax_alu_kernel, op, n_iters):
    x = _tile(100 + n_iters)
    want = jax_alu_kernel(n_iters, ac.OPS.index(op), x)
    got = ac.alu_chain(torch.from_numpy(x), n_iters, op).numpy()
    assert got.shape == SHAPE and got.dtype == np.float32
    if n_iters == 0:  # the sum of the scaled starts, exact
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=RTOL[op], atol=0.0)


def _fma_chain(x, reps):
    """The fma chain in numpy, each rep rounded once to float32."""
    a, b = float(np.float32(1.0000001)), float(np.float32(1e-7))
    xs = [x * np.float32(1.0 + 0.01 * k) for k in range(ac.CHAINS)]
    for _ in range(reps):
        xs = [(v.astype(np.float64) * a + b).astype(np.float32) for v in xs]
    return ((xs[0] + xs[1]) + xs[2]) + xs[3]


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_alu_chain_plain_fma_counts_reps(n_iters):
    x = _tile(200 + n_iters)
    got = ac.alu_chain(torch.from_numpy(x), n_iters, "fma").numpy()
    reps = n_iters * ac.BODY_REPS
    np.testing.assert_allclose(got, _fma_chain(x, reps),
                               rtol=FMA_COUNT_RTOL, atol=0.0)
    if reps:  # one rep fewer lies beyond the limit on ~99% of the tile
        short = _fma_chain(x, reps - 1)
        beyond = np.abs(got - short) > FMA_COUNT_RTOL * np.abs(got)
        assert beyond.mean() > 0.9


def _calibrate_vpu_constants():
    """``shape``, ``body_reps``, ``lanes`` and ``ops_per_rep`` as assigned
    in ``bench.calibrate_vpu``'s source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "calibrate_vpu")
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id in ("shape", "body_reps", "lanes",
                                       "ops_per_rep"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


@pytest.mark.parametrize("op", ac.OPS)
def test_alu_op_count_matches_bench(op):
    c = _calibrate_vpu_constants()
    assert calibrate.ALU_SHAPE == c["shape"]
    assert (ac.BODY_REPS, ac.CHAINS) == (c["body_reps"], c["lanes"])
    assert calibrate.OPS_PER_REP == c["ops_per_rep"]
    elems = c["shape"][0] * c["shape"][1]
    i1, i2 = calibrate.ALU_ITERS[op]
    # bench.py:481
    d_ops = (i2 - i1) * c["body_reps"] * c["lanes"] * c["ops_per_rep"][op] \
        * elems
    assert calibrate.alu_op_count(op, i1, i2, elems) == d_ops
    # the median of the per-pair deltas; None where it is not positive
    rates = calibrate.alu_rates({op: [3e-3, 1e-3, 2e-3]}, elems)
    assert rates[op] == pytest.approx(d_ops / 2e-3)
    assert calibrate.alu_rates({op: [-1.0, 0.0, 1.0]}, elems)[op] is None


def test_calibrations_raise_on_the_cpu():
    for fn in (calibrate.calibrate_peaks, calibrate.calibrate_alu):
        with pytest.raises(ValueError, match="no peak of the card"):
            fn(device="cpu")
    assert ac.LAUNCHES == 0


def test_alu_chain_cpu_calls_are_not_launches():
    x = torch.full((4, 32), 0.75)
    for op in ac.OPS:
        out = ac.alu_chain(x, 2, op)
        assert out.shape == x.shape and torch.isfinite(out).all()
    assert ac.LAUNCHES == 0
    with pytest.raises(ValueError, match="op must be"):
        ac.alu_chain(x, 1, "sqrt")
    with pytest.raises(ValueError, match="float32"):
        ac.alu_chain(x.double(), 1, "fma")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ac.alu_chain(torch.empty((4, 32), device="meta"), 1, "fma")

"""The port's contraction-depth probe against the JAX package: the plain
version of the kdepth kernel against ``tools/mxu_kdepth.make_fn`` in
interpret mode for every variant at the probe's real shapes, the probe
record against the JAX record's keys and verdict, and the guards."""

import importlib.util
import os
import sys
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qfa_tpu_torch import calibrate
from qfa_tpu_torch.ops import kdepth as kd
from qfa_tpu_torch.tools import mxu_kdepth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: of max|out|: at grid 3 the float32 result lies within 5e-7 of a float64
#: reference (JAX interpret mode and the plain version alike)
REL = 1e-5


@pytest.fixture(scope="module")
def jax_probe():
    """``tools/mxu_kdepth.py``, loaded by path (sys.path restored)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_mxu_kdepth", os.path.join(ROOT, "tools", "mxu_kdepth.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def operands():
    """numpy operands at the probe's shapes, as its pool makes them."""
    rng = np.random.default_rng(11)
    l_np = rng.standard_normal((kd.KMAX, kd.TB)).astype(np.float32) * 1e-3
    r_np = rng.standard_normal((kd.KMAX, kd.P)).astype(np.float32) * 1e-3
    r2_np = np.zeros((kd.KMAX, 2 * kd.P), np.float32)
    r2_np[0:36, :kd.P] = r_np[0:36]
    r2_np[36:44, kd.P:] = r_np[36:44]
    return l_np, np.ascontiguousarray(l_np.T), r_np, r2_np


@pytest.mark.parametrize("variant", kd.VARIANTS, ids=[v[0] for v in
                                                      kd.VARIANTS])
def test_probe_plain_matches_jax_kernel(jax_probe, operands, monkeypatch,
                                        variant):
    name, k1, k2, vpu_k2 = variant
    assert variant in jax_probe.VARIANTS  # the same variants
    assert (kd.TB, kd.P, kd.KMAX) == (jax_probe.TB, jax_probe.P,
                                      jax_probe.KMAX)
    monkeypatch.setattr(pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    fn = jax_probe.make_fn(k1, k2, 3, vpu_k2)
    want = np.asarray(fn(*(jnp.asarray(a) for a in operands)))
    got = kd.contraction_probe(*(torch.from_numpy(a) for a in operands),
                               k1=k1, k2=k2, vpu_k2=vpu_k2, grid=3).numpy()
    assert got.shape == (kd.TB, kd.P) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= REL * scale, name


def test_step_scale_is_float32_arithmetic():
    for j in (0, 1, 3, 4095):
        want = np.float32(1.0) + np.float32(j) * np.float32(1e-9)
        assert kd.step_scale(j) == float(want)


def _jax_record(times, grid, tflops):
    """tools/mxu_kdepth.py:231-261 on given per-variant times."""
    variants = {}
    for name, k1, k2, vpu_k2 in kd.VARIANTS:
        med = float(np.median(times[name]))
        flops = 2 * kd.TB * kd.P * (k1 + (k2 or 0))
        rec = {"k": ([k1] if k1 else []) + ([k2] if k2 is not None else []),
               "k2_on_vpu": vpu_k2, "us_per_step": round(med * 1e6, 3),
               "ns_per_spectrum_equiv": round(med / kd.TB * 1e9, 2),
               "flops_per_step": flops,
               "samples_us": [round(x * 1e6, 3) for x in sorted(times[name])]}
        if tflops:
            rec["naive_peak_us"] = round(flops / (tflops * 1e12) * 1e6, 3)
        variants[name] = rec
    t8 = variants["single8"]["us_per_step"]
    t128 = variants["single128"]["us_per_step"]
    return {"tb": kd.TB, "p": kd.P, "grid": grid, "variants": variants,
            "mxu_peak_tflops_f32": None if tflops is None
            else round(tflops, 2),
            "k_scaling_128_over_8": round(t128 / t8, 3) if t8 else None,
            "flat_in_k": bool(t8 and t128 / t8 < 2.0)}


@pytest.mark.parametrize("t128_us, tflops", [(4.6, 51.8), (0.4, None)])
def test_make_record_matches_jax_record(t128_us, tflops):
    rng = np.random.default_rng(3)
    times = {name: list(rng.uniform(0.2e-6, 3e-6, 5))
             for name, *_ in kd.VARIANTS}
    times["single8"] = [0.33e-6, 0.34e-6, 0.335e-6]
    times["single128"] = [t128_us * 1e-6] * 3
    info = {"name": "card", "power_limit": "700.00 W"}
    got = mxu_kdepth.make_record(times, 4096, tflops, info)
    want = _jax_record(times, 4096, tflops)
    assert set(got) == set(want) | {"what", "device"}
    assert got["device"] == info
    for key, value in want.items():
        assert got[key] == value, key
    assert got["flat_in_k"] == (t128_us / 0.335 < 2.0)


def test_probe_cpu_calls_are_not_launches_and_bad_calls_raise(operands):
    l, lt, r, r2 = (torch.from_numpy(a) for a in operands)
    out = kd.contraction_probe(l, lt, r, r2, k1=8, k2=None, vpu_k2=False,
                               grid=2)
    assert out.shape == (kd.TB, kd.P) and kd.LAUNCHES == 0
    with pytest.raises(ValueError, match="VARIANTS"):
        kd.contraction_probe(l, lt, r, r2, k1=9, k2=None, vpu_k2=False,
                             grid=1)
    with pytest.raises(ValueError, match="must be"):
        kd.contraction_probe(l, lt[:, :64], r, r2, k1=8, k2=None,
                             vpu_k2=False, grid=1)
    with pytest.raises(TypeError, match="float32"):
        kd.contraction_probe(l, lt, r.double(), r2, k1=8, k2=None,
                             vpu_k2=False, grid=1)
    meta = [torch.empty(t.shape, device="meta") for t in (l, lt, r, r2)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.contraction_probe(*meta, k1=8, k2=None, vpu_k2=False, grid=1)
    assert kd.LAUNCHES == 0


def test_probe_and_calibration_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card guard cannot show")
    for fn in (calibrate.calibrate_peaks, calibrate.calibrate_alu):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mxu_kdepth.main(["--out", str(tmp_path)])
    with pytest.raises(ValueError, match="CUDA card"):
        mxu_kdepth.main(["--out", str(tmp_path), "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []

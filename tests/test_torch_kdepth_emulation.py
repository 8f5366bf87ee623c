"""The contraction-depth probe kernel's own source (``csrc/kdepth.cu``),
compiled for the CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread
per CUDA thread, dynamic shared memory filled with NaN, the warp's m16n8k8
TF32 tensor-core product in the PTX ISA's fragment layout), run through
the CUDA wrapper ``_launch`` on CPU tensors and held against
``contraction_probe_plain``, which tests/test_torch_kdepth.py holds
against the JAX kernel.

* the kernel's tensor-core product (the emulator's stand-in) and TF32
  rounding: one 16 x 8 x 8 fragment product, each lane loading its
  fragments from the ISA's layout table as written out here, against
  numpy on TF32-rounded operands; the rounding to nearest, ties away from
  zero, as cvt.rna.tf32.f32 rounds;
* every variant at grid 3, at TB 128 and P 128 (two output tiles, one
  chunk), to
  ``REL`` of max|out|, the limit of tests/test_torch_kdepth.py and of
  ``chip_smoke.py``'s phase 14 at grid 3;
* for one variant of each mode, a grid split into several chunks (the
  emulated card has 2 resident blocks, so one tile takes 2 chunks; and one
  step per chunk), the partials summed in chunk order: within ``REL``,
  and a repeat call bitwise equal; the library's chunk count, the fewest
  chunks that fill whole waves of resident blocks.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from qfa_tpu_torch.ops import _build
from qfa_tpu_torch.ops import kdepth as kd
from qfa_tpu_torch.tools import emulate

#: of max|out|, as tests/test_torch_kdepth.py: the 3xTF32 products keep
#: close to f32 accuracy (the kernel read 1e-7 to 1.5e-6 here and on an
#: H100)
REL = 1e-5
KMAX, TB, P = kd.KMAX, 128, 128
IDS = [v[0] for v in kd.VARIANTS]
#: one variant of each mode for the chunked sums (each launch with several
#: chunks also runs the summing kernel's 256-thread blocks)
CHUNKED = [v for v in kd.VARIANTS if v[0] in ("pair36+8", "pair36+vpu8",
                                               "wide44")]

#: one warp's m16n8k8 product by the kernel's mma_tf32, every lane loading
#: its fragments as the PTX ISA's table lays them out (g = lane / 4, t =
#: lane % 4), and the kernel's TF32 rounding
FRAGMENT_SRC = r"""
#include "kdepth.cu"
extern "C" unsigned tf32(float x) { return to_tf32(x); }
// d = c + a b: a (16 x 8), b (8 x 8, b[k][n]), c and d (16 x 8), row-major
extern "C" void frag_product(const float* a, const float* b, const float* c,
                             float* d) {
  emu_launch(dim3(1), dim3(32), [&] {
    const unsigned lane = threadIdx.x, g = lane / 4, t = lane % 4;
    const uint32_t fa[4] = {
        __float_as_uint(a[g * 8 + t]),            // a0 (row g, col t)
        __float_as_uint(a[(g + 8) * 8 + t]),      // a1 (row g + 8, col t)
        __float_as_uint(a[g * 8 + t + 4]),        // a2 (row g, col t + 4)
        __float_as_uint(a[(g + 8) * 8 + t + 4])}; // a3 (row g + 8, col t + 4)
    const uint32_t b0 = __float_as_uint(b[t * 8 + g]);        // (k t, n g)
    const uint32_t b1 = __float_as_uint(b[(t + 4) * 8 + g]);  // (k t + 4, n g)
    const int at[4] = {int(g * 8 + 2 * t), int(g * 8 + 2 * t + 1),
                       int((g + 8) * 8 + 2 * t), int((g + 8) * 8 + 2 * t + 1)};
    float acc[4];
    for (int e = 0; e < 4; ++e) acc[e] = c[at[e]];
    mma_tf32(acc, fa, b0, b1);
    for (int e = 0; e < 4; ++e) d[at[e]] = acc[e];
  });
}
"""


def tf32_rna(x):
    """float32 rounded to TF32 (10 fraction bits), to nearest with ties
    away from zero, in numpy."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.fixture(scope="module")
def fragment_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the kernel's source for the CPU"
    out = tmp_path_factory.mktemp("frag")
    (out / "frag.cpp").write_text(FRAGMENT_SRC)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{emulate.HEADERS}",
         f"-I{_build.CSRC}", str(out / "frag.cpp"), "-o",
         str(out / "libfrag.so")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libfrag.so"))
    lib.tf32.argtypes, lib.tf32.restype = [ctypes.c_float], ctypes.c_uint
    lib.frag_product.argtypes = [ctypes.c_void_p] * 4
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"),
                                     source="kdepth.cu"))
    before = kd.LAUNCHES
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors; other
    # files check that CPU calls never count
    kd.LAUNCHES = before


def operands(tb, p, seed):
    """Seeded operands as the probe makes them: l (KMAX, TB) and r (KMAX, P)
    at 1e-3, lt = l^T, r2 the block-diagonal [[r[:36], 0], [0, r[36:44]]]."""
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((KMAX, tb)).astype(np.float32) * 1e-3
    r = rng.standard_normal((KMAX, p)).astype(np.float32) * 1e-3
    r2 = np.zeros((KMAX, 2 * p), np.float32)
    r2[:36, :p] = r[:36]
    r2[36:44, p:] = r[36:44]
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (l, l.T, r, r2)]


def rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_tf32_rounding_is_to_nearest_ties_away(fragment_lib):
    ulp = 2.0 ** -10  # of TF32 at 1
    cases = np.array([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 1.5 * ulp, 3.14159265, -2.7182818e-5, 0.0],
                     np.float32)
    got = np.array([fragment_lib.tf32(float(x)) for x in cases],
                   np.uint32).view(np.float32)
    np.testing.assert_array_equal(got, tf32_rna(cases))
    # the ties go away from zero, and the low 13 bits are cleared
    assert got[0] == np.float32(1.0 + ulp) and got[1] == -got[0]
    assert got[2] == 1.0 and got[3] == np.float32(1.0 + 2 * ulp)
    assert not (got.view(np.uint32) & 0x1FFF).any()


def test_fragment_product_follows_the_ptx_layout(fragment_lib):
    rng = np.random.default_rng(2)
    a = tf32_rna(rng.standard_normal((16, 8)).astype(np.float32))
    b = tf32_rna(rng.standard_normal((8, 8)).astype(np.float32))
    c = rng.standard_normal((16, 8)).astype(np.float32)
    d = np.full((16, 8), np.nan, np.float32)
    fragment_lib.frag_product(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                              d.ctypes.data)
    want = c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-5)
    # the tensor cores read only an operand's TF32 bits
    fragment_lib.frag_product((a + a * 2.0**-14).ctypes.data, b.ctypes.data,
                              c.ctypes.data, d.ctypes.data)
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", kd.VARIANTS, ids=IDS)
def test_kernel_matches_plain(emulated, variant):
    name, k1, k2, vpu_k2 = variant
    ops = operands(TB, P, seed=k1 + 3 * (k2 or 0))
    before = kd.LAUNCHES
    got = kd._launch(*ops, k1, k2, vpu_k2, 3)
    assert kd.LAUNCHES == before + 1
    want = kd.contraction_probe_plain(*ops, k1=k1, k2=k2, vpu_k2=vpu_k2,
                                      grid=3)
    assert got.shape == (TB, P) and bool(torch.isfinite(got).all())
    assert rel_err(got, want) <= REL, name


@pytest.mark.parametrize("variant", CHUNKED, ids=[v[0] for v in CHUNKED])
def test_chunks_sum_in_order_and_repeat_bitwise(emulated, variant):
    name, k1, k2, vpu_k2 = variant
    grid = 4
    ops = operands(64, 128, seed=11)  # one output tile
    n = ctypes.c_int(0)
    assert emulated.qfa_kdepth_chunks(64, 128, k1, k2 or 0,
                                      kd._MODE[vpu_k2], grid, 0,
                                      ctypes.byref(n)) == 0
    assert n.value > 1  # the two resident blocks take a chunk each
    want = kd.contraction_probe_plain(*ops, k1=k1, k2=k2, vpu_k2=vpu_k2,
                                      grid=grid)
    got = kd._launch(*ops, k1, k2, vpu_k2, grid)
    assert rel_err(got, want) <= REL, name
    assert torch.equal(kd._launch(*ops, k1, k2, vpu_k2, grid), got)
    # one step per chunk: four partials summed in chunk order
    each = kd._launch(*ops, k1, k2, vpu_k2, grid, chunks=grid)
    assert rel_err(each, want) <= REL, name
    assert torch.equal(kd._launch(*ops, k1, k2, vpu_k2, grid, chunks=grid),
                       each)


@pytest.mark.parametrize("tb, p, grid, want", [
    (64, 128, 4096, 2),   # one tile on 2 slots: 2 chunks, one wave
    (128, 128, 4096, 1),  # two tiles fill the wave alone
    (64, 384, 4096, 2),   # three tiles: 6 blocks, 3 whole waves
    (64, 128, 1, 1),      # never more chunks than steps
])
def test_chunks_fill_whole_waves(emulated, tb, p, grid, want):
    """The library's chunk count is slots / gcd(tiles, slots), at most the
    grid (the emulated card has 2 resident blocks)."""
    n = ctypes.c_int(0)
    assert emulated.qfa_kdepth_chunks(tb, p, 36, 8, 0, grid, 0,
                                      ctypes.byref(n)) == 0
    assert n.value == want


def test_no_steps_give_zeros_and_bad_splits_raise(emulated):
    ops = operands(64, 128, seed=1)
    assert not kd._launch(*ops, 36, 8, False, 0).any()
    for chunks in (0, 4, 65):  # at least 1, at most the grid and 64
        with pytest.raises(RuntimeError, match="launch failed"):
            kd._launch(*ops, 36, 8, False, 3, chunks=chunks)


def test_kernel_source_has_no_atomics_and_uses_tensor_cores():
    src = (_build.CSRC / "kdepth.cu").read_text()
    assert not re.findall(r"atomic\w*\(", src)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "fmaf(" in src
    assert "<<<" not in src  # launched through cudaLaunchKernelEx

"""The port's C++ npz reader (``qfa_tpu_torch.native``) against the port's
Python reader and the JAX package's ``read_spectra(engine="python")``.

Tolerance: none. Both readers cast ``<f8`` payloads to float32 by
round-to-nearest (C++'s ``(float)double``, numpy's ``astype``) and apply
the same sentinel rule, so every array is bitwise equal, dtypes included.

These tests never skip: a reader that does not build fails them with the
compiler's message. The library is built into the package's git-ignored
``_build/`` (or a test's own directory), never into ``qfa_tpu/native/``.
"""

import os
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest

from qfa_tpu.data.loader import read_spectra as jax_read_spectra
from qfa_tpu_torch import native
from qfa_tpu_torch.data import loader
from qfa_tpu_torch.data.loader import SpectraDataset, read_spectra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPIX = 97


def write_survey(root, n=24, seed=0):
    """n npz files: -999 in flux and error, error-only and flux-only
    masks; np.savez and np.savez_compressed in turns, <f8 and <f4
    payloads in turns (z too)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        flux = rng.uniform(0.5, 2.0, NPIX)
        err = rng.uniform(0.05, 0.2, NPIX)
        sel = rng.choice(NPIX, 9, replace=False)
        flux[sel[:5]] = -999.0
        err[sel[:5]] = -999.0
        err[sel[5:7]] = -999.0  # error-only masked (flux_ok stays True)
        flux[sel[7:]] = -999.0  # flux-only masked
        z = 2.0 + 0.05 * i + 1e-9 * rng.normal()
        if i % 4 >= 2:
            flux, err, z = (np.float32(x) if np.ndim(x) == 0
                            else x.astype(np.float32) for x in (flux, err, z))
        p = str(root / f"s{i:02d}.npz")
        save = np.savez if i % 2 == 0 else np.savez_compressed
        save(p, flux=flux, error=err, z=z)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return write_survey(tmp_path_factory.mktemp("torch_native_survey"))


def assert_reads_equal(got, want):
    for name, a, b in zip(("flux", "error", "mask", "z", "flux_ok"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_reader_builds_into_the_port_and_loads():
    """The library builds (failing with g++'s message if it does not)
    into the port's build directory, not the JAX package's."""
    if not native.native_available():
        pytest.fail(f"native reader did not build: {native.build_error()}")
    path = native.build_library()
    assert os.path.dirname(os.path.dirname(path)) == str(native.BUILD_ROOT)
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert "qfa_tpu_torch" in path.split(os.sep)


@pytest.mark.parametrize("engine", ["native", "auto"])
def test_native_matches_both_python_readers(survey, engine):
    """The native engine (by name and through auto) equals the port's
    Python pool and JAX's Python engine, bitwise, on every array."""
    before = native.READS
    got = read_spectra(survey, engine=engine)
    assert native.READS == before + 1
    assert_reads_equal(got, read_spectra(survey, engine="python"))
    assert_reads_equal(got, jax_read_spectra(survey, engine="python"))
    assert native.READS == before + 1  # the python engine does not count
    f, e, m, z, ok = got
    assert (~m & ok).any() and (m <= ok).all()  # error-only masks kept
    assert (f[~m] == 0).all() and (e[~m] == 0).all()


def test_compressed_stored_f4_f8_each_alone(survey):
    """Each container and payload kind alone (the four kinds rotate
    every file) reads as the Python pool does."""
    for k in range(4):
        paths = survey[k::4]
        assert_reads_equal(native.read_spectra_native(paths, NPIX, 2),
                           read_spectra(paths, engine="python"))
    with zipfile.ZipFile(survey[0]) as zf:
        assert zf.getinfo("flux.npy").compress_type == zipfile.ZIP_STORED
    with zipfile.ZipFile(survey[1]) as zf:
        assert zf.getinfo("flux.npy").compress_type == zipfile.ZIP_DEFLATED


def test_dataset_from_paths_takes_the_native_reader(survey):
    before = native.READS
    ds = SpectraDataset.from_paths(survey, max_workers=3)
    assert native.READS == before + 1
    f, e, m, z, ok = read_spectra(survey, engine="python")
    for a, b in ((ds.flux, f), (ds.error, e), (ds.mask, m), (ds.zqso, z),
                 (ds.flux_ok, ok)):
        np.testing.assert_array_equal(a, b)


def test_missing_file_and_bad_container_raise(survey, tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        native.read_spectra_native(survey[:2] + [str(tmp_path / "no.npz")],
                                   NPIX)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip archive at all, but long enough to scan")
    with pytest.raises(IOError, match="EOCD"):
        native.read_spectra_native([str(bad)], NPIX)
    short = tmp_path / "short.npz"
    np.savez(short, flux=np.ones(NPIX - 1), error=np.ones(NPIX - 1), z=2.0)
    with pytest.raises(IOError, match="does not match the common grid"):
        read_spectra([survey[0], str(short)], engine="native")
    with pytest.raises(ValueError, match="unknown engine"):
        read_spectra(survey, engine="fast")


def test_auto_falls_back_with_the_compilers_message(survey, monkeypatch,
                                                   caplog):
    """A reader that did not build: ``"native"`` raises with the
    compiler's message, ``"auto"`` reads through the Python pool and logs
    that message once."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++: error: no zlib.h")
    monkeypatch.setattr(loader, "_FALLBACK_LOGGED", False)
    with pytest.raises(RuntimeError, match="no zlib.h"):
        read_spectra(survey, engine="native")
    before = native.READS
    with caplog.at_level("WARNING", logger="qfa_tpu_torch.data.loader"):
        got = read_spectra(survey, engine="auto")
        read_spectra(survey, engine="auto")
    assert native.READS == before
    assert [r.getMessage() for r in caplog.records].count(
        "native npz reader unavailable, reading with the Python pool: "
        "g++: error: no zlib.h") == 1
    assert_reads_equal(got, jax_read_spectra(survey, engine="python"))


def test_declared_zlib_entry_points_read_deflate(survey, tmp_path,
                                                 monkeypatch):
    """The source's own zlib declarations (taken where zlib's headers are
    missing) read DEFLATE entries against the interpreter's libz."""
    path = native.build_library(build_root=tmp_path,
                                defines=("QFA_DECLARE_ZLIB",))
    monkeypatch.setattr(native, "_lib", native._bind(path))
    assert_reads_equal(native.read_spectra_native(survey, NPIX),
                       read_spectra(survey, engine="python"))


def test_concurrent_first_builds_all_load(survey, tmp_path):
    """Six processes that build at once into one fresh directory each get
    a whole library, and it reads."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from qfa_tpu_torch import native
        path = native.build_library(build_root={str(tmp_path)!r})
        native._lib = native._bind(path)
        f = native.read_spectra_native({survey[:4]!r}, {NPIX})[0]
        print(path, float(np.abs(f).sum()))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1  # one library path, one reading
    built = [n for n in os.listdir(os.path.dirname(lines.pop().split()[0]))]
    assert built == [native.LIB_NAME]  # no temporary left behind

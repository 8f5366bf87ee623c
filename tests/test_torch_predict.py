"""The prediction and serving slice as a whole, against qfa_tpu.

* ``infer.predict``: ``predict_dataset_fused`` (the JAX one in Pallas
  interpret mode, with a padded tail chunk) and ``predict_dataset``;
* ``data.loader.read_predict_catalog`` on the same catalog files;
* ``cli.main(["--type", "predict", ...])`` on the same tiny survey on
  disk, comparing every output npz, per file and consolidated;
* ``serve``: a ``POST /predict`` round trip with ``-999`` sentinels and
  ``GET /healthz``, against ``qfa_tpu.serve`` on the XLA engine.

Prediction outputs are compared with the prediction-kernel tolerances of
tests/test_infer_kernel.py (ll rtol 2e-5; hmean rtol 1e-4 atol 1e-6; hcov
rtol 1e-4 atol 1e-7; continuum rtol 1e-4 atol 1e-5; std rtol 1e-3 atol
1e-5): float32 on both sides, sums in different orders.
"""

import json
import os
import threading
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.cli import main as jax_main
from qfa_tpu.data.loader import SpectraDataset as JaxDataset
from qfa_tpu.data.loader import read_predict_catalog as jax_read_catalog
from qfa_tpu.data.synthetic import generate
from qfa_tpu.infer import predict_dataset as jax_predict_dataset
from qfa_tpu.infer import predict_dataset_fused as jax_predict_dataset_fused
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.models import save_npz as jax_save_npz
from qfa_tpu.serve import QFAPredictor as JaxPredictor
from qfa_tpu.serve import make_http_server as jax_http_server
from qfa_tpu_torch import config as tconfig
from qfa_tpu_torch.cli import main as port_main
from qfa_tpu_torch.data.loader import SpectraDataset
from qfa_tpu_torch.data.loader import read_predict_catalog
from qfa_tpu_torch.infer import predict_dataset, predict_dataset_fused
from qfa_tpu_torch.models.params import load_npz
from qfa_tpu_torch.serve import QFAPredictor, make_http_server

TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
}
#: output npz keys -> tolerance
NPZ_TOL = {"ll": TOL["ll"], "hmean": TOL["hmean"], "hcov": TOL["hcov"],
           "cont": TOL["continuum"], "uncertainty": TOL["continuum_std"]}
GRID = dict(lammin=1150.0, lammax=1300.0, loglam_delta=1e-3)
NH = 4
N = 36


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """A JAX-written checkpoint and N spectra drawn from the generative
    model, saved as npz files with -999 sentinels, plus a predict catalog."""
    root = tmp_path_factory.mktemp("torch_survey")
    grid = qfa_tpu.make_grid(*GRID.values())
    params = jax_random_init(jax.random.key(0), grid.npix, grid.nb, NH)
    params = params._replace(
        Psi=jnp.full((grid.npix,), 0.2), omega=jnp.full((grid.nb,), 0.5),
        tau0=jnp.asarray(0.1), c0=jnp.asarray(0.3), beta=jnp.asarray(2.0),
    )
    mu = np.linspace(0.9, 1.3, grid.npix).astype(np.float32)
    ckpt = str(root / "model.npz")
    jax_save_npz(ckpt, params, mu)
    syn = generate(jax.random.key(1), params, jnp.asarray(mu), grid, N,
                   mask_frac=0.15)
    data_dir = root / "spectra"
    data_dir.mkdir()
    mask = np.asarray(syn.mask) > 0
    flux, err, z = (np.asarray(a) for a in (syn.flux, syn.error, syn.zqso))
    names = [f"spec-{i:04d}.npz" for i in range(N)]
    for i, name in enumerate(names):
        np.savez(data_dir / name, flux=np.where(mask[i], flux[i], -999.0),
                 error=np.where(mask[i], err[i], -999.0), z=z[i])
    catalog = root / "predict-catalog.csv"
    catalog.write_text("\n".join(names) + "\n")
    return root, ckpt, str(data_dir), str(catalog), grid, names


def datasets(survey):
    root, ckpt, data_dir, catalog, grid, names = survey
    paths = [os.path.join(data_dir, n) for n in names]
    return JaxDataset.from_paths(paths), SpectraDataset.from_paths(paths)


def assert_results_close(port, ref):
    for name, tol in TOL.items():
        np.testing.assert_allclose(np.asarray(getattr(port, name)),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)


def test_dataset_reader_matches_jax(survey):
    jds, tds = datasets(survey)
    for name in ("flux", "error", "mask", "zqso", "flux_ok"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name),
                                      name)
    assert tds.paths == jds.paths


@pytest.mark.parametrize("sanitized", [True, False])
def test_predict_dataset_fused_matches_jax(survey, sanitized):
    """36 spectra in chunks of 24: the JAX predict_dataset_fused pads its
    tail chunk to the tile; the port's kernel takes the 12-row tail as it
    is. With unsanitized error planes the mask plane ships instead of
    being derived."""
    root, ckpt, data_dir, catalog, grid, names = survey
    jds, tds = datasets(survey)
    if not sanitized:
        err = np.where(jds.mask, jds.error, 0.5).astype(np.float32)
        jds, tds = jds._replace(error=err), tds._replace(error=err)
    jparams, jmu = qfa_tpu.models.load_npz(ckpt)
    ref = jax_predict_dataset_fused(jparams, jmu, jds, grid, chunk=24,
                                    tile_batch=8, interpret=True)
    params, mu = load_npz(ckpt)
    out = predict_dataset_fused(params, mu, tds, grid, chunk=24)
    assert_results_close(out, ref)


def test_predict_dataset_matches_jax(survey):
    root, ckpt, data_dir, catalog, grid, names = survey
    jds, tds = datasets(survey)
    ref = jax_predict_dataset(*qfa_tpu.models.load_npz(ckpt), jds, grid,
                              batch_size=16)
    out = predict_dataset(*load_npz(ckpt), tds, grid, batch_size=16)
    assert_results_close(out, ref)


def _catalog_result(fn, path, data_dir):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = fn(path, data_dir)
        except FileNotFoundError as e:
            got = ("raises", "looks like a spectrum" in str(e))
    return got, [str(w.message).split(" is not")[0] for w in caught]


@pytest.mark.parametrize("case", [
    "plain", "header", "ghost", "missing_first", "missing_first_fits",
    "missing_first_subdir", "bare_word", "blank_lines", "single",
])
def test_read_predict_catalog_matches_jax(survey, tmp_path, case):
    """Same rows, the same header sniff (warn and drop a bare header word;
    raise on a missing path-like first row) as the pandas reader."""
    root, ckpt, data_dir, catalog, grid, names = survey
    rows = {
        "plain": names[:3],
        "header": ["file"] + names[:3],
        "ghost": ["a.npz", "b.npz"],
        "missing_first": ["gone.npz"] + names[:2],
        "missing_first_fits": ["spec-0268-51633-0064.fits.gz"] + names[:2],
        "missing_first_subdir": ["sub/dir/t9"] + names[:2],
        "bare_word": ["spec_path"] + names[:2],
        "blank_lines": ["", names[0], "", names[1], ""],
        "single": names[:1],
    }[case]
    path = str(tmp_path / "cat.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    port = _catalog_result(read_predict_catalog, path, data_dir)
    ref = _catalog_result(jax_read_catalog, path, data_dir)
    assert port == ref


def _grid_opts(grid_kw):
    return ["DATA.LAMMIN", str(grid_kw["lammin"]),
            "DATA.LAMMAX", str(grid_kw["lammax"]),
            "DATA.LOGLAM_DELTA", str(grid_kw["loglam_delta"])]


@pytest.mark.parametrize("consolidated", [False, True])
def test_cli_predict_matches_jax(survey, tmp_path, consolidated):
    """``--type predict`` of both packages on the same survey: every output
    npz has the same keys, shapes and dtypes, and values within the
    prediction tolerances."""
    root, ckpt, data_dir, catalog, grid, names = survey
    opts = _grid_opts(GRID) + ["RUNTIME.CONSOLIDATED_PREDICT",
                               str(consolidated)]
    common = ["--type", "predict", "--catalog", catalog, "--data_dir",
              data_dir, "--resume", ckpt, "--batch_size", "16",
              "--nh", str(NH)]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_main(common + ["--output_dir", jax_out, "--opts", *opts])
    timings = port_main(common + ["--output_dir", port_out, "--device", "cpu",
                                  "--opts", *opts])
    assert timings["n"] == N
    assert os.path.exists(os.path.join(port_out, "config.yaml"))
    with open(os.path.join(port_out, "log.txt")) as f:
        assert f"predicted {N} spectra in" in f.read()
    if consolidated:
        files = ["predictions.npz"]
        assert not os.path.isdir(os.path.join(port_out, "predict"))
    else:
        files = [os.path.join("predict", n) for n in names]
        assert sorted(os.listdir(os.path.join(port_out, "predict"))) == \
            sorted(os.listdir(os.path.join(jax_out, "predict")))
    for fname in files:
        with np.load(os.path.join(port_out, fname)) as p, \
                np.load(os.path.join(jax_out, fname)) as j:
            assert sorted(p.files) == sorted(j.files)
            for key in j.files:
                assert p[key].shape == j[key].shape, (fname, key)
                assert p[key].dtype == j[key].dtype, (fname, key)
                if key == "paths":
                    np.testing.assert_array_equal(p[key], j[key])
                else:
                    np.testing.assert_allclose(p[key], j[key], err_msg=key,
                                               **NPZ_TOL[key])


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_http_round_trip_matches_jax(survey, engine):
    """POST /predict with -999 sentinels and an explicit mask, and
    GET /healthz, on the port (device cpu) and on qfa_tpu.serve (XLA)."""
    root, ckpt, data_dir, catalog, grid, names = survey
    rng = np.random.default_rng(9)
    n = 5
    flux = rng.normal(1.0, 0.2, (n, grid.npix))
    error = rng.uniform(0.05, 0.2, (n, grid.npix))
    flux[:, 4:9] = -999.0
    error[1, 20:30] = -999.0
    mask = np.ones((n, grid.npix), bool)
    mask[2, 40:] = False
    payload = {"flux": flux.tolist(), "error": error.tolist(),
               "zqso": rng.uniform(2.2, 3.2, n).tolist(),
               "mask": mask.astype(int).tolist()}
    port = QFAPredictor(ckpt, max_batch=2, engine=engine, device="cpu",
                        **GRID)
    ref = JaxPredictor(ckpt, max_batch=8, engine="xla", **GRID)
    servers = [make_http_server(port, port=0), jax_http_server(ref, port=0)]
    threads = [_serve(s) for s in servers]
    try:
        p_port, p_ref = (s.server_address[1] for s in servers)
        got, want = _http(p_port, "/predict", payload), \
            _http(p_ref, "/predict", payload)
        health = _http(p_port, "/healthz")
        # a malformed request is a 400, not a crash
        with pytest.raises(urllib.error.HTTPError) as bad:
            _http(p_port, "/predict", {"flux": [[1.0]]})
        assert bad.value.code == 400
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
    assert sorted(got) == sorted(want)
    assert got["n_obs"] == want["n_obs"]
    assert got["n_obs"][1] == grid.npix - 5 - 10
    for key, tol in TOL.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   err_msg=key, **tol)
    assert health["engine"] == engine and health["device"] == "cpu"
    assert health["npix"] == grid.npix and health["nh"] == NH
    assert health["requests"] == 1


def test_config_dump_reads_back_and_keeps_the_jax_schema():
    """The built-in YAML emitter round-trips through yaml.safe_load, and
    the port's defaults carry every key of the JAX package's."""
    import yaml

    from qfa_tpu.config import default_config as jax_default

    cfg = tconfig.default_config()
    cfg.merge_from_list(["DATA.LOGLAM_DELTA", "1e-5", "MODEL.TAU", "mock"])
    assert yaml.safe_load(cfg.dump()) == cfg.to_dict()

    def keys(d, prefix=""):
        return {prefix + k for k in d} | {
            x for k, v in d.items() if isinstance(v, dict)
            for x in keys(v, prefix + k + ".")
        }

    port_keys, jax_keys = keys(cfg.to_dict()), keys(jax_default().to_dict())
    assert port_keys - jax_keys == {"RUNTIME.DEVICE"}

"""The port's reference-API facade (``qfa_tpu_torch.compat``) against the
JAX package's (``qfa_tpu.compat``) on the same spectra files and the same
parameters, on the CPU.

Tolerances, and why:

* the ``Dataloader``'s shuffles and samples are numpy draws from the same
  seed: the row orders are equal, and the batches are bitwise the port's
  residual rows at those orders; the residuals and mu against JAX's rtol
  1e-5 (float32 tau power laws through XLA and torch,
  ``tests/test_torch_train.py``); a callable tau's residuals are numpy
  arithmetic in both facades: bitwise equal;
* ``forward`` and the single-spectrum methods to
  ``tests/test_torch_step.py``'s limits: loss rel 1e-6, each gradient
  atol 1e-4 * max|g|; the prediction to ``PRED_TOL`` (the JAX kernel-vs-
  XLA tolerances, ``tests/test_torch_model.py``);
* ``Adam.update`` against the JAX facade's: rtol 2e-6 (the JAX package's
  own bound between its facade and its functional Adam,
  ``tests/test_compat.py``);
* ``train(engine="xla")`` on the CPU against the JAX facade fed the same
  epoch permutations: per-epoch losses rtol 1e-5, parameters rtol 5e-4
  atol 1e-5 (``tests/test_torch_train.py``'s bounds for a run of several
  epochs with smoothing).
"""

import csv
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu import compat as jax_compat
from qfa_tpu.config import load_config as jax_load_config
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import load_npz as jax_load_npz
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu_torch import compat
from qfa_tpu_torch.config import load_config
from qfa_tpu_torch.models.params import PARAM_NAMES
from qfa_tpu_torch.physics.tau import tau as port_tau
from qfa_tpu_torch.train import loop

GRID = dict(lam_min=1030.0, lam_max=1120.0, dloglam=5e-4)
N = 32
PRED_TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
}


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """32 spectra with -999 sentinels, a training catalog (csv module),
    and the JAX init of Nh 3 as numpy."""
    root = tmp_path_factory.mktemp("torch_compat_survey")
    grid = qfa_tpu.make_grid(**GRID)
    true = jax_random_init(jax.random.key(0), grid.npix, grid.nb, 3)
    mu = jnp.ones((grid.npix,), jnp.float32) * 1.2
    syn = generate(jax.random.key(1), true, mu, grid, N, mask_frac=0.1)
    ddir = root / "spectra"
    ddir.mkdir()
    m = np.asarray(syn.mask) > 0
    with open(root / "catalog.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["file", "snr", "z", "num_mask"])
        for i in range(N):
            f = np.where(m[i], np.asarray(syn.flux)[i], -999.0)
            e = np.where(m[i], np.asarray(syn.error)[i], -999.0)
            np.savez(ddir / f"s{i:03d}.npz", flux=f, error=e,
                     z=float(syn.zqso[i]))
            w.writerow([f"s{i:03d}.npz", 10.0, float(syn.zqso[i]), 0])
    p0 = jax_random_init(jax.random.key(5), grid.npix, grid.nb, 3)
    return root, grid, {k: np.asarray(v) for k, v in p0.as_dict().items()}


def opts(root, out=""):
    return ["TYPE", "train",
            "DATA.CATALOG", str(root / "catalog.csv"),
            "DATA.DATA_DIR", str(root / "spectra"),
            "DATA.OUTPUT_DIR", out,
            "DATA.DATA_NUM", str(N),
            "DATA.BATCH_SIZE", "12",
            "DATA.NUM_MASK", "40",
            "DATA.LAMMIN", str(GRID["lam_min"]),
            "DATA.LAMMAX", str(GRID["lam_max"]),
            "DATA.LOGLAM_DELTA", str(GRID["dloglam"])]


def loaders(root, seed=0):
    return (compat.Dataloader(load_config(opts=opts(root)), seed=seed),
            jax_compat.Dataloader(jax_load_config(opts=opts(root)),
                                  seed=seed))


def models(survey, **kw):
    root, grid, p0 = survey
    return (compat.QFA(grid.nb, grid.nr, 3, device="cpu", model_params=p0,
                       **kw),
            jax_compat.QFA(grid.nb, grid.nr, 3, model_params=p0, **kw))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_grads_match(got, want, rel=1e-4):
    for k in PARAM_NAMES:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np_(got[k]), w,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   rtol=0, err_msg=k)


def test_dataloader_protocol_and_batches_match_jax(survey):
    """Sizes, mu and residuals against JAX; every rewind's row order and
    every sample's rows equal JAX's, and each batch is bitwise the port's
    residual rows at that order."""
    dl, jdl = loaders(survey[0])
    assert (dl.Nb, dl.Nr, len(dl), dl.batch_size) == \
        (jdl.Nb, jdl.Nr, len(jdl), jdl.batch_size)
    np.testing.assert_array_equal(dl.pathlist, jdl.pathlist)
    np.testing.assert_allclose(dl.mu, jdl.mu, rtol=1e-5)
    res, jres = dl.residuals(), jdl.residuals()
    for k in ("delta", "error", "zabs", "mask"):
        np.testing.assert_allclose(np_(getattr(res, k)),
                                   np.asarray(getattr(jres, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for _ in range(2):
        dl.rewind()
        jdl.rewind()
        np.testing.assert_array_equal(dl._order, jdl._order)
        n_batches, start = 0, 0
        while dl.have_next_batch():
            assert jdl.have_next_batch()
            got, want = dl.next_batch(), jdl.next_batch()
            rows = torch.from_numpy(dl._order[start:start + 12])
            start += 12
            for g, w, k in zip(got, want, ("delta", "error", "zabs", "mask")):
                assert torch.equal(g, getattr(res, k)[rows]), k
                np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5,
                                           atol=1e-6)
            n_batches += 1
        assert n_batches == 3 and not jdl.have_next_batch()
    state = dl._rng.bit_generator.state
    got, want = dl.sample(), jdl.sample()
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    rows = torch.from_numpy(rng.integers(0, N, size=12))
    assert torch.equal(got[0], res.delta[rows])
    np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)


def test_dataloader_getitem_and_set_device(survey):
    dl, jdl = loaders(survey[0])
    flux, err, zabs, mask, path = dl[3]
    jflux, jerr, jzabs, jmask, jpath = jdl[3]
    assert path == jpath and str(path).endswith(".npz")
    np.testing.assert_array_equal(np_(flux), np.asarray(jflux))
    np.testing.assert_array_equal(np_(err), np.asarray(jerr))
    np.testing.assert_array_equal(np_(mask), np.asarray(jmask))
    np.testing.assert_allclose(np_(zabs), np.asarray(jzabs), rtol=1e-6)
    before = dl.residuals()
    dl.set_device("cpu")
    assert all(torch.equal(a, b) for a, b in zip(before, dl.residuals()))
    assert dl.residuals().delta.device == torch.device("cpu")


def test_forward_matches_jax(survey):
    dl, jdl = loaders(survey[0])
    model, jmodel = models(survey)
    dl.rewind()
    jdl.rewind()
    batch = dl.next_batch()
    jbatch = jdl.next_batch()
    loss, grads = model.forward(*batch)
    jloss, jgrads = jmodel.forward(*jbatch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert set(grads) == set(jgrads) == set(PARAM_NAMES)
    assert_grads_match(grads, jgrads)


def test_single_spectrum_methods_match_jax(survey, tmp_path):
    """The single-spectrum NLL and gradients, and the prediction from a
    checkpoint the JAX package wrote, with hmean as an (Nh, 1) column."""
    dl, jdl = loaders(survey[0])
    model, jmodel = models(survey)
    d, e, z, m = (np_(x)[5] for x in dl.residuals())
    ll, g = model.loglikelihood_and_gradient_for_single_spectra(d, e, z, m)
    jll, jg = jmodel.loglikelihood_and_gradient_for_single_spectra(
        d, e, z, m)
    assert float(ll) == pytest.approx(float(jll), rel=1e-6)
    assert_grads_match(g, jg)

    jmodel.mu = jnp.asarray(jdl.mu)
    jmodel.save_to_npz(str(tmp_path), "jax.npz")
    model.load_from_npz(str(tmp_path / "jax.npz"))
    flux, err, zabs, mask, _ = jdl[7]
    got = model.prediction_for_single_spectra(np.asarray(flux),
                                              np.asarray(err),
                                              np.asarray(zabs),
                                              np.asarray(mask))
    want = jmodel.prediction_for_single_spectra(flux, err, zabs, mask)
    assert tuple(got[1].shape) == (3, 1) == want[1].shape
    for field, a, b in zip(PRED_TOL, got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=field,
                                   **PRED_TOL[field])


def test_adam_update_matches_jax_facade():
    """Two updates at epoch counter 2, then reset, against the JAX
    facade's Adam on the same numpy dicts."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32),
              "c": np.float32(0.7)}
    grads = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": np.full((4,), 0.3, np.float32), "c": np.float32(-0.2)}
    sched = compat.step_scheduler(0.5, 2)
    opt = compat.Adam(params, "cpu", scheduler=sched, learning_rate=3e-3,
                      weight_decay=0.05)
    jopt = jax_compat.Adam(params, scheduler=jax_compat.step_scheduler(0.5, 2),
                           learning_rate=3e-3, weight_decay=0.05)
    for o in (opt, jopt):
        o.step()
        o.step()
    assert opt.scheduled_lr == jopt.scheduled_lr
    new, jnew = opt.update(params, grads), jopt.update(params, grads)
    new, jnew = opt.update(new, grads), jopt.update(jnew, grads)
    for k in params:
        np.testing.assert_allclose(np_(new[k]), np.asarray(jnew[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(np_(opt.m[k]), np.asarray(jopt.m[k]),
                                   rtol=2e-6, atol=1e-8)
        np.testing.assert_allclose(np_(opt.v[k]), np.asarray(jopt.v[k]),
                                   rtol=2e-6, atol=1e-9)
    opt.reset(params)
    assert opt.i == 0
    assert all(float(t.abs().max()) == 0.0 for t in opt.m.values())
    # lazy moments when constructed without params
    lazy = compat.Adam(device="cpu", learning_rate=3e-3, weight_decay=0.05)
    jlazy = jax_compat.Adam(learning_rate=3e-3, weight_decay=0.05)
    got, want = lazy.update(params, grads), jlazy.update(params, grads)
    for k in params:
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   rtol=2e-6, atol=1e-7, err_msg=k)


def test_reference_training_loop_idiom_runs_verbatim(survey):
    """The reference's manual loop (forward, ``optimizer.update`` into the
    parameters setter, ``optimizer.step`` per epoch) runs on both facades
    from the same parameters and rows: the same epoch losses."""
    root, grid, p0 = survey
    losses = {}
    for name, mod, make_opt in (
            ("port", compat, lambda p: compat.Adam(p, "cpu", learning_rate=1e-2,
                                                   weight_decay=0.01)),
            ("jax", jax_compat, lambda p: jax_compat.Adam(
                p, None, learning_rate=1e-2, weight_decay=0.01))):
        cfg = (load_config if name == "port" else jax_load_config)(
            opts=opts(root))
        dl = mod.Dataloader(cfg)
        kw = {"device": "cpu"} if name == "port" else {}
        model = mod.QFA(dl.Nb, dl.Nr, 3, model_params=p0, **kw)
        optimizer = make_opt(model.parameters)
        niter = dl.data_size // dl.batch_size
        out = []
        for _epoch in range(2):
            dl.rewind()
            total = 0.0
            while dl.have_next_batch():
                d, e, z, m = dl.next_batch()
                loss, grads = model.forward(d, e, z, m)
                total += float(loss) / niter
                model.parameters = optimizer.update(model.parameters, grads)
            optimizer.step()
            out.append(total)
        losses[name] = out
        for leaf in model.parameters.values():
            assert np.isfinite(np_(leaf)).all()
    assert losses["port"][1] < losses["port"][0]  # it learns
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)


class JaxRows:
    """The row permutations JAX's ``fit`` draws for a key:
    ``permutation(fold_in(key(seed), epoch))``."""

    def __init__(self, seed, rank=0):
        self.key = jax.random.key(seed)

    def rows(self, epoch, n):
        k = jax.random.fold_in(self.key, epoch)
        return torch.tensor(np.asarray(jax.random.permutation(k, n)))


def test_train_xla_matches_jax_facade(survey, tmp_path, monkeypatch):
    """``QFA.train(engine="xla")`` with a reference-style optimizer and
    its step schedule, fed the JAX facade's epoch permutations through
    the trainer's shuffler: the same per-epoch losses, parameters and
    checkpoints."""
    monkeypatch.setattr(loop, "SeededShuffler", JaxRows)
    dl, jdl = loaders(survey[0])
    model, jmodel = models(survey, seed=4)
    hist = {}

    def opt(mod):
        return mod.Adam(learning_rate=2e-2, weight_decay=0.01,
                        scheduler=mod.step_scheduler(0.5, 2),
                        **({"device": "cpu"} if mod is compat else {}))

    def spy(name, real):
        def run(*a, **k):
            params, history = real(*a, **k)
            hist[name] = history
            return params, history
        return run

    monkeypatch.setattr(compat, "fit", spy("port", compat.fit))
    monkeypatch.setattr(jax_compat, "fit_fn", spy("jax", jax_compat.fit_fn))
    for name, m, d in (("port", model, dl), ("jax", jmodel, jdl)):
        m.train(optimizer=opt(jax_compat if name == "jax" else compat),
                dataloader=d, n_epochs=4, output_dir=str(tmp_path / name),
                save_interval=2, smooth_interval=2, quiet=True, engine="xla")
    assert len(hist["port"]) == 4
    np.testing.assert_allclose(hist["port"], hist["jax"], rtol=1e-5)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(np_(model.parameters[k]),
                                   np.asarray(jmodel.parameters[k]),
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == \
        sorted(os.listdir(tmp_path / "jax" / "checkpoints"))
    np.testing.assert_allclose(np_(model.mu), np.asarray(jmodel.mu),
                               rtol=1e-5)


def test_train_engine_validation(survey, tmp_path, monkeypatch):
    """Unknown engines raise with JAX's message; ``"pallas"`` raises on a
    CPU model (the port never falls back from the kernel) and, with
    JAX's message, for an opaque tau; ``"auto"`` on the CPU trains with
    ``train.fit``, not the epoch kernel."""
    root, grid, p0 = survey
    dl, _ = loaders(root)
    model, jmodel = models(survey)
    kw = dict(dataloader=dl, n_epochs=1, output_dir=str(tmp_path / "e"),
              quiet=True)
    with pytest.raises(ValueError, match="unknown engine 'XLA'; expected"):
        model.train(engine="XLA", **kw)
    with pytest.raises(ValueError, match="no CUDA device"):
        model.train(engine="pallas", **kw)

    def clone(zz):
        return 0.0018 * (1.0 + zz) ** 3.92

    opaque = compat.QFA(grid.nb, grid.nr, 3, "cpu", tau=clone,
                        model_params=p0)
    jopaque = jax_compat.QFA(grid.nb, grid.nr, 3, None, tau=clone,
                             model_params=p0)
    with pytest.raises(ValueError) as got:
        opaque.train(engine="pallas", **kw)
    _, jdl = loaders(root)
    with pytest.raises(ValueError) as want:
        jopaque.train(dataloader=jdl, n_epochs=1, engine="pallas",
                      output_dir=str(tmp_path / "j"), quiet=True)
    assert str(got.value) == str(want.value)
    calls = []
    real = compat.fit
    monkeypatch.setattr(compat, "fit",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(compat, "fit_fused",
                        lambda *a, **k: pytest.fail("fit_fused called"))
    model.train(engine="auto", **kw)
    assert len(calls) == 1 and calls[0]["seed"] == 0


def test_set_tau_by_name_and_by_callable(survey):
    """A law name rebuilds the residuals with that law (as JAX's, rtol
    1e-5); a callable's residuals are bitwise JAX's on the same taus; mu
    keeps its law."""
    dl, jdl = loaders(survey[0])
    mu = dl.mu.copy()
    becker = dl.residuals().delta.clone()
    dl.set_tau("mock")
    jdl.set_tau("mock")
    assert not torch.allclose(becker, dl.residuals().delta)
    np.testing.assert_allclose(np_(dl.residuals().delta),
                               np.asarray(jdl.residuals().delta), rtol=1e-5,
                               atol=1e-6)

    def taus(wav, zqso):  # numpy, the same for both facades
        blue = np.asarray(wav)[: dl.Nb]
        return 0.002 * (1.0 + np.asarray(zqso)[:, None]) ** 3.5 \
            * (blue / blue[-1])

    # the same mu in both (the estimates differ at rtol 1e-5): the rest
    # is the same numpy arithmetic
    dl._mu = np.array(jdl.mu)
    dl.set_tau(taus)
    jdl.set_tau(taus)
    np.testing.assert_array_equal(np_(dl.residuals().delta),
                                  np.asarray(jdl.residuals().delta))
    dl._mu = mu
    dl.set_tau("becker")
    assert torch.equal(dl.residuals().delta, becker)
    assert dl.tau_which == "becker"


def test_tau_partial_resolves_to_named_law(survey):
    """``QFA(..., tau=partial(tau, which='fg'))`` trains and evaluates
    with fg, as JAX's facade does."""
    root, grid, p0 = survey
    dl, jdl = loaders(root)
    batch = dl.next_batch()
    jbatch = jdl.next_batch()
    model = compat.QFA(grid.nb, grid.nr, 3, "cpu",
                       tau=functools.partial(port_tau, which="fg"),
                       model_params=p0)
    assert model.tau_which == "fg"
    loss, _ = model.forward(*batch)
    named, _ = compat.QFA(grid.nb, grid.nr, 3, "cpu", tau="fg",
                          model_params=p0).forward(*batch)
    assert float(loss) == float(named)
    jloss, _ = jax_compat.QFA(grid.nb, grid.nr, 3, tau="fg",
                              model_params=p0).forward(*jbatch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)


def test_opaque_tau_is_trained_by_xla(survey, tmp_path):
    """An opaque callable flows through the plain path verbatim (a
    hand-rolled fg equals tau='fg'), and ``engine="xla"`` trains with it
    to finite parameters."""
    root, grid, p0 = survey
    dl, _ = loaders(root)
    batch = dl.next_batch()

    def fg_clone(zz):
        return 0.0018 * (1.0 + zz) ** 3.92

    model = compat.QFA(grid.nb, grid.nr, 3, "cpu", tau=fg_clone,
                       model_params=p0)
    assert callable(model.tau_which)
    loss_c, grads_c = model.forward(*batch)
    loss_n, grads_n = compat.QFA(grid.nb, grid.nr, 3, "cpu", tau="fg",
                                 model_params=p0).forward(*batch)
    assert float(loss_c) == pytest.approx(float(loss_n), rel=1e-7)
    np.testing.assert_allclose(np_(grads_c["tau0"]), np_(grads_n["tau0"]),
                               rtol=1e-6)
    model.train(dataloader=dl, n_epochs=1, engine="xla", quiet=True,
                output_dir=str(tmp_path / "x"), weight_decay=0.0)
    assert all(np.isfinite(np_(v)).all() for v in model.parameters.values())


def test_scheduler_introspection_and_epoch_print(survey, tmp_path, capsys,
                                                 monkeypatch):
    """``QFA.train`` reads a reference-style optimizer's step schedule,
    and the non-quiet run prints the reference's epoch line."""
    sched = compat.step_scheduler(0.5, 2)
    assert sched(3, 1.0) == pytest.approx(0.25)
    opt = compat.Adam(device="cpu", learning_rate=2e-2, weight_decay=0.0,
                      scheduler=sched)
    assert opt.scheduled_lr == pytest.approx(2e-2)
    opt.step()
    assert opt.scheduled_lr == pytest.approx(1e-2)
    opt.i = 0
    dl, _ = loaders(survey[0])
    model, _ = models(survey)
    seen = {}
    real = compat.fit
    monkeypatch.setattr(compat, "fit",
                        lambda *a, **k: seen.update(cfg=a[3]) or real(*a, **k))
    model.train(optimizer=opt, dataloader=dl, n_epochs=1,
                output_dir=str(tmp_path / "o"), quiet=False)
    assert (seen["cfg"].decay_alpha, seen["cfg"].decay_step,
            seen["cfg"].learning_rate) == (0.5, 2, 2e-2)
    out = capsys.readouterr().out
    assert "epoch: 000/001" in out and "loss:" in out


def test_parameters_setter_and_checkpoints(survey, tmp_path):
    """The parameters setter clips; ``save_to_npz`` writes a checkpoint
    the JAX package loads; ``load_from_npz`` honors ``compat_c0_bug``."""
    root, grid, p0 = survey
    model, _ = models(survey)
    assert model.Nparams == grid.npix * 3 + grid.npix + grid.nb + 3
    p = model.parameters
    p["Psi"] = torch.full_like(p["Psi"], 99.0)
    model.parameters = p
    assert float(model.parameters["Psi"].max()) == 2.0
    model.mu = np.full(grid.npix, 1.1, np.float32)
    model.save_to_npz(str(tmp_path), "m.npz")
    jp, jmu = jax_load_npz(str(tmp_path / "m.npz"))
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(np_(model.parameters[k]),
                                      np.asarray(getattr(jp, k)))
    other = compat.QFA(grid.nb, grid.nr, 3, "cpu")
    other.load_from_npz(str(tmp_path / "m.npz"), compat_c0_bug=True)
    assert float(other.parameters["c0"]) == float(p0["beta"])
    np.testing.assert_array_equal(np_(other.mu), np.asarray(jmu))


def test_device_defaults_to_cuda(monkeypatch):
    """``QFA``, ``Adam`` and ``Dataloader.set_device`` without a device
    mean ``cuda``: where torch sees no card they raise, never fall back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.QFA(10, 20, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.Adam()
    model = compat.QFA(10, 20, 2, "cpu", seed=3)
    again = compat.QFA(10, 20, 2, "cpu", seed=3)
    assert torch.equal(model.parameters["F"], again.parameters["F"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert model.device == torch.device("cpu")

"""Reference-API facade: the upstream QFA classes on the port.

Object-oriented shims with the public surface of the reference
implementation (class ``QFA`` of ``QFA/model.py``, class ``Dataloader``
of ``QFA/dataloader.py``, ``Adam`` and ``step_scheduler`` of
``QFA/optimizer.py``), the counterpart of ``qfa_tpu.compat``: code written
against the reference ports with an import change. Semantics follow
``qfa_tpu.compat``: exact (autograd) gradients, ``load_from_npz`` loads
``c0`` correctly unless ``compat_c0_bug=True``, resume works.

Unlike the JAX facade, ``device`` is honored, as in the reference:
``QFA(..., device=None)`` and ``Adam(device=None)`` mean ``cuda`` (a
machine without a card raises; pass ``"cpu"``), and
``Dataloader.set_device`` moves its resident residuals (built on the
CPU). ``QFA.train`` runs the CUDA epoch kernel (``train.fit_fused``) on a
CUDA model with a named tau law, else the per-step trainer
``train.fit``. Random draws come from ``torch.Generator``s seeded with
``seed``: the parameters of ``QFA(seed=s)`` are not the JAX facade's
(carry those over with ``model_params=`` or the ``parameters`` setter),
while the ``Dataloader``'s numpy shuffles are the same row for row.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .data.batch import SpectraBatch
from .data.grid import make_grid
from .data.loader import (
    ResidualDataset,
    SpectraDataset,
    compute_taus,
    estimate_mu,
    make_residuals,
    read_predict_catalog,
    select_from_catalog,
    validation_concat_paths,
)
from .models import params as params_mod
from .models import qfa as qfa_mod
from .models.params import PARAM_NAMES, QFAParams
from .physics.tau import resolve_tau
from .train import TrainConfig, fit, fit_fused
from .utils.device import resolve_device, to_device
from .utils.profiling import is_cuda

Tensor = torch.Tensor

__all__ = ["QFA", "Dataloader", "Adam", "step_scheduler"]


class _StepScheduler:
    """Reference step-decay schedule with introspectable parameters:
    callable as ``lr * alpha ** ((i + 1) // step)``; exposes
    ``alpha``/``step`` so :meth:`QFA.train` recovers the decay."""

    def __init__(self, alpha: float, step: int) -> None:
        self.alpha = float(alpha)
        self.step = int(step)

    def __call__(self, i, lr):
        return lr * self.alpha ** ((i + 1) // self.step)


def step_scheduler(alpha: float, step: int) -> _StepScheduler:
    """Reference-API scheduler factory."""
    return _StepScheduler(alpha, step)


class Adam:
    """Reference-API optimizer over dicts of tensors.

    ``update(params, g)`` / ``reset(params)`` / ``step()`` /
    ``scheduled_lr`` follow the reference's hand-rolled Adam (L2 weight
    decay folded into the gradient before the moment updates, bias
    correction from the per-EPOCH counter ``i``), so the reference's own
    loop, ``model.parameters = optimizer.update(model.parameters, grads);
    optimizer.step()``, runs verbatim. Passed to :meth:`QFA.train`, only
    its hyper-parameters are read. The moments and the updated tensors
    live on ``device`` (default ``cuda``); the moments are made at
    construction when ``params`` is given, else at the first
    :meth:`update`.
    """

    def __init__(
        self,
        params=None,
        device=None,
        scheduler=None,
        learning_rate: float = 1e-2,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-3,
    ) -> None:
        self.learning_rate = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.device = resolve_device(device or "cuda")
        self.weight_decay = weight_decay
        self.scheduler = scheduler
        self.m: Dict[str, Tensor] | None = None
        self.v: Dict[str, Tensor] | None = None
        if params is not None:
            self.reset(params)
        self.i = 0

    def _zeros(self, params) -> Dict[str, Tensor]:
        return {k: torch.zeros_like(to_device(params[k], self.device))
                for k in params}

    def update(self, params: Dict[str, Tensor], g: Dict[str, Tensor]
               ) -> Dict[str, Tensor]:
        """One Adam step over a dict of tensors; returns the updated dict
        (float32, on the optimizer's device): ``g += wd * p``; the moment
        EMAs; bias correction with the per-epoch counter ``i`` (advanced
        only by :meth:`step`); the learning rate of
        :attr:`scheduled_lr`. The JAX facade's arithmetic, term for
        term."""
        if self.m is None:
            # lazy moment init; unlike reset(), the counter stays as set
            self.m, self.v = self._zeros(params), self._zeros(params)
        dev = self.device
        g = {k: to_device(g[k], dev) for k in g}
        p32 = {k: to_device(params[k], dev) for k in g}
        g = {k: g[k] + self.weight_decay * p32[k] for k in g}
        self.m = {k: (1.0 - self.b1) * g[k] + self.b1 * self.m[k] for k in g}
        self.v = {k: (1.0 - self.b2) * g[k] * g[k] + self.b2 * self.v[k]
                  for k in g}
        bc1 = 1.0 - self.b1 ** (self.i + 1)
        bc2 = 1.0 - self.b2 ** (self.i + 1)
        lr = self.scheduled_lr
        return {k: p32[k] - lr * (self.m[k] / bc1)
                / (torch.sqrt(self.v[k] / bc2) + self.eps) for k in params}

    def reset(self, params: Dict[str, Tensor]) -> None:
        """Zero the moments and the counter."""
        self.m, self.v = self._zeros(params), self._zeros(params)
        self.i = 0

    def step(self) -> None:
        self.i += 1

    @property
    def scheduled_lr(self):
        if callable(self.scheduler):
            return self.scheduler(self.i, self.learning_rate)
        return self.learning_rate


class QFA:
    """The reference's model class over the port's functional core, on
    ``device`` (default ``cuda``)."""

    def __init__(
        self,
        Nb: int,  # noqa: N803
        Nr: int,  # noqa: N803
        Nh: int,  # noqa: N803
        device=None,
        tau="becker",
        model_params: Optional[Dict[str, np.ndarray]] = None,
        seed: int = 0,
    ) -> None:
        self.Nb, self.Nr, self.Nh = Nb, Nr, Nh
        self.Npix = Nb + Nr
        self.Nparams = params_mod.num_params(self.Npix, Nb, Nh)
        self.device = resolve_device(device or "cuda")
        # the reference passes tau as partial(tau, which=...): resolve_tau
        # recovers the law's name; an opaque callable is kept as it is
        # (the plain path evaluates it, the epoch kernel refuses it)
        self.tau_which = resolve_tau(tau)
        self._options = qfa_mod.ModelOptions(tau_which=self.tau_which)
        self._seed = seed
        self.mu = None
        if model_params is not None:
            self._params = QFAParams(**{
                k: to_device(model_params[k], self.device) for k in PARAM_NAMES})
        else:
            self.random_init_func()

    # -- parameters ---------------------------------------------------------
    def random_init_func(self) -> None:
        """F ~ U(-0.5, 0.5) from a ``torch.Generator`` seeded with
        ``seed`` (drawn on the CPU, so every device gets the same init),
        Psi = omega = 1, tau0 = 0.02, c0 = 0.3, beta = 2."""
        self._params = params_mod.random_init(
            self.Npix, self.Nb, self.Nh,
            generator=torch.Generator().manual_seed(self._seed),
        ).to(self.device)

    @property
    def parameters(self) -> Dict[str, Tensor]:
        return self._params.as_dict()

    @parameters.setter
    def parameters(self, params_dict: Dict[str, Tensor]) -> None:
        self._params = params_mod.clip_params(QFAParams(**{
            k: to_device(params_dict[k], self.device) for k in PARAM_NAMES}))

    def clip(self) -> None:
        self._params = params_mod.clip_params(self._params)

    def smooth(self) -> None:
        self._params = params_mod.smooth_params(self._params)

    # -- likelihood ----------------------------------------------------------
    def _as_batch(self, delta, error, zabs, mask) -> SpectraBatch:
        dev = self.device

        def to2d(x):
            return torch.atleast_2d(to_device(x, dev))

        mask2 = to2d(mask)
        return SpectraBatch(
            delta=to2d(delta) * mask2,
            error=to2d(error) * mask2,
            zabs=to2d(zabs),
            mask=mask2,
            weight=torch.ones((mask2.shape[0],), dtype=torch.float32,
                              device=dev),
        )

    def forward(self, delta, error, zabs, mask):
        """Batch mean NLL and reference-normalized gradients (a dict):
        the reference's ``forward``, vectorized over the batch, with
        autograd gradients."""
        batch = self._as_batch(delta, error, zabs, mask)
        loss, grads = qfa_mod.loss_and_grads(
            self._params, batch, self._options, reference_norm=True)
        return loss, grads.as_dict()

    def loglikelihood_and_gradient_for_single_spectra(
        self, delta, error, zabs, mask
    ):
        """Single-spectrum NLL and gradient dict (plain sums)."""
        batch = self._as_batch(delta, error, zabs, mask)
        total, _n, grads, _c = qfa_mod.summed_stats(
            self._params, batch, self._options)
        return total, grads.as_dict()

    def prediction_for_single_spectra(self, flux, error, zabs, mask):
        """(ll, hmean, hcov, continuum, uncertainty) for one spectrum;
        ``hmean`` is an (Nh, 1) column, as in the reference."""
        if self.mu is None:
            raise RuntimeError("model.mu is unset — load a checkpoint first")
        dev = self.device
        res = qfa_mod.predict(
            self._params,
            to_device(self.mu, dev),
            torch.atleast_2d(to_device(flux, dev)),
            torch.atleast_2d(to_device(error, dev)),
            torch.atleast_2d(to_device(zabs, dev)),
            torch.atleast_2d(to_device(mask, dev)),
            self._options,
        )
        return (res.ll[0], res.hmean[0][:, None], res.hcov[0],
                res.continuum[0], res.continuum_std[0])

    # -- training ------------------------------------------------------------
    def train(
        self,
        optimizer=None,
        dataloader=None,
        n_epochs: int = 500,
        output_dir: str = "./result",
        save_interval: int = 5,
        smooth_interval: int = 5,
        quiet: bool = False,
        logger=None,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.1,
        decay_alpha: float = 0.9,
        decay_step: int = 10,
        engine: str = "auto",
    ) -> None:
        """Train on a :class:`Dataloader`'s data, on the model's device.

        ``optimizer`` may be None (the keyword arguments give the
        hyper-parameters) or a reference-style / :class:`Adam` optimizer:
        ``learning_rate``, ``weight_decay``, ``b1``, ``b2`` and ``eps``
        are read from it, and a ``scheduler`` exposing ``alpha``/``step``
        (as :func:`step_scheduler`'s does) gives the decay; an opaque
        schedule closure cannot be read, so pass ``decay_alpha`` /
        ``decay_step``.

        ``engine``: ``"auto"`` (default) trains with the CUDA epoch kernel
        (``train.fit_fused``) when the model is on a CUDA device and its
        tau law is named, else with the per-step trainer ``train.fit``;
        ``"pallas"`` forces the kernel (it raises on a CPU model and for
        an opaque tau callable), ``"xla"`` forces ``train.fit``. Epoch
        ``e``'s shuffle depends only on ``seed`` and ``e``.
        """
        if dataloader is None:
            raise ValueError("dataloader is required")
        b1, b2, eps = 0.9, 0.999, 1e-8
        if optimizer is not None:
            learning_rate = getattr(optimizer, "learning_rate", learning_rate)
            weight_decay = getattr(optimizer, "weight_decay", weight_decay)
            b1 = float(getattr(optimizer, "b1", b1))
            b2 = float(getattr(optimizer, "b2", b2))
            eps = float(getattr(optimizer, "eps", eps))
            sched = getattr(optimizer, "scheduler", None)
            if sched is not None and hasattr(sched, "alpha") \
                    and hasattr(sched, "step"):
                decay_alpha = float(sched.alpha)
                decay_step = int(sched.step)
        if engine not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"unknown engine {engine!r}; expected auto, pallas or xla")
        opaque_tau = callable(self.tau_which)
        if opaque_tau and engine == "pallas":
            # the epoch kernel knows the named power laws only: refuse
            # rather than train with the wrong optical depth
            raise ValueError(
                "engine='pallas' requires a named tau law; this model was "
                "constructed with an opaque tau callable — use "
                "engine='xla', or pass tau=partial(tau, which='<law>') so "
                "the law name can be recovered")
        cuda = is_cuda(self.device)
        if engine == "pallas" and not cuda:
            raise ValueError(
                f"engine='pallas' requested but the model's device "
                f"{self.device} is no CUDA device: the epoch kernel runs on "
                "the card; use engine='xla' (or 'auto') to train there")
        use_kernel = engine == "pallas" or (
            engine == "auto" and cuda and not opaque_tau)
        self.mu = to_device(dataloader.mu, self.device)
        config = TrainConfig(
            n_epochs=n_epochs,
            batch_size=dataloader.batch_size,
            learning_rate=learning_rate,
            weight_decay=weight_decay,
            decay_alpha=decay_alpha,
            decay_step=decay_step,
            b1=b1,
            b2=b2,
            eps=eps,
            smooth_interval=smooth_interval,
            save_interval=save_interval,
            options=self._options,
        )
        # the reference's terminal line per epoch unless quiet
        metrics_cb = None
        if not quiet:
            def metrics_cb(epoch, loss, dt):
                print("epoch: {:03d}/{:03d}  ;  loss:  {:.2f}  ;  "
                      "time:  {:.2f} s ".format(epoch, n_epochs, loss, dt))
        data = ResidualDataset(*(None if x is None else x.to(self.device)
                                 for x in dataloader.residuals()))
        run = fit_fused if use_kernel else fit
        self._params, _history = run(
            self._params, data, self.mu, config, seed=self._seed,
            output_dir=output_dir, logger=logger, metrics_cb=metrics_cb)

    # -- checkpoints ----------------------------------------------------------
    def save_to_npz(self, output_dir: str, file_name: str) -> None:
        params_mod.save_npz(os.path.join(output_dir, file_name),
                            self._params, self.mu)

    def load_from_npz(self, path: str, compat_c0_bug: bool = False) -> None:
        self._params, self.mu = params_mod.load_npz(
            path, compat_c0_bug=compat_c0_bug, device=self.device)


class Dataloader:
    """The reference's data loader over the port's data layer, with its
    iteration protocol: ``next_batch`` / ``have_next_batch`` / ``rewind``
    / ``sample`` / ``__getitem__`` / ``mu``. The residuals are built on
    the CPU; :meth:`set_device` moves them. Shuffles come from
    ``np.random.default_rng(seed)``, row for row as in ``qfa_tpu.compat``.
    """

    def __init__(self, config, seed: int = 0):
        self.grid = make_grid(config.DATA.LAMMIN, config.DATA.LAMMAX,
                              config.DATA.LOGLAM_DELTA)
        self.Nb, self.Nr = self.grid.nb, self.grid.nr
        self.wav_grid = self.grid.wav
        self.type = config.TYPE
        self.batch_size = config.DATA.BATCH_SIZE
        self.tau_which = config.MODEL.TAU
        self._rng = np.random.default_rng(seed)
        self._device = torch.device("cpu")

        if self.type == "train":
            paths = select_from_catalog(
                config.DATA.CATALOG,
                config.DATA.DATA_DIR,
                config.DATA.DATA_NUM,
                snr_min=config.DATA.SNR_MIN,
                snr_max=config.DATA.SNR_MAX,
                z_min=config.DATA.Z_MIN,
                z_max=config.DATA.Z_MAX,
                num_mask=config.DATA.NUM_MASK,
                seed=seed,
                output_dir=config.DATA.OUTPUT_DIR or None,
                prefix="train",
            )
            # the reference concatenates the validation spectra into the
            # training arrays (DATA.VALIDATION_CONCAT_COMPAT)
            extra = validation_concat_paths(
                config.DATA, seed, output_dir=config.DATA.OUTPUT_DIR or None)
            if extra is not None:
                paths = list(paths) + extra
        elif self.type == "predict":
            paths = read_predict_catalog(config.DATA.CATALOG,
                                         config.DATA.DATA_DIR)
        else:
            raise NotImplementedError("TYPE should be in ['train', 'predict']!")

        self.dataset = SpectraDataset.from_paths(
            paths, max_workers=config.DATA.NPROCS)
        self.pathlist = np.asarray(self.dataset.paths)
        self.zqso = self.dataset.zqso
        self.zabs = self.grid.zabs(self.zqso).astype(np.float32)
        self.data_size = self.dataset.size
        taus = compute_taus(self.grid, self.zqso, tau_which=self.tau_which)
        self._mu = estimate_mu(self.dataset, self.grid,
                               tau_which=self.tau_which,
                               window=config.TRAIN.WINDOW_LENGTH_FOR_MU,
                               taus=taus)
        self._residuals = make_residuals(self.dataset, self.grid, self._mu,
                                         tau_which=self.tau_which, taus=taus)
        self._order = np.arange(self.data_size)
        self.cur = 0

    # -- reference iteration protocol ----------------------------------------
    def have_next_batch(self) -> bool:
        return self.cur < self.data_size

    def next_batch(self):
        """(delta, error, zabs, mask) tensors of the next batch, on the
        loader's device."""
        start, end = self.cur, min(self.cur + self.batch_size, self.data_size)
        self.cur = end
        batch = self._residuals.gather(
            torch.from_numpy(self._order[start:end]))
        return batch.delta, batch.error, batch.zabs, batch.mask

    def sample(self):
        """A random batch (rows drawn with replacement)."""
        idx = self._rng.integers(0, self.data_size, size=self.batch_size)
        batch = self._residuals.gather(torch.from_numpy(idx))
        return batch.delta, batch.error, batch.zabs, batch.mask

    def rewind(self) -> None:
        self._rng.shuffle(self._order)
        self.cur = 0

    def set_tau(self, tau) -> None:
        """Switch the mean-optical-depth law of the residuals served from
        now on (``mu`` keeps the law it was estimated with, as in the
        reference). ``tau`` is a law name or a callable ``tau(wav_grid,
        zqso) -> (N, Nb)``; the callable's residuals take the JAX facade's
        numpy arithmetic."""
        if callable(tau):
            taus = np.asarray(tau(self.wav_grid, self.zqso), np.float32)
            absorb = np.concatenate(
                [np.exp(-taus),
                 np.ones((self.data_size, self.Nr), np.float32)], axis=1)
            mask = self.dataset.mask.astype(np.float32)
            delta = (self.dataset.flux
                     - np.asarray(self._mu, np.float32) * absorb) * mask
            self._residuals = self._residuals._replace(delta=torch.as_tensor(
                delta.astype(np.float32), device=self._device))
        else:
            self.tau_which = str(tau)
            self._residuals = make_residuals(
                self.dataset, self.grid, self._mu, tau_which=self.tau_which,
                device=self._device)

    def set_device(self, device) -> None:
        """Move the resident residuals to ``device`` (the batches are
        served there from now on)."""
        self._device = resolve_device(device or "cuda")
        self._residuals = ResidualDataset(*(
            None if x is None else x.to(self._device)
            for x in self._residuals))

    def residuals(self) -> ResidualDataset:
        """The resident dataset (for the functional trainers)."""
        return self._residuals

    def __len__(self) -> int:
        return self.data_size

    def __getitem__(self, idx):
        """(flux, error, zabs, mask, path) of a spectrum, for prediction
        workflows (tensors on the loader's device)."""
        def t(x):
            return torch.as_tensor(x, device=self._device)

        return (t(self.dataset.flux[idx]), t(self.dataset.error[idx]),
                t(self.zabs[idx]), t(self.dataset.mask[idx]),
                self.pathlist[idx] if len(self.pathlist) else "")

    @property
    def mu(self) -> np.ndarray:
        return self._mu

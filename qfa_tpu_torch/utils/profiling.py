"""Profiling and numerical-health utilities, the counterparts of
``qfa_tpu.utils.profiling``:

* :func:`trace`: a ``torch.profiler`` trace of a block (CPU activity, and
  the card's when one is in use), written as a Chrome trace JSON that
  TensorBoard's profiler plugin and Perfetto read;
* :func:`span`: a named host range in such a trace, on the clock of the
  card's events. The port's hot paths mark their host phases with it, so
  a ``RUNTIME.PROFILE_DIR`` trace shows what the host was doing while the
  card waited: ``qfa.fit_fused`` around a training call and, inside it
  for each call of the epoch engine, ``qfa.fit_fused.shuffle`` (the tile
  permutations drawn, and a physical reshuffle), ``qfa.epoch_kernel.launch``
  (the CUDA wrapper's checks, set-up, permutation copy and launch),
  ``qfa.fit_fused.readback`` (the wait for the device and the loss read
  back: the call's one synchronization; on one device the next chunk's
  shuffle and launch come before it), ``qfa.fit_fused.check`` (the
  non-finite test and a rollback), ``qfa.fit_fused.report`` (validation, log lines, the metrics
  callback), then ``qfa.fit_fused.smooth`` and ``qfa.fit_fused.save`` at
  their intervals; ``qfa.fused_predict`` around a prediction call, with
  ``qfa.fused_predict.launch`` around the CUDA launch (the rest of it is
  the host's preparation). A span is a ``cpu_op`` event, like an aten
  operator's, and has no mirror on the card's rows;
* :func:`timed`: a wall timer that waits for the card's queued work;
* :func:`tree_health`: NaN/Inf and magnitude summary per leaf, keyed as
  ``jax.tree_util.keystr`` keys the JAX package's;
* :func:`enable_nan_debugging`: the trainers raise ``FloatingPointError``
  on the first non-finite loss or state instead of rolling the update
  back (the JAX package's ``jax_debug_nans``);
* :func:`is_cuda`: the engine choice of the facade (``is_tpu``'s place).

``honor_cpu_request`` is not ported: it pins JAX's platform, and the
port's device is always explicit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "is_cuda",
    "span",
    "trace",
    "timed",
    "tree_health",
    "first_nonfinite",
    "nonfinite_leaf",
    "enable_nan_debugging",
    "nan_debugging",
    "raise_if_nonfinite",
]

_NAN_DEBUG = False


def is_cuda(device=None) -> bool:
    """Whether a card is visible and ``device`` (when given) is a CUDA
    device: the facade's engine choice, as ``is_tpu`` is the JAX
    package's."""
    return torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")


@contextlib.contextmanager
def trace(log_dir: str, *, device=None) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` and write its trace into
    ``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``, the TensorBoard
    plugin's layout). Records CPU activity, and the card's when
    ``device`` is CUDA (default: when a card is visible). A warm-up step
    is traced first and dropped: a trace that starts right before the
    work loses the device events of its first launches now and then."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        schedule,
        tensorboard_trace_handler,
    )

    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    warm = torch.zeros(256, device=dev)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        for _ in range(8):
            warm.add_(1.0)
        if cuda:
            torch.cuda.synchronize(warm.device)
        prof.step()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(warm.device)
            prof.step()


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a host range while
    ``torch.profiler`` is on (:func:`trace`, ``RUNTIME.PROFILE_DIR``), on
    the clock of the card's events; with the profiler off, one shared
    no-op (the cost of a flag test). The range is a ``cpu_op`` event, not
    a ``record_function`` annotation: an annotation is mirrored onto the
    card's rows over the kernels launched inside it, where it would read
    as device work."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str = "", sink=print) -> Iterator[dict]:
    """Wall-clock a block; at its exit wait for the current CUDA device's
    queued work (when CUDA is in use) so the seconds include it."""
    record: dict = {"label": label}
    t0 = time.perf_counter()
    try:
        yield record
    finally:
        _sync()
        record["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink(f"[timed] {label}: {record['seconds']:.4f}s")


def _leaves(tree: Any, path: str) -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, NamedTuple and ``QFAParams`` fields as ``.name``, sequences
    as ``[i]``, a dataclass (the train state) by its fields' positions,
    None an empty subtree."""
    from ..models.params import PARAM_NAMES, QFAParams

    if tree is None:
        return
    if isinstance(tree, QFAParams):
        for k in PARAM_NAMES:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for i, f in enumerate(dataclasses.fields(tree)):
            yield from _leaves(getattr(tree, f.name),
                               f"{path}[<flat index {i}>]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def tree_health(tree: Any) -> dict:
    """Per-leaf finiteness and magnitude summary (on the host): ``{path:
    {"shape", "finite", "absmax", "absmean"}}``, with the JAX package's
    keys for the same structure."""
    out = {}
    for name, leaf in _leaves(tree, ""):
        arr = _host(leaf)
        out[name] = {
            "shape": list(arr.shape),
            "finite": bool(np.isfinite(arr).all()),
            "absmax": float(np.max(np.abs(arr))) if arr.size else 0.0,
            "absmean": float(np.mean(np.abs(arr))) if arr.size else 0.0,
        }
    return out


def first_nonfinite(tree: Any) -> str | None:
    """The path of the first leaf holding a NaN or Inf, or None. One host
    sync for all the tensor leaves."""
    leaves = list(_leaves(tree, ""))
    tensors = [x for _, x in leaves if isinstance(x, torch.Tensor)]
    flags = iter(torch.stack([
        torch.isfinite(x.detach()).all().to(tensors[0].device)
        for x in tensors]).tolist() if tensors else [])
    for name, leaf in leaves:
        ok = next(flags) if isinstance(leaf, torch.Tensor) \
            else bool(np.isfinite(np.asarray(leaf, np.float64)).all())
        if not ok:
            return name
    return None


def enable_nan_debugging(enable: bool = True) -> None:
    """Fail fast on NaN or Inf: while on, ``train.fit_fused``, ``fit``
    and ``fit_streaming`` check the loss and the state once per epoch (or
    call of the epoch engine) and raise ``FloatingPointError`` naming the
    first non-finite leaf where they would otherwise reject the update;
    ``fit`` and ``fit_streaming`` also run under
    ``torch.autograd.detect_anomaly`` (its own check after every backward
    operation, with the forward's stack). Off (the default), they add
    nothing."""
    global _NAN_DEBUG
    _NAN_DEBUG = bool(enable)


def nan_debugging() -> bool:
    """Whether :func:`enable_nan_debugging` is on."""
    return _NAN_DEBUG


def nonfinite_leaf(**trees) -> str | None:
    """``name + path`` of the first non-finite leaf of the trees, in the
    order given (``nonfinite_leaf(params=p)`` -> ``"params.F"``), or
    None."""
    for name, tree in trees.items():
        bad = first_nonfinite(tree)
        if bad is not None:
            return name + bad
    return None


def raise_if_nonfinite(where: str, losses, **trees) -> None:
    """With NaN debugging on, raise ``FloatingPointError`` naming the
    first non-finite leaf of ``trees`` (in the order given: the cause
    before its effect), then of ``losses``; nothing when it is off."""
    if not _NAN_DEBUG:
        return
    bad = nonfinite_leaf(**trees, loss=losses)
    if bad is not None:
        raise FloatingPointError(
            f"invalid value (nan or inf) encountered in {where}: first "
            f"non-finite leaf {bad}")

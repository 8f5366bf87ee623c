"""One driver per kind of traffic (``"kind"`` in the traffic file):
``train`` or ``predict``. A driver builds the system under test
from the configuration, the traffic and the seed, warms it up, runs the
window, and judges what the window produced against the reference."""

from __future__ import annotations

import importlib

import torch


def driver(kind: str):
    """The driver class of a traffic kind."""
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Base:
    """What every driver keeps: the cell's files, the seed, a scratch
    directory, the device, and after the window its stats."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 workdir: str, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self.stats: dict = {}

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float, span) -> dict:
        """Run for ``seconds``; ``span(name)`` wraps each call into the
        program (a profiler range in a traced run). Returns the stats the
        end-to-end metrics and the metric readers read."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state, keeping what the check judges."""

    def check(self, control: str | None = None) -> dict:
        """The numbers compared: the window's outputs against the
        reference, or with ``control`` the control against it."""
        raise NotImplementedError

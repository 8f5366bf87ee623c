"""Configuration: yaml-backed frozen config nodes.

The same schema and workflow as ``qfa_tpu.config`` (a nested
``ConfigNode`` with attribute access, recursive ``BASE`` yaml inheritance,
``KEY.SUBKEY value`` overrides, freezing), so the JAX package's yaml files
load unchanged. One key is new: ``RUNTIME.DEVICE``, the torch device
(``--device``). ``default_config`` is plain Python; ``yaml`` is imported
only to read a ``--cfg`` file, and ``config.yaml`` dumps are written by a
small emitter here, since the GPU machine may not have pyyaml.
"""

from __future__ import annotations

import copy
import json
import math
import os
from typing import Any

__all__ = ["ConfigNode", "default_config", "load_config", "get_config"]


class ConfigNode(dict):
    """A dict with attribute access, freezing, and yaml merge support."""

    _FROZEN = "_ConfigNode__frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value):
        if getattr(self, ConfigNode._FROZEN):
            raise AttributeError(f"config is frozen; cannot set {name!r}")
        super().__setitem__(name, value)

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def merge_dict(self, other: dict) -> None:
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], ConfigNode)
                and isinstance(v, dict)
            ):
                self[k].merge_dict(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        """Merge a yaml file, honoring recursive ``BASE`` inheritance
        (paths relative to the including file)."""
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        for base in loaded.pop("BASE", []) or []:
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(path), base))
        self.merge_dict(loaded)

    def merge_from_list(self, opts: list) -> None:
        """Merge ``[KEY.SUBKEY, value, ...]`` pairs (CLI ``--opts``)."""
        if len(opts) % 2:
            raise ValueError(f"--opts needs KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf)
            node[leaf] = _coerce(value, old)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v
            for k, v in self.items()
        }

    def dump(self) -> str:
        """The config as block-style YAML (``yaml.safe_load`` reads it back
        to :meth:`to_dict`)."""
        return "".join(_yaml_lines(self.to_dict(), 0))


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        # YAML 1.1 floats need a dot in the mantissa: 1e-05 -> 1.0e-05
        if "e" in r and "." not in r:
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    return json.dumps(str(v))  # a double-quoted YAML string


def _yaml_lines(d: dict, indent: int):
    pad = " " * indent
    for k, v in d.items():
        if isinstance(v, dict) and v:
            yield f"{pad}{k}:\n"
            yield from _yaml_lines(v, indent + 2)
        else:
            yield f"{pad}{k}: {'{}' if isinstance(v, dict) else _yaml_scalar(v)}\n"


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a string override to the type of the existing value."""
    if not isinstance(value, str) or old is None:
        return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return value


def default_config() -> ConfigNode:
    """The JAX package's defaults key for key, plus ``RUNTIME.DEVICE``.

    Keys that only the training half reads are kept so that one yaml file
    serves both packages.
    """
    return ConfigNode(
        {
            "BASE": [""],
            "TYPE": "train",
            "SEED": 0,
            "DATA": {
                "DATA_DIR": "",
                "VALIDATION_DIR": "",
                "OUTPUT_DIR": "output",
                "CATALOG": "",
                "VALIDATION_CATALOG": "",
                "DATA_NUM": 10000,
                "VALIDATION_NUM": 1000,
                "BATCH_SIZE": 500,
                "SNR_MIN": 2.0,
                "SNR_MAX": 100.0,
                "Z_MIN": 2.0,
                "Z_MAX": 3.5,
                "NUM_MASK": 0,
                "LAMMIN": 1030.0,
                "LAMMAX": 1600.0,
                "LOGLAM_DELTA": 1e-4,
                "NPROCS": 16,
                "VALIDATION": False,
                "VALIDATION_CONCAT_COMPAT": False,
            },
            "MODEL": {
                "NH": 8,
                "TAU": "becker",
                "RESUME": "",
                "COMPAT_C0_BUG": False,
            },
            "TRAIN": {
                "NEPOCHS": 500,
                "LEARNING_RATE": 1e-3,
                "WEIGHT_DECAY": 1e-1,
                "DECAY_ALPHA": 0.9,
                "DECAY_STEP": 10,
                "WINDOW_LENGTH_FOR_MU": 16,
                "SMOOTH_INTERVAL": 5,
                "SAVE_INTERVAL": 5,
                "REFERENCE_NORM": True,
                "AUTO_RESUME": True,
                #: "auto"/"pallas" take the fused CUDA prediction kernel
                #: when RUNTIME.DEVICE is a CUDA device; otherwise (and for
                #: "xla") the plain torch path.
                "ENGINE": "auto",
                "BF16_PLANES": False,
                "MXU_BF16": True,
                "BWD_WIDE": False,
                "EPOCHS_PER_LAUNCH": 1,
                "DP_EXACT": False,
                "BATCHES_PER_LAUNCH": 1,
            },
            "MESH": {
                "DATA_AXIS": -1,
            },
            "RUNTIME": {
                "DEBUG_NANS": False,
                "PROFILE_DIR": "",
                #: predict mode: one consolidated predictions.npz instead
                #: of one file per spectrum.
                "CONSOLIDATED_PREDICT": False,
                #: torch device of the run (``--device``): "cuda" requires
                #: a visible GPU and never falls back to the CPU.
                "DEVICE": "cuda",
            },
        }
    )


def load_config(
    cfg_file: str | None = None, opts: list | None = None
) -> ConfigNode:
    """Build the frozen run config from defaults + yaml + overrides."""
    cfg = default_config()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg.freeze()


def get_config(args) -> ConfigNode:
    """argparse-namespace entry point: yaml first, then ``--opts``, then
    individual CLI flags."""
    cfg = default_config()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        cfg.merge_from_list(list(args.opts))

    flag_map = {
        "type": ("TYPE",),
        "seed": ("SEED",),
        "n_epochs": ("TRAIN", "NEPOCHS"),
        "learning_rate": ("TRAIN", "LEARNING_RATE"),
        "weight_decay": ("TRAIN", "WEIGHT_DECAY"),
        "decay_alpha": ("TRAIN", "DECAY_ALPHA"),
        "decay_step": ("TRAIN", "DECAY_STEP"),
        "data_dir": ("DATA", "DATA_DIR"),
        "validation_dir": ("DATA", "VALIDATION_DIR"),
        "output_dir": ("DATA", "OUTPUT_DIR"),
        "catalog": ("DATA", "CATALOG"),
        "validation_catalog": ("DATA", "VALIDATION_CATALOG"),
        "data_num": ("DATA", "DATA_NUM"),
        "validation_num": ("DATA", "VALIDATION_NUM"),
        "batch_size": ("DATA", "BATCH_SIZE"),
        "snr_min": ("DATA", "SNR_MIN"),
        "snr_max": ("DATA", "SNR_MAX"),
        "z_min": ("DATA", "Z_MIN"),
        "z_max": ("DATA", "Z_MAX"),
        "num_mask": ("DATA", "NUM_MASK"),
        "nprocs": ("DATA", "NPROCS"),
        "validation": ("DATA", "VALIDATION"),
        "nh": ("MODEL", "NH"),
        "tau": ("MODEL", "TAU"),
        "resume": ("MODEL", "RESUME"),
        "device": ("RUNTIME", "DEVICE"),
    }
    for flag, path in flag_map.items():
        value = getattr(args, flag, None)
        # `is not None`: explicit falsy values (--z_min 0) override too
        if value is not None:
            node = cfg
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = value
    return cfg.freeze()

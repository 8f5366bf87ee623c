"""The port's top-level API against the JAX package's: every name that
``qfa_tpu`` and ``qfa_tpu.models`` export, the port exports, with the
same values where they are data; ``import qfa_tpu_torch`` loads no JAX
and builds no kernel (checked in a fresh interpreter)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import qfa_tpu
import qfa_tpu.models
import qfa_tpu_torch
import qfa_tpu_torch.models
from qfa_tpu.models import DEFAULT_BOUNDS as JAX_DEFAULT_BOUNDS
from qfa_tpu.models import num_params as jax_num_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("jax_mod, port_mod", [
    (qfa_tpu, qfa_tpu_torch), (qfa_tpu.models, qfa_tpu_torch.models)],
    ids=["top", "models"])
def test_every_jax_export_exists_in_the_port(jax_mod, port_mod):
    missing = [n for n in jax_mod.__all__ if not hasattr(port_mod, n)]
    assert missing == []
    assert set(jax_mod.__all__) <= set(port_mod.__all__)
    subpackages = {n for n in jax_mod.__all__
                   if type(getattr(jax_mod, n)).__name__ == "module"}
    for n in subpackages:
        assert getattr(port_mod, n).__name__ == \
            f"{port_mod.__name__}.{n}", n


def test_the_top_level_names_are_the_ported_objects():
    from qfa_tpu_torch import config, data, models

    assert qfa_tpu_torch.QFAParams is models.params.QFAParams
    assert qfa_tpu_torch.load_config is config.load_config
    assert qfa_tpu_torch.make_grid is data.grid.make_grid
    assert qfa_tpu_torch.SpectraBatch is data.batch.SpectraBatch
    assert qfa_tpu_torch.loss_and_grads is models.qfa.loss_and_grads
    assert qfa_tpu_torch.smooth_params is models.params.smooth_params
    grid = qfa_tpu_torch.make_grid()
    assert (grid.npix, grid.nb) == (qfa_tpu.make_grid().npix,
                                    qfa_tpu.make_grid().nb)


def test_num_params_and_default_bounds_match_jax():
    for shape in ((1913, 720, 8), (9243, 2238, 10), (54, 25, 3)):
        assert qfa_tpu_torch.models.num_params(*shape) == \
            jax_num_params(*shape)
    assert tuple(qfa_tpu_torch.models.DEFAULT_BOUNDS) == \
        tuple(JAX_DEFAULT_BOUNDS)
    assert qfa_tpu_torch.models.DEFAULT_BOUNDS._fields == \
        JAX_DEFAULT_BOUNDS._fields
    p = qfa_tpu_torch.random_init(6, 3, 2,
                                  generator=torch.Generator().manual_seed(0))
    d = p.as_dict()
    assert list(d) == list(qfa_tpu.random_init(
        __import__("jax").random.key(0), 6, 3, 2).as_dict())
    assert sum(int(np.prod(v.shape)) for v in d.values()) == \
        qfa_tpu_torch.models.num_params(6, 3, 2)
    assert not any(v.requires_grad for v in d.values())


def test_import_loads_no_jax_and_builds_nothing():
    code = textwrap.dedent("""
        import sys
        import qfa_tpu_torch
        from qfa_tpu_torch import compat, native
        from qfa_tpu_torch.models import mdn
        from qfa_tpu_torch.ops import _build
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "optax",
                                            "qfa_tpu"))
        print(bad, _build._LIB is None, native._lib is None,
              native._build_error is None, len(qfa_tpu_torch.__all__))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True", "True", "True",
                                  str(len(qfa_tpu.__all__))]

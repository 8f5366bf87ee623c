"""The generators are seeded and repeatable at tiny sizes."""

from __future__ import annotations

import pytest
import torch

from portbench import gen
from portbench.tests.conftest import tiny_grid

CFG = tiny_grid({"name": "tiny"})
TRAFFIC = {"z_range": [2.0, 3.5], "error_range": [0.05, 0.5],
           "mask_frac": 0.1}


def draw(seed, residual=False):
    grid = gen.make_grid(CFG)
    return gen.spectra(300, grid, 4, seed, "cpu", TRAFFIC, residual=residual,
                       chunk=128)


@pytest.mark.parametrize("residual", [False, True])
def test_spectra_repeat_for_a_seed_and_differ_across_seeds(residual):
    a, b, c = draw(2**40 + 3, residual), draw(2**40 + 3, residual), \
        draw(5, residual)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_masked_chunk_is_zero_in_both_planes():
    flux, error, zqso, mu = draw(11)
    masked = error == 0
    span = max(int(0.1 * CFG["npix"]), 1)
    assert torch.all(masked.sum(dim=1) == span)
    assert torch.all(flux[masked] == 0)
    assert torch.all((zqso >= 2.0) & (zqso <= 3.5))


def test_params_repeat_for_a_seed():
    grid = gen.make_grid(CFG)
    a = gen.model_params(grid, 4, 9, "cpu")
    b = gen.model_params(grid, 4, 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["F"].abs().max()) <= 0.5


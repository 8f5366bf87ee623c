"""qfa_tpu_torch.models.params against qfa_tpu.models.params: checkpoints
written by either package load bit-exactly in the other, including the
compat_c0_bug flag, and from_numpy/to_numpy convert losslessly."""

import jax
import numpy as np
import pytest
import torch

from qfa_tpu.models import load_npz as jax_load_npz
from qfa_tpu.models import num_params as jax_num_params
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.models import save_npz as jax_save_npz
from qfa_tpu_torch.models.params import (
    PARAM_NAMES,
    QFAParams,
    load_npz,
    random_init,
    save_npz,
)

NPIX, NB, NH = 40, 15, 5


def jax_params():
    p = jax_random_init(jax.random.key(7), NPIX, NB, NH)
    rng = np.random.default_rng(7)
    return p._replace(
        Psi=rng.uniform(0.01, 1.0, NPIX).astype(np.float32),
        omega=rng.uniform(0.01, 1.0, NB).astype(np.float32),
        tau0=np.float32(0.17), c0=np.float32(-0.4), beta=np.float32(3.1),
    )


def test_from_numpy_to_numpy_round_trip():
    ref = {k: np.asarray(v) for k, v in jax_params().as_dict().items()}
    params = QFAParams.from_numpy(ref)
    assert isinstance(params, torch.nn.Module)
    assert [n for n, _ in params.named_parameters()] == list(PARAM_NAMES)
    assert (params.npix, params.nb, params.nh) == (NPIX, NB, NH)
    back = params.to_numpy()
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(back[k], ref[k], k)
        assert back[k].dtype == np.float32


@pytest.mark.parametrize("compat_c0_bug", [False, True])
def test_jax_checkpoint_loads_bit_exact(tmp_path, compat_c0_bug):
    path = str(tmp_path / "jax.npz")
    mu = np.linspace(0.5, 1.5, NPIX).astype(np.float32)
    jax_save_npz(path, jax_params(), mu)
    jp, jmu = jax_load_npz(path, compat_c0_bug=compat_c0_bug)
    tp, tmu = load_npz(path, compat_c0_bug=compat_c0_bug)
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(
            getattr(tp, k).detach().numpy(), np.asarray(getattr(jp, k)), k
        )
    # the compat flag puts beta into c0, as the JAX loader does
    assert (float(tp.c0.detach()) == float(tp.beta.detach())) == compat_c0_bug


def test_port_checkpoint_loads_bit_exact_in_jax(tmp_path):
    path = str(tmp_path / "sub" / "torch.npz")
    ref = {k: np.asarray(v) for k, v in jax_params().as_dict().items()}
    mu = torch.linspace(0.5, 1.5, NPIX)
    save_npz(path, QFAParams.from_numpy(ref), mu)
    with np.load(path) as f:
        assert sorted(f.files) == sorted(("mu",) + PARAM_NAMES)
        assert all(f[k].dtype == np.float32 for k in f.files)
    jp, jmu = jax_load_npz(path)
    np.testing.assert_array_equal(np.asarray(jmu), mu.numpy())
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jp, k)), ref[k], k)


def test_random_init_is_seeded_and_in_range():
    a = random_init(NPIX, NB, NH, generator=torch.Generator().manual_seed(3))
    b = random_init(NPIX, NB, NH, generator=torch.Generator().manual_seed(3))
    assert a.F.shape == (NPIX, NH) and a.omega.shape == (NB,)
    torch.testing.assert_close(a.F, b.F, rtol=0, atol=0)
    f = a.F.detach()
    assert float(f.min()) >= -0.5 and float(f.max()) < 0.5
    # the same constants as the JAX initialization
    j = jax_random_init(jax.random.key(0), NPIX, NB, NH)
    for k in ("Psi", "omega", "tau0", "c0", "beta"):
        np.testing.assert_array_equal(getattr(a, k).detach().numpy(),
                                      np.asarray(getattr(j, k)), k)
    # as many trainable values as the JAX package's num_params counts
    assert jax_num_params(NPIX, NB, NH) == \
        sum(p.numel() for p in a.parameters())

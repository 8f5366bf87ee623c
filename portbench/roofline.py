"""The yardstick's arithmetic: published peaks, and the operations and
bytes of each kernel and step computed from shapes and the stated
precision.

Counting rules: each input byte read
once and each output byte written once, whatever a kernel reads again;
the products' multiply-adds count 2 operations each; the per-pixel
exp/log/pow chain is not counted. A roofline share is the least time the
chip could take (the larger of operations / peak and bytes / bandwidth)
over the measured device time, in percent; an mfu is the model's
operations over window seconds x chips x peak, in percent.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flop_per_s": 989e12,
    "tf32_flop_per_s": 495e12,
    "fp32_flop_per_s": 67e12,
}


def peak_flops(precision: str) -> float:
    """Peak of the fastest unit that holds the stated precision of the
    products: bf16 operands on bf16 tensor cores; float32 products
    exactly on the tensor cores in three TF32 passes (495/3)."""
    if precision == "bf16":
        return PEAKS["bf16_flop_per_s"]
    if precision == "fp32":
        return PEAKS["tf32_flop_per_s"] / 3.0
    raise ValueError(f"no peak for precision {precision!r}")


def ntri(nh: int) -> int:
    return nh * (nh + 1) // 2


def epoch_flops(n_rows: int, npix: int, nh: int) -> float:
    """One epoch's products: per row and pixel the forward K triangle and
    W, the backward cotangents dw and du, and the accumulations dG and
    dF, i.e. 3 (ntri + nh) multiply-adds."""
    return 2.0 * 3 * (ntri(nh) + nh) * n_rows * npix


def params_bytes(npix: int, nb: int, nh: int) -> int:
    return 4 * (npix * nh + npix + nb + 3)


def epoch_bytes(n_rows: int, npix: int, nb: int, nh: int, tile: int,
                n_batches: int, plane_bytes: int = 4) -> float:
    """One epoch's traffic: the delta and error planes, the zq column
    (2 floats per row), the loglam row, the tile permutation, and the
    parameters and both moments read and written once; per batch a loss
    sum and a real-row count out."""
    return (plane_bytes * 2 * n_rows * npix + 4 * 2 * n_rows + 4 * npix
            + 4 * (n_rows // tile) + 6 * params_bytes(npix, nb, nh)
            + 8 * n_batches)


def predict_flops(n: int, npix: int, nh: int, stats_only: bool = False
                  ) -> float:
    """The prediction's products: K triangle and W per pixel, and with
    full output the continuum and std products again."""
    return 2.0 * (ntri(nh) + nh) * (1 if stats_only else 2) * n * npix


def predict_bytes(n: int, npix: int, nb: int, nh: int, *,
                  stats_only: bool = False, plane_bytes: int = 4,
                  out_bytes: int = 4) -> float:
    """Flux and error in, the zq column, loglam, mu and the parameters in;
    ll, n_obs, hmean, hcov out, and the continuum and std planes."""
    planes = 0 if stats_only else 2
    return (plane_bytes * 2 * n * npix + 4 * (2 * n + 2 * npix)
            + params_bytes(npix, nb, nh) + 4 * n * (2 + nh + nh * nh)
            + out_bytes * planes * n * npix)


def bound_s(flops: float, nbytes: float, precision: str
            ) -> tuple[float, str]:
    """(least seconds, which bound binds: "bytes" or "operations")."""
    t_ops = flops / peak_flops(precision)
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_pct(bound: float, device_s: float) -> float | None:
    """Share of the roofline in percent; None without a device time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * bound / device_s


def mfu_pct(flops: float, window_s: float, chips: int, precision: str
            ) -> float | None:
    if window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (window_s * chips * peak_flops(precision))

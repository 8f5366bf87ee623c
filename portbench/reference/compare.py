"""The comparisons that decide ``correct``: widest gaps between what the
timed path produced and the reference, each a plain number that the
cell's limits file bounds."""

from __future__ import annotations

import statistics

import torch


def norm(x) -> float:
    return float(torch.as_tensor(x).double().norm())


def leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple[float, dict]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    leaves = list(ref) if leaves is None else list(leaves)
    nr = {k: norm(ref[k]) for k in ref}
    med = statistics.median(nr.values())
    gaps = {k: abs(norm(prog[k]) - nr[k]) / max(nr[k], med, 1e-300)
            for k in leaves}
    return max(gaps.values()), gaps


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least ``share`` of the median leaf's."""
    nr = {k: norm(v) for k, v in ref_grad.items()}
    med = statistics.median(nr.values())
    return [k for k, v in nr.items() if v >= share * med]


class PredictGaps:
    """Widest gaps over blocks of predictions, each in the scale of the
    quantity: ll over max(|ll|, 1), hmean over its posterior std, hcov
    over sqrt(hcov_ii hcov_jj), continuum and std over the std; n_obs
    exactly."""

    NAMES = ("ll", "n_obs", "hmean", "hcov", "continuum", "continuum_std")

    def __init__(self):
        self.gap = {k: 0.0 for k in self.NAMES}

    def add(self, prog: dict, ref: dict) -> None:
        def d(k):
            return (prog[k].to(ref[k].device).double() - ref[k].double()).abs()

        r = {k: v.double() for k, v in ref.items()}
        var = torch.diagonal(r["hcov"], dim1=-2, dim2=-1).clamp(min=1e-300)
        vals = {
            "ll": d("ll") / r["ll"].abs().clamp(min=1.0),
            "n_obs": d("n_obs"),
            "hmean": d("hmean") / var.sqrt(),
            "hcov": d("hcov") / (var[..., :, None] * var[..., None, :]).sqrt(),
        }
        if "continuum" in prog:  # full output
            std = r["continuum_std"].clamp(min=1e-300)
            vals["continuum"] = d("continuum") / std
            vals["continuum_std"] = d("continuum_std") / std
        for k, v in vals.items():
            if v.numel():
                m = float(torch.nan_to_num(v, nan=float("inf")).max())
                self.gap[k] = max(self.gap[k], m)

    def numbers(self) -> dict:
        return {f"{k}_gap": v for k, v in self.gap.items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every number is finite
    and at most its limit (a number with no limit fails)."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        good = lim is not None and v == v and v <= lim
        ok &= good
        out[k] = {"value": v, "limit": lim}
    return ok, out

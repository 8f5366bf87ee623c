"""predict_spectra_per_s: spectra predicted in the window's whole sweeps
over the window's seconds (host clock)."""


def read(ctx):
    s = ctx.stats
    if "sweeps" not in s:
        return None
    return s["rows"] * s["sweeps"] / s["window_s"]

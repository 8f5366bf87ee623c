"""train_spectra_per_s: spectra x epochs completed in the window over the
window's seconds (host clock)."""


def read(ctx):
    s = ctx.stats
    if "epochs" not in s:
        return None
    return s["rows"] * s["epochs"] / s["window_s"]

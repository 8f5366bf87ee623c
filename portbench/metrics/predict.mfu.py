"""predict.mfu: the model's operations in the window's sweeps (K triangle
and W, and with full output the continuum and std products) over window
seconds x chips x the peak at the stated precision, in percent."""

from portbench import roofline


def read(ctx):
    s, c, t = ctx.stats, ctx.cell.config, ctx.cell.traffic
    if not s.get("sweeps"):
        return None
    flops = roofline.predict_flops(s["rows"], c["npix"], c["nh"],
                                   t["stats_only"]) * s["sweeps"]
    return roofline.mfu_pct(flops, s["window_s"], ctx.chips,
                            c["precision"]["predict_products"])

"""predict_kernel_roofline: the least time of the window's sweeps on the
prediction kernel (flux and error in, the stats, continuum and std out,
4 bytes each per pixel; the products at the stated precision) over the
device time of its launches in the trace, in percent."""

from portbench import roofline


def read(ctx):
    s, c, t = ctx.stats, ctx.cell.config, ctx.cell.traffic
    if ctx.trace is None or not s.get("sweeps"):
        return None
    device = ctx.trace.union_s(lambda n: "predict" in n and "kernel" in n)
    bound, which = roofline.bound_s(
        roofline.predict_flops(s["rows"], c["npix"], c["nh"], t["stats_only"]),
        roofline.predict_bytes(s["rows"], c["npix"], c["nb"], c["nh"],
                               stats_only=t["stats_only"]),
        c["precision"]["predict_products"])
    pct = roofline.roofline_pct(bound * s["sweeps"], device)
    ctx.say(f"predict_kernel_roofline: {bound * 1e3:.4f} ms per sweep "
            f"({which} bound) against {device / s['sweeps'] * 1e3:.4f} ms "
            f"on the device; card {ctx.card}")
    return pct

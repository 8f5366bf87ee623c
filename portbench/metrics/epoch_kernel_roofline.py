"""epoch_kernel_roofline: the least time of the window's epochs on
csrc/epoch.cu (the padded resident set, params and moments in and out;
the products at the stated precision) over the device time of its three
kernels in the trace (overlaps counted once), in percent."""

from portbench import roofline
from portbench.drivers.train import tile_of

KERNELS = ("forward_kernel", "backward_kernel", "update_kernel")


def read(ctx):
    s, c, t = ctx.stats, ctx.cell.config, ctx.cell.traffic
    if ctx.trace is None or not s.get("epochs"):
        return None
    device = ctx.trace.union_s(lambda n: any(k in n for k in KERNELS))
    b = t["batch_size"]
    n_batches = -(-s["rows"] // b)
    rows = n_batches * b
    tile = tile_of(b)
    bound, which = roofline.bound_s(
        roofline.epoch_flops(rows, c["npix"], c["nh"]),
        roofline.epoch_bytes(rows, c["npix"], c["nb"], c["nh"], tile,
                             n_batches),
        c["precision"]["train_products"])
    pct = roofline.roofline_pct(bound * s["epochs"], device)
    ctx.say(f"epoch_kernel_roofline: {bound * 1e3:.4f} ms per epoch "
            f"({which} bound) against {device / s['epochs'] * 1e3:.4f} ms "
            f"on the device; card {ctx.card}")
    return pct

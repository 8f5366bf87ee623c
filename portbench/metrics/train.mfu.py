"""train.mfu: the model's operations in the window's epochs (every real
row and pixel, 3 (ntri + nh) multiply-adds) over window seconds x chips x
the peak at the stated precision of the products, in percent."""

from portbench import roofline


def read(ctx):
    s, c = ctx.stats, ctx.cell.config
    if "epochs" not in s or not s["epochs"]:
        return None
    flops = roofline.epoch_flops(s["rows"], c["npix"], c["nh"]) * s["epochs"]
    return roofline.mfu_pct(flops, s["window_s"], ctx.chips,
                            c["precision"]["train_products"])

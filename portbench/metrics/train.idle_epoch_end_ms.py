"""train.idle_epoch_end_ms: the device-idle ms per epoch in which the
host was inside ``qfa.fit_fused.readback`` (the loss read back: the
epoch's one synchronization), ``.check`` (the non-finite test) or
``.report`` (validation, log lines, the metrics callback)."""

from portbench import idle


def read(ctx):
    return idle.train_phase(ctx, "train.idle_epoch_end_ms")

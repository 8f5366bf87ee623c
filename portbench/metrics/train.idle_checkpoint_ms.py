"""train.idle_checkpoint_ms: the device-idle ms in which the host was
inside ``qfa.fit_fused.smooth`` or ``qfa.fit_fused.save`` (every few
epochs), spread over all the window's epochs."""

from portbench import idle


def read(ctx):
    return idle.train_phase(ctx, "train.idle_checkpoint_ms")

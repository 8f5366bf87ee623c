"""train.idle_other_ms: the device-idle ms per epoch that no phase of
``portbench.idle.TRAIN_PHASES`` holds: the host in no ``qfa.*`` span, or
in ``qfa.fit_fused``'s own time. The five ``train.idle_*_ms`` sum to
``train.idle_share`` / 100 x the traced window / its epochs."""

from portbench import idle


def read(ctx):
    return idle.train_phase(ctx, "train.idle_other_ms")

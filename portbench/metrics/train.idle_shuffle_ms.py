"""train.idle_shuffle_ms: the device-idle ms per epoch in which the host was
inside ``qfa.fit_fused.shuffle``: the tile permutations drawn on the CPU
and stacked (and a physical reshuffle, when one is due)."""

from portbench import idle


def read(ctx):
    return idle.train_phase(ctx, "train.idle_shuffle_ms")

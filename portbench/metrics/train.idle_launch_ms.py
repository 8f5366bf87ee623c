"""train.idle_launch_ms: the device-idle ms per epoch in which the host was
inside ``qfa.epoch_kernel.launch``: the CUDA wrapper's argument checks,
the kernel's set-up, the permutation's copy to the card and the launch."""

from portbench import idle


def read(ctx):
    return idle.train_phase(ctx, "train.idle_launch_ms")

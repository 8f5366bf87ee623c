"""predict.idle_call_ms: the device-idle ms per sweep in which the host
was inside ``qfa.fused_predict`` (the call's checks, reads, output
allocation and tables) or its child ``qfa.fused_predict.launch``."""

from portbench import idle


def read(ctx):
    return idle.predict_call(ctx)

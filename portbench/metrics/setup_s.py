"""setup_s: seconds from the process's start to the window (imports,
kernel build or load, inputs, warm-up; host clock)."""


def read(ctx):
    return ctx.setup_s

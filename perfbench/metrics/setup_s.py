"""Set-up: process start to the first timed unit (imports, the CUDA context,
weights and inputs, kernel builds where none is cached, warm-up units)."""


def read(run):
    return run.setup_s

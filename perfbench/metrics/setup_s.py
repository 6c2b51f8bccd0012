"""Set-up seconds: process start to the end of the warm pass (imports, the
kernel library, weights, engine, the cell's own shapes once)."""


def read(run):
    return run.setup_s

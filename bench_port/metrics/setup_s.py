"""Process start to the first timed request: imports, CUDA start, data, the
port's Matrix build and the warm-up requests (and, in a checkout's first
run, the kernel build)."""


def read(run):
    return run.setup_s

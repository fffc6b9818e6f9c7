"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernel library's build or load, the sequence's
rendering, the system's construction (vocabulary) and the set-up frames."""

NAME = "setup_s"
UNIT = "s"
SOURCE = "host_clock"
READS = "the host clock at the process's start and at the window's start"


def read(run):
    return run.setup_s

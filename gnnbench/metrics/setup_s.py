"""setup_s: seconds from the process's start to the end of warm-up:
generating the graph and weights, loading the program, building its
kernels (on a checkout's first run), compiling and warming up. The
benchmark's profiler, started after it where the cell reads the device
trace, is not the program's set-up and is not counted."""


def read(run):
    return run.setup_s

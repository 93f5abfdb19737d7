"""setup_s: seconds from the process's start to the window's opening:
generating the graph and weights, loading the program, building its
kernels (on a checkout's first run), compiling and warming up."""


def read(run):
    return run.setup_s

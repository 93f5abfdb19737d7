"""idle_untraced.infer (device): the share, in %, of the traced window's
device-idle time that no span of the program covers, on any thread: what
the program's spans leave unexplained (the client's side of the closed
loop, the server thread's idle polls, whatever runs outside the
program)."""
from gnnbench.harness import spans


def read(run):
    return spans.untraced_idle(run)

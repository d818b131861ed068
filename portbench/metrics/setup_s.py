"""setup_s: from the start of the process to the start of the window (the
program's import, frames, weights drawn on the card, models built, kernels
loaded or built, warm-up chunks)."""

NAME = "setup_s"
UNIT = "s"


def read(run):
    return run.setup_s

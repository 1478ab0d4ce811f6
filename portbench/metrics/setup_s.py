"""setup_s: process start to the window's start (imports, weights made on
the card, the program built, nvcc where the build directory is empty, and
every shape of the cell's traffic warmed), host clock."""


def read(run):
    return run.setup_s

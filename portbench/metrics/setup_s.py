"""Seconds from the process's start to the window's: imports, the CUDA
context, the library's build or load, the inputs, the warm-up calls and,
in a traced run, the traced stretch."""


def read(run):
    return run.window.setup_s

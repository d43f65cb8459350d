"""Seconds from the process's start to the window's: imports, the
inputs drawn and made, the port's build or load of its kernels, and the
warm unit."""


def read(run, res):
    return res["setup_s"]

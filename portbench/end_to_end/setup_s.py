"""setup_s (s): from the start of the process to the start of the window:
imports, the scene, the kernels' build or load, the warm-up calls."""


def read(w):
    return w.setup_s

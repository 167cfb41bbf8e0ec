"""setup_s (s): from the start of the benchmark's process to the window's
start: imports, kernel builds, rendering the lap, the tracker's
initialization on the host path and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s

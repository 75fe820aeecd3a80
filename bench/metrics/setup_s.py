"""The whole set-up: from the process's start (before torch is imported)
to the window's start: data made on the device, the kernels loaded (built
on a checkout's first run), graphs captured, every budget warmed."""


def read(run):
    return run.setup_s

"""Neural-frame rays (width x height x spp of every completed call) over
the window's host-clock seconds, in millions a second."""


def read(run):
    return run.work_per_call * run.calls / run.window_s / 1e6

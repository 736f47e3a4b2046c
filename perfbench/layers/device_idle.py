"""The share of the traced window in which no device operation ran, in %
(busy time is the union of the device operations' intervals). Where the
host paces the calls, as in the viewer's frame, the profiler's host cost
lengthens the window and so raises this share above an untraced run's."""


def read(tr):
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

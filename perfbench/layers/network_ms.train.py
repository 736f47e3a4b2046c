"""Device ms a step of the training network (`ops/lane_grid_train_kernel.py`):
K2 in its training layout and K6's two passes."""

KERNELS = ("lane_grid_forward_kernel", "lane_grid_backward_rays",
           "lane_grid_backward_dw")


def read(tr):
    s = tr.kernel_s(KERNELS)
    return s * 1e3 / tr.calls if s > 0.0 else None

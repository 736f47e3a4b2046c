"""Device ms a call of the trace kernels (`ops/traversal.py`,
`ops/trace_cluster.py`, `ops/trace_pallas.py`, `ops/trace_mxu.py`): K1,
K3, K4, K5, their matrix forms and the slice folds and orderings they
launch."""

KERNELS = ("trace_dense_kernel", "sweep_dense_kernel", "nr_dense_fold",
           "nr_trace_cluster_items", "nr_trace_cluster_passengers",
           "nr_trace_cluster_order", "nr_sweep_cluster_items",
           "trace_dense_mxu_kernel", "sweep_dense_mxu_kernel",
           "nr_dx_features")


def read(tr):
    s = tr.kernel_s(KERNELS)
    return s * 1e3 / tr.calls if s > 0.0 else None

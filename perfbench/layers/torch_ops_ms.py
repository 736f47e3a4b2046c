"""Device ms a call of the kernels that are PyTorch's, its libraries' or
copies: the frame, march and bounces in plain PyTorch
(`render/neural_frame.py`, `render/neural_march.py`,
`render/pathtrace.py`, `ops/brdf.py`, `ops/envlight.py`)."""


def read(tr):
    s = tr.library_s()
    return s * 1e3 / tr.calls if s > 0.0 else None

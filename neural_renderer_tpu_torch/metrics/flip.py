"""FLIP perceptual metric in PyTorch.

Port of `neural_renderer_tpu/metrics/flip.py`, the published LDR-FLIP
algorithm (Andersson et al. 2020): YCxCz color pipeline with CSF spatial
filtering and Hunt-adjusted L*a*b* HyAB differences, combined with edge and
point feature differences. The default pixels-per-degree is the monitor
geometry 0.7 m distance, 3840 px, 0.7 m wide. Convolutions are
`torch.nn.functional.conv2d` over an edge-replicated image, in full float32
on any device. The error visualization uses this module's own 256-entry
Magma table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .image_io import encode_png


def calculate_ppd(monitor_distance: float = 0.7, resolution_x: float = 3840.0,
                  monitor_width: float = 0.7) -> float:
    """Pixels per degree."""
    return monitor_distance * (resolution_x / monitor_width) * (math.pi / 180.0)


_LINRGB2XYZ = np.array([
    [10135552.0 / 24577794.0, 8788810.0 / 24577794.0, 4435075.0 / 24577794.0],
    [2613072.0 / 12288897.0, 8788810.0 / 12288897.0, 887015.0 / 12288897.0],
    [1425312.0 / 73733382.0, 8788810.0 / 73733382.0, 70074185.0 / 73733382.0],
], dtype=np.float64)
_D65 = np.array([0.950428545, 1.000000000, 1.088900371], dtype=np.float64)


def _const(a, like):
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((torch.clamp(c, min=0.0) + 0.055) / 1.055,
                                 2.4))


def linrgb_to_xyz(c):
    return torch.einsum("...c,rc->...r", c, _const(_LINRGB2XYZ, c))


def xyz_to_linrgb(c):
    return torch.einsum("...c,rc->...r", c,
                        _const(np.linalg.inv(_LINRGB2XYZ), c))


def xyz_to_ycxcz(c):
    n = c / _const(_D65, c)
    y = 116.0 * n[..., 1] - 16.0
    cx = 500.0 * (n[..., 0] - n[..., 1])
    cz = 200.0 * (n[..., 1] - n[..., 2])
    return torch.stack([y, cx, cz], dim=-1)


def ycxcz_to_xyz(c):
    yy = (c[..., 0] + 16.0) / 116.0
    x = yy + c[..., 1] / 500.0
    z = yy - c[..., 2] / 200.0
    return torch.stack([x, yy, z], dim=-1) * _const(_D65, c)


def xyz_to_lab(c):
    n = c / _const(_D65, c)
    delta = 6.0 / 29.0
    f = torch.where(n > delta ** 3,
                    torch.pow(torch.clamp(n, min=1e-20), 1.0 / 3.0),
                    n / (3.0 * delta * delta) + 4.0 / 29.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def srgb_to_ycxcz(c):
    return xyz_to_ycxcz(linrgb_to_xyz(srgb_to_linear(c)))


def linrgb_to_lab(c):
    return xyz_to_lab(linrgb_to_xyz(c))


def hunt_adjustment(lab):
    l = lab[..., 0]
    return torch.stack([l, 0.01 * l * lab[..., 1], 0.01 * l * lab[..., 2]],
                       dim=-1)


def hyab(a, b):
    d = a - b
    return torch.abs(d[..., 0]) + torch.sqrt(d[..., 1] ** 2 + d[..., 2] ** 2)


_CSF_PARAMS = {  # channel: (a1, b1, a2, b2)
    "A": (1.0, 0.0047, 0.0, 1.0e-5),
    "RG": (1.0, 0.0053, 0.0, 1.0e-5),
    "BY": (34.1, 0.04, 13.5, 0.025),
}


def _csf_kernel(ppd: float, channel: str) -> np.ndarray:
    a1, b1, a2, b2 = _CSF_PARAMS[channel]
    # Radius from the widest Gaussian (b = 0.04), shared by all channels.
    r = int(math.ceil(3.0 * math.sqrt(0.04 / (2.0 * math.pi ** 2)) * ppd))
    coords = np.arange(-r, r + 1) / ppd
    xx, yy = np.meshgrid(coords, coords)
    z = xx * xx + yy * yy
    g = (a1 * math.sqrt(math.pi / b1) * np.exp(-math.pi ** 2 * z / b1)
         + a2 * math.sqrt(math.pi / b2) * np.exp(-math.pi ** 2 * z / b2))
    return (g / g.sum()).astype(np.float32)


def _feature_kernels(ppd: float) -> tuple[np.ndarray, np.ndarray]:
    """Edge (1st derivative of Gaussian) and point (2nd derivative) kernels,
    positive and negative halves normalized separately."""
    w = 0.082
    sd = 0.5 * w * ppd
    r = int(math.ceil(3.0 * sd))
    coords = np.arange(-r, r + 1, dtype=np.float64)
    xx, yy = np.meshgrid(coords, coords)
    g = np.exp(-(xx * xx + yy * yy) / (2.0 * sd * sd))
    edge = -xx * g
    point = (xx * xx / (sd * sd) - 1.0) * g

    def norm(k):
        pos = k[k > 0].sum()
        neg = -k[k < 0].sum()
        out = k.copy()
        if pos > 0:
            out[k > 0] /= pos
        if neg > 0:
            out[k < 0] /= neg
        return out.astype(np.float32)

    return norm(edge), norm(point)


def _conv2d_same(img, kernel):
    """img [H, W], kernel [kh, kw] (numpy); 'same' output with
    edge-replicate padding."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    x = torch.nn.functional.pad(img[None, None], (pw, pw, ph, ph),
                                mode="replicate")
    k = torch.as_tensor(np.ascontiguousarray(kernel), device=img.device)
    return torch.nn.functional.conv2d(x, k[None, None])[0, 0]


_QC = 0.7
_QF = 0.5
_PC = 0.4
_PT = 0.95


def _spatial_filter(ycxcz, ppd: float):
    """Per-channel CSF filtering, then clamp in linear RGB."""
    filtered = torch.stack([
        _conv2d_same(ycxcz[..., 0], _csf_kernel(ppd, "A")),
        _conv2d_same(ycxcz[..., 1], _csf_kernel(ppd, "RG")),
        _conv2d_same(ycxcz[..., 2], _csf_kernel(ppd, "BY"))], dim=-1)
    return torch.clamp(xyz_to_linrgb(ycxcz_to_xyz(filtered)), 0.0, 1.0)


def _redistribute_errors(de_c, cmax):
    pccmax = _PC * cmax
    lo = de_c * (_PT / pccmax)
    hi = _PT + ((de_c - pccmax) / (cmax - pccmax)) * (1.0 - _PT)
    return torch.where(de_c < pccmax, lo, hi)


@torch.no_grad()
def compute_flip_map(reference_srgb, test_srgb, ppd: float | None = None,
                     device="cuda"):
    """reference/test: [H, W, 3] float sRGB in [0, 1]. Returns the [H, W]
    error map in [0, 1] as a tensor on `device` (the card unless the caller
    passes "cpu")."""
    if ppd is None:
        ppd = calculate_ppd()
    ref = torch.as_tensor(np.asarray(reference_srgb, np.float32),
                          device=device)
    test = torch.as_tensor(np.asarray(test_srgb, np.float32), device=device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # full-f32 convolutions
    try:
        ref_ycc = srgb_to_ycxcz(ref)
        test_ycc = srgb_to_ycxcz(test)

        # Color pipeline.
        ref_hunt = hunt_adjustment(linrgb_to_lab(_spatial_filter(ref_ycc,
                                                                 ppd)))
        test_hunt = hunt_adjustment(linrgb_to_lab(_spatial_filter(test_ycc,
                                                                  ppd)))
        de_hyab = hyab(ref_hunt, test_hunt)
        green = hunt_adjustment(linrgb_to_lab(
            torch.tensor([[0.0, 1.0, 0.0]], device=device)))
        blue = hunt_adjustment(linrgb_to_lab(
            torch.tensor([[0.0, 0.0, 1.0]], device=device)))
        cmax = torch.pow(hyab(green, blue), _QC)[0]
        de_c = _redistribute_errors(torch.pow(de_hyab, _QC), cmax)

        # Feature pipeline.
        edge_k, point_k = _feature_kernels(ppd)
        y_ref = (ref_ycc[..., 0] + 16.0) / 116.0
        y_test = (test_ycc[..., 0] + 16.0) / 116.0

        def feature_mag(y, k):
            fx = _conv2d_same(y, k)
            fy = _conv2d_same(y, k.T)
            return torch.sqrt(fx * fx + fy * fy)

        de_edge = torch.abs(feature_mag(y_ref, edge_k)
                            - feature_mag(y_test, edge_k))
        de_point = torch.abs(feature_mag(y_ref, point_k)
                             - feature_mag(y_test, point_k))
        de_f = torch.pow(torch.clamp(
            torch.maximum(de_edge, de_point) * (1.0 / math.sqrt(2.0)),
            0.0, 1.0), _QF)
        return torch.pow(de_c, 1.0 - de_f)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def compute_flip(reference_u8, test_u8, ppd: float | None = None,
                 output_path: str | None = None, device="cuda"):
    """uint8 image API, computed on `device` (the card unless the caller
    passes "cpu"). Returns (mean_error, max_error); optionally saves a
    Magma-colormap visualization PNG."""
    ref = np.asarray(reference_u8).astype(np.float32) / 255.0
    test = np.asarray(test_u8).astype(np.float32) / 255.0
    err = compute_flip_map(ref[..., :3], test[..., :3], ppd,
                           device=device).cpu().numpy()
    if output_path:
        save_flip_visualization(err, output_path)
    return float(err.mean()), float(err.max())


# Magma colormap, 256 RGB entries (the matplotlib table, as uint8).
_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f030311040313040415"
    "05041706051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c"
    "100c2f110c31120d33140d35150e38160e3a170f3c180f3f1a10411b10441c1046"
    "1e10491f114b20114d2211502311522511552611572811592a115c2b115e2d1060"
    "2f1062301065321067341068350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73"
    "420f74430f75450f76470f774810784a10794b10794d117a4f117b50127b52127c"
    "53137c55137d57147d58157e5a157e5b167e5d177e5e177f60187f61187f63197f"
    "651a80661a80681b80691c806b1c806c1d806e1e816f1e81711f81731f81742081"
    "7621817721817922817a22817c23817e24817f2481812581822581842681852681"
    "8727818928818a28818c29808d29808f2a80912a80922b80942b80952c80972c7f"
    "992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317da9327c"
    "ab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70"
    "ce4070d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968"
    "de4a67e04b66e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660"
    "ec585fed595fee5b5eee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775cf9795cf97b5df97d5d"
    "fa7f5efa805efa825ffb8460fb8660fb8861fb8a62fc8c63fc8e63fc9064fc9265"
    "fc9366fd9567fd9768fd9969fd9b6afd9d6bfd9f6cfda16efda26ffda470fea671"
    "fea873feaa74feac75feae76feaf78feb179feb37bfeb57cfeb77dfeb97ffebb80"
    "febc82febe83fec085fec286fec488fec689fec78bfec98dfecb8efdcd90fdcf92"
    "fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1fde1a3fce3a5"
    "fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7fbf7b9"
    "fbf9bbfbfabdfbfcbf")


def magma_u8(values: np.ndarray) -> np.ndarray:
    """[...] floats in [0, 1] -> [..., 3] uint8 Magma colors."""
    table = np.frombuffer(bytes.fromhex(_MAGMA_HEX), np.uint8).reshape(256, 3)
    idx = np.minimum((np.clip(values, 0.0, 1.0) * 256.0).astype(np.int64),
                     255)
    return table[idx]


def save_flip_visualization(error_map: np.ndarray, path: str):
    """Magma-colormap error visualization PNG, written without a message
    (as the reference writes it)."""
    with open(path, "wb") as f:
        f.write(encode_png(magma_u8(error_map)))

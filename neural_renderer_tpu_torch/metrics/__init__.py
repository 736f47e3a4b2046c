from .flip import calculate_ppd, compute_flip, compute_flip_map
from .image_io import load_image, save_png
from .psnr import compute_psnr

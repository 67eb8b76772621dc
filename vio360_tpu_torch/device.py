"""Device choice and float32 pinning for the port's entry points.

The reference runs every matmul at full float32 precision
(``vio360_tpu/utils/precision.py``). On the card PyTorch's float32
matmuls are full precision by default, but cuDNN convolutions default
to TF32; the port pins both off explicitly. (The pyramid and Scharr
stencils are written as sliced adds, so no convolution runs anyway.)
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0``, and an error when there is no card: the
    entry points run on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by default; "
                               "pass device='cpu' (CLI: --device cpu) to run on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)


def check_kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (use the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel or plain version for device {t.device}")

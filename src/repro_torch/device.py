"""Device resolution shared by the port's entry points.

The card is the default: ``resolve("cuda")`` raises when no CUDA device is
present rather than carrying on on the CPU. Tests pass ``device="cpu"``;
the dry-run passes ``device="meta"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def attn_impl(device) -> str:
    """The attention impl an entry point serves ``device`` with: the kernels
    on any CUDA device (``"cuda"``, ``"cuda:0"``, ...) and on ``"meta"``
    (where each kernel wrapper only counts its work: the dry-run), their
    plain versions on the CPU."""
    return "cuda" if torch.device(device).type in ("cuda", "meta") \
        else "torch"


def kernel_device(t: torch.Tensor) -> bool:
    """Whether impl "cuda" takes ``t``: on a CUDA device its kernel
    launches; on ``"meta"`` its wrapper counts the kernel's work
    (``roofline/dispatch_count.py``) and launches nothing."""
    return t.is_cuda or t.is_meta

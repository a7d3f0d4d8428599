"""Device selection and float32 arithmetic shared by the port's entry
points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, ``cuda``. Asking for CUDA on a host without
    a card raises: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def float32_math():
    """Matrix products and convolutions in full float32 inside the block:
    TF32 (about three decimal digits) is switched off for both and the
    caller's settings come back afterwards. Gradients of such ops are
    computed when ``backward`` runs, so a training step wraps its backward
    pass too."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv

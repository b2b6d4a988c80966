"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the GPU. Without a
GPU that is an error naming the way out (``device="cpu"``); an entry
point never drops to the CPU on its own.
"""
import torch


def resolve_device(device=None):
    """``None`` -> ``cuda``; returns a ``torch.device``. Raises when a
    CUDA device is asked for and none is present. Also pins float32
    matmuls and convolutions to full float32 (no TF32), as the JAX
    reference computes them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Device resolution and a report of the hand kernels.

The device is always explicit: callers name it, and asking for `cuda`
where torch sees no card raises instead of carrying on on the CPU. The
CPU runs only the plain PyTorch versions of the kernels (the tests'
path)."""

import contextlib

import torch

from .ops import _build


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def on_device(device):
    """`device` as the calling thread's current card while the context
    is open (a kernel is launched on the card that is current); nothing
    on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def kernel_report() -> list:
    """One dict per hand kernel: name, CUDA source, the TPU code it
    replaces, whether this process has built and loaded it, and how
    often its wrapper launched it."""
    built = _build.loaded()
    return [dict(name=name, source=k["source"], replaces=k["replaces"],
                 built=built, launches=_build.LAUNCHES[name])
            for name, k in _build.KERNELS.items()]

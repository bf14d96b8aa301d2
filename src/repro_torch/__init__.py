"""PyTorch/CUDA port of the Pier reproduction (``src/repro`` is the reference).

The port imports ``torch``, numpy and the standard library only: never
``jax`` and never a module of ``repro``. Its kernels are written by hand in
CUDA C++ for Hopper (``repro_torch/kernels/csrc``). Which implementation
runs follows the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain PyTorch version of the same function.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import torch

# Full float32 everywhere: a float32 product on the card must not drop to
# TF32 (about three decimal digits), or the port stops agreeing with the
# reference and with its own CPU path. Matmul defaults to full precision but
# cuDNN does not, so both are set here, where the package starts.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; ``cuda`` without a GPU raises.

    There is no silent fallback: asking for the card on a machine that has
    none is an error, not a reason to carry on on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev

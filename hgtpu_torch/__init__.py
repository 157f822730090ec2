"""hgtpu_torch — the PyTorch / CUDA port of hgtpu for one NVIDIA H100.

Mirrors hgtpu's layout (``db``, ``sim``, ``utils``, ``ops``, ``align``,
``typer``, ``assemble``, ``parallel``, ``pipeline``, ``cli``, ``tools``)
and is held bit for bit against it.  It imports torch and numpy, and nothing of hgtpu or jax: the host
modules it shares with hgtpu are its own copies.

Every device function takes an explicit ``device``; ``default_device()``
is ``cuda`` when a card is present and raises otherwise: the CPU is
taken only when asked for (``device="cpu"``, or ``HGTPU_TORCH_DEVICE=cpu``
on the command line), never as a silent fallback.  The algebra is
integer-valued, so float32 products must stay exact: TF32 is off for
matmuls and convolutions alike.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """``cuda`` when a card is present; otherwise a RuntimeError that
    says how to ask for the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available; to run on the CPU pass "
        "device=\"cpu\", or on the command line set HGTPU_TORCH_DEVICE=cpu")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)

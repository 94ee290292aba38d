"""Global numeric settings (counterpart of ``warpconvnet_tpu/constants.py:122-145``)
and the default device.

Only the conv compute dtype and the low-precision-accumulation flag are
ported; algorithm modes, autotune flags and environment knobs are not.
Entry points (``Voxels.create`` and every module constructor) place their
tensors on ``DEFAULT_DEVICE``, the card, unless the caller asks for another
device; with no card they raise rather than fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"
Device = Union[str, torch.device]

_COMPUTE_DTYPE: Optional[torch.dtype] = None
_LOW_PRECISION_ACCUM = False


def _as_dtype(value: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(value, torch.dtype):
        return value
    dtype = getattr(torch, str(value), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {value!r}")
    return dtype


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE


def set_compute_dtype(value: Union[str, torch.dtype, None]) -> None:
    """Set the global conv compute dtype (e.g. ``"bfloat16"``); None keeps
    each conv's input dtype. Features and weights are cast at the conv
    boundary; accumulation stays fp32 unless low-precision accumulation is
    on."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = None if value is None else _as_dtype(value)


def get_low_precision_accum() -> bool:
    return _LOW_PRECISION_ACCUM


def set_low_precision_accum(value: bool) -> None:
    """Accumulate conv GEMMs in bf16 (the plain paths only: the CUDA
    implicit-GEMM kernel accumulates in fp32 and refuses this mode)."""
    global _LOW_PRECISION_ACCUM
    _LOW_PRECISION_ACCUM = bool(value)


def accum_dtype() -> torch.dtype:
    return torch.bfloat16 if _LOW_PRECISION_ACCUM else torch.float32


def resolve_device(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present, so that nothing lands on the CPU unless asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev

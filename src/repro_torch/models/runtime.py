"""Where the port runs: device resolution shared by every entry point.

The port has no implementation switch: the kernels dispatch on the
device their tensors live on (``kernels.ops``).  What remains of the JAX
package's ``Runtime`` knobs is the device itself.  Entry points run on
the CUDA device unless the caller asks for the CPU explicitly; asking for
nothing on a machine without a GPU is an error, never a silent CPU run.
The ``meta`` device (shapes without data) is accepted for the dry-run
(``launch.dryrun``), which counts what a step does without running it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# config dtype names -> torch dtypes (model compute and arena storage)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Turn a device spec into a ``torch.device``; raises when CUDA is
    requested (the default) but no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev

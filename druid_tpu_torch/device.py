"""The one place that decides which device the port runs on.

The counterpart of the reference package's `pallas_agg.backend_ok` and
`contracts.donation_supported`, without their silent fallback: asking for
CUDA where there is none raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "druid_tpu_torch needs a CUDA device; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

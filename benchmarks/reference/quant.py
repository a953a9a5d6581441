"""Rounding for the control: the reference in the precision below the one
the configuration states.

The detection configuration states bfloat16 (its convolutions and the DFT
product); the next precision below is fp8.  ``fp8`` rounds a tensor to
float8 e4m3 with one scale per tensor (its largest magnitude maps to 448,
e4m3's largest finite value), as an fp8 inference path would, and returns
it in float32, so that the products accumulate in float32.  ``bf16``
rounds to bfloat16: what a configuration that states a one-pass bf16
product computes (the training frontend's DFT).
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the one-pass bf16 product's operands."""
    return x.to(torch.bfloat16).float()


PRECISIONS = {"float32": None, "fp8": fp8, "bfloat16": bf16}

"""Plain PyTorch oracle for fused crop+normalize, op for op as
``repro.kernels.fused_preprocess.ref``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ref_preprocess(images: torch.Tensor, crop: Tuple[int, int, int, int],
                   mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    y0, x0, h, w = crop
    x = images[:, y0:y0 + h, x0:x0 + w, :].to(torch.float32) / 255.0
    mean_a = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std_a = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (x - mean_a) / std_a

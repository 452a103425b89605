"""Rendering losses for the Gaussian-SLAM tier (port of
``ovo_tpu/slam/gaussian/losses.py``): l1 with mean / sum / none
aggregation, windowed SSIM (separable gaussian blur with SAME zero
padding), PSNR and the isotropic scale regularizer."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, agg: str = "mean"):
    d = torch.abs(pred - gt)
    if agg == "mean":
        return d.mean()
    if agg == "sum":
        return d.sum()
    return d


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable blur of (H, W, C), channels as the batch, zero padding."""
    size = win.shape[0]
    x = img.permute(2, 0, 1)[:, None]                    # (C, 1, H, W)
    x = F.conv2d(x, win.reshape(1, 1, size, 1), padding=(size // 2, 0))
    x = F.conv2d(x, win.reshape(1, 1, 1, size), padding=(0, size // 2))
    return x[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair."""
    win = _gaussian_window(window_size, 1.5, img1.device)
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = _blur(img1 * img1, win) - mu1_sq
    sigma2 = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return s.mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio over [0, 1] images."""
    err = (pred - gt) ** 2
    if mask is not None:
        mse = torch.where(mask[..., None], err, 0.0).sum() / torch.clamp(
            mask.sum() * pred.shape[-1], min=1)
    else:
        mse = err.mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def isotropic_loss(scales_log: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Mean |scale - mean(scale)| per gaussian, over the valid slots."""
    s = torch.exp(scales_log)
    dev = torch.abs(s - s.mean(dim=-1, keepdim=True)).mean(dim=-1)
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, dev, 0.0).sum() / n

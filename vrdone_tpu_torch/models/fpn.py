"""1-D FPN fuse neck (counterpart of ``vrdone_tpu/models/fpn.py``).

A top-down pathway over the backbone's temporal pyramid that produces ONE
full-resolution mask-feature map (reference FPN1D_Fuse,
models/fpns.py:141-257).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ChannelLayerNorm, MaskedConv1D

Tensor = torch.Tensor


def upsample_nearest(x: Tensor, scale: int) -> Tensor:
    """Nearest x``scale`` temporal upsample of (B, T, C)."""
    return torch.repeat_interleave(x, scale, dim=1)


class FPN1DFuse(nn.Module):

    def __init__(self, in_channels: tuple[int, ...], out_channel: int,
                 scale_factor: int = 2, start_level: int = 0,
                 end_level: int = -1, with_ln: bool = True,
                 norm_first: bool = False, *, device: torch.device):
        super().__init__()
        self.n_inputs = len(in_channels)
        self.scale_factor = scale_factor
        end_level = len(in_channels) if end_level == -1 else end_level
        self.levels = list(range(start_level, end_level))
        self.with_ln = with_ln
        self.norm_first = norm_first
        top = len(self.levels) - 1
        for pos, i in enumerate(self.levels):
            c_in = in_channels[i]
            if with_ln and norm_first:
                self.add_module(f"input_norm_{pos}",
                                ChannelLayerNorm(c_in, device=device))
            if pos == top:
                # top level: depthwise 3-conv straight to out_channel
                conv = MaskedConv1D(c_in, out_channel, 3, groups=out_channel,
                                    use_bias=not with_ln, device=device)
            else:
                self.add_module(f"lateral_conv_{pos}", MaskedConv1D(
                    c_in, out_channel, 1, use_bias=not with_ln,
                    device=device))
                if with_ln:
                    self.add_module(f"lateral_norm_{pos}", ChannelLayerNorm(
                        out_channel, device=device))
                conv = MaskedConv1D(out_channel, out_channel, 3,
                                    groups=out_channel, use_bias=not with_ln,
                                    device=device)
            self.add_module(f"fpn_conv_{pos}", conv)
            if with_ln:
                self.add_module(f"fpn_norm_{pos}",
                                ChannelLayerNorm(out_channel, device=device))
        self.mask_features = MaskedConv1D(out_channel, out_channel, 3,
                                          groups=out_channel, device=device)

    def forward(self, inputs, fpn_masks) -> tuple[Tensor, Tensor]:
        if len(inputs) != self.n_inputs:
            raise ValueError(f"expected {self.n_inputs} pyramid levels, got "
                             f"{len(inputs)}")
        y = None
        for pos in range(len(self.levels) - 1, -1, -1):
            i = self.levels[pos]
            x, mask = inputs[i], fpn_masks[i]
            if self.with_ln and self.norm_first:
                x = getattr(self, f"input_norm_{pos}")(x)
            if pos != len(self.levels) - 1:
                lat, _ = getattr(self, f"lateral_conv_{pos}")(x, mask)
                if self.with_ln:
                    lat = getattr(self, f"lateral_norm_{pos}")(lat)
                x = lat + upsample_nearest(y, self.scale_factor)
            y, _ = getattr(self, f"fpn_conv_{pos}")(x, mask)
            if self.with_ln:
                y = getattr(self, f"fpn_norm_{pos}")(y)
        return self.mask_features(y, fpn_masks[0])

"""MinkUNet with basic residual blocks (counterpart of
``warpconvnet_tpu/models/mink_unet.py``).

Stem conv, four stride-2 downsamples each followed by a block stage, four
transposed-conv upsamples with skip concatenation, 1x1 head. Kernel maps
are built inside the forward, once per level: every 3^3 conv of a level
shares one submanifold map, and each decoder level reuses the encoder's
strided map reversed and its stage map.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.modules.norms import BatchNorm
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d


def _relu(x: Voxels) -> Voxels:
    return x.replace_features(torch.relu(x.features))


class ConvBlock(nn.Module):
    """conv -> BN -> ReLU."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        transposed: bool = False,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.conv = SparseConv3d(
            in_channels, out_channels, kernel_size, stride=stride,
            transposed=transposed, device=device, generator=generator,
        )
        self.norm = BatchNorm(out_channels, device=device)

    def forward(self, x: Voxels, out_coords=None, pair_table=None, out_capacity=None):
        x, table = self.conv(
            x, out_coords=out_coords, pair_table=pair_table, out_capacity=out_capacity
        )
        return _relu(self.norm(x)), table


class BasicBlock(nn.Module):
    """Two 3^3 submanifold convs and a skip (1x1 conv + BN when the width
    changes). Both convs share one kernel map, returned for reuse."""

    def __init__(
        self, in_channels: int, out_channels: int,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = SparseConv3d(in_channels, out_channels, 3, **kw)
        self.norm1 = BatchNorm(out_channels, device=device)
        self.conv2 = SparseConv3d(out_channels, out_channels, 3, **kw)
        self.norm2 = BatchNorm(out_channels, device=device)
        self.proj = self.proj_norm = None
        if in_channels != out_channels:
            self.proj = SparseConv3d(in_channels, out_channels, 1, **kw)
            self.proj_norm = BatchNorm(out_channels, device=device)

    def forward(self, x: Voxels, pair_table=None):
        residual = x
        out, table = self.conv1(
            x, pair_table=pair_table, out_coords=x if pair_table is not None else None
        )
        out = _relu(self.norm1(out))
        out, _ = self.conv2(out, pair_table=table, out_coords=out)
        out = self.norm2(out)
        if self.proj is not None:
            residual, _ = self.proj(residual)
            residual = self.proj_norm(residual)
        out = out.replace_features(torch.relu(out.features + residual.features))
        return out, table


class MinkUNetBase(nn.Module):
    """MinkUNet with ``BasicBlock`` stages.

    The padded row capacity of stride level i (1, 2, 4, 8, 16) is the
    input's halved i times, with a floor of 128. Parameters are drawn from
    ``generator`` and placed on ``device`` (the card unless the caller asks
    for another).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        init_dim: int = 32,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.planes = tuple(planes)
        self.layers = tuple(layers)
        p, l = self.planes, self.layers
        kw = dict(device=constants.resolve_device(device), generator=generator)
        self.conv0 = ConvBlock(in_channels, init_dim, 1, **kw)
        in_chs = (init_dim, p[0], p[1], p[2])
        for s in range(4):
            self.add_module(f"conv{s + 1}", ConvBlock(in_chs[s], in_chs[s], 2, stride=2, **kw))
            self.add_module(f"block{s + 1}", self._stage(in_chs[s], p[s], l[s], kw))
        dec_in = p[3]
        skip_chs = (p[2], p[1], p[0], init_dim)
        for s in range(4):
            self.add_module(
                f"convtr{4 + s}",
                ConvBlock(dec_in, p[4 + s], 2, stride=2, transposed=True, **kw),
            )
            self.add_module(
                f"block{5 + s}",
                self._stage(p[4 + s] + skip_chs[s], p[4 + s], l[4 + s], kw),
            )
            dec_in = p[4 + s]
        self.final = SparseConv3d(dec_in, out_channels, 1, use_bias=True, **kw)

    @staticmethod
    def _stage(in_ch, out_ch, n, kw) -> nn.ModuleList:
        return nn.ModuleList(
            BasicBlock(in_ch if i == 0 else out_ch, out_ch, **kw) for i in range(n)
        )

    @staticmethod
    def _caps(n: int) -> Tuple[int, ...]:
        return tuple(max(n // (2 ** i), 128) for i in range(5))

    @staticmethod
    def _run_stage(stage: nn.ModuleList, x: Voxels, table=None):
        for blk in stage:
            x, table = blk(x, table)
        return x, table

    @tracing.spanned("wcn.model.minkunet")
    def forward(self, x: Voxels) -> Voxels:
        caps = self._caps(x.max_num_points)
        out_p1, _ = self.conv0(x)
        skips: List[Voxels] = [out_p1]
        tables = []
        stage_tables = [None]  # the stride-1 level has no map yet
        enc = out_p1
        for s in range(4):
            enc, t = getattr(self, f"conv{s + 1}")(enc, out_capacity=caps[s + 1])
            tables.append(t)
            enc, st = self._run_stage(getattr(self, f"block{s + 1}"), enc)
            if s < 3:
                skips.append(enc)
                stage_tables.append(st)

        dec = enc
        for s in range(4):
            skip = skips[3 - s]
            dec, _ = getattr(self, f"convtr{4 + s}")(
                dec, out_coords=skip, pair_table=tables[3 - s].reversed()
            )
            dec = dec.replace_features(torch.cat([dec.features, skip.features], dim=-1))
            dec, _ = self._run_stage(
                getattr(self, f"block{5 + s}"), dec, stage_tables[3 - s]
            )
        out, _ = self.final(dec)
        return out


def MinkUNet18(in_channels, out_channels, **kw) -> MinkUNetBase:
    return MinkUNetBase(in_channels, out_channels,
                        planes=(32, 64, 128, 256, 256, 128, 96, 96),
                        layers=(2, 2, 2, 2, 2, 2, 2, 2), **kw)


def MinkUNet34(in_channels, out_channels, **kw) -> MinkUNetBase:
    return MinkUNetBase(in_channels, out_channels,
                        planes=(32, 64, 128, 256, 256, 128, 96, 96),
                        layers=(2, 3, 4, 6, 2, 2, 2, 2), **kw)

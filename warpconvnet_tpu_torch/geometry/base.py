"""Shared behaviour of batched-padded geometry (counterpart of
``warpconvnet_tpu/geometry/base.py``).

Layout: ``coords [B, N, 3]``, ``features [B, N, C]``, ``num_valid [B]``;
the valid rows of a scene are always its first ``num_valid`` rows.
"""

from __future__ import annotations

import dataclasses

import torch


class GeometryMixin:
    """Subclasses are frozen dataclasses with fields ``coords``,
    ``features`` and ``num_valid``."""

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def max_num_points(self) -> int:
        return self.coords.shape[1]

    @property
    def num_channels(self) -> int:
        return self.features.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        """[B, N] bool, True on real (non-pad) rows."""
        iota = torch.arange(self.max_num_points, device=self.coords.device)
        return iota[None, :] < self.num_valid[:, None]

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def replace_features(self, features: torch.Tensor):
        """Same coordinates, new features."""
        if features.shape[:2] != self.features.shape[:2]:
            raise ValueError(
                f"feature rows {tuple(features.shape[:2])} != "
                f"{tuple(self.features.shape[:2])}"
            )
        return dataclasses.replace(self, features=features)

"""ResidueTensor: the carrier of residue-domain values (a dataclass).

* ``planes``: layout ``"rns"`` -- ``(*stack, C, K, N)`` centered residue
  planes (int8 when every centered residue fits); layout ``"rns_pack"`` --
  ``(*stack, 1, K, N/vpb)`` uint8, both residues of a packable 2-channel
  set bit-packed into byte lanes (the KV page storage format).
* ``scale``: optional dequantization scale, broadcastable against the
  decoded ``(*stack, K, N)`` value.
* ``mset``, ``layout``, ``qbits``, ``max_abs``: the moduli set, the layout
  tag, the prepare-time bit width and the magnitude bound that drives
  K-segmentation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.moduli import ModuliSet

__all__ = ["LAYOUTS", "ResidueTensor"]

LAYOUTS = ("rns", "rns_pack")


@dataclasses.dataclass(eq=False)
class ResidueTensor:
    planes: torch.Tensor
    scale: torch.Tensor | None = None
    mset: ModuliSet = None  # type: ignore[assignment]
    layout: str = "rns"
    qbits: int | None = None
    max_abs: int | None = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; expected one of {LAYOUTS}")
        if self.mset is None:
            raise ValueError("ResidueTensor needs a ModuliSet")
        if self.planes.dim() < 3:
            raise ValueError(f"planes need >= 3 dims (*stack, C, K, N), got "
                             f"shape {tuple(self.planes.shape)}")
        lanes = 1 if self.layout == "rns_pack" else self.mset.num_channels
        if self.layout == "rns_pack":
            self.mset.packed()   # raises unless the set is packable
        if self.planes.shape[self.channel_axis] != lanes:
            raise ValueError(
                f"{self.layout} planes need {lanes} channel lane(s) at axis "
                f"{self.channel_axis}, got shape {tuple(self.planes.shape)}")

    @property
    def channel_axis(self) -> int:
        return self.planes.dim() - 3

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of the represented integer value."""
        s = list(self.planes.shape)
        del s[self.channel_axis]
        if self.layout == "rns_pack":
            s[-1] *= self.mset.packed().values_per_byte
        return tuple(s)

    @property
    def stack_shape(self) -> tuple[int, ...]:
        return self.shape[:-2]

    def nbytes(self) -> int:
        """Bytes held by the planes and the scale."""
        n = self.planes.numel() * self.planes.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n

    def to_int(self) -> torch.Tensor:
        """Reverse conversion to int32 values (ignores ``scale``)."""
        if self.layout == "rns_pack":
            return self.mset.packed().decode(
                self.planes.select(self.channel_axis, 0))
        cf = self.planes.movedim(self.channel_axis, 0).to(torch.int32)
        return self.mset.from_residues(cf)

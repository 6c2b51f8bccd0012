"""ResidueTensor: the carrier of residue-domain values (a dataclass).

* ``planes``: layout ``"rns"`` -- ``(*stack, C, K, N)`` centered residue
  planes (int8 when every centered residue fits); layouts ``"sd"`` /
  ``"sd_matvec"`` -- ``(*stack, C, K, N, n)`` int8 signed-digit planes, the
  digit axis LSB first (``"sd_matvec"`` pins the decode-shaped matmul
  schedule); layout ``"rns_pack"`` -- ``(*stack, 1, K, N/vpb)`` uint8, both
  residues of a packable 2-channel set bit-packed into byte lanes (the KV
  page storage format).
* ``scale``: optional dequantization scale, broadcastable against the
  decoded ``(*stack, K, N)`` value.
* ``mset``, ``layout``, ``qbits``, ``max_abs``: the moduli set, the layout
  tag, the prepare-time bit width and the magnitude bound that drives
  K-segmentation.

Ring ops (``+``, ``-``, ``*``, unary ``-``) are exact mod M: centered plane
arithmetic for ``rns``, the carry-free SD adder and Eq. 2 multiplier of
``core.sdrns`` per channel for the sd layouts; :meth:`ResidueTensor.flush`
re-centers lazily reduced ``rns`` planes.  Every op builds its result with
:meth:`ResidueTensor._with_planes`, so a subclass
(:class:`~repro_torch.core.rns.RnsTensor`) keeps its type.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sdrns
from repro_torch.core.moduli import ModuliSet

__all__ = ["LAYOUTS", "ResidueTensor"]

LAYOUTS = ("rns", "sd", "sd_matvec", "rns_pack")


def _digit_width(mset: ModuliSet) -> int:
    """Shared SD digit width of a special moduli set (raises otherwise)."""
    kinds = {k for k, _ in mset.kinds}
    widths = {n for _, n in mset.kinds}
    if "generic" in kinds or len(widths) != 1:
        raise ValueError(
            "signed-digit layouts need a special moduli set (2^n-1 / 2^n / "
            f"2^n+1 at one width), got kinds {mset.kinds}")
    return next(iter(widths))


@dataclasses.dataclass(eq=False)
class ResidueTensor:
    planes: torch.Tensor
    scale: torch.Tensor | None = None
    mset: ModuliSet = None  # type: ignore[assignment]
    layout: str = "rns"
    qbits: int | None = None
    max_abs: int | None = None

    def __post_init__(self):
        self._validate()

    def _validate(self) -> None:
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; expected one of {LAYOUTS}")
        if self.mset is None:
            raise ValueError("ResidueTensor needs a ModuliSet")
        need = 4 if self.is_sd else 3
        if self.planes.dim() < need:
            raise ValueError(
                f"{self.layout} planes need >= {need} dims (*stack, C, K, N"
                f"{', n' if self.is_sd else ''}), got shape "
                f"{tuple(self.planes.shape)}")
        lanes = self.mset.num_channels
        if self.layout == "rns_pack":
            fmt = self.mset.packed()   # raises unless the set is packable
            lanes = 1 + self.mset.redundant
            if self.mset.redundant and fmt.values_per_byte != 1:
                raise ValueError(
                    "redundant rns_pack needs one value per byte, got "
                    f"vpb={fmt.values_per_byte} for {self.mset.moduli}")
        if self.planes.shape[self.channel_axis] != lanes:
            raise ValueError(
                f"{self.layout} planes need {lanes} channel lane(s) at axis "
                f"{self.channel_axis}, got shape {tuple(self.planes.shape)}")
        if self.is_sd:
            if self.mset.redundant:
                raise ValueError(
                    "signed-digit layouts cannot carry redundant channels "
                    "(redundant moduli are generic, not special); use "
                    "layout='rns' for fault-tolerant residency")
            n = _digit_width(self.mset)
            if self.planes.shape[-1] != n:
                raise ValueError(
                    f"sd planes need digit width {n} on the last axis, got "
                    f"shape {tuple(self.planes.shape)}")

    @property
    def is_sd(self) -> bool:
        return self.layout in ("sd", "sd_matvec")

    @property
    def digit_width(self) -> int:
        return _digit_width(self.mset)

    @property
    def channel_axis(self) -> int:
        return self.planes.dim() - (4 if self.is_sd else 3)

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of the represented integer value."""
        s = list(self.planes.shape)
        if self.is_sd:
            del s[-1]
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
        cf = self.planes.movedim(self.channel_axis, 0)
        if self.is_sd:
            return sdrns.sdrns_decode(cf, self.mset)
        return self.mset.from_residues(cf.to(torch.int32))

    # -- ring ops (exact mod M) ----------------------------------------------
    def _check_ring_op(self, other: "ResidueTensor") -> None:
        if not isinstance(other, ResidueTensor):
            raise TypeError(f"expected ResidueTensor, got {type(other)}")
        if "rns_pack" in (self.layout, other.layout):
            raise ValueError("rns_pack is a storage layout (bit-packed KV "
                             "pages); decode before arithmetic")
        if self.mset.moduli != other.mset.moduli:
            raise ValueError(f"moduli mismatch: {self.mset.moduli} vs "
                             f"{other.mset.moduli}")
        if self.is_sd != other.is_sd:
            raise ValueError(f"layout mismatch: {self.layout} vs "
                             f"{other.layout}")
        if self.scale is not None or other.scale is not None:
            raise ValueError("ring ops on scaled (quantized-weight) tensors "
                             "are ill-defined; decode first or drop the "
                             "scale")

    def _per_channel(self, fn, *operands: torch.Tensor) -> torch.Tensor:
        """``fn(kind, *channel_planes)`` per channel, restacked."""
        cf = [o.movedim(self.channel_axis, 0) for o in operands]
        outs = [fn(kind, *(o[c] for o in cf))
                for c, (kind, _) in enumerate(self.mset.kinds)]
        return torch.stack(outs, dim=0).movedim(0, self.channel_axis)

    def _with_planes(self, planes: torch.Tensor) -> "ResidueTensor":
        return dataclasses.replace(self, planes=planes)

    def _center(self, planes: torch.Tensor) -> torch.Tensor:
        # int32 inside the reduction (int8 storage would wrap), back to the
        # storage dtype after (centered residues fit it)
        out = self.mset.center(
            planes.movedim(self.channel_axis, 0).to(torch.int32))
        return out.movedim(0, self.channel_axis).to(self.planes.dtype)

    def __add__(self, other: "ResidueTensor") -> "ResidueTensor":
        self._check_ring_op(other)
        if self.is_sd:
            planes = self._per_channel(
                lambda kind, x, y: sdrns.modular_add(x, y, kind),
                self.planes, other.planes)
        else:
            planes = self._center(self.planes.to(torch.int32)
                                  + other.planes.to(torch.int32))
        return self._with_planes(planes)

    def __sub__(self, other: "ResidueTensor") -> "ResidueTensor":
        return self + (-other)

    def __mul__(self, other: "ResidueTensor") -> "ResidueTensor":
        self._check_ring_op(other)
        if self.is_sd:
            planes = self._per_channel(
                lambda kind, x, y: sdrns.modular_mul(x, y, kind),
                self.planes, other.planes)
        else:
            planes = self._center(self.planes.to(torch.int32)
                                  * other.planes.to(torch.int32))
        return self._with_planes(planes)

    def __neg__(self) -> "ResidueTensor":
        # digit-wise / plane-wise in both layouts: no carry chain at all
        if self.scale is not None:
            raise ValueError("negation of scaled tensors is ill-defined")
        if self.layout == "rns_pack":
            raise ValueError("rns_pack is a storage layout; decode first")
        return self._with_planes(-self.planes)

    def flush(self) -> "ResidueTensor":
        """Re-center ``rns`` planes (lazy reduction's flush); sd digits are
        closed over {-1, 0, 1} and ``rns_pack`` is storage: no-ops."""
        if self.is_sd or self.layout == "rns_pack":
            return self
        return self._with_planes(self._center(self.planes))

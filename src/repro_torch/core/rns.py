"""RnsTensor: the channel-first elementwise view of the residue representation.

A subclass of :class:`repro_torch.numerics.tensor.ResidueTensor` pinned to
the ``rns`` layout with the channel axis first: planes ``(C, ...)`` of any
value rank.  The ring arithmetic (centered add / sub / mul, negation,
:meth:`~ResidueTensor.flush`) is inherited; what stays here is the
elementwise surface of the paper's lazy-reduction carrier:
``lazy_add`` / ``lazy_mul`` (no re-centering), integer ``scale_by`` and
``matmul``.

Redundancy contract: planes may be non-canonical (outside ``[-m/2, m/2]``)
between operations, the residue analogue of the paper's signed-digit
redundancy; ``flush()`` re-centers, and
:meth:`ModuliSet.lazy_add_capacity` is the budget.

``matmul`` is the residue matmul kernel's function (B1, which replaces
``repro/kernels/rns_matmul.py::rns_matmul_pallas``): per channel the
products accumulate with no reduction and are centered once.  PyTorch has
no int32 matmul on CUDA, so on the card it launches B1 through the
registry; on the CPU it takes B1's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.moduli import ModuliSet
from repro_torch.numerics import runners  # noqa: F401  (registers B1)
from repro_torch.numerics.registry import backend_for, get_impl
from repro_torch.numerics.tensor import ResidueTensor

__all__ = ["RnsTensor"]


class RnsTensor(ResidueTensor):
    """(C, ...) residue planes, int32 (int8 storage allowed for sets whose
    moduli are at most 256)."""

    def __init__(self, residues: torch.Tensor, mset: ModuliSet):
        super().__init__(planes=residues, scale=None, mset=mset,
                         layout="rns", qbits=None, max_abs=None)

    def _validate(self) -> None:
        if self.planes.dim() < 1 or \
                self.planes.shape[0] != self.mset.num_channels:
            raise ValueError(
                f"residues of shape {tuple(self.planes.shape)} carry no "
                f"{self.mset.num_channels} channels on axis 0 for "
                f"{self.mset.moduli}")

    @property
    def channel_axis(self) -> int:
        return 0

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.planes.shape[1:])

    def _with_planes(self, planes: torch.Tensor) -> "RnsTensor":
        return RnsTensor(planes, self.mset)

    @property
    def residues(self) -> torch.Tensor:
        return self.planes

    @classmethod
    def from_int(cls, x: torch.Tensor, mset: ModuliSet) -> "RnsTensor":
        return cls(mset.to_residues(x, centered=True), mset)

    # lazy variants skip the re-centering; the caller owns the budget
    def lazy_add(self, other: "RnsTensor") -> "RnsTensor":
        return RnsTensor(self.planes.to(torch.int32)
                         + other.planes.to(torch.int32), self.mset)

    def lazy_mul(self, other: "RnsTensor") -> "RnsTensor":
        return RnsTensor(self.planes.to(torch.int32)
                         * other.planes.to(torch.int32), self.mset)

    def scale_by(self, k: int) -> "RnsTensor":
        """Multiply by an integer scalar (reduced per channel)."""
        planes = torch.stack([
            torch.remainder(self.planes[c].to(torch.int32) * (k % m), m)
            for c, m in enumerate(self.mset.moduli)])
        return RnsTensor(self.mset.center(planes), self.mset)

    def _kernel_planes(self) -> torch.Tensor:
        """The planes as B1 takes them on the card: int8, cast only where
        every value fits a byte (one read of the planes' range)."""
        p = self.planes
        if p.dtype == torch.int8:
            return p
        if max(self.mset.moduli) > 256:
            raise ValueError(
                f"RnsTensor.matmul on the card runs the int8 residue matmul "
                f"kernel; moduli {self.mset.moduli} exceed 256 and have no "
                "kernel")
        lo, hi = (int(v) for v in torch.aminmax(p))
        if lo < -128 or hi > 127:
            raise ValueError(
                f"planes span [{lo}, {hi}], outside int8: flush() them "
                "before a matmul on the card")
        return p.to(torch.int8)

    def matmul(self, other: "RnsTensor") -> "RnsTensor":
        """Channel-wise modular matmul ``(C, *batch, M, K) x (C, *batch, K,
        N) -> (C, *batch, M, N)``, int32 centered residues: lazy reduction,
        one centering at the end, valid while K <= lazy_add_capacity()."""
        if self.mset.moduli != other.mset.moduli:
            raise ValueError(f"moduli mismatch: {self.mset.moduli} vs "
                             f"{other.mset.moduli}")
        a, b = self.planes, other.planes
        if a.dim() < 3 or a.dim() != b.dim() or \
                a.shape[1:-2] != b.shape[1:-2] or a.shape[-1] != b.shape[-2]:
            raise ValueError(f"matmul takes (C, *batch, M, K) x (C, *batch, "
                             f"K, N), got {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
        if a.device != b.device:
            raise ValueError(f"operands on {a.device} and {b.device}")
        K = a.shape[-1]
        cap = self.mset.lazy_add_capacity()
        if K > cap:
            raise ValueError(
                f"K={K} exceeds lazy capacity {cap}; segment the contraction")
        if backend_for(a.device) == "cuda":
            a, b = self._kernel_planes(), other._kernel_planes()
        impl = get_impl("rns_matmul", a.device)
        batch = a.shape[1:-2]
        C, M, N = a.shape[0], a.shape[-2], b.shape[-1]
        if not batch:
            return RnsTensor(impl(a, b, self.mset.moduli), self.mset)
        # a batch runs as B1's stack: (S, C, M, K) views, one launch
        a4 = a.reshape(C, -1, M, K).movedim(1, 0)
        b4 = b.reshape(C, -1, K, N).movedim(1, 0)
        out = impl(a4, b4, self.mset.moduli)
        return RnsTensor(out.movedim(0, 1).reshape(C, *batch, M, N),
                         self.mset)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RnsTensor(shape={self.shape}, moduli={self.mset.moduli})"

"""The typed numerics surface for layout ``"rns"``: encode / matmul / decode.

    spec = EncodeSpec(layout="rns", mset=P21, qbits=4)
    t = encode(w, spec)            # quantize + forward-convert, paid once
    y = matmul(qx, t)              # exact int32 product of the integers
    v = decode(t)                  # reverse conversion (times the scale)

The kernel implementation follows the tensors' device (numerics/registry).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import runners
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.quant import qmax_for_bits, quantize_symmetric

__all__ = ["EncodeSpec", "encode", "decode", "matmul"]


@dataclasses.dataclass(frozen=True)
class EncodeSpec:
    """Static recipe for a forward conversion.

    layout: ``"rns"``, channel planes for the matmul kernel (the packed
      KV page storage is written by ``numerics/kv_pages``).
    qbits: quantization width of float inputs, and the magnitude bound of
      the encoded integers (it drives K-segmentation in :func:`matmul`).
    """

    layout: str = "rns"
    mset: ModuliSet = P21
    qbits: int | None = None

    def __post_init__(self):
        if self.layout != "rns":
            raise ValueError(f"encode writes layout 'rns', got "
                             f"{self.layout!r}")

    @property
    def bound(self) -> int | None:
        return None if self.qbits is None else qmax_for_bits(self.qbits)


def encode(w: torch.Tensor, spec: EncodeSpec | None = None) -> ResidueTensor:
    """Forward conversion: (..., K, N) values -> :class:`ResidueTensor`.

    Float ``w`` is quantized symmetrically to ``spec.qbits`` per output
    channel (over K) first, and the scale rides on the tensor.
    """
    spec = spec or EncodeSpec()
    if w.dim() < 2:
        raise ValueError(f"encode needs a (..., K, N) value, got "
                         f"{tuple(w.shape)}")
    scale = None
    if w.is_floating_point():
        if spec.qbits is None:
            raise ValueError("float input needs EncodeSpec.qbits")
        w, scale = quantize_symmetric(w, spec.qbits, axis=-2)
    return ResidueTensor(planes=runners.encode_rns_planes(w, spec.mset),
                         scale=scale, mset=spec.mset, layout=spec.layout,
                         qbits=spec.qbits, max_abs=spec.bound)


def decode(t: ResidueTensor) -> torch.Tensor:
    """int32 codes, or f32 ``codes * scale`` when ``t`` carries a scale."""
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"decode expects a ResidueTensor, got {type(t)}")
    codes = t.to_int()
    if t.scale is not None:
        return codes.to(torch.float32) * t.scale
    return codes


def matmul(a: torch.Tensor, t: ResidueTensor, *,
           max_abs_a: int | None = None) -> torch.Tensor:
    """Exact integer matmul of an (M, K) activation against encoded planes.

    ``max_abs_a`` bounds |a| (defaults to the tensor's own bound).  Only
    ``a`` is forward-converted per call; the planes are consumed as they
    are.  Returns (M, N) int32.
    """
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"matmul expects a ResidueTensor operand, got "
                        f"{type(t)}; encode the weight first")
    if t.layout != "rns":
        raise ValueError(f"matmul needs layout 'rns', got {t.layout!r}")
    if t.stack_shape:
        raise ValueError(f"matmul takes a 2-D encoded weight, got stacked "
                         f"value shape {t.shape}")
    if a.dim() != 2:
        raise ValueError(f"matmul takes a 2-D activation, got "
                         f"{tuple(a.shape)}")
    if t.max_abs is None:
        raise ValueError("tensor has no magnitude bound (encode with "
                         "qbits=); the bound drives K-segmentation")
    maa = t.max_abs if max_abs_a is None else max_abs_a
    return runners.rns_run(a, t.planes, mset=t.mset, max_abs_a=maa,
                           max_abs_b=t.max_abs)

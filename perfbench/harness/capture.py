"""Copies of what the program's decoder stages took and gave in one
admission prefill, taken inside the timed path.

While installed, :class:`Capture` stands in for the program functions that
the configuration's family names (``families/<family>.py``'s ``CAPTURE``):
the attention block over a prompt and the MLP block, each called as
``fn(params, x, ...)`` with input rows ``x (B, S, d)`` and returning its
output rows (the attention block with its cache).  The decoder's layer
loop calls each through its module, and every call is passed through.
While ``on``, it also copies, layer by layer, on the device: the attention
block's whole normed input (every prompt of the batch), and at the
selected rows its input and output and the MLP block's residual input and
output.  Nothing is read back to the host inside the window.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass
class Sel:
    """The rows one captured call copies: pairs (batch row, position) of
    ``bi`` / ``ri``, and the longest prompt's length ``n`` (the attention
    input is copied for every batch row up to it)."""

    bi: torch.Tensor
    ri: torch.Tensor
    n: int


class Capture:
    def __init__(self, targets: dict[str, tuple[str, str]]):
        self.targets = targets
        self.on = False
        self.sel: Sel | None = None
        self.layers: list[dict] = []
        self._orig: dict[str, tuple[object, object]] = {}

    def install(self):
        wrap = {"attention": self._attention, "mlp": self._mlp}
        for kind, (mod_name, attr) in self.targets.items():
            mod = importlib.import_module(mod_name)
            self._orig[kind] = (mod, getattr(mod, attr))
            setattr(mod, attr, wrap[kind])
        return self

    def uninstall(self) -> None:
        for kind, (mod, fn) in self._orig.items():
            setattr(mod, self.targets[kind][1], fn)

    def start(self, sel: Sel) -> list[dict]:
        self.sel, self.layers, self.on = sel, [], True
        return self.layers

    def stop(self) -> None:
        self.on = False

    def _attention(self, params, x, *a, **kw):
        res = self._orig["attention"][1](params, x, *a, **kw)
        if self.on:
            s = self.sel
            out = res[0] if isinstance(res, tuple) else res
            self.layers.append({"x_full": x[:, : s.n].clone(),
                                "a": x[s.bi, s.ri].clone(),
                                "h": out[s.bi, s.ri].clone()})
        return res

    def _mlp(self, params, x, *a, **kw):
        y = self._orig["mlp"][1](params, x, *a, **kw)
        if self.on:
            s = self.sel
            self.layers[-1].update(m=x[s.bi, s.ri].clone(),
                                   y=y[s.bi, s.ri].clone())
        return y

"""repro_torch: the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

One module per reference module, at the same relative path, and
``tracing.py`` (the port's spans and counters, on while ``torch.profiler``
records), which the reference has not.  Plain tensor
code is PyTorch; every TPU kernel on the ported path is a hand-written
Hopper kernel in ``csrc/`` (built at first use, see ``kernels/build.py``)
beside its plain PyTorch version.  The package imports neither ``jax`` nor
anything of ``repro``.
"""

"""The benchmark's frozen yardstick: peaks, work functions, model FLOP
arithmetic and the synthetic CIFAR generator.

These are copies, made when the benchmark was defined, of arithmetic the
program also carries (``repro_torch/roofline/hw.py``,
``repro_torch/roofline/op_cost.py``, ``repro_torch/launch/params.py``,
``repro_torch/data/cifar.py``).  The harness reads only these copies, so a
change to the program cannot move the ruler it is measured with.
"""

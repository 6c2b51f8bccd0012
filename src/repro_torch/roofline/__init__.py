"""Roofline analysis of the port on one NVIDIA H100: the card's peaks
(``hw``), the work a step does counted the same on the card, the CPU and
the meta device (``op_cost``), the three-term model (``analysis``) and the
dry run's report table (``report``)."""

"""One generator a kind of traffic.  A mix's data file
(``perfbench/traffic/<mix>.json``) names its ``kind``, and the harness
loads ``generators/<kind>.py`` by that name (``harness.main.generator``):
``requests`` (prompts and budgets for a served model) and ``images``
(batches for a classifier).  A new kind of traffic is a new file here."""

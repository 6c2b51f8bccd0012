"""One driver a kind of cell: ``serve`` (a model served through the
request scheduler) and ``cnn`` (the paper's CNN inference)."""

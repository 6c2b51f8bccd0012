"""Stream seconds in the program's ``attn.latent`` spans (MLA's ``kv_a``
product, the latent's norm, the rotary key, ``kv_b``'s expansion into
every head's k and v) over the profiled slice, %."""
from harness import spans


def read(run):
    return spans.share(run, "attn.latent")

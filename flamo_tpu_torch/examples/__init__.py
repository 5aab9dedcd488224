"""The port's e8 examples (counterparts of ``examples/e8_*.py``), run as
modules from the repository's root, e.g.
``python -m flamo_tpu_torch.examples.e8_colorless_fdn --device cpu``."""

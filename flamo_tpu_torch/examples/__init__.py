"""The port's examples (counterparts of ``examples/*.py``), run as
modules from the repository's root, e.g.
``python -m flamo_tpu_torch.examples.e8_colorless_fdn --device cpu``;
``flamo_tpu_torch.scripts.run_examples`` runs the tutorial and filter
examples at their defaults."""

"""See the package docstring of mudg_tpu_torch."""

"""Command-line apps (`python -m mudg_tpu_torch <command>`)."""

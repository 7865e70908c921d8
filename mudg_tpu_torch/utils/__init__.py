"""Host-side utilities (numpy), copied from `mudg_tpu/utils`."""

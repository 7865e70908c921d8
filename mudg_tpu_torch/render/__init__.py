"""Host-side rendering helpers (numpy), copied from `mudg_tpu/render`."""

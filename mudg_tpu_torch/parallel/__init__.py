"""Multi-GPU: process groups, data parallelism with ZeRO-2 or FSDP, sequence
and tensor parallelism (port of `mudg_tpu/parallel/`)."""

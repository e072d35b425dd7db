"""Parallelism over torch.distributed (port of graphcast_tpu/parallel)."""

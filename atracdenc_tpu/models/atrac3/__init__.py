"""ATRAC3 codec (batched JAX encoder + QA decoder)."""

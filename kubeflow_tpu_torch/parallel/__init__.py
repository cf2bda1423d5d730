"""Parallelism of the port. Today only ``ring_attention.full_attention``,
the single-device exact attention; the rest is ROADMAP.md queue A, A.7."""

"""Distributed-execution primitives: the logical sharding annotations
(:mod:`repro_torch.dist.api`) the model zoo reads.  On one card every
annotation is the identity."""

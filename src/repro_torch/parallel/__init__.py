"""Tensor-parallel metadata (port of part of ``repro/parallel``)."""

"""Solvers: the batched interior-point method."""

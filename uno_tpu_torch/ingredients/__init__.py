"""Ingredients of the interior-point method."""

"""Batched pipelines."""

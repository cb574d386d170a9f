"""Sparse and dense numerical ops of the port."""

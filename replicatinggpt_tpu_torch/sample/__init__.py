"""Batched per-slot sampling."""

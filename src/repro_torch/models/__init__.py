"""Functional models over dict-of-tensor params."""

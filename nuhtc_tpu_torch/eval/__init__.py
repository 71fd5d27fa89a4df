"""Evaluation helpers of the port (host code)."""

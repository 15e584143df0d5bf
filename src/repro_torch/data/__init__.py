"""Synthetic property-graph generators (the paper's workload datasets)."""

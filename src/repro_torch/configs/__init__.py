"""Workload configurations: the paper's views, reads and write mix."""

"""Partitioning of rows across buckets and, later, devices."""

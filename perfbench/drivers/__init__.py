"""Entries the benchmark drives, one module each, named by a traffic
file's "entry"."""

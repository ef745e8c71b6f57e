"""Serving: retrieval attention over a proximity-graph index of the keys."""

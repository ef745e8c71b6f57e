"""Serving: retrieval attention over a proximity-graph index of the keys,
and the slot-based LM decode engine."""

"""Training-side utilities; so far only the checkpoint module's framed and
atomic file helpers, which the serving resilience layer and the streaming
index share."""

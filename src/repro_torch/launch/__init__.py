"""Launchers: the mesh helpers and the training launcher (port of
``repro/launch``)."""

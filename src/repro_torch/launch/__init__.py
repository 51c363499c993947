"""Launchers of the port: ``serve`` (prefill -> decode model serving)."""

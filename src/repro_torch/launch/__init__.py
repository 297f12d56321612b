"""Launchers of the port: the batched serving engine."""

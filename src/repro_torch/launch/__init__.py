"""Launchers of the port: the serving CLI (``serve``)."""

"""Launchers of the port: the LM serving engine (``serve``) and the
community-detection service (``community_serve``)."""

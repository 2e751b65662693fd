"""Entry points: the server."""

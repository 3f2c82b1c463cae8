"""Serving path of the port: step functions, batching and the CLI."""

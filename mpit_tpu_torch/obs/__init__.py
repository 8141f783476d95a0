"""Observability of the port: stand-ins until ROADMAP.md item A12."""

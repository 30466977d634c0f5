"""Measurement tools that are not part of any entry point's path."""

"""Measurement tools that run beside the renderer."""

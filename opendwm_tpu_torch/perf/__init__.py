"""Measurement helpers and experiments of the port on the card."""

"""Weights interchange and serving artifacts of the port."""

"""Serving step functions."""

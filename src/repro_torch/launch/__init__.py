"""Serving step functions and the analytic cost model."""

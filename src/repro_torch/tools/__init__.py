"""Measurement scripts run on the card against a checkout of the port."""

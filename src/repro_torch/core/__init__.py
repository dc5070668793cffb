"""Deployment core of the port: targets, plans, app specs, the tuner."""

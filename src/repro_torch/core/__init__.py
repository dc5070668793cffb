"""Deployment core of the port: targets, plans, app specs, the tuner, the
build service, packages, job specs, batch files, the local scheduler, the
middleware and the end-to-end workflow."""

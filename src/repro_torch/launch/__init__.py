"""Execution layer of the port: the command dispatcher EASEY jobs run."""

"""Serving substrate: requests, traces, sampling, the engine."""

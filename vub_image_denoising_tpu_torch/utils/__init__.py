"""Checkpoint IO, logging, profiling, model info and device utilities."""

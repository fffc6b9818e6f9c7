"""Observation-sharded bundle adjustment over a mesh of devices."""

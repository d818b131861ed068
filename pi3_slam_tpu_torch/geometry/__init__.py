"""Geometry: SE3 helpers, dense-map utilities, focal recovery."""

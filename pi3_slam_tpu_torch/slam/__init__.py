"""Offline chunk creation."""

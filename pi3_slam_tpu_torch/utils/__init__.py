"""Utilities: grid keypoints."""

"""Chunk-file IO."""

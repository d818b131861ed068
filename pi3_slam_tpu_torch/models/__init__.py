"""Models: DINOv2 encoder, transformer blocks and Pi3, with parameter conversion."""

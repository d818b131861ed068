"""Host-side data pipeline: image loading, chunk windowing, prefetch."""

from .datasets import ChunkDataset, PrefetchLoader, chunk_windows
from .image_io import calculate_target_size, load_image, load_images
